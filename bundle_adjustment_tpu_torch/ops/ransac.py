"""Batched-hypothesis RANSAC pose estimation (port of
``bundle_adjustment_tpu.ops.ransac``).

The JAX package draws its sample uniforms inside ``_sample_indices`` with
``jax.random.uniform(key, (num_hyp, sample_size))``.  Here those draws are
an input: ``_sample_indices``, ``estimate_essential_pose`` and
``estimate_pnp_pose`` take the ``(num_hyp, sample_size)`` uniform tensor
``u`` in place of the key, so a test can feed both packages the same
numbers.  ``essential_draw_shape`` / ``pnp_draw_shape`` give the shapes.

Everything else is the JAX algorithm: 5-point (or 8-point) minimal solves,
MSAC scoring, IRLS 8-point refinement, cheirality-vote decomposition and a
Gauss-Newton polish on the essential manifold; DLT PnP hypotheses, inlier
counting and a Gauss-Newton polish.  Jacobians of the polish residuals come
from ``torch.func.jacfwd``, as the JAX package uses ``jax.jacfwd``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd

from bundle_adjustment_tpu_torch.ops.five_point import five_point_candidates
from bundle_adjustment_tpu_torch.ops.lie import so3_exp, so3_hat
from bundle_adjustment_tpu_torch.ops.projection import pixel_to_normalized, sampson_distance


class PoseResult(NamedTuple):
    R: torch.Tensor            # (3, 3) relative rotation (x2 = R x1 + t)
    t: torch.Tensor            # (3,)
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor  # () int32
    inlier_ratio: torch.Tensor # () f32
    ok: torch.Tensor           # () bool


def essential_draw_shape(num_hyp: int, solver: str = "5pt") -> tuple:
    """Shape of the uniforms ``estimate_essential_pose`` consumes."""
    if solver == "5pt":
        return (max(num_hyp // 10, 32), 5)
    return (num_hyp, 8)


def pnp_draw_shape(num_hyp: int) -> tuple:
    """Shape of the uniforms ``estimate_pnp_pose`` consumes."""
    return (num_hyp, 6)


def _sample_indices(u, valid, num_hyp, sample_size, quality=None):
    """(num_hyp, sample_size) indices drawn from the valid slots by the
    uniforms ``u`` of that shape; with ``quality`` (lower = better) the
    draws are progressive (PROSAC-style), as in the JAX package."""
    if tuple(u.shape) != (num_hyp, sample_size):
        raise ValueError(f"u: expected shape {(num_hyp, sample_size)}, got "
                         f"{tuple(u.shape)}")
    n = valid.shape[0]
    if quality is None:
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
    else:
        order = torch.argsort(torch.where(valid, quality, torch.inf), stable=True)
    n_valid = torch.sum(valid).to(torch.float32)
    if quality is None:
        k_h = torch.ones((num_hyp, 1), device=u.device) * torch.clamp(n_valid, min=1.0)
    else:
        frac = (torch.arange(num_hyp, dtype=torch.float32, device=u.device) + 1.0) / num_hyp
        k0 = torch.clamp(torch.clamp(n_valid, min=1.0), max=2.0 * sample_size)
        k_h = (k0 + frac * torch.clamp(n_valid - k0, min=0.0))[:, None]
    r = torch.floor(u * k_h).to(torch.int64)
    return order[torch.clamp(r, 0, n - 1)]


def _hartley_normalize(x):
    """Isotropic normalization over the rows of x (..., S, 2)."""
    c = torch.mean(x, dim=-2)
    d = torch.mean(torch.linalg.norm(x - c[..., None, :], dim=-1), dim=-1)
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-8)
    T = torch.zeros(x.shape[:-2] + (3, 3), dtype=x.dtype, device=x.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 2, 2] = 1.0
    T[..., 0, 2] = -s * c[..., 0]
    T[..., 1, 2] = -s * c[..., 1]
    return (x - c[..., None, :]) * s[..., None, None], T


def _project_essential(E):
    U, _, Vt = torch.linalg.svd(E)
    sv = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return torch.matmul(U * sv, Vt)


def _eight_point(x1, x2, w=None):
    """Weighted 8-point essential estimate (batched over leading dims)."""
    x1n, T1 = _hartley_normalize(x1)
    x2n, T2 = _hartley_normalize(x2)
    ones = torch.ones_like(x1n[..., :1])
    p1 = torch.cat([x1n, ones], dim=-1)
    p2 = torch.cat([x2n, ones], dim=-1)
    A = (p2[..., :, None] * p1[..., None, :]).reshape(x1.shape[:-1] + (9,))
    if w is not None:
        A = A * w[..., None]
    AtA = torch.matmul(A.transpose(-1, -2), A)
    _, vecs = torch.linalg.eigh(AtA)
    E = vecs[..., :, 0].reshape(x1.shape[:-2] + (3, 3))
    E = torch.matmul(torch.matmul(T2.transpose(-1, -2), E), T1)
    return _project_essential(E)


def _decompose_e(E):
    """E -> the four (R, t) candidates (Hartley-Zisserman)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _cheirality_counts(Rs, ts, x1, x2, mask):
    """Points in front of both cameras for each candidate (R, t) of (4,...)."""
    ones = torch.ones_like(x1[:, :1])
    p1 = torch.cat([x1, ones], dim=1)
    p2 = torch.cat([x2, ones], dim=1)
    Rp1 = torch.matmul(p1, Rs.transpose(-1, -2))                # (4, N, 3)
    a = torch.linalg.cross(p2.expand_as(Rp1), Rp1, dim=-1)
    b = torch.linalg.cross(p2.expand_as(Rp1), ts[:, None, :].expand_as(Rp1), dim=-1)
    d1 = -torch.sum(b * a, dim=-1) / torch.sum(a * a, dim=-1).clamp(min=1e-12)
    z2 = d1 * Rp1[..., 2] + ts[:, 2:3]
    return torch.sum((d1 > 0) & (z2 > 0) & mask, dim=-1)


def _tangent_basis(t):
    """(3, 2) orthonormal basis of the plane perpendicular to unit t."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    e = torch.where(torch.abs(t[0]) < 0.9, ex, ey)
    b1 = torch.linalg.cross(t, e, dim=-1)
    b1 = b1 / torch.linalg.norm(b1).clamp(min=1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=1)


def _polish_rt(R, t, x1, x2, valid, thr_norm_sq, iters=5):
    """Gauss-Newton on the 5-dof essential manifold minimizing the signed
    Sampson residual over current inliers; accept on the MSAC score."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    dt = x1.dtype
    eye5 = torch.eye(5, dtype=dt, device=x1.device)

    def signed_sampson(E, w):
        Ep1 = torch.matmul(p1, E.T)
        Etp2 = torch.matmul(p2, E)
        err = torch.sum(p2 * Ep1, dim=-1)
        denom = (Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2
                 + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2).clamp(min=1e-12)
        return err / torch.sqrt(denom) * w

    def msac(R_, t_):
        E_ = torch.matmul(so3_hat(t_), R_)
        return torch.sum(torch.clamp(sampson_distance(E_, x1, x2), max=thr_norm_sq)
                         * valid)

    for _ in range(iters):
        E = torch.matmul(so3_hat(t), R)
        d = sampson_distance(E, x1, x2)
        w = ((d < thr_norm_sq) & valid).to(dt)
        B = _tangent_basis(t)

        def res(params, R=R, t=t, B=B, w=w):
            # (1, 3) rather than (3,): under jacfwd a 0-dim tensor meeting a
            # Python float promotes to float64
            R2 = torch.matmul(so3_exp(params[None, :3])[0], R)
            t2 = t + B @ params[3:]
            t2 = t2 / torch.linalg.norm(t2).clamp(min=1e-12)
            return signed_sampson(torch.matmul(so3_hat(t2), R2), w)

        p0 = torch.zeros(5, dtype=dt, device=x1.device)
        r = res(p0)
        J = jacfwd(res)(p0)
        JtJ = torch.matmul(J.T, J) + 1e-9 * eye5
        g = torch.matmul(J.T, r)
        delta = -torch.linalg.solve_ex(JtJ, g)[0]
        R_new = torch.matmul(so3_exp(delta[:3]), R)
        t_new = t + B @ delta[3:]
        t_new = t_new / torch.linalg.norm(t_new).clamp(min=1e-12)
        better = msac(R_new, t_new) <= msac(R, t)
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
    return R, t


def estimate_essential_pose(
    u: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    threshold_px: float = 3.0,
    num_hyp: int = 1024,
    refine_iters: int = 2,
    quality: torch.Tensor | None = None,
    solver: str = "5pt",
) -> PoseResult:
    """Essential-matrix RANSAC + cheirality-max decomposition.  ``u``:
    uniforms of shape ``essential_draw_shape(num_hyp, solver)``.  Returns the
    relative pose with x2 = R x1 + t and the epipolar-inlier mask."""
    Kf = K.to(uv1.dtype)
    x1 = pixel_to_normalized(Kf, uv1)
    x2 = pixel_to_normalized(Kf, uv2)
    f = (Kf[0, 0] + Kf[1, 1]) * 0.5
    thr_norm_sq = (threshold_px / f) ** 2
    validf = valid

    def msac_batch(Es):
        d = sampson_distance(Es, x1, x2)                            # (C, N)
        return torch.sum(torch.minimum(d, thr_norm_sq) * validf, dim=-1)

    def msac(E):
        return torch.sum(torch.minimum(sampson_distance(E, x1, x2), thr_norm_sq)
                         * validf)

    if solver == "5pt":
        n_samples = max(num_hyp // 10, 32)
        idx = _sample_indices(u, valid, n_samples, 5, quality)
        Es, cand_ok = five_point_candidates(x1[idx], x2[idx])
        Es = Es.reshape(-1, 3, 3)
        cand_ok = cand_ok.reshape(-1)
        scores = torch.where(cand_ok, msac_batch(Es), torch.inf)
    else:
        idx = _sample_indices(u, valid, num_hyp, 8, quality)
        Es = _eight_point(x1[idx], x2[idx])
        scores = msac_batch(Es)

    E = Es[torch.argmin(scores)]

    for _ in range(refine_iters):
        d = sampson_distance(E, x1, x2)
        w = ((d < thr_norm_sq) & valid).to(x1.dtype)
        E2 = _eight_point(x1, x2, w)
        E = torch.where(msac(E2) <= msac(E), E2, E)

    inliers = (sampson_distance(E, x1, x2) < thr_norm_sq) & valid
    Rs, ts = _decompose_e(E)
    votes = _cheirality_counts(Rs, ts, x1, x2, inliers)
    pick = torch.argmax(votes)
    R, t = Rs[pick], ts[pick]

    R, t = _polish_rt(R, t, x1, x2, valid, thr_norm_sq)
    E = torch.matmul(so3_hat(t), R)
    inliers = (sampson_distance(E, x1, x2) < thr_norm_sq) & valid
    n_inl = torch.sum(inliers)
    n_valid = torch.sum(valid)
    return PoseResult(
        R=R, t=t, inliers=inliers, num_inliers=n_inl.to(torch.int32),
        inlier_ratio=n_inl / torch.clamp(n_valid, min=1).to(uv1.dtype),
        ok=n_valid >= 8,
    )


# ---------------------------------------------------------------------------
# PnP (3D-2D) RANSAC
# ---------------------------------------------------------------------------


def _dlt_projection(X, x):
    """Batched 6-point DLT for P (..., 3, 4) from X (..., S, 3), x (..., S, 2).

    The null vector comes from a float32 eigh of the unnormalised A^T A, as
    in the JAX package.  That squares A's condition number: with the map a
    few metres off the origin the vector misses the float64 null vector's
    residual by 5 to 10 times, in both packages alike, and on a sample that
    is close to coplanar the null space has more than one dimension and the
    vector is whichever one LAPACK lands on.  RANSAC over such hypotheses
    then differs between the packages by chance, in either direction
    (``tests/test_torch_geometry.py``).  A float64 eigh repairs the first and
    not the second, and moves the port away from the JAX package on scenes
    of two planes, so it is not taken here."""
    ones = torch.ones_like(X[..., :1])
    Xh = torch.cat([X, ones], dim=-1)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -x[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -x[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    AtA = torch.matmul(A.transpose(-1, -2), A)
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0].reshape(X.shape[:-2] + (3, 4))


def _pose_from_projection(P):
    """(R, t) from P = s[R|t]: nearest rotation by SVD, scale from the
    singular values, sign from det.  Invariant to the sign of P."""
    M = P[..., :, :3]
    U, s, Vt = torch.linalg.svd(M)
    detUV = torch.linalg.det(torch.matmul(U, Vt))
    sgn = torch.sign(detUV)
    R = torch.matmul(U * sgn[..., None, None], Vt)
    scale = sgn * 3.0 / torch.sum(s, dim=-1).clamp(min=1e-12)
    t = P[..., :, 3] * scale[..., None]
    return R, t


def _reproj_err_norm(R, t, X, x):
    """Squared reprojection error in normalized coords (batched over leading
    dims of R, t); behind-camera points get 1e12."""
    Xc = torch.matmul(X, R.transpose(-1, -2)) + t[..., None, :]
    z = Xc[..., 2]
    bad = z <= 1e-6
    proj = Xc[..., :2] / torch.where(bad, torch.ones_like(z), z)[..., None]
    err = torch.sum((proj - x) ** 2, dim=-1)
    return torch.where(bad, torch.full_like(err, 1e12), err)


def estimate_pnp_pose(
    u: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    reproj_threshold_px: float = 8.0,
    num_hyp: int = 128,
    polish_iters: int = 5,
) -> PoseResult:
    """PnP RANSAC (world -> camera) from 3D-2D correspondences.  ``u``:
    uniforms of shape ``pnp_draw_shape(num_hyp)``."""
    Kf = K.to(uv.dtype)
    x = pixel_to_normalized(Kf, uv)
    f = (Kf[0, 0] + Kf[1, 1]) * 0.5
    thr_norm_sq = (reproj_threshold_px / f) ** 2
    dt = x.dtype

    idx = _sample_indices(u, valid, num_hyp, 6)
    Rs, ts = _pose_from_projection(_dlt_projection(X[idx], x[idx]))
    counts = torch.sum((_reproj_err_norm(Rs, ts, X, x) < thr_norm_sq) & valid, dim=-1)
    best = torch.argmax(counts)
    R, t = Rs[best], ts[best]
    eye6 = torch.eye(6, dtype=dt, device=x.device)

    def cost(R_, t_):
        e = _reproj_err_norm(R_, t_, X, x)
        return torch.sum(torch.clamp(e, max=thr_norm_sq) * valid)

    for _ in range(polish_iters):
        w_mask = ((_reproj_err_norm(R, t, X, x) < thr_norm_sq) & valid).to(dt)

        def residual(params, R=R, t=t, w_mask=w_mask):
            Rp = torch.matmul(so3_exp(params[None, :3])[0], R)   # see _polish_rt
            Xc = torch.matmul(X, Rp.T) + (t + params[3:])
            z = Xc[:, 2]
            z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
            proj = Xc[:, :2] / z[:, None]
            return ((proj - x) * w_mask[:, None]).reshape(-1)

        p0 = torch.zeros(6, dtype=dt, device=x.device)
        r = residual(p0)
        J = jacfwd(residual)(p0)
        JtJ = torch.matmul(J.T, J) + 1e-6 * eye6
        g = torch.matmul(J.T, r)
        delta = -torch.linalg.solve_ex(JtJ, g)[0]
        R_new = torch.matmul(so3_exp(delta[:3]), R)
        t_new = t + delta[3:]
        better = cost(R_new, t_new) < cost(R, t)
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)

    inliers = (_reproj_err_norm(R, t, X, x) < thr_norm_sq) & valid
    n_inl = torch.sum(inliers)
    n_valid = torch.sum(valid)
    return PoseResult(
        R=R, t=t, inliers=inliers, num_inliers=n_inl.to(torch.int32),
        inlier_ratio=n_inl / torch.clamp(n_valid, min=1).to(uv.dtype),
        ok=n_valid >= 6,
    )
