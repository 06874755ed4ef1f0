"""Dense observation-grid bundle adjustment (port of
``bundle_adjustment_tpu.ops.ba_grid``): each map point owns D observation
slots, so every reduction is a masked einsum over the (P, D) grid.  Same LM
semantics as ``ops/ba.py`` (the shared ``lm_loop``).

Two camera-system steps.  The dense one (``_solve_step``) is what a window
of at most ``pcg_min_cameras`` cameras runs when the window LM kernel
(``ops/ba_kernel.py``) is switched off or does not admit its shape.  The
matrix-free PCG one (``_solve_step_pcg``, ``cg_iters > 0``) is the
global-scale solver wherever the global-BA kernels (``ops/ba_global_kernel.py``)
do not run: on the CPU, with a grouped preconditioner
(``cg_precond_group > 1``), or outside their gate.  Its camera reductions
are one float32 product against a static one-hot matrix, which adds in a
fixed order on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bundle_adjustment_tpu_torch.ops import ba as ba_flat
from bundle_adjustment_tpu_torch.ops.lie import so3_exp_and_jac


def _mv(A, x):
    """(..., i, j) @ (..., j) -> (..., i) as multiply + sum."""
    return torch.sum(A * x[..., None, :], dim=-1)


def _mm(a, b):
    """(..., i, k) @ (..., k, j) -> (..., i, j) as multiply + sum."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _jtj(a, b, w):
    """sum_k w[..., k] * a[..., k, i] * b[..., k, j] -> (..., i, j)."""
    aw = a * w[..., None]
    return torch.sum(aw[..., :, :, None] * b[..., :, None, :], dim=-3)


def _inv6(M):
    """Batched 6x6 inverse by 3x3-block Schur elimination (adjugate 3x3
    inverses, ``ba._inv3``).  M is the damped block-Jacobi diagonal of the
    Schur complement, SPD by construction, so the A block is invertible."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    Cb = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ainv = ba_flat._inv3(A)
    AinvB = _mm(Ainv, B)
    Sinv = ba_flat._inv3(D - _mm(Cb, AinvB))
    SinvCAinv = _mm(Sinv, _mm(Cb, Ainv))
    top = torch.cat([Ainv + _mm(AinvB, SinvCAinv), -_mm(AinvB, Sinv)], dim=-1)
    bot = torch.cat([-SinvCAinv, Sinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


class BAProblemGrid(NamedTuple):
    rvecs: torch.Tensor      # (C, 3)
    tvecs: torch.Tensor      # (C, 3)
    points: torch.Tensor     # (P, 3)
    cam_slot: torch.Tensor   # (P, D) int in [0, C)
    uv: torch.Tensor         # (P, D, 2)
    mask: torch.Tensor       # (P, D) f32 — 0 for empty slots
    point_mask: torch.Tensor # (P,) bool
    K: torch.Tensor          # (3, 3)


def from_flat(problem: ba_flat.BAProblem, max_slots: int | None = None,
              on_drop=None) -> BAProblemGrid:
    """Host-side conversion from the flat observation table; each point's
    live observations fill its D slots in table order.  With ``max_slots``
    below the largest count the excess is dropped and ``on_drop(n)`` called."""
    dev = problem.points.device
    pnt = problem.pnt_idx.cpu().numpy()
    cam = problem.cam_idx.cpu().numpy()
    uv = problem.uv.cpu().numpy()
    m = problem.obs_mask.cpu().numpy() > 0
    P = problem.points.shape[0]

    counts = np.zeros(P, np.int64)
    np.add.at(counts, pnt[m], 1)
    D = int(max(counts.max(initial=1), 1))
    if max_slots is not None:
        D = min(D, max_slots)

    cam_slot = np.zeros((P, D), np.int32)
    uv_g = np.zeros((P, D, 2), np.float32)
    mask = np.zeros((P, D), np.float32)
    live = np.flatnonzero(m)
    order = np.argsort(pnt[live], kind="stable")
    rows = live[order]
    p_sorted = pnt[rows]
    run_start = np.r_[0, np.flatnonzero(np.diff(p_sorted)) + 1]
    starts_rep = np.repeat(run_start, np.diff(np.r_[run_start, len(p_sorted)]))
    slots = np.arange(len(p_sorted)) - starts_rep
    keep = slots < D
    n_dropped = int((~keep).sum())
    if n_dropped and on_drop is not None:
        on_drop(n_dropped)
    cam_slot[p_sorted[keep], slots[keep]] = cam[rows[keep]]
    uv_g[p_sorted[keep], slots[keep]] = uv[rows[keep]]
    mask[p_sorted[keep], slots[keep]] = 1.0

    return BAProblemGrid(
        rvecs=problem.rvecs, tvecs=problem.tvecs, points=problem.points,
        cam_slot=torch.as_tensor(cam_slot, device=dev),
        uv=torch.as_tensor(uv_g, device=dev),
        mask=torch.as_tensor(mask, device=dev),
        point_mask=problem.point_mask, K=problem.K,
    )


def _grid_terms(rvecs, tvecs, points, p: BAProblemGrid, with_jac: bool = True):
    """Residuals r (P,D,2) and Jacobians Jc (P,D,2,6), Jp (P,D,2,3), with
    the rotation and its derivative computed per camera only.  With
    ``with_jac=False`` only r is computed (Jc, Jp are None)."""
    Rs, dRdr = so3_exp_and_jac(rvecs)
    cs = p.cam_slot.long()
    Rg = Rs[cs]                                     # (P, D, 3, 3)
    tg = tvecs[cs]
    X = points[:, None, :].expand(Rg.shape[:2] + (3,))
    Xc = _mv(Rg, X) + tg
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z = 1.0 / z_safe
    fx, fy = p.K[0, 0], p.K[1, 1]
    u = fx * Xc[..., 0] * inv_z + p.K[0, 2]
    v = fy * Xc[..., 1] * inv_z + p.K[1, 2]
    r = (torch.stack([u, v], dim=-1) - p.uv) * p.mask[..., None]
    if not with_jac:
        return r, None, None

    duv_dXc = ba_flat._duv_dxc(Xc, p.K)             # (P, D, 2, 3)
    J_X = torch.sum(duv_dXc[..., :, :, None] * Rg[..., None, :, :], dim=-2)
    dXc_dr = torch.sum(dRdr[cs] * points[:, None, None, :, None], dim=-2)
    J_r = torch.sum(duv_dXc[..., :, :, None] * dXc_dr[..., None, :, :], dim=-2)
    return r, torch.cat([J_r, duv_dXc], dim=-1), J_X


def _solve_step(rvecs, tvecs, points, p: BAProblemGrid, lam, delta, n_fixed, onehot):
    """One damped Schur step with a dense (6C')^2 camera solve."""
    C = rvecs.shape[0]
    C_adj = max(C - n_fixed, 1)

    r, Jc, Jp = _grid_terms(rvecs, tvecs, points, p)
    a = torch.abs(r)
    w = torch.where(a <= delta, torch.ones_like(a), delta / torch.clamp(a, min=1e-12)) \
        * p.mask[..., None]
    cam_ok = (p.cam_slot >= n_fixed).to(r.dtype)[..., None, None]
    Jc = Jc * cam_ok
    Jc_w = Jc * w[..., None]
    Jp_w = Jp * w[..., None]

    U = torch.einsum("pdc,pdki,pdkj->cij", onehot, Jc_w, Jc)
    g_c = torch.einsum("pdc,pdki,pdk->ci", onehot, Jc_w, r)
    V = torch.einsum("pdki,pdkj->pij", Jp_w, Jp)
    g_p = torch.einsum("pdki,pdk->pi", Jp_w, r)
    Y = torch.einsum("pdki,pdkj->pdij", Jc_w, Jp)
    B = torch.einsum("pdc,pdij->pcij", onehot, Y)

    U = ba_flat._damp(U, lam)
    V = ba_flat._damp(V, lam)
    Vinv = ba_flat._inv3(V)
    Vinv = torch.where(p.point_mask[:, None, None], Vinv, torch.zeros_like(Vinv))

    n = C_adj * 6
    BV = torch.einsum("pcik,pkl->pcil", B, Vinv)
    S = -torch.einsum("pcil,pdjl->cidj", BV, B).reshape(n, n)
    idx = torch.arange(C_adj, device=U.device)
    Ublock = torch.zeros((C_adj, 6, C_adj, 6), dtype=U.dtype, device=U.device)
    Ublock[idx, :, idx, :] = U
    S = S + Ublock.reshape(n, n)

    z_p = torch.einsum("pij,pj->pi", Vinv, g_p)
    Wz = torch.einsum("pcij,pj->ci", B, z_p)
    b = (-g_c + Wz).reshape(n)
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    dc_blocks = torch.linalg.solve_ex(S + 1e-8 * eye, b)[0].reshape(C_adj, 6)

    Wt_dc = torch.einsum("pcij,ci->pj", B, dc_blocks)
    dp = torch.einsum("pij,pj->pi", Vinv, -g_p - Wt_dc)

    d_r = torch.zeros_like(rvecs)
    d_t = torch.zeros_like(tvecs)
    d_r[n_fixed:] = dc_blocks[: C - n_fixed, :3]
    d_t[n_fixed:] = dc_blocks[: C - n_fixed, 3:]
    return d_r, d_t, dp


def _group_precond_rows(Y, YV, cam_slot, n_fixed, g):
    """Per-observation rows of the grouped block-Jacobi preconditioner.

    Adjustable cameras (index a = cam - n_fixed) fall into groups of ``g``
    consecutive cameras; the preconditioner is the exact principal submatrix
    of the Schur complement S of each group: every within-group coupling
    block S_{c1,c2} = -sum_p Y(c1,p) V^-1 Y(c2,p)^T, whatever its offset, so
    it stays SPD under loop-closure fill-in.

    Returns (P, D, g*36) rows: row (p, d1) holds, for each group-local
    position l, the 6x6 block summed over the slots d2 of the same point whose
    camera shares d1's group and sits at position l.  Reduced by camera like
    the rest of the setup; the term l == local(d1) is the plain block-Jacobi
    block."""
    P, D = cam_slot.shape
    a = cam_slot.long() - n_fixed                             # (P, D)
    grp = torch.where(a >= 0, torch.div(a, g, rounding_mode="floor"),
                      torch.full_like(a, -1))
    loc = torch.remainder(a, g)
    same = (grp[:, :, None] == grp[:, None, :]) & (a[:, :, None] >= 0) \
        & (a[:, None, :] >= 0)                                # (P, D, D)
    rows = torch.zeros((P, D, g, 36), dtype=Y.dtype, device=Y.device)
    pos = torch.arange(g, device=Y.device)
    for d2 in range(D):
        # q[p, d1] = YV[p, d1] @ Y[p, d2]^T  (6x6)
        q = torch.sum(YV[..., :, None, :] * Y[:, d2, None, None, :, :], dim=-1)
        oh = (loc[:, d2, None] == pos[None, :])[:, None, :] & same[:, :, d2, None]
        rows = rows + q.reshape(P, D, 1, 36) * oh[..., None].to(Y.dtype)
    return rows.reshape(P, D, g * 36)


def _solve_step_pcg(rvecs, tvecs, points, p: BAProblemGrid, lam, delta,
                    n_fixed, onehot_T, cg_iters, cg_tol, pc_group=1,
                    bf16_reduce: bool = False):
    """One damped Schur step on the grid layout with a matrix-free PCG camera
    solve: the global-scale path (cameras in the hundreds), where the dense
    step's (P, C', 6, 3) coupling tensor and (6C')^2 system stop scaling.

    Every point-side reduction is a sum over the D slot axis; every
    camera-side reduction is one product against ``onehot_T`` (C_adj, P*D),
    float32, whose order of summation is fixed.  The setup's four camera
    reductions (U blocks, gradient, right-hand-side coupling, preconditioner
    blocks) ride one product.  ``cg_tol`` may be a 0-d tensor.

    ``bf16_reduce`` rounds the reduced rows to bfloat16 before the product
    and accumulates in float32: the numerics of the JAX package's
    ``cg_bf16`` (its one-hot is exact in bfloat16).  The product itself stays
    float32 here (``torch.matmul`` has no bfloat16-in, float32-out form), so
    the option buys no memory on the card: it is kept to hold the port to
    the JAX package's numbers, and the pipeline never sets it.

    Returns (d_rvecs, d_tvecs, d_points, |b|)."""
    C = rvecs.shape[0]
    C_adj = max(C - n_fixed, 1)
    P, D = p.cam_slot.shape

    r, Jc, Jp = _grid_terms(rvecs, tvecs, points, p)
    a = torch.abs(r)
    w = torch.where(a <= delta, torch.ones_like(a), delta / torch.clamp(a, min=1e-12)) \
        * p.mask[..., None]
    cam_ok = (p.cam_slot >= n_fixed).to(r.dtype)[..., None, None]
    Jc = Jc * cam_ok
    Jc_w = Jc * w[..., None]
    Jp_w = Jp * w[..., None]

    def cam_reduce(rows):
        """(P, D, ...) observation rows -> (C_adj, ...)."""
        flat = rows.reshape(P * D, -1)
        if bf16_reduce:
            flat = flat.to(torch.bfloat16).to(onehot_T.dtype)
        return (onehot_T @ flat).reshape((C_adj,) + rows.shape[2:])

    V = torch.sum(_jtj(Jp, Jp, w), dim=1)                       # (P, 3, 3)
    g_p = torch.sum(Jp_w * r[..., None], dim=(1, 2))            # (P, 3)
    Y = _jtj(Jc, Jp, w)                                         # (P, D, 6, 3)

    Vinv = ba_flat._inv3(ba_flat._damp(V, lam))
    Vinv = torch.where(p.point_mask[:, None, None], Vinv, torch.zeros_like(Vinv))
    z_p = _mv(Vinv, g_p)
    YV = _mm(Y, Vinv[:, None])                                  # (P, D, 6, 3)
    if pc_group > 1:
        pc_rows = _group_precond_rows(Y, YV, p.cam_slot, n_fixed, pc_group)
    else:
        pc_rows = torch.sum(YV[..., :, None, :] * Y[..., None, :, :], dim=-1) \
            .reshape(P, D, 36)

    # one camera reduction for the whole setup:
    #   [U blocks (36) | gradient (6) | rhs coupling Wz (6) | precond blocks]
    red = cam_reduce(torch.cat([
        _jtj(Jc, Jc, w).reshape(P, D, 36),
        torch.sum(Jc_w * r[..., None], dim=-2),
        torch.sum(Y * z_p[:, None, None, :], dim=-1),
        pc_rows,
    ], dim=-1))                                   # (C_adj, 48 + 36*pc_group)
    U = ba_flat._damp(red[:, :36].reshape(C_adj, 6, 6), lam)
    b = -red[:, 36:42] + red[:, 42:48]                          # (C', 6)

    cs = p.cam_slot.long()
    pad = torch.zeros((n_fixed, 6), dtype=U.dtype, device=U.device)

    def matvec(x):
        xs = torch.cat([pad, x], dim=0)[cs]                     # (P, D, 6)
        q = torch.sum(torch.sum(Y * xs[..., None], dim=-2), dim=1)
        z = _mv(Vinv, q)
        WVWx = cam_reduce(torch.sum(Y * z[:, None, None, :], dim=-1))
        return _mv(U, x) - WVWx

    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    if pc_group > 1:
        # grouped block-Jacobi: the exact (6g x 6g) group-diagonal blocks of
        # S, inverted once per LM iteration and applied per CG iteration
        g = pc_group
        nG = -(-C_adj // g)
        pad_n = nG * g - C_adj
        grp = red[:, 48:].reshape(C_adj, g, 6, 6)
        Ud = U
        if pad_n:
            Ud = torch.cat([U, eye6.expand(pad_n, 6, 6)], dim=0)
            grp = torch.cat([grp, grp.new_zeros((pad_n, g, 6, 6))], dim=0)
        Mg = -grp.reshape(nG, g, g, 6, 6)
        di = torch.arange(g, device=U.device)
        Mg[:, di, di] += Ud.reshape(nG, g, 6, 6)
        M = Mg.permute(0, 1, 3, 2, 4).reshape(nG, 6 * g, 6 * g)
        eye = torch.eye(6 * g, dtype=M.dtype, device=M.device)
        Minv_g = torch.linalg.inv_ex(M + 1e-8 * eye)[0]

        def Minv(rr):
            if pad_n:
                rr = torch.cat([rr, rr.new_zeros((pad_n, 6))], dim=0)
            return _mv(Minv_g, rr.reshape(nG, 6 * g)).reshape(nG * g, 6)[:C_adj]
    else:
        # block-Jacobi: the exact 6x6 diagonal blocks of S (a camera sees a
        # point through at most one slot)
        Minv = _inv6(U - red[:, 48:].reshape(C_adj, 6, 6) + 1e-8 * eye6)

    dc_blocks = ba_flat._pcg_blocked(matvec, b, Minv, cg_iters, cg_tol)

    # back-substitute points: dp = V^-1 (-g_p - W^T dc)
    dcs = torch.cat([pad, dc_blocks], dim=0)[cs]                # (P, D, 6)
    Wt = torch.sum(torch.sum(Y * dcs[..., None], dim=-2), dim=1)
    dp = _mv(Vinv, -g_p - Wt)

    d_r = torch.zeros_like(rvecs)
    d_t = torch.zeros_like(tvecs)
    d_r[n_fixed:] = dc_blocks[: C - n_fixed, :3]
    d_t[n_fixed:] = dc_blocks[: C - n_fixed, 3:]
    return d_r, d_t, dp, torch.sqrt(torch.sum(b * b))


def ba_solve_grid_impl(
    problem: BAProblemGrid,
    n_fixed: int = 1,
    max_iterations: int = 50,
    huber_delta: float = 1.0,
    lambda_init: float = 1e-3,
    lambda_up: float = 4.0,
    lambda_down: float = 0.5,
    lambda_min: float = 1e-10,
    lambda_max: float = 1e8,
    ftol: float = 1e-5,
    xtol: float = 1e-5,
    cg_iters: int = 0,
    cg_tol: float = 1e-6,
    cg_forcing: bool = True,
    cg_bf16: bool = False,
    cg_precond_group: int = 1,
):
    """LM on the grid layout, same semantics as ``ops/ba.ba_solve``.  Returns
    (rvecs, tvecs, points, BAStats).

    ``cg_iters`` = 0: the dense camera solve, the window-scale path.
    ``cg_iters`` > 0: the matrix-free PCG camera solve (``_solve_step_pcg``)
    with a block-Jacobi preconditioner, grouped over ``cg_precond_group``
    consecutive cameras when that is above 1; with ``cg_forcing`` its
    tolerance follows the Eisenstat-Walker sequence of ``ba.lm_loop``, else
    it is ``cg_tol``; ``cg_bf16`` rounds the camera reductions' rows to
    bfloat16."""
    p = problem._replace(mask=problem.mask.to(problem.uv.dtype))
    C = p.rvecs.shape[0]
    C_adj = max(C - n_fixed, 1)
    cams = torch.arange(C_adj, device=p.uv.device)
    if cg_iters > 0:
        # transposed layout, (C_adj, P*D); an all-zero column for a slot of a
        # gauge-fixed camera
        onehot_T = (cams[:, None] == (p.cam_slot.long().reshape(-1)[None, :] - n_fixed)
                    ).to(p.uv.dtype)
    else:
        onehot = (p.cam_slot.long()[..., None] - n_fixed == cams).to(p.uv.dtype)

    def residuals(rv, tv, pt):
        return _grid_terms(rv, tv, pt, p, with_jac=False)[0]

    def cost_at(rv, tv, pt):
        return ba_flat.robust_cost(residuals(rv, tv, pt), huber_delta)

    def sq_at(rv, tv, pt):
        r = residuals(rv, tv, pt)
        return torch.sum(r * r)

    if cg_iters > 0:
        def step(rv, tv, pt, lam, tol):
            return _solve_step_pcg(rv, tv, pt, p, lam, huber_delta, n_fixed, onehot_T,
                                   cg_iters, tol, pc_group=cg_precond_group,
                                   bf16_reduce=cg_bf16)
    else:
        def step(rv, tv, pt, lam):
            return _solve_step(rv, tv, pt, p, lam, huber_delta, n_fixed, onehot)

    return ba_flat.lm_loop(
        step, cost_at, sq_at, p.rvecs, p.tvecs, p.points,
        max_iterations=max_iterations, lambda_init=lambda_init,
        lambda_up=lambda_up, lambda_down=lambda_down, lambda_min=lambda_min,
        lambda_max=lambda_max, ftol=ftol, xtol=xtol,
        cg_tol=cg_tol if cg_iters > 0 else None, cg_forcing=cg_forcing)


ba_solve_grid = ba_solve_grid_impl
