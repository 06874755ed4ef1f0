"""Window bundle adjustment as one kernel launch: the CUDA kernel's wrapper
and its plain version.

Counterpart of ``bundle_adjustment_tpu.ops.ba_pallas`` (K3).  The kernel
(``csrc/ba_window_lm.cu``) runs the whole Schur-complement Levenberg-Marquardt
solve of one BA window in a single launch, the LM loop included: Rodrigues
and its analytic derivative, per-slot residuals and Jacobians with Huber
weights, the normal equations, the Schur complement, Gauss-Jordan on the
(6C')^2 camera system, point back-substitution, the trial cost and the
accept/reject step.  Same LM semantics as ``ba_grid.ba_solve_grid_impl``.

``lm_solve`` launches the kernel for CUDA tensors and runs ``lm_solve_plain``
for CPU tensors; nothing gives way from the card to the plain version.

``lm_solve_plain`` is the kernel's arithmetic in plain PyTorch over the
(P, D) observation grid: cameras are gathered by ``cam_slot`` where the TPU
kernel multiplies by a one-hot matrix, and what is gathered for a dead slot
(mask 0) is zeroed, as the all-zero one-hot rows do there.  What is carried
over from ``ba_pallas._lm_solve_values`` as it stands: the small-angle
series of Rodrigues and its derivative (``lie.so3_exp_and_jac``), ``z_safe``,
Huber weights with the mask folded in, the damping ``v + lam*|v| + lam*1e-6``
of V's and U's diagonals and the ``1e-8`` ridge, the adjugate 3x3 inverse
with ``|det| < 1e-12 -> 1e-12`` and the point mask folded into ``1/det``,
Gauss-Jordan without pivoting and its ``1e-20`` pivot clamp, and the LM loop
(``ba.lm_loop``: accept on ``new_cost < cost``, the ftol/xtol test, ``stuck``
at ``lambda_max``; the TPU loop's start state ``done = init_cost < 0`` is
false for every Huber cost, so the loop is entered alike).

A point a hair from a camera centre has a V block near 1e13 whose float32
determinant overflows (inf - inf op by op, inf under FMA contraction).  The
kernel and the plain version both give such a point an inverse of 0: it does
not move in that step and adds nothing to the camera system, as ``ba._inv3``
does and as the jitted JAX solve does.

The shape gate.  ``6 * (C - n_fixed) <= 48`` bounds the in-kernel
Gauss-Jordan (the system and its right-hand side sit in shared memory);
``C <= 16`` bounds the camera state in shared memory.  D has no bound but
``P * D < 2**31`` (a slot index): the per-point passes loop over a point's
slots at run time, and a second slot of one camera adds to that camera's
coupling block (a keyframe that sees a point through several keypoints, as
the long drive's windows do past 12 slots).  The TPU gate's ``D <= 12``
answered its VMEM plan and is not kept.  The TPU gate's ``P <= 2048`` and its 10 MB
estimate are Mosaic's and are not kept: one thread-block cluster of
16 CTAs splits the points between them, and what must survive
between the kernel's phases (per point: one 6x3 coupling block per
adjustable camera, V^-1, g_p, the trial point, a camera bit mask:
``18 * C' + 13`` floats) lives in a global scratch buffer.
P is bounded by keeping that buffer within ``SCRATCH_LIMIT_BYTES`` = 32 MiB,
so that it stays in the H100's 50 MB L2 between phases: P <= 53,430 at
C' = 8 and P <= 125,203 at C' = 3.  Every default window (``max_points`` =
8192, 5.1 MB of scratch at C' = 8) is admitted.
"""

from __future__ import annotations

import torch

from bundle_adjustment_tpu_torch import kernels
from bundle_adjustment_tpu_torch.ops import ba as ba_flat
from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid
from bundle_adjustment_tpu_torch.ops.lie import so3_exp, so3_exp_and_jac

NAME = "ba_window_lm"

MAX_SYSTEM = 48          # 6 * adjustable cameras
MAX_CAMERAS = 16         # C, fixed ones included
SCRATCH_LIMIT_BYTES = 32 << 20


def scratch_floats(C: int, P: int, n_fixed: int) -> int:
    """Floats of global scratch the kernel needs for a (C, P) window."""
    return P * (18 * (C - n_fixed) + 13)


def eligible_shape(C: int, P: int, D: int, n_fixed: int = 1) -> bool:
    """Whether the kernel takes a window of this shape (module docstring)."""
    c_adj = C - n_fixed
    if n_fixed < 0 or c_adj < 1 or 6 * c_adj > MAX_SYSTEM:
        return False
    if C > MAX_CAMERAS or D < 1 or P < 1 or P * D >= 2 ** 31:
        return False
    return 4 * scratch_floats(C, P, n_fixed) <= SCRATCH_LIMIT_BYTES


def kernel_eligible(grid: BAProblemGrid, n_fixed: int = 1) -> bool:
    P, D = grid.cam_slot.shape
    return eligible_shape(grid.rvecs.shape[0], P, D, n_fixed)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _slot_terms(rv, tv, pts, p: BAProblemGrid, live, with_jac: bool):
    """Residuals r (P, D, 2) and, with ``with_jac``, Jacobians Jc (P, D, 2, 6)
    and Jp (P, D, 2, 3).  Rotation, its derivative and translation are
    gathered per slot and zeroed for dead slots."""
    cs = p.cam_slot.long()
    if with_jac:
        R, dR = so3_exp_and_jac(rv)
    else:
        R, dR = so3_exp(rv), None
    Rg = R[cs] * live[..., None, None]                       # (P, D, 3, 3)
    tg = tv[cs] * live[..., None]
    Xc = torch.sum(Rg * pts[:, None, None, :], dim=-1) + tg
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z = 1.0 / z_safe
    u = p.K[0, 0] * Xc[..., 0] * inv_z + p.K[0, 2]
    v = p.K[1, 1] * Xc[..., 1] * inv_z + p.K[1, 2]
    r = (torch.stack([u, v], dim=-1) - p.uv) * p.mask[..., None]
    if not with_jac:
        return r, None, None
    duv = ba_flat._duv_dxc(Xc, p.K)                          # (P, D, 2, 3)
    Jp = torch.sum(duv[..., :, :, None] * Rg[..., None, :, :], dim=-2)
    dRg = dR[cs] * live[..., None, None, None]               # [i, j, k]
    dXdr = torch.sum(dRg * pts[:, None, None, :, None], dim=-2)
    Jr = torch.sum(duv[..., :, :, None] * dXdr[..., None, :, :], dim=-2)
    return r, torch.cat([Jr, duv], dim=-1), Jp


def _inv3_damped(V, lam, point_mask):
    """Inverse of the damped symmetric 3x3 blocks V (P, 3, 3) by the
    adjugate, the point mask folded into 1/det; an inverse that is not
    finite becomes 0."""
    v00, v01, v02 = V[:, 0, 0], V[:, 0, 1], V[:, 0, 2]
    v11, v12, v22 = V[:, 1, 1], V[:, 1, 2], V[:, 2, 2]
    v00 = v00 + lam * torch.abs(v00) + lam * 1e-6
    v11 = v11 + lam * torch.abs(v11) + lam * 1e-6
    v22 = v22 + lam * torch.abs(v22) + lam * 1e-6
    A = v11 * v22 - v12 * v12
    B = v02 * v12 - v01 * v22
    Cc = v01 * v12 - v02 * v11
    E = v00 * v22 - v02 * v02
    F = v01 * v02 - v00 * v12
    I = v00 * v11 - v01 * v01
    det = v00 * A + v01 * B + v02 * Cc
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    inv_det = point_mask.to(V.dtype) / det
    inv = torch.stack([A, B, Cc, B, E, F, Cc, F, I], dim=-1) * inv_det[:, None]
    ok = torch.isfinite(inv).all(dim=-1, keepdim=True)
    return torch.where(ok, inv, torch.zeros_like(inv)).reshape(-1, 3, 3)


def _gauss_jordan(S, b):
    """Solve S x = b by Gauss-Jordan without pivoting (S is damped SPD),
    pivots below 1e-20 in magnitude clamped to 1e-20."""
    n = S.shape[0]
    M = torch.cat([S, b[:, None]], dim=1)
    for k in range(n):
        piv = M[k, k]
        piv = torch.where(torch.abs(piv) < 1e-20, torch.full_like(piv, 1e-20), piv)
        prow = M[k] * (1.0 / piv)
        factor = M[:, k].clone()
        factor[k] = 0.0
        M = M - factor[:, None] * prow[None, :]
        M[k] = prow
    return M[:, n]


def _solve_step(rv, tv, pts, p: BAProblemGrid, live, onehot, lam, delta, n_fixed):
    """One damped Schur step: (d_rvecs, d_tvecs, d_points)."""
    C = rv.shape[0]
    c_adj = C - n_fixed
    n = 6 * c_adj
    r, Jc, Jp = _slot_terms(rv, tv, pts, p, live, with_jac=True)
    a = torch.abs(r)
    w = torch.where(a <= delta, torch.ones_like(a),
                    delta / torch.clamp(a, min=1e-12)) * p.mask[..., None]
    Jc_w = Jc * w[..., None]
    Jp_w = Jp * w[..., None]

    V = torch.einsum("pdki,pdkj->pij", Jp_w, Jp)
    g_p = torch.einsum("pdki,pdk->pi", Jp_w, r)
    U = torch.einsum("pdc,pdki,pdkj->cij", onehot, Jc_w, Jc)
    g_c = torch.einsum("pdc,pdki,pdk->ci", onehot, Jc_w, r)
    Y = torch.einsum("pdki,pdkj->pdij", Jc_w, Jp)
    B = torch.einsum("pdc,pdij->pcij", onehot, Y)            # (P, C', 6, 3)

    Vinv = _inv3_damped(V, lam, p.point_mask)
    z_p = torch.einsum("pij,pj->pi", Vinv, g_p)
    BV = torch.einsum("pcik,pkl->pcil", B, Vinv)
    S = -torch.einsum("pcil,pdjl->cidj", BV, B).reshape(n, n)
    idx = torch.arange(c_adj, device=U.device)
    Ublock = torch.zeros((c_adj, 6, c_adj, 6), dtype=U.dtype, device=U.device)
    Ublock[idx, :, idx, :] = U
    S_u = Ublock.reshape(n, n)
    diag = torch.diagonal(S_u)
    S = S + S_u + torch.diag(lam * torch.abs(diag) + lam * 1e-6 + 1e-8)
    b = (-g_c + torch.einsum("pcij,pj->ci", B, z_p)).reshape(n)

    dc = _gauss_jordan(S, b).reshape(c_adj, 6)
    Wt_dc = torch.einsum("pcij,ci->pj", B, dc)
    dp = torch.einsum("pij,pj->pi", Vinv, -g_p - Wt_dc)
    d_r = torch.zeros_like(rv)
    d_t = torch.zeros_like(tv)
    d_r[n_fixed:] = dc[:, :3]
    d_t[n_fixed:] = dc[:, 3:]
    return d_r, d_t, dp


def lm_solve_plain(
    grid: BAProblemGrid,
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
):
    """The plain PyTorch version of the kernel, in float32 (in float64 for
    float64 inputs: a reference for the float32 versions' rounding).
    Returns (rvecs, tvecs, points, BAStats), as
    ``ba_grid.ba_solve_grid_impl``."""
    C = grid.rvecs.shape[0]
    if not 1 <= C - n_fixed:
        raise ValueError(f"no adjustable camera: C={C}, n_fixed={n_fixed}")
    f32 = torch.float64 if grid.rvecs.dtype == torch.float64 else torch.float32
    p = grid._replace(rvecs=grid.rvecs.to(f32), tvecs=grid.tvecs.to(f32),
                      points=grid.points.to(f32), uv=grid.uv.to(f32),
                      mask=grid.mask.to(f32), K=grid.K.to(f32))
    live = (p.mask > 0).to(f32)
    onehot = ((p.cam_slot.long()[..., None] - n_fixed
               == torch.arange(C - n_fixed, device=p.uv.device)).to(f32)
              * live[..., None])

    def residuals(rv, tv, pt):
        return _slot_terms(rv, tv, pt, p, live, with_jac=False)[0]

    def cost_at(rv, tv, pt):
        return ba_flat.robust_cost(residuals(rv, tv, pt), huber_delta)

    def sq_at(rv, tv, pt):
        r = residuals(rv, tv, pt)
        return torch.sum(r * r)

    def step(rv, tv, pt, lam):
        return _solve_step(rv, tv, pt, p, live, onehot, lam, huber_delta, n_fixed)

    return ba_flat.lm_loop(
        step, cost_at, sq_at, p.rvecs, p.tvecs, p.points,
        max_iterations=max_iterations, lambda_init=lambda_init,
        lambda_up=lambda_up, lambda_down=lambda_down, lambda_min=lambda_min,
        lambda_max=lambda_max, ftol=ftol, xtol=xtol)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_FIELDS = (("rvecs", torch.float32), ("tvecs", torch.float32),
           ("points", torch.float32), ("cam_slot", torch.int32),
           ("uv", torch.float32), ("mask", torch.float32),
           ("point_mask", torch.bool), ("K", torch.float32))


def _check(grid: BAProblemGrid, n_fixed: int):
    """Shapes, dtypes, one device and the gate; raises ``ValueError``."""
    C = grid.rvecs.shape[0]
    P, D = grid.cam_slot.shape
    shapes = dict(rvecs=(C, 3), tvecs=(C, 3), points=(P, 3), cam_slot=(P, D),
                  uv=(P, D, 2), mask=(P, D), point_mask=(P,), K=(3, 3))
    for name, dtype in _FIELDS:
        t = getattr(grid, name)
        if tuple(t.shape) != shapes[name] or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shapes[name]} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    devs = {getattr(grid, name).device for name, _ in _FIELDS}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    if not eligible_shape(C, P, D, n_fixed):
        raise ValueError(f"window of C={C}, P={P}, D={D}, n_fixed={n_fixed} is "
                         "outside the kernel's gate (eligible_shape)")
    return C, P, D


def launch(grid: BAProblemGrid, n_fixed: int, max_iterations: int,
           huber_delta: float, lambda_init: float, lambda_up: float,
           lambda_down: float, lambda_min: float, lambda_max: float,
           ftol: float, xtol: float):
    """Launch the kernel, one thread-block cluster, on a checked CUDA
    window.  Returns (rvecs, tvecs, points, stats) with the kernel's eight
    float32 stats lanes: initial cost, final cost, initial and final squared
    cost, iterations, accepted, the last lambda, 0."""
    C, P, D = _check(grid, n_fixed)
    dev = grid.rvecs.device
    g = BAProblemGrid(*(t.contiguous() for t in grid))
    rv = torch.empty((C, 3), dtype=torch.float32, device=dev)
    tv = torch.empty((C, 3), dtype=torch.float32, device=dev)
    pts = torch.empty((P, 3), dtype=torch.float32, device=dev)
    stats = torch.empty(8, dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_floats(C, P, n_fixed), dtype=torch.float32, device=dev)
    fn = kernels.library_fn(NAME)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(g.rvecs.data_ptr(), g.tvecs.data_ptr(), g.points.data_ptr(),
             g.cam_slot.data_ptr(), g.uv.data_ptr(), g.mask.data_ptr(),
             g.point_mask.data_ptr(), g.K.data_ptr(), C, P, D, int(n_fixed),
             int(max_iterations), float(huber_delta), float(lambda_init),
             float(lambda_up), float(lambda_down), float(lambda_min),
             float(lambda_max), float(ftol), float(xtol),
             rv.data_ptr(), tv.data_ptr(), pts.data_ptr(), stats.data_ptr(),
             scratch.data_ptr(), stream)
    kernels.check(NAME, err)
    kernels.count_launch(NAME)
    return rv, tv, pts, stats


def lm_solve(
    grid: BAProblemGrid,
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
):
    """The whole LM solve of one BA window.  CUDA tensors launch the kernel;
    CPU tensors take ``lm_solve_plain``; any other device raises.  Returns
    (rvecs, tvecs, points, BAStats), as ``ba_grid.ba_solve_grid_impl``."""
    opts = dict(max_iterations=max_iterations, huber_delta=huber_delta,
                lambda_init=lambda_init, lambda_up=lambda_up,
                lambda_down=lambda_down, lambda_min=lambda_min,
                lambda_max=lambda_max, ftol=ftol, xtol=xtol)
    kind = grid.rvecs.device.type
    if kind == "cpu":
        return lm_solve_plain(grid, n_fixed, **opts)
    if kind != "cuda":
        raise ValueError(f"unsupported device {grid.rvecs.device}")
    grid = grid._replace(mask=grid.mask.to(torch.float32),
                         cam_slot=grid.cam_slot.to(torch.int32))
    rv, tv, pts, s = launch(grid, n_fixed, **opts)
    stats = ba_flat.BAStats(
        initial_cost=s[0], final_cost=s[1], initial_sq=s[2], final_sq=s[3],
        iterations=s[4].to(torch.int32), accepted=s[5] > 0.5)
    return rv, tv, pts, stats
