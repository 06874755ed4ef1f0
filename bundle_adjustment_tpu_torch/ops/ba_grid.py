"""Dense observation-grid bundle adjustment (port of
``bundle_adjustment_tpu.ops.ba_grid``): each map point owns D observation
slots, so every reduction is a masked einsum over the (P, D) grid.  Same LM
semantics as ``ops/ba.py`` (the shared ``lm_loop``).

Ported: the dense camera-system step (``_solve_step``), which every window
solve of at most ``pcg_min_cameras`` cameras runs when the window LM kernel
(``ops/ba_kernel.py``) is switched off or does not admit its shape.  The
matrix-free
PCG step (``_solve_step_pcg``, ``_group_precond_rows``) comes with the
global-BA kernels (K4); ``cg_iters > 0`` raises ``NotImplementedError``.
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
    """LM on the grid layout with the dense camera solve.  Returns
    (rvecs, tvecs, points, BAStats)."""
    if cg_iters > 0:
        raise NotImplementedError(
            "the grid PCG step (_solve_step_pcg) comes with the global-BA "
            "kernels (K4), not ported yet")
    p = problem._replace(mask=problem.mask.to(problem.uv.dtype))
    C = p.rvecs.shape[0]
    C_adj = max(C - n_fixed, 1)
    onehot = (p.cam_slot.long()[..., None] - n_fixed
              == torch.arange(C_adj, device=p.uv.device)).to(p.uv.dtype)

    def residuals(rv, tv, pt):
        return _grid_terms(rv, tv, pt, p, with_jac=False)[0]

    def cost_at(rv, tv, pt):
        return ba_flat.robust_cost(residuals(rv, tv, pt), huber_delta)

    def sq_at(rv, tv, pt):
        r = residuals(rv, tv, pt)
        return torch.sum(r * r)

    def step(rv, tv, pt, lam):
        return _solve_step(rv, tv, pt, p, lam, huber_delta, n_fixed, onehot)

    return ba_flat.lm_loop(
        step, cost_at, sq_at, p.rvecs, p.tvecs, p.points,
        max_iterations=max_iterations, lambda_init=lambda_init,
        lambda_up=lambda_up, lambda_down=lambda_down, lambda_min=lambda_min,
        lambda_max=lambda_max, ftol=ftol, xtol=xtol)


ba_solve_grid = ba_solve_grid_impl
