"""Windowed bundle adjustment on the flat observation table: Schur-complement
Levenberg-Marquardt (port of ``bundle_adjustment_tpu.ops.ba``).

Same problem layout (BAProblem), Huber IRLS weights, Marquardt damping,
closed-form 3x3 point elimination, dense reduced camera system, LM
accept/reject with ftol/xtol.  ``segment_sum`` becomes a sum in a fixed
order on either device (``_segment_sum``).  The LM loop is a Python loop that
reads its stop flag once per iteration, or, with ``masked`` (the pose
refine), runs to its cap with its updates masked after the stop and reads
nothing on the host; the matrix-free PCG camera solve
(``_pcg_blocked``, ``cg_iters > 0``) runs to its iteration cap with its
updates masked once the residual test holds, as the reference's
``while_loop`` stops, and reads nothing on the host.

The point-sharded solve (``parallel/dist_ba``) passes a process group in
place of the reference's ``axis_name``: each rank holds a shard of the
points and their observations, the cameras are replicated, and every
quantity the reference psums (the camera blocks and gradient, the reduced
system or its matvec, the costs and the point terms of the step norms) is
summed over the group by ``all_reduce``, so every rank takes the same LM
decisions.  With ``group=None`` nothing is reduced and the solve is the
single-rank one, bit for bit.  The collectives run eagerly: a CUDA graph
cannot capture one of gloo's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from bundle_adjustment_tpu_torch.ops.lie import so3_exp, so3_exp_and_jac


class BAProblem(NamedTuple):
    """Static-shape windowed BA problem: C cameras (first ``n_fixed``
    gauge-fixed), P points, O observations, all padded."""

    rvecs: torch.Tensor     # (C, 3)
    tvecs: torch.Tensor     # (C, 3)
    points: torch.Tensor    # (P, 3)
    cam_idx: torch.Tensor   # (O,) int in [0, C)
    pnt_idx: torch.Tensor   # (O,) int in [0, P)
    uv: torch.Tensor        # (O, 2)
    obs_mask: torch.Tensor  # (O,) f32 or bool
    point_mask: torch.Tensor  # (P,) bool
    K: torch.Tensor         # (3, 3)


#: the test that ended an LM loop, by its code in ``BAStats.stop``: 0 the
#: iteration cap, 1 ``ftol`` (an accepted step that lowered the cost by at
#: most ftol of it), 2 ``xtol`` (an accepted step shorter than xtol of the
#: parameters' norm, ftol not met), 3 ``stuck`` (a rejected step at
#: lambda_max)
STOP_TESTS = ("cap", "ftol", "xtol", "stuck")


class BAStats(NamedTuple):
    initial_cost: torch.Tensor   # robust (Huber) cost, 0.5*sum(rho)
    final_cost: torch.Tensor
    initial_sq: torch.Tensor     # raw sum of squared residuals
    final_sq: torch.Tensor
    iterations: torch.Tensor
    accepted: torch.Tensor
    #: int32 code of ``STOP_TESTS`` (the window LM kernel writes it into
    #: its stats lane 7); None from a solver that does not record it
    stop: Optional[torch.Tensor] = None


def stop_code(accept, ftol_met, xtol_met, stuck):
    """The ``STOP_TESTS`` code of one LM iteration's tests, int32 (0: none
    held), with no host read."""
    f = accept & ftol_met
    x = accept & xtol_met & ~f
    return f.to(torch.int32) + 2 * x.to(torch.int32) + 3 * stuck.to(torch.int32)


def _segment_sum(x, idx, n):
    """Sum the rows of x by segment id, in table order on either device.  On
    the card ``index_put_`` with ``accumulate`` does that (it sorts by index,
    stably), where ``index_add_`` uses float atomics, whose order, and so the
    sum's last bits, changes from run to run.  On the CPU it is the other way
    round: ``index_put_`` splits the rows over the torch threads and adds in
    another order on each run, where ``index_add_`` adds the rows in table
    order whatever the thread count (and is the faster of the two, and of a
    stable sort with ``segment_reduce``, at the tests' sizes)."""
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        return out.index_add_(0, idx.long(), x)
    return out.index_put_((idx.long(),), x, accumulate=True)


def _psum(x, group):
    """``x`` summed over the ranks of ``group`` (``x`` itself for None);
    ``x`` is a temporary that the reduction overwrites."""
    if group is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _residuals(rvecs, tvecs, points, p: BAProblem):
    """(O, 2) reprojection residuals, masked."""
    Rs = so3_exp(rvecs)
    ci = p.cam_idx.long()
    X = points[p.pnt_idx.long()]
    Xc = torch.einsum("oij,oj->oi", Rs[ci], X) + tvecs[ci]
    z = Xc[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = p.K[0, 0] * Xc[:, 0] / z_safe + p.K[0, 2]
    v = p.K[1, 1] * Xc[:, 1] / z_safe + p.K[1, 2]
    r = torch.stack([u, v], dim=1) - p.uv
    return r * p.obs_mask[:, None]


def _huber_weights(r, delta):
    """Per-component IRLS weights for scipy's loss='huber'."""
    a = torch.abs(r)
    return torch.where(a <= delta, torch.ones_like(a), delta / torch.clamp(a, min=1e-12))


def robust_cost(r, delta):
    """0.5 * sum(rho(r)) with Huber rho."""
    a = torch.abs(r)
    quad = r * r
    lin = 2.0 * delta * a - delta * delta
    return 0.5 * torch.sum(torch.where(a <= delta, quad, lin))


def _duv_dxc(Xc, K):
    """(.., 2, 3) pinhole projection Jacobian and the safe 1/z."""
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z = 1.0 / z_safe
    fx, fy = K[0, 0], K[1, 1]
    zeros = torch.zeros_like(inv_z)
    return torch.stack(
        [
            torch.stack([fx * inv_z, zeros, -fx * Xc[..., 0] * inv_z * inv_z], dim=-1),
            torch.stack([zeros, fy * inv_z, -fy * Xc[..., 1] * inv_z * inv_z], dim=-1),
        ],
        dim=-2,
    )


def _obs_jacobians(rvecs, tvecs, points, p: BAProblem):
    """Jc (O, 2, 6) wrt (rvec, tvec) and Jp (O, 2, 3) wrt the point; the
    rotation derivative is computed once per camera (analytic, equal to
    jacfwd(so3_exp) to float tolerance)."""
    Rs, dRdr = so3_exp_and_jac(rvecs)
    ci = p.cam_idx.long()
    X = points[p.pnt_idx.long()]
    Rg = Rs[ci]
    Xc = torch.einsum("oij,oj->oi", Rg, X) + tvecs[ci]
    duv_dXc = _duv_dxc(Xc, p.K)
    J_X = torch.einsum("oki,oij->okj", duv_dXc, Rg)
    dXc_dr = torch.einsum("oijr,oj->oir", dRdr[ci], X)
    J_r = torch.einsum("oki,oir->okr", duv_dXc, dXc_dr)
    return torch.cat([J_r, duv_dXc], dim=2), J_X


def _inv3(M):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [torch.stack([A, B, Cc], dim=-1), torch.stack([D, E, F], dim=-1),
         torch.stack([G, H, I], dim=-1)], dim=-2)
    inv = adj / det[..., None, None]
    # A point within a hair of a camera centre has a V block near 1e13 whose
    # determinant overflows float32.  Evaluated op by op, as here, det is
    # then inf - inf = NaN and one NaN poisons the whole camera solve; the
    # JAX package's jitted solve contracts the sum into FMAs, gets det = inf
    # and an inverse of 0, which freezes that point for the step.  Do the
    # same explicitly.
    ok = torch.isfinite(inv).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], inv, torch.zeros_like(inv))


def _damp(M, lam):
    """M + lam * (|diag(M)| + 1e-6 I), batched over leading dims."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    diag = torch.abs(torch.diagonal(M, dim1=-2, dim2=-1))
    return M + lam * (torch.diag_embed(diag) + 1e-6 * eye)


def _pcg_blocked(matvec, b, Minv, iters, tol, live=None):
    """Preconditioned conjugate gradient on the reduced camera system,
    matrix-free.  ``b`` and the state are (C_adj, 6) block vectors; ``Minv``
    is the (C_adj, 6, 6) block-Jacobi preconditioner or a callable
    r -> M^-1 r (grouped preconditioners, ``ops/ba_grid``).  Stops at
    ``iters`` or a relative residual ``tol`` (a float or a 0-d tensor),
    whichever comes first, as the reference's ``while_loop`` does, done from
    the start when b = 0.  The stop is a device flag: the loop always runs
    ``iters`` iterations and keeps the state of the last live one, so ``x``
    has the bits of a loop that leaves at the stop, and nothing is read on
    the host.  ``live``, a 0-d integer tensor, has the number of live
    iterations added to it."""
    if callable(Minv):
        apply_precond = Minv
    else:
        def apply_precond(r):
            return torch.sum(Minv * r[:, None, :], dim=-1)
    bnorm = torch.sqrt(torch.sum(b * b))
    x = torch.zeros_like(b)
    r = b
    p = apply_precond(r)
    rz = torch.sum(r * p)
    floor = torch.full_like(rz, 1e-30)
    stop = tol * torch.clamp(bnorm, min=1e-30)
    done = bnorm <= 0.0
    for _ in range(iters):
        if live is not None:
            live += (~done).to(live.dtype)
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-30, floor, pAp)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = apply_precond(r_new)
        rz_new = torch.sum(r_new * z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-30, floor, rz)
        p_new = z + beta * p
        x = torch.where(done, x, x_new)
        r = torch.where(done, r, r_new)
        p = torch.where(done, p, p_new)
        rz = torch.where(done, rz, rz_new)
        done = done | (torch.sqrt(torch.sum(r * r)) <= stop)
    return x


def _solve_normal_equations(rvecs, tvecs, points, p: BAProblem, lam, delta, n_fixed,
                            cg_iters: int = 0, cg_tol: float = 1e-6, group=None):
    """One damped Schur step: returns (d_rvecs, d_tvecs, d_points).

    With ``group`` the points and observations are this rank's shard and the
    cameras replicated: the point blocks stay local and only the camera
    system (U, g_c, W V^-1 g_p, and S or each matvec's W V^-1 W^T x and the
    preconditioner's blocks) is summed over the group.

    ``cg_iters`` = 0 solves the reduced camera system densely (the
    (P, C_adj, 6, 3) coupling tensor and a (6C')^2 matrix: right for
    windows).  ``cg_iters`` > 0 solves it by matrix-free block-Jacobi PCG:
    S x = U x - W V^-1 W^T x through two gathers and two segment sums per
    iteration, so neither S nor the coupling tensor exists and memory stays
    O(observations) whatever the camera count."""
    C = rvecs.shape[0]
    P = points.shape[0]
    C_adj = C - n_fixed
    nC = max(C_adj, 1)
    n = nC * 6

    r = _residuals(rvecs, tvecs, points, p)
    w = _huber_weights(r, delta) * p.obs_mask[:, None]
    Jc, Jp = _obs_jacobians(rvecs, tvecs, points, p)

    cam_adj = p.cam_idx.long() - n_fixed
    cam_ok = (cam_adj >= 0)[:, None, None]
    cam_adj_c = torch.clamp(cam_adj, 0, max(C_adj - 1, 0))
    pi = p.pnt_idx.long()
    Jc = torch.where(cam_ok, Jc, torch.zeros_like(Jc))

    Jc_w = Jc * w[:, :, None]
    Jp_w = Jp * w[:, :, None]

    U_o = torch.einsum("oki,okj->oij", Jc_w, Jc)
    V_o = torch.einsum("oki,okj->oij", Jp_w, Jp)
    Y_o = torch.einsum("oki,okj->oij", Jc_w, Jp)
    gc_o = torch.einsum("oki,ok->oi", Jc_w, r)
    gp_o = torch.einsum("oki,ok->oi", Jp_w, r)

    U = _damp(_psum(_segment_sum(U_o, cam_adj_c, nC), group), lam)
    V = _damp(_segment_sum(V_o, pi, P), lam)
    g_c = _psum(_segment_sum(gc_o, cam_adj_c, nC), group)
    g_p = _segment_sum(gp_o, pi, P)
    Vinv = _inv3(V)
    Vinv = torch.where(p.point_mask[:, None, None], Vinv, torch.zeros_like(Vinv))

    z_p = torch.einsum("pij,pj->pi", Vinv, g_p)
    Wz_o = torch.einsum("oij,oj->oi", Y_o, z_p[pi])
    b_blocks = -g_c + _psum(_segment_sum(Wz_o, cam_adj_c, nC), group)

    if cg_iters > 0:
        # Y_o rows of gauge-fixed cameras are zero (Jc was masked), so the
        # clamped index adds nothing for them
        def matvec(x):
            y_o = torch.einsum("oij,oi->oj", Y_o, x[cam_adj_c])
            z = torch.einsum("pij,pj->pi", Vinv, _segment_sum(y_o, pi, P))
            w_o = torch.einsum("oij,oj->oi", Y_o, z[pi])
            return torch.einsum("cij,cj->ci", U, x) - _psum(_segment_sum(w_o, cam_adj_c, nC),
                                                            group)

        # block-Jacobi preconditioner: the exact 6x6 diagonal blocks of S (a
        # camera sees a point through at most one observation)
        D_o = torch.einsum("oij,ojk,olk->oil", Y_o, Vinv[pi], Y_o)
        eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
        Minv = torch.linalg.inv_ex(U - _psum(_segment_sum(D_o, cam_adj_c, nC), group)
                                   + 1e-8 * eye6)[0]
        dc_blocks = _pcg_blocked(matvec, b_blocks, Minv, cg_iters, cg_tol)
    else:
        # dense Schur complement S = blockdiag(U) - W V^-1 W^T
        B = torch.zeros((P, nC, 6, 3), dtype=U.dtype, device=U.device)
        B.index_put_((pi, cam_adj_c), Y_o * cam_ok.to(U.dtype), accumulate=True)
        BV = torch.einsum("pcik,pkl->pcil", B, Vinv)
        S = -_psum(torch.einsum("pcil,pdjl->cidj", BV, B), group).reshape(n, n)
        idx = torch.arange(nC, device=U.device)
        Ublock = torch.zeros((nC, 6, nC, 6), dtype=U.dtype, device=U.device)
        Ublock[idx, :, idx, :] = U
        S = S + Ublock.reshape(n, n)
        eye = torch.eye(n, dtype=S.dtype, device=S.device)
        dc = torch.linalg.solve_ex(S + 1e-8 * eye, b_blocks.reshape(n))[0]
        dc_blocks = dc.reshape(nC, 6)

    Wt_dc_o = torch.einsum("oij,oi->oj", Y_o, dc_blocks[cam_adj_c])
    Wt_dc = _segment_sum(Wt_dc_o, pi, P)
    dp = torch.einsum("pij,pj->pi", Vinv, -g_p - Wt_dc)

    d_r = torch.zeros_like(rvecs)
    d_t = torch.zeros_like(tvecs)
    d_r[n_fixed:] = dc_blocks[:C_adj, :3]
    d_t[n_fixed:] = dc_blocks[:C_adj, 3:]
    return d_r, d_t, dp


def next_lambda(lam, accept, lambda_up, lambda_down, lambda_min, lambda_max):
    """The LM damping after an iteration (tensors): ``lambda_down`` times it
    where the step was accepted, at least ``lambda_min``; else
    ``lambda_up`` times it, at most ``lambda_max``."""
    return torch.where(accept, torch.clamp(lam * lambda_down, min=lambda_min),
                       torch.clamp(lam * lambda_up, max=lambda_max))


def _lm_iteration(step, cost_at, rv, tv, pt, lam, cost, b0, blast, *, lambda_up,
                  lambda_down, lambda_min, lambda_max, ftol, xtol, cg_tol, cg_forcing,
                  group=None):
    """One LM iteration of ``lm_loop``: the step, the trial cost,
    accept/reject, lambda and the stop test.  Returns the new (rv, tv, pt,
    lam, cost, b0, blast) and the ``stop_code`` of the test that held (0
    while the loop goes on), all tensors.
    With ``group`` the points are this rank's shard: their terms of the step
    and parameter norms are summed over it (the cameras are replicated)."""
    if cg_tol is None:
        d_r, d_t, d_p = step(rv, tv, pt, lam)
    else:
        if cg_forcing:
            loose = torch.full_like(b0, 0.1)
            tol = torch.where(
                b0 > 0.0,
                torch.clamp(torch.sqrt(blast / torch.clamp(b0, min=1e-30)),
                            min=cg_tol, max=0.1),
                loose)
        else:
            tol = torch.full_like(b0, cg_tol)
        d_r, d_t, d_p, bnorm = step(rv, tv, pt, lam, tol)
        b0 = torch.where(b0 > 0.0, b0, bnorm)
        blast = bnorm
    rv2, tv2, pt2 = rv + d_r, tv + d_t, pt + d_p
    new_cost = cost_at(rv2, tv2, pt2)
    accept = new_cost < cost
    step_norm = torch.sqrt(torch.sum(d_r * d_r) + torch.sum(d_t * d_t)
                           + _psum(torch.sum(d_p * d_p), group))
    param_norm = torch.sqrt(torch.sum(rv * rv) + torch.sum(tv * tv)
                            + _psum(torch.sum(pt * pt), group))
    ftol_met = (cost - new_cost) <= ftol * torch.clamp(cost, min=1e-12)
    xtol_met = step_norm <= xtol * (param_norm + xtol)
    rv = torch.where(accept, rv2, rv)
    tv = torch.where(accept, tv2, tv)
    pt = torch.where(accept, pt2, pt)
    cost = torch.where(accept, new_cost, cost)
    lam = next_lambda(lam, accept, lambda_up, lambda_down, lambda_min, lambda_max)
    stuck = (~accept) & (lam >= lambda_max)
    return (rv, tv, pt, lam, cost, b0, blast), stop_code(accept, ftol_met, xtol_met, stuck)


def lm_loop(step, cost_at, sq_at, rv, tv, pt, *, max_iterations, lambda_init,
            lambda_up, lambda_down, lambda_min, lambda_max, ftol, xtol,
            cg_tol=None, cg_forcing: bool = False, masked: bool = False, group=None):
    """The LM accept/reject loop shared by the flat and grid solvers (the
    global-BA kernels' solve runs the same iteration as a device body,
    ``ba_global_kernel.GlobalLM``).  ``step(rv, tv, pt, lam) -> (d_r, d_t,
    d_p)``.  Returns (rv, tv, pt, BAStats).

    With ``cg_tol`` set the step solves its camera system by PCG and the loop
    hands it the tolerance: ``step(rv, tv, pt, lam, tol) -> (d_r, d_t, d_p,
    bnorm)`` with ``bnorm`` the norm of the step's right-hand side.  With
    ``cg_forcing`` the tolerance follows an Eisenstat-Walker sequence,
    tol_k = clip(sqrt(|b_k-1| / |b_0|), cg_tol, 0.1), and 0.1 in the first
    iteration: early LM iterations solve loosely, later ones tighter, and
    accept/reject guards the inexact steps.  Without it every step gets
    ``cg_tol``.

    The loop leaves at the stop test (converged or stuck), which it reads on
    the host once per iteration; ``BAStats.stop`` says which test it was
    (``STOP_TESTS``: the cap when none held).  With ``masked`` it reads
    nothing on the host, as the reference's ``while_loop`` on the device: it
    runs
    ``max_iterations`` iterations and keeps the state of the last live one
    (each later iteration's updates are masked by the device flag), so the
    result has the bits of the loop that leaves, and ``iterations`` (a
    device tensor then) counts the live iterations alone.  ``group``: the
    point-sharded solve's process group (``_lm_iteration``); ``cost_at`` and
    ``sq_at`` then return sums over it."""
    opts = dict(lambda_up=lambda_up, lambda_down=lambda_down, lambda_min=lambda_min,
                lambda_max=lambda_max, ftol=ftol, xtol=xtol, cg_tol=cg_tol,
                cg_forcing=cg_forcing, group=group)
    init_cost = cost_at(rv, tv, pt)
    init_sq = sq_at(rv, tv, pt)
    lam = torch.full((), lambda_init, dtype=rv.dtype, device=rv.device)
    b0 = blast = torch.full((), -1.0, dtype=rv.dtype, device=rv.device)
    state = (rv, tv, pt, lam, init_cost, b0, blast)
    stop = torch.zeros((), dtype=torch.int32, device=rv.device)
    if masked:
        iterations = torch.zeros((), dtype=torch.int32, device=rv.device)
        for _ in range(max_iterations):
            new, code = _lm_iteration(step, cost_at, *state, **opts)
            done = stop > 0
            state = tuple(torch.where(done, a, b) for a, b in zip(state, new))
            iterations = iterations + (~done).to(torch.int32)
            stop = torch.where(done, stop, code)
    else:
        it = 0
        while it < max_iterations:
            state, stop = _lm_iteration(step, cost_at, *state, **opts)
            it += 1
            if bool(stop):
                break
        iterations = torch.tensor(it, dtype=torch.int32)
    rv, tv, pt, _, cost = state[:5]
    stats = BAStats(
        initial_cost=init_cost, final_cost=cost, initial_sq=init_sq,
        final_sq=sq_at(rv, tv, pt), iterations=iterations,
        accepted=cost < init_cost, stop=stop,
    )
    return rv, tv, pt, stats


def ba_solve_impl(
    problem: BAProblem,
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
    group=None,
    cg_iters: int = 0,
    cg_tol: float = 1e-6,
    masked: bool = False,
):
    """Levenberg-Marquardt with Schur elimination on the flat table.
    Returns (rvecs, tvecs, points, BAStats); the caller applies the
    divergence-discard rule.  ``cg_iters`` > 0 solves the reduced camera
    system by matrix-free block-Jacobi PCG to the fixed tolerance ``cg_tol``
    (global BA over long keyframe chains).  ``masked``: the LM loop that
    reads nothing on the host (``lm_loop``), as the pose refine runs it.
    ``group``: a process group over which the points and observations are
    sharded (``parallel/dist_ba.ba_solve_sharded``; the reference's
    ``axis_name``): every cost and camera-system sum is reduced over it, so
    each rank returns the same cameras and its own shard's points."""
    p = problem._replace(obs_mask=problem.obs_mask.to(problem.uv.dtype))

    def cost_at(rv, tv, pt):
        return _psum(robust_cost(_residuals(rv, tv, pt, p), huber_delta), group)

    def sq_at(rv, tv, pt):
        r = _residuals(rv, tv, pt, p)
        return _psum(torch.sum(r * r), group)

    def step(rv, tv, pt, lam):
        return _solve_normal_equations(rv, tv, pt, p, lam, huber_delta, n_fixed,
                                       cg_iters=cg_iters, cg_tol=cg_tol, group=group)

    return lm_loop(step, cost_at, sq_at, p.rvecs, p.tvecs, p.points,
                   max_iterations=max_iterations, lambda_init=lambda_init,
                   lambda_up=lambda_up, lambda_down=lambda_down,
                   lambda_min=lambda_min, lambda_max=lambda_max, ftol=ftol,
                   xtol=xtol, masked=masked, group=group)


ba_solve = ba_solve_impl
