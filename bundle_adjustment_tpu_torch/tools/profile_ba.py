"""Per-stage breakdown of bundle adjustment's LM iteration: the counterpart
of the JAX package's ``tools/profile_ba.py``, with its JSON keys (metrics
``ba_lm_iteration_breakdown`` and ``ba_global_pcg_breakdown``; ``stage_us``,
``stage_flops``, ``stage_bytes``).

(a) The window grid solver (``ops/ba_grid._solve_step``) by stage, as the
JAX tool splits it: terms (residuals and Jacobians), assemble (Huber
weights, U, g_c, V, g_p, Y, B), schur (damping, V^-1, S, b), solve (the
dense camera system), backsub (the points' step), cost (the trial cost),
and one whole LM iteration.  Each stage's function runs on the stage's own
inputs: ``stage_us`` by CUDA events over back-to-back calls (median of
trials), ``stage_device_us`` the device time of its kernels under
``torch.profiler``; ``stage_flops`` as ``torch.utils.flop_counter`` counts
them (the matrix products and einsums), ``stage_bytes`` its inputs and
outputs once each.

(b) ``--global-pcg``: the global solve through K4 (``ops/ba_global_kernel``)
on the JAX tool's global problem (C = 200, P = 30,000, 4 slots): each role's
ms per launch (CUDA events), its launches per LM iteration counted by
``kernels.LAUNCHES`` over a solve of fixed length, the LM iteration's fixed
part (setup, backsub, cost) and one CG iteration (matvec), beside the
replayed LM iteration's ms.

(c) K3 by phase (on the card, with (a)).  K3 is one launch, which no
profiler splits: a second build of ``csrc/ba_window_lm.cu`` under
``BA_WINDOW_PHASE_CLOCKS`` (``ops/ba_kernel.CLOCKS``) stamps ``clock64()``
at each phase boundary of each LM iteration (``ops/ba_kernel.PHASES``).
At the main path's window (C = 5, n_fixed = 2, P = 8192, D = 5) and the
widest K3 takes (C = 10, P = 53,430): the two builds' outputs compared bit
for bit, each phase's ms summed over the solve's LM iterations, and the
stamps' span against the launch's device time (launches queued back to
back, CUDA events; one launch's event time beside it).

    python -m bundle_adjustment_tpu_torch.tools.profile_ba
    python -m bundle_adjustment_tpu_torch.tools.profile_ba --global-pcg
    python -m bundle_adjustment_tpu_torch.tools.profile_ba --device cpu --points 256

On the CPU the stages' times are host times (``time`` says which), K4's
roles are their plain versions, and (c) does not run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

#: the window LM solve's settings (``config.BAConfig``'s defaults)
LM_OPTS = dict(max_iterations=50, huber_delta=1.0, lambda_init=1e-3, lambda_up=4.0,
               lambda_down=0.5, lambda_min=1e-10, lambda_max=1e8, ftol=1e-5, xtol=1e-5)
#: K3's shapes for (c): (name, C, n_fixed, live points, P, D)
K3_SHAPES = (("main", 5, 2, 6000, 8192, 5), ("widest", 10, 2, 50000, 53430, 5))


def _timer(torch, on_card: bool):
    """ms per call of ``fn``: CUDA events over ``reps`` back-to-back calls on
    the card, the host clock on the CPU; median of ``trials`` after a
    warm-up."""
    def ms(fn, reps: int = 10, trials: int = 5) -> float:
        fn()
        out = []
        for _ in range(trials):
            if on_card:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(reps):
                    fn()
                b.record()
                b.synchronize()
                out.append(a.elapsed_time(b) / reps)
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                out.append((time.perf_counter() - t0) * 1e3 / reps)
        return statistics.median(out)
    return ms


def _device_us(torch, fns: dict, reps: int = 5) -> dict:
    """Each of ``fns`` ``reps`` times under the profiler, each call in a
    range of its name: the device time of its kernels per call (us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in fns.items():
            for _ in range(reps):
                with record_function("stage:" + name):
                    fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("stage:"):
            k = e.name[len("stage:"):]
            out[k] = out.get(k, 0.0) + e.device_time_total / reps
    return out


def _work(torch, fn, args) -> tuple:
    """(flops as ``FlopCounterMode`` counts them, bytes of the inputs and the
    outputs) of one call of ``fn(*args)``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        out = fn(*args)

    def nbytes(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, (tuple, list)):
            return sum(nbytes(v) for v in x)
        return 0

    return int(fc.get_total_flops()), nbytes(args) + nbytes(out)


def grid_stages(torch, g, n_fixed: int, on_card: bool) -> dict:
    """(a): the grid solver's LM iteration by stage on the window ``g``."""
    from bundle_adjustment_tpu_torch.ops import ba as ba_flat
    from bundle_adjustment_tpu_torch.ops import ba_grid

    C = g.rvecs.shape[0]
    c_adj = C - n_fixed
    n = 6 * c_adj
    lam = torch.tensor(1e-3, device=g.rvecs.device)
    onehot = ((g.cam_slot.long()[..., None] - n_fixed
               == torch.arange(c_adj, device=g.rvecs.device)).float())

    def terms(pt):
        return ba_grid._grid_terms(g.rvecs, g.tvecs, pt, g)

    def assemble(r, Jc, Jp):
        a = torch.abs(r)
        w = torch.where(a <= 1.0, torch.ones_like(a), 1.0 / torch.clamp(a, min=1e-12)) \
            * g.mask[..., None]
        Jc = Jc * (g.cam_slot >= n_fixed).to(r.dtype)[..., None, None]
        Jc_w, Jp_w = Jc * w[..., None], Jp * w[..., None]
        U = torch.einsum("pdc,pdki,pdkj->cij", onehot, Jc_w, Jc)
        g_c = torch.einsum("pdc,pdki,pdk->ci", onehot, Jc_w, r)
        V = torch.einsum("pdki,pdkj->pij", Jp_w, Jp)
        g_p = torch.einsum("pdki,pdk->pi", Jp_w, r)
        Y = torch.einsum("pdki,pdkj->pdij", Jc_w, Jp)
        B = torch.einsum("pdc,pdij->pcij", onehot, Y)
        return U, g_c, V, g_p, B

    def schur(U, g_c, V, g_p, B):
        U, V = ba_flat._damp(U, lam), ba_flat._damp(V, lam)
        Vinv = ba_flat._inv3(V)
        Vinv = torch.where(g.point_mask[:, None, None], Vinv, torch.zeros_like(Vinv))
        BV = torch.einsum("pcik,pkl->pcil", B, Vinv)
        S = -torch.einsum("pcil,pdjl->cidj", BV, B).reshape(n, n)
        idx = torch.arange(c_adj, device=U.device)
        Ub = torch.zeros((c_adj, 6, c_adj, 6), dtype=U.dtype, device=U.device)
        Ub[idx, :, idx, :] = U
        z_p = torch.einsum("pij,pj->pi", Vinv, g_p)
        b = (-g_c + torch.einsum("pcij,pj->ci", B, z_p)).reshape(n)
        return S + Ub.reshape(n, n), b, Vinv

    def solve(S, b):
        eye = torch.eye(n, dtype=S.dtype, device=S.device)
        return torch.linalg.solve_ex(S + 1e-8 * eye, b)[0]

    def backsub(dc, B, Vinv, g_p):
        Wt = torch.einsum("pcij,ci->pj", B, dc.reshape(c_adj, 6))
        return torch.einsum("pij,pj->pi", Vinv, -g_p - Wt)

    def cost(pt):
        r = ba_grid._grid_terms(g.rvecs, g.tvecs, pt, g, with_jac=False)[0]
        return torch.sum(r * r)

    def full(pt):
        d_r, d_t, d_p = ba_grid._solve_step(g.rvecs, g.tvecs, pt, g, lam, 1.0, n_fixed, onehot)
        r = ba_grid._grid_terms(g.rvecs + d_r, g.tvecs + d_t, pt + d_p, g, with_jac=False)[0]
        return torch.sum(r * r)

    r0, Jc0, Jp0 = terms(g.points)
    U0, gc0, V0, gp0, B0 = assemble(r0, Jc0, Jp0)
    S0, b0, Vinv0 = schur(U0, gc0, V0, gp0, B0)
    dc0 = solve(S0, b0)
    stages = {"terms": (terms, (g.points,)), "assemble": (assemble, (r0, Jc0, Jp0)),
              "schur": (schur, (U0, gc0, V0, gp0, B0)), "solve": (solve, (S0, b0)),
              "backsub": (backsub, (dc0, B0, Vinv0, gp0)), "cost": (cost, (g.points,)),
              "full_lm_iter": (full, (g.points,))}
    ms = _timer(torch, on_card)
    stage_us = {k: round(1e3 * ms(lambda f=f, a=a: f(*a)), 2) for k, (f, a) in stages.items()}
    work = {k: _work(torch, f, a) for k, (f, a) in stages.items()}
    P, D = g.cam_slot.shape
    out = {
        "metric": "ba_lm_iteration_breakdown",
        "problem": f"C={C} n_fixed={n_fixed} P={P} D<={D}",
        "backend": g.rvecs.device.type,
        "time": "CUDA events" if on_card else "host (cpu)",
        "stage_us": stage_us,
        "stage_flops": {k: v[0] for k, v in work.items()},
        "stage_bytes": {k: v[1] for k, v in work.items()},
        "sum_of_stages_us": round(sum(v for k, v in stage_us.items() if k != "full_lm_iter"), 2),
    }
    if on_card:
        dev_us = _device_us(torch, {k: (lambda f=f, a=a: f(*a)) for k, (f, a) in stages.items()})
        out["stage_device_us"] = {k: round(dev_us.get(k, 0.0), 2) for k in stages}
    return out


def k3_phases(torch, ba_kernel, grid_cls, synthetic_window, seed: int,
              launches: int = 10) -> dict:
    """(c): K3's phase-clock build against the shipped one at ``K3_SHAPES``:
    bit-equal outputs, the phases' ms, and the stamps' span beside the
    launch's device time: CUDA events over ``launches`` launches queued
    behind a sleeping kernel, so that the card runs them back to back (an
    event pair around one launch of under a millisecond also holds the
    launch's latency), per launch; one launch's event time beside it."""
    from bundle_adjustment_tpu_torch import kernels

    kernels.build_all([ba_kernel.NAME, ba_kernel.CLOCKS])
    out = {"metric": "ba_window_lm_phase_breakdown", "phases": list(ba_kernel.PHASES),
           "shapes": {}}
    for name, C, n_fixed, n_pts, P, D in K3_SHAPES:
        w = synthetic_window(seed, C=C, n_pts=n_pts, P=P, D=D)
        g = grid_cls(**{k: torch.as_tensor(v, device="cuda") for k, v in w.items()})
        shipped = ba_kernel.launch(g, n_fixed, **LM_OPTS)
        clocked = ba_kernel.launch(g, n_fixed, clocks=True, **LM_OPTS)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(shipped, clocked))
        its = int(shipped[3][4])

        def per_launch_ms(clocks: bool, n: int) -> float:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(20_000_000)
            a.record()
            for _ in range(n):
                ba_kernel.launch(g, n_fixed, clocks=clocks, **LM_OPTS)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / n

        shipped_ms = statistics.median(per_launch_ms(False, launches) for _ in range(3))
        clocked_ms = statistics.median(per_launch_ms(True, launches) for _ in range(3))
        one_ms = statistics.median(per_launch_ms(True, 1) for _ in range(3))
        pc = ba_kernel.phase_clocks(its)
        stamped = pc["before_loop_ms"] + sum(pc["phase_ms"].values()) + pc["after_loop_ms"]
        out["shapes"][name] = dict(
            C=C, n_fixed=n_fixed, P=P, D=D, iterations=its, bit_equal=equal,
            stop=int(shipped[3][7]), launch_device_ms=round(clocked_ms, 4),
            shipped_device_ms=round(shipped_ms, 4), one_launch_event_ms=round(one_ms, 4),
            phase_ms={k: round(v, 4) for k, v in pc["phase_ms"].items()},
            per_iteration_us={k: round(1e3 * v / max(pc["iterations"], 1), 2)
                              for k, v in pc["phase_ms"].items()},
            before_loop_ms=round(pc["before_loop_ms"], 4),
            after_loop_ms=round(pc["after_loop_ms"], 4), stamped_ms=round(stamped, 4),
            stamps_vs_launch_pct=round(100.0 * (stamped - clocked_ms) / clocked_ms, 2),
            clock_ghz=round(pc["cycles_per_ns"], 4))
    return out


def global_pcg(torch, gk, ba, kernels, g, n_fixed: int, on_card: bool) -> dict:
    """(b): K4's roles per launch and per LM iteration on ``g``."""
    from bundle_adjustment_tpu_torch.tools.global_scale_sweep import SWEEP_OPTS, role_times

    roles = (gk.SETUP, gk.MATVEC, gk.BACKSUB, gk.COST)
    before = {r: kernels.LAUNCHES[r] for r in roles}
    stats = gk.solve(g, n_fixed=n_fixed, **SWEEP_OPTS)[3]
    launched = {r: kernels.LAUNCHES[r] - before[r] for r in roles}
    rec = gk.SOLVES[-1]
    its = int(rec["lm_iterations"])
    per_it = {r: round(launched[r] / its, 3) for r in roles}
    P, D = g.cam_slot.shape
    out = {"metric": "ba_global_pcg_breakdown",
           "problem": f"C={g.rvecs.shape[0]} P={P} D<={D}", "backend": g.rvecs.device.type,
           "lm_iterations": its, "cg_iterations": int(rec["cg_iterations"]),
           "stop": ba.STOP_TESTS[int(stats.stop)],
           "launches": launched,
           "launches_per_lm_iteration": per_it}
    if on_card:
        rt = role_times(torch, gk, g, n_fixed)
        us = {r: round(1e3 * rt[r]["ms"], 2) for r in roles}
        out.update(
            time="CUDA events", stage_us=us,
            bound_us={r: round(1e3 * rt[r]["bound_ms"], 2) for r in roles},
            per_lm_iter_fixed_us=round(sum(us[r] * per_it[r] for r in roles if r != gk.MATVEC),
                                       2),
            per_cg_iter_us=us[gk.MATVEC],
            ms_per_replayed_lm_iteration=round(
                1e3 * rec["replay_s"] / max(rec["graph_replays"], 1), 4))
    else:
        out.update(time="not measured (the roles' plain versions on the CPU)")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--global-pcg", action="store_true",
                    help="(b): the global solve's K4 roles instead of the window's stages")
    ap.add_argument("--cams", type=int, default=None,
                    help="C (default 5 for the window, 200 for --global-pcg)")
    ap.add_argument("--n-fixed", type=int, default=None,
                    help="gauge cameras (default 2 for the window, 1 for --global-pcg)")
    ap.add_argument("--points", type=int, default=None,
                    help="P (default 8192 for the window, 30000 for --global-pcg)")
    ap.add_argument("--slots", type=int, default=None,
                    help="D of the window, observations per point of --global-pcg "
                         "(default 5, 4)")
    ap.add_argument("--seed", type=int, default=1)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch.ops import ba, ba_grid, ba_kernel
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk
    from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid
    from bundle_adjustment_tpu_torch.tools.stress import device_name
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_problem, \
        synthetic_window

    dev = device_mod.resolve(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        device_mod.set_float32_numerics()
    if args.global_pcg:
        C, P = args.cams or 200, args.points or 30000
        pr = synthetic_global_problem(np.random.default_rng(11), C=C, P=P,
                                      obs_per_pt=args.slots or 4)
        g = ba_grid.from_flat(ba.BAProblem(**{k: torch.as_tensor(v, device=dev)
                                              for k, v in pr.items()}))
        out = global_pcg(torch, gk, ba, kernels, g, args.n_fixed or 1, on_card)
    else:
        C, P, D = args.cams or 5, args.points or 8192, args.slots or 5
        n_fixed = args.n_fixed or 2
        w = synthetic_window(args.seed, C=C, n_pts=max(P * 3 // 4, 1), P=P, D=D)
        g = BAProblemGrid(**{k: torch.as_tensor(v, device=dev) for k, v in w.items()})
        out = grid_stages(torch, g, n_fixed, on_card)
        if on_card:
            out["k3_phases"] = k3_phases(torch, ba_kernel, BAProblemGrid, synthetic_window,
                                         args.seed)
    out["device"] = device_name(dev.type)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
