"""Global BA at large camera counts and at the long drive's slot counts:
the counterpart of the JAX package's ``tools/global_scale_sweep.py``.

The camera sweep solves the JAX sweep's problem (``bench.make_global_problem``
from ``numpy.random.default_rng(13)``: a chain of C cameras, P = C *
``--pts-per-cam`` points, each seen by 4 consecutive cameras; the port's copy
is ``utils/synthetic.synthetic_global_problem`` given that generator) at C =
2048, 4096 and 8192 with the JAX sweep's settings: n_fixed 1, 21 LM
iterations with ftol = xtol = 0 and lambda_max 1e30, 8 CG iterations with
Eisenstat-Walker forcing.  The slot sweep solves, with the same settings, a
ring whose points are each seen by D = 14, 54 and 91 keyframes
(``synthetic_ring_problem``; by default 280 cameras and 120,000 points,
the long drive's final map).  Per size one JSON line: LM iterations, live
CG iterations, initial and final squared cost, ms per replayed LM iteration
(host clock to the stop flag's read, median over ``--repeats`` solves), each
K4 role's ms per launch (CUDA events over 20 back-to-back launches, median
of 5) beside its bound (the bytes it must move over 3.35 TB/s or its
operations over 67 T/s, ``ba_global_kernel.role_work``, the larger), the
peak device memory of a solve and the card's name and power limit.

    python -m bundle_adjustment_tpu_torch.tools.global_scale_sweep
    python -m bundle_adjustment_tpu_torch.tools.global_scale_sweep --cams 2048 --slots 91

On the CPU (``--device cpu``, for the tests) the same solves run the roles'
plain versions and no time is reported.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

#: peak rates of one H100 SXM (NVIDIA data sheet): device-memory bytes/s and
#: float32 operations/s on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: the JAX sweep's solve: ``tools/global_scale_sweep.py``
SWEEP_OPTS = dict(max_iterations=21, ftol=0.0, xtol=0.0, lambda_max=1e30, cg_iters=8,
                  cg_tol=1e-6, cg_forcing=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cams", type=int, nargs="*", default=[2048, 4096, 8192])
    ap.add_argument("--pts-per-cam", type=int, default=120,
                    help="P = cams * this (bench's C=1000 row uses 120)")
    ap.add_argument("--slots", type=int, nargs="*", default=[14, 54, 91],
                    help="D of the ring sweep")
    ap.add_argument("--ring-cams", type=int, default=280)
    ap.add_argument("--ring-points", type=int, default=120000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _events_ms(torch, fn, reps: int = 20, trials: int = 5) -> float:
    """ms per call of ``fn`` by CUDA events over ``reps`` back-to-back calls,
    median of ``trials``, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def role_times(torch, gk, g, n_fixed: int) -> dict:
    """role -> ms per launch, bound ms and what bounds it, on the problem's
    starting state."""
    C = g.rvecs.shape[0]
    lay = gk.layout(g)
    index = gk.camera_index(lay.slotT, lay.maskT, C, n_fixed)
    ptT = g.points.T.contiguous()
    cam = gk.camera_rows(g.rvecs, g.tvecs, True)
    camc = gk.camera_rows(g.rvecs, g.tvecs, False)
    scal = gk.with_lambda(lay.scal, 1e-3)
    x = torch.full((C - n_fixed, 6), 1e-3, device=g.rvecs.device)
    YT, VinvT, zpT, _ = (t.clone() for t in gk.setup(cam, ptT, lay.slotT, lay.maskT, lay.uvT,
                                                     lay.pmask, scal, n_fixed, index))
    calls = {
        gk.SETUP: lambda: gk.setup(cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask, scal,
                                   n_fixed, index),
        gk.MATVEC: lambda: gk.matvec(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed, index),
        gk.BACKSUB: lambda: gk.backsub(YT, VinvT, zpT, lay.slotT, lay.maskT, x, n_fixed,
                                       index),
        gk.COST: lambda: gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal, index),
    }
    work = gk.role_work(g, n_fixed)
    out = {}
    for role, fn in calls.items():
        nbytes, ops = work[role]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        out[role] = dict(ms=round(_events_ms(torch, fn), 5), bound_ms=round(max(t_bytes, t_ops), 5),
                         bound_by="bytes" if t_bytes > t_ops else "operations")
    return out


def measure(torch, gk, ba, g, n_fixed: int, repeats: int) -> dict:
    """One size: the solve ``repeats`` times (each a fresh ``GlobalLM``), its
    record, and on the card the roles' times and the solve's peak memory."""
    dev = g.rvecs.device
    on_card = dev.type == "cuda"
    records, stats = [], None
    peak = None
    for _ in range(max(repeats, 1)):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out = gk.solve(g, n_fixed=n_fixed, **SWEEP_OPTS)
        stats = out[3]
        rec = dict(gk.SOLVES[-1])
        if on_card:
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        records.append(rec)
        del out
    P, D = g.cam_slot.shape
    res = {"C": int(g.rvecs.shape[0]), "P": int(P), "D": int(D),
           "O": int((g.mask > 0).sum()),
           "lm_iterations": records[-1]["lm_iterations"],
           "cg_iterations": int(records[-1]["cg_iterations"]),
           "stop": ba.STOP_TESTS[int(stats.stop)],
           "initial_sq": float(stats.initial_sq), "final_sq": float(stats.final_sq),
           "scratch_mib": round(gk.scratch_bytes(P, D, g.rvecs.shape[0]) / 2 ** 20, 1)}
    if not (np.isfinite(res["initial_sq"]) and np.isfinite(res["final_sq"])):
        raise FloatingPointError(f"non-finite cost at C={res['C']} D={res['D']}: {res}")
    if on_card:
        per = [1e3 * r["replay_s"] / r["graph_replays"] for r in records if r["graph_replays"]]
        res.update(path="kernels",
                   ms_per_replayed_lm_iteration=round(statistics.median(per), 4),
                   first_iteration_ms=round(1e3 * records[-1]["first_s"], 2),
                   capture_ms=round(1e3 * records[-1]["capture_s"], 2),
                   peak_mib=round(peak, 1), roles=role_times(torch, gk, g, n_fixed))
    else:
        res.update(path="plain (cpu)")
    return res


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch.ops import ba, ba_grid
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk
    from bundle_adjustment_tpu_torch.tools.stress import device_name
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_problem, \
        synthetic_ring_problem

    dev = device_mod.resolve(args.device)
    if dev.type == "cuda":
        device_mod.set_float32_numerics()

    def grid(pr):
        return ba_grid.from_flat(ba.BAProblem(**{k: torch.as_tensor(v, device=dev)
                                                 for k, v in pr.items()}))

    out = {"metric": "ba_global_scale_sweep", "backend": dev.type,
           "device": device_name(dev.type), "opts": SWEEP_OPTS, "sizes": {}, "slots": {}}
    for C in args.cams:
        t0 = time.perf_counter()
        g = grid(synthetic_global_problem(np.random.default_rng(13), C=C,
                                          P=C * args.pts_per_cam))
        res = measure(torch, gk, ba, g, 1, args.repeats)
        res["seconds"] = round(time.perf_counter() - t0, 1)
        out["sizes"][str(C)] = res
        print(json.dumps({C: res}), flush=True)
        del g
    for D in args.slots:
        t0 = time.perf_counter()
        g = grid(synthetic_ring_problem(13, C=args.ring_cams, P=args.ring_points, D=D))
        res = measure(torch, gk, ba, g, 1, args.repeats)
        res["seconds"] = round(time.perf_counter() - t0, 1)
        out["slots"][str(D)] = res
        print(json.dumps({f"D={D}": res}), flush=True)
        del g
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
