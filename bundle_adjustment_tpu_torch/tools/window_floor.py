"""Window-kernel latency floor: the counterpart of the JAX package's
``tools/window_floor.py``, with its JSON keys (one line per P: ``P``,
``obs``, ``us_per_lm_iteration``; then the verdict line: ``metric``
"window_kernel_floor", ``P_span``, ``time_ratio``, ``latency_bound``,
``note``).

Is K3, the window LM kernel (``ops/ba_kernel.lm_solve``, one launch per
solve), at a latency floor, or does its time per LM iteration follow the
work?  The sweep holds the window (C = 6 cameras, one gauge camera, 4
observations per point) and grows the point count P.  An LM iteration's
time is the difference between a 50-iteration and a 10-iteration solve
(``ftol = xtol = 0`` and an unreachable ``lambda_max``, so each runs to its
cap), over the difference of their iteration counts.  On the card each
solve is timed by CUDA events over back-to-back launches, best of several
trials.  The JAX tool's sweep is P = 256 to 2048 (its TPU kernel's gate);
K3 has no such gate, so the sweep goes on to the widest window K3 takes on
the long drive (P = 53,430).  The verdict is the JAX tool's, over its own
span (256 to 2048); ``beyond`` gives the time ratio from P = 2048 to the
widest.

The windows are the port's own (``utils/synthetic.synthetic_window``: all
six cameras see each point, then each point keeps four of them, drawn at
random, in camera order), not ``bench.make_window_problem``.

    python -m bundle_adjustment_tpu_torch.tools.window_floor
    python -m bundle_adjustment_tpu_torch.tools.window_floor --device cpu --points 64 128

On the CPU K3's wrapper runs its plain version and the times are host
times (``time`` says which).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

#: the JAX tool's sweep, then past it to the widest window K3 takes on the
#: long drive (PERF.md section 5)
POINTS = (256, 512, 1024, 2048, 8192, 32768, 53430)
#: the window: cameras, gauge cameras, observations per point
C, N_FIXED, OBS_PER_PT = 6, 1, 4
#: the two solve lengths whose difference gives one LM iteration
SHORT, LONG = 10, 50
#: the JAX tool's solve settings (each solve runs to its cap) and its seed
LM_OPTS = dict(ftol=0.0, xtol=0.0, lambda_max=1e30)
SEED = 7


def window(torch, seed: int, P: int, dev):
    """The sweep's window of ``P`` points: ``synthetic_window`` with every
    camera seeing every point, each point's slots cut to ``OBS_PER_PT`` of
    them drawn at random (kept in camera order)."""
    from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_window

    w = synthetic_window(seed, C=C, n_pts=P, P=P, D=C, see=1.0)
    rng = np.random.default_rng(seed)
    keep = np.sort(np.argsort(rng.random((P, C)), axis=1)[:, :OBS_PER_PT], axis=1)
    w["cam_slot"] = np.take_along_axis(w["cam_slot"], keep, axis=1)
    w["uv"] = np.take_along_axis(w["uv"], keep[..., None], axis=1)
    w["mask"] = np.take_along_axis(w["mask"], keep, axis=1)
    return BAProblemGrid(**{k: torch.as_tensor(v, device=dev) for k, v in w.items()})


def solve_seconds(torch, g, max_iterations: int, on_card: bool, reps: int,
                  trials: int) -> tuple:
    """(seconds per solve, LM iterations per solve) of K3 at
    ``max_iterations``: ``reps`` solves back to back, best of ``trials``."""
    from bundle_adjustment_tpu_torch.ops import ba_kernel

    def solve():
        return ba_kernel.lm_solve(g, n_fixed=N_FIXED, max_iterations=max_iterations,
                                  **LM_OPTS)[3]

    its = int(solve().iterations)
    best = float("inf")
    for _ in range(trials):
        if on_card:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for _ in range(reps):
                solve()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3 / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                solve()
            best = min(best, (time.perf_counter() - t0) / reps)
    return best, its


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--points", type=int, nargs="+", default=list(POINTS),
                    help="the sweep's point counts (the verdict spans the first to 2048, "
                         "or to the last where the sweep stops short of it)")
    ap.add_argument("--reps", type=int, default=10, help="solves back to back per trial")
    ap.add_argument("--trials", type=int, default=5)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch.tools.stress import device_name

    dev = device_mod.resolve(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        device_mod.set_float32_numerics()
    rows = []
    for P in args.points:
        g = window(torch, SEED, P, dev)
        d_lo, i_lo = solve_seconds(torch, g, SHORT, on_card, args.reps, args.trials)
        d_hi, i_hi = solve_seconds(torch, g, LONG, on_card, args.reps, args.trials)
        us = 1e6 * (d_hi - d_lo) / max(i_hi - i_lo, 1)
        rows.append(dict(P=P, obs=int((g.mask > 0).sum()), us_per_lm_iteration=round(us, 2),
                         lm_iterations=[i_lo, i_hi]))
        print(json.dumps(rows[-1]), flush=True)
    jax_span = [r for r in rows if r["P"] <= 2048] or rows[:1]
    (p0, t0), (pn, tn) = ((r["P"], r["us_per_lm_iteration"]) for r in (jax_span[0],
                                                                        jax_span[-1]))
    ratio = tn / t0
    verdict = {
        "metric": "window_kernel_floor",
        "P_span": f"{p0}->{pn} ({pn // p0}x points)",
        "time_ratio": round(ratio, 2),
        "latency_bound": bool(ratio < 2.0),
        "note": ("time_ratio << P ratio => the LM body is dependency-latency bound; "
                 "per-iteration FLOPs are nearly free and MFU is not the binding metric "
                 "for this kernel"),
        "beyond": ({"P_span": f"{pn}->{rows[-1]['P']}",
                    "time_ratio": round(rows[-1]["us_per_lm_iteration"] / tn, 2)}
                   if rows[-1]["P"] > pn else None),
        "rows": rows,
        "time": "CUDA events" if on_card else "host (cpu)",
        "device": device_name(dev.type),
    }
    print(json.dumps({k: v for k, v in verdict.items() if k != "rows"}), flush=True)
    return verdict


if __name__ == "__main__":
    main()
