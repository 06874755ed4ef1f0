#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bundle_adjustment_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--frames 40] [--seed 0]

Phases, each of which exits non-zero when it fails:

1. the card's name and power limit, torch and CUDA versions, TF32 flags;
2. build every CUDA kernel of the port from ``bundle_adjustment_tpu_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all at once);
3. K1, the Hamming 2-NN kernel, against its plain PyTorch version on the
   card at 4000 x 4000 (invalid train slots, planted ties) and at a ragged
   size: exact equality; kernel and plain times from CUDA events;
4. K2, the ORB patch gather, against its plain version on a 1280 x 720
   level with 2067 keypoints, edge starts included: exact equality;
5. K3, the window LM solve, against its plain version on seeded synthetic
   windows: one LM iteration and a full solve at the main path's shape
   (C = 5, n_fixed = 2, P = 8192), at C = 9 / n_fixed = 1 (6C' = 48) with a
   ragged P and at D = 12, all with padding points and dead slots; one point
   on a camera centre; two launches bit-equal; times per solve and per LM
   iteration from CUDA events;
6. the main path: the port's numpy-rendered strafe sequence at 1280 x 720,
   ``preset_video`` (4000 features, 8 levels) with the camera fitted to the
   render and the default ``BAConfig``, through
   ``VisualOdometryPipeline.process_frame`` and ``finalize``, with the
   kernels' launch counters set to 0 just before and read just after, and
   what came out: keyframes, map points, BA results, trajectory against the
   ground truth, outputs on disk;
7. the earlier path, ``BAConfig(use_pallas_ba=False)`` (the grid solver), on
   the same frames until its first windowed BA completes;
8. determinism: the first 12 frames through two fresh pipelines give equal
   statuses, keyframe ids and keyframe poses, bit for bit.

The line before the last is the kernels' JSON record, the line before that
the card's name and power limit; the last line is the ``{"ok": true, ...}``
record.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

#: peak rates of one H100 SXM (NVIDIA data sheet, dense): device-memory
#: bytes/s and float32 operations/s on the CUDA cores (no tensor cores)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def cuda_ms(fn, warmup: int = 3, reps: int = 20, trials: int = 5) -> float:
    """ms per call of ``fn()``: CUDA events around ``reps`` back-to-back
    calls, over the count; the median of ``trials`` such runs after a
    warm-up.  A call shorter than its own launch overhead reads as that
    overhead, which is what a caller pays for it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check_knn2(torch, hamming_kernel, gen, n1: int, n2: int, dev) -> dict:
    """K1 against its plain version on random words with planted ties and
    invalid train slots; exact on best, idx and second."""
    d1 = torch.randint(-2 ** 31, 2 ** 31, (n1, 8), generator=gen, dtype=torch.int64,
                       device=dev).to(torch.int32)
    d2 = torch.randint(-2 ** 31, 2 ** 31, (n2, 8), generator=gen, dtype=torch.int64,
                       device=dev).to(torch.int32)
    # planted ties: duplicate train rows (equal distances at two indices) and
    # queries equal to train rows (distance 0 at both copies)
    n_dup = d2[1::7].shape[0]
    d2[1::7] = d2[0::7][:n_dup]
    d1[::5] = d2[torch.arange(0, n1, 5, device=dev) % n2]
    # near copies: one bit flipped, so best and second sit close together
    d1[2::11] = d2[torch.arange(2, n1, 11, device=dev) % n2] ^ 1
    valid2 = torch.rand(n2, generator=gen, device=dev) > 0.1
    valid2[-1] = False

    best_k, idx_k, second_k = hamming_kernel.knn2_fused(d1, d2, valid2)
    best_p, idx_p, second_p = hamming_kernel.knn2_plain(d1, d2, valid2)
    torch.cuda.synchronize()
    for what, a, b in (("best", best_k, best_p), ("idx", idx_k, idx_p),
                       ("second", second_k, second_p)):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            fail(f"K1 {n1}x{n2}: {what} differs from the plain version in {bad} rows")
    ties = int((best_p == second_p).sum())
    err = max(float((best_k - best_p).abs().max()),
              float((second_k - second_p).abs().max()),
              float((idx_k - idx_p).abs().max()))
    ms = cuda_ms(lambda: hamming_kernel.knn2_fused(d1, d2, valid2))
    plain_ms = cuda_ms(lambda: hamming_kernel.knn2_plain(d1, d2, valid2))
    # bytes: both word arrays and the mask read once, three (N1,) outputs
    nbytes = (n1 + n2) * 32 + n2 + 3 * n1 * 4
    # operations: XOR + POPC + ADD per word, 8 words, for every pair
    ops = n1 * n2 * 8 * 3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    print(f"K1 hamming_knn2 {n1}x{n2}: exact (ties {ties}, invalid train "
          f"{int((~valid2).sum())}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {max(t_bytes, t_ops):.5f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def check_gather(torch, orb_kernel, gen, H: int, W: int, B: int, dev) -> dict:
    """K2 against its plain version on one level; exact."""
    img = torch.rand((H, W), generator=gen, device=dev) * 255.0
    sy = torch.randint(0, H - 37 + 1, (B,), generator=gen, device=dev).to(torch.int32)
    sx = torch.randint(0, W - 37 + 1, (B,), generator=gen, device=dev).to(torch.int32)
    # edge starts: the last rows/columns of the 40x40 window fall off the image
    sy[:64] = H - 37
    sx[32:96] = W - 37
    sy[96:128] = 0
    sx[96:128] = 0
    out_k = orb_kernel.gather_patches40(img, sy, sx)
    out_p = orb_kernel.gather_patches40_plain(img, sy, sx)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_p):
        fail(f"K2 {H}x{W} B={B}: {int((out_k != out_p).sum())} values differ "
             "from the plain version")
    err = float((out_k - out_p).abs().max())
    ms = cuda_ms(lambda: orb_kernel.gather_patches40(img, sy, sx))
    plain_ms = cuda_ms(lambda: orb_kernel.gather_patches40_plain(img, sy, sx))
    # bytes: the output written once; the pixels it needs read once (at most
    # the whole level), the two start vectors read once
    nbytes = B * 40 * 40 * 4 + min(H * W, B * 40 * 40) * 4 + 2 * B * 4
    ops = B * 40 * 40          # one subtract per output
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    print(f"K2 orb_gather40 {H}x{W} B={B}: exact; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def window_work(torch, g, n_fixed: int, iterations: int) -> tuple:
    """(bytes, operations) of one window LM solve that ran ``iterations``
    LM iterations on the window ``g``, counted from its shapes and masks.

    Bytes: every input read once, every output written once.  Operations
    (a multiply and an add count one each), per LM iteration:

    * per live slot: residual 29, Huber weights 6, projection Jacobian 8,
      point Jacobian 30, dXc/dr 45, camera Jacobian 30, V 36, g_p 18 (202),
      and the trial cost's residual and rho 35;
    * per live slot of an adjustable camera: the coupling block Y 108, U
      (upper triangle) 126, g_c 36;
    * per point seen by k adjustable cameras: damping and the 3x3 inverse
      50, z_p 15, B z_p 36k, B V^-1 90k, the Schur blocks 216 k(k+1)/2,
      back-substitution 36k + 18;
    * Gauss-Jordan on the n x (n+1) system: 2 n^2 (n+1);

    and once per solve the initial and the final cost, 35 per live slot
    each."""
    C = g.rvecs.shape[0]
    P, D = g.cam_slot.shape
    n = 6 * (C - n_fixed)
    live = g.mask > 0
    adj = live & (g.cam_slot >= n_fixed)
    onehot = (g.cam_slot[..., None] == torch.arange(n_fixed, C, device=g.mask.device)) \
        & adj[..., None]
    k = onehot.any(dim=1).sum(dim=1).to(torch.float64)       # (P,) cameras per point
    L, La = float(live.sum()), float(adj.sum())
    per_point = float((65 + 18 + (36 + 90 + 36) * k + 216 * k * (k + 1) / 2).sum())
    per_iter = L * (202 + 35) + La * (108 + 126 + 36) + per_point + 2 * n * n * (n + 1)
    ops = iterations * per_iter + 2 * 35 * L
    nbytes = (2 * C * 12 + P * 12 + P * D * (4 + 8 + 4) + P + 36      # inputs
              + 2 * C * 12 + P * 12 + 32)                              # outputs
    return nbytes, ops


def check_window_lm(torch, np, ba_kernel, grid_cls, synthetic_window, so3_exp_np,
                    seed: int, dev) -> dict:
    """K3 against its plain version on seeded synthetic windows."""

    def window(seed_, **kw):
        w = synthetic_window(seed_, **kw)
        return w, grid_cls(**{k: torch.as_tensor(v, device=dev) for k, v in w.items()})

    def costs(st):
        return np.array([float(st.initial_cost), float(st.final_cost),
                         float(st.initial_sq), float(st.final_sq)])

    shapes = [   # name, n_fixed, window
        ("main C=5 n_fixed=2 P=8192 D=5", 2, dict(C=5, n_pts=6000, P=8192, D=5)),
        ("C=9 n_fixed=1 P=1777 D=6 (6C'=48, ragged P)", 1, dict(C=9, n_pts=1531, P=1777, D=6)),
        ("C=10 n_fixed=2 P=1024 D=12", 2, dict(C=10, n_pts=900, P=1024, D=12)),
    ]
    main_err = None
    for name, n_fixed, kw in shapes:
        _, g = window(seed + 1, **kw)
        dead = float((g.mask == 0).float().mean())
        # (a) one LM iteration: rvecs and tvecs 1e-5, points 1e-4 absolute,
        # costs 1e-5 relative.  Measured on one H100 over the three shapes:
        # rvecs 4.0e-07 to 5.8e-07, tvecs 2.2e-06 to 3.1e-06, points 6.2e-06
        # to 5.7e-05, costs 9.5e-08 to 7.8e-06
        a = ba_kernel.lm_solve(g, n_fixed=n_fixed, max_iterations=1)
        b = ba_kernel.lm_solve_plain(g, n_fixed=n_fixed, max_iterations=1)
        torch.cuda.synchronize()
        e_rv = float((a[0] - b[0]).abs().max())
        e_tv = float((a[1] - b[1]).abs().max())
        e_pt = float((a[2] - b[2]).abs().max())
        e_cost = float(np.max(np.abs(costs(a[3]) - costs(b[3])) / np.abs(costs(b[3]))))
        print(f"K3 {name}: dead slots {100 * dead:.0f} %, one iteration: max abs err "
              f"rvecs {e_rv:.2e} tvecs {e_tv:.2e} points {e_pt:.2e}, costs rel {e_cost:.2e}")
        if not (e_rv <= 1e-5 and e_tv <= 1e-5 and e_pt <= 1e-4 and e_cost <= 1e-5):
            fail(f"K3 {name}: one iteration differs from the plain version")
        if int(a[3].iterations) != 1 or bool(a[3].accepted) != bool(b[3].accepted):
            fail(f"K3 {name}: iterations/accepted differ after one iteration")
        if main_err is None:
            main_err = max(e_rv, e_tv, e_pt)
        # (b) a full solve: final cost 1 %, iterations within 2, accepted equal
        a = ba_kernel.lm_solve(g, n_fixed=n_fixed)
        b = ba_kernel.lm_solve_plain(g, n_fixed=n_fixed)
        torch.cuda.synchronize()
        ca, cb = costs(a[3]), costs(b[3])
        ia, ib = int(a[3].iterations), int(b[3].iterations)
        print(f"K3 {name}: full solve: cost {cb[0]:.2f} -> kernel {ca[1]:.4f} in {ia} "
              f"iterations, plain {cb[1]:.4f} in {ib}")
        if not (abs(ca[1] - cb[1]) <= 1e-2 * cb[1] and abs(ia - ib) <= 2
                and bool(a[3].accepted) == bool(b[3].accepted)
                and all(bool(torch.isfinite(x).all()) for x in a[:3])):
            fail(f"K3 {name}: the full solve differs from the plain version")

    # one point a hair from an adjustable camera's centre: everything finite
    w, _ = window(seed + 2, C=5, n_pts=6000, P=8192, D=5)
    centre = -so3_exp_np(w["rvecs"][3].astype(np.float64)).T @ w["tvecs"][3]
    w["points"][0] = (centre + [1e-7, -1e-7, 2e-7]).astype(np.float32)
    g = grid_cls(**{k: torch.as_tensor(v, device=dev) for k, v in w.items()})
    for iters in (1, 50):
        a = ba_kernel.lm_solve(g, n_fixed=2, max_iterations=iters)
        torch.cuda.synchronize()
        if not (all(bool(torch.isfinite(x).all()) for x in a[:3])
                and np.isfinite(costs(a[3])).all()):
            fail("K3: a point on a camera centre gave non-finite outputs")
    print(f"K3 point on a camera centre: finite; {int(a[3].iterations)} iterations, "
          f"cost {float(a[3].initial_cost):.2f} -> {float(a[3].final_cost):.4f}")

    # two launches on the same input: equal bits
    name, n_fixed, kw = shapes[0]
    _, g = window(seed + 1, **kw)
    opts = dict(max_iterations=50, huber_delta=1.0, lambda_init=1e-3, lambda_up=4.0,
                lambda_down=0.5, lambda_min=1e-10, lambda_max=1e8, ftol=1e-5, xtol=1e-5)
    r1 = ba_kernel.launch(g, n_fixed, **opts)
    r2 = ba_kernel.launch(g, n_fixed, **opts)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(r1, r2)):
        fail("K3: two launches on the same input differ")
    iters = int(r1[3][4])
    print(f"K3 two launches on the same input: equal bits ({iters} iterations, "
          f"last lambda {float(r1[3][6]):.3g})")

    # times at the main path's shape: per solve, and per LM iteration by the
    # marginal protocol (K iterations with ftol = xtol = 0, minus one)
    ms = cuda_ms(lambda: ba_kernel.lm_solve(g, n_fixed=n_fixed))
    plain_ms = cuda_ms(lambda: ba_kernel.lm_solve_plain(g, n_fixed=n_fixed),
                       warmup=1, reps=2, trials=3)
    K_IT = 12
    free = dict(opts, ftol=0.0, xtol=0.0)
    it_k = int(ba_kernel.launch(g, n_fixed, **dict(free, max_iterations=K_IT))[3][4])
    t_k = cuda_ms(lambda: ba_kernel.launch(g, n_fixed, **dict(free, max_iterations=K_IT)))
    t_1 = cuda_ms(lambda: ba_kernel.launch(g, n_fixed, **dict(free, max_iterations=1)))
    p_k = cuda_ms(lambda: ba_kernel.lm_solve_plain(g, n_fixed, **dict(free, max_iterations=K_IT)),
                  warmup=1, reps=2, trials=3)
    p_1 = cuda_ms(lambda: ba_kernel.lm_solve_plain(g, n_fixed, **dict(free, max_iterations=1)),
                  warmup=1, reps=2, trials=3)
    if it_k < 2:
        fail(f"K3: the {K_IT}-iteration timing solve stopped after {it_k}")
    nbytes, ops = window_work(torch, g, n_fixed, iters)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    print(f"K3 ba_window_lm {name}: solve of {iters} iterations kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms; per LM iteration kernel {(t_k - t_1) / (it_k - 1):.4f} ms, "
          f"plain {(p_k - p_1) / (it_k - 1):.3f} ms ({it_k} iterations minus 1); one "
          f"iteration kernel {t_1:.4f} ms, plain {p_1:.3f} ms; {ops / 1e6:.1f} Mop, "
          f"{nbytes / 1e6:.2f} MB, bound {max(t_bytes, t_ops):.5f} ms")
    return dict(max_abs_err=main_err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def profile_frames(torch, frames, cfg, pipeline_cls, log_cls) -> None:
    """A fresh pipeline over ``frames`` under torch.profiler: the device's
    busy share of the wall time and the kernels by device time, printed.
    Runs after the main path, so it adds nothing to the main path's launch
    counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe = pipeline_cls(cfg, log=log_cls(echo=False), device="cuda")
    pipe.process_frame(frames[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames[1:]:
            pipe.process_frame(f)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    summary = (f"profile over {len(frames) - 1} frames: wall {wall_us / 1e3:.1f} ms, "
               f"device busy {dev_us / 1e3:.1f} ms ({100 * dev_us / wall_us:.1f} %)")
    print(summary)
    print(table)
    for e in events:
        if e.device_type == DeviceType.CUDA and any(
                k in e.key for k in ("knn2_kernel", "gather40_kernel", "ba_window_lm_kernel")):
            print(f"{e.key[:60]}: {e.count} launches, device time "
                  f"{e.self_device_time_total / max(e.count, 1) / 1e3:.4f} ms each")


def drive(torch, pipe, frames, until_first_ba: bool = False) -> dict:
    """``frames`` through ``pipe.process_frame``, each timed on the host clock
    up to a device synchronise.  With ``until_first_ba`` it stops after the
    first frame whose windowed BA ran."""
    frame_ms, frame_of_kf, statuses = [], {}, []
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        r = pipe.process_frame(f)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        statuses.append(r["status"])
        if r["status"] in ("initialized", "keyframe"):
            frame_of_kf[r["kf_id"]] = i
        if until_first_ba and r.get("ba"):
            break
    return dict(frame_ms=frame_ms, frame_of_kf=frame_of_kf, statuses=statuses)


def keyframe_state(np, pipe) -> tuple:
    """Keyframe ids and their poses as one float64 array (R row-major, t)."""
    ids = pipe.map.sorted_kf_ids()
    poses = np.stack([np.r_[pipe.map.keyframes[k].R.ravel(), pipe.map.keyframes[k].t]
                      for k in ids])
    return ids, poses


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the checks, profile a fresh pipeline over the "
                         "first N frames (default 0: no profile)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA card")

    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch.config import CAMERA_LEHMAN, CameraModel, preset_video
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.ops import ba_kernel, hamming_kernel, orb, orb_kernel
    from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid
    from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog, read_events
    from bundle_adjustment_tpu_torch.utils.metrics import ate_rmse
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_sequence, synthetic_window

    if "jax" in sys.modules:
        fail("the port imported jax")

    # -- 1. the card ---------------------------------------------------------
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    device_mod.set_float32_numerics()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build_all(verbose=True)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"(per kernel: { {k: round(v, 2) for k, v in built.items()} })")

    # -- 3./4./5. kernels against their plain versions -----------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    k1 = check_knn2(torch, hamming_kernel, gen, 4000, 4000, dev)
    check_knn2(torch, hamming_kernel, gen, 1237, 3001, dev)
    budgets = orb.level_budgets(int(4000 * 1.6), 8, 1.2)
    k2 = check_gather(torch, orb_kernel, gen, 720, 1280, budgets[0], dev)
    k3 = check_window_lm(torch, np, ba_kernel, BAProblemGrid, synthetic_window,
                         so3_exp_np, args.seed, dev)

    # -- 6. the main path ----------------------------------------------------
    W, H = 1280, 720
    t0 = time.perf_counter()
    frames, K, gt_C, _ = synthetic_sequence(
        n_frames=args.frames, width=W, height=H, fx=CAMERA_LEHMAN.fx,
        seed=args.seed, motion="strafe")
    print(f"rendered {len(frames)} frames {W}x{H} in "
          f"{time.perf_counter() - t0:.1f} s")
    cam = CameraModel(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                      cy=float(K[1, 2]), width=W, height=H)
    cfg = preset_video(cam)
    if not (cfg.ba.use_pallas_ba and cfg.ba.window_size == 5 and cfg.ba.n_fixed == 2):
        fail(f"preset_video no longer ships the default BAConfig: {cfg.ba}")
    log = EventLog(echo=False)
    pipe = VisualOdometryPipeline(cfg, log=log, device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    run = drive(torch, pipe, frames)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    summary = pipe.finalize(out_dir)
    torch.cuda.synchronize()
    finalize_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    frame_of_kf, statuses = run["frame_of_kf"], run["statuses"]

    n_kf = pipe.map.num_keyframes
    n_pts = pipe.map.num_points
    events = read_events(f"{out_dir}/events.jsonl")
    ba_events = [e for e in events if e["event"] in ("ba_complete", "ba_diverged")]
    n_ba = sum(1 for e in ba_events if e["event"] == "ba_complete")
    gba = summary["global_ba"] or {}
    final_cost = float(gba.get("final", float("nan")))
    traj = pipe.map.trajectory(cfg.consistent_convention)
    gt = np.stack([gt_C[frame_of_kf[k]] for k in pipe.map.sorted_kf_ids()])
    ate = ate_rmse(traj, gt, with_scale=True)
    scale = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    fm = np.asarray(run["frame_ms"])
    print(f"statuses: {''.join(s[0] for s in statuses)} "
          "(i=initialized k=keyframe t=tracked d=discarded)")
    print(f"per-frame ms: median {np.median(fm):.1f}, p90 "
          f"{np.percentile(fm, 90):.1f}, first {fm[0]:.1f}, max {fm.max():.1f}; "
          f"finalize {finalize_s:.2f} s")
    slowest = np.argsort(-fm)[:4]
    print("slowest frames: " + ", ".join(
        f"#{i} {statuses[i]} {fm[i]:.1f} ms" for i in slowest))
    print(f"keyframes {n_kf}, map points {n_pts}, observations "
          f"{pipe.map.num_observations}, ba_complete events {n_ba} of "
          f"{len(ba_events)} BA solves, K3 launches {launches['ba_window_lm']}, final BA "
          f"{json.dumps(gba)}")
    print(f"keyframe-centre ATE after similarity alignment {ate:.4f} "
          f"(motion scale {scale:.3f})")
    print(f"launches on the main path: {launches}; peak device memory "
          f"{peak_mem / 2 ** 20:.1f} MiB")

    if not 3 <= n_kf <= 24:
        fail(f"{n_kf} keyframes, expected 3..24")
    if n_pts <= 100:
        fail(f"{n_pts} map points, expected > 100")
    if n_ba <= 0:
        fail("no ba_complete event")
    if not math.isfinite(final_cost) or gba.get("diverged"):
        fail(f"final BA not a finite, converged cost: {gba}")
    if not (np.isfinite(traj).all() and traj.shape == (n_kf, 3)):
        fail("trajectory not finite or of the wrong shape")
    if not ate <= 0.25 * scale:
        fail(f"keyframe ATE {ate} above 0.25 of the path extent {scale} "
             "(the bound tests/test_torch_pipeline.py holds on the CPU)")
    with open(f"{out_dir}/trajectory.txt") as fh:
        rows = [ln for ln in fh if not ln.startswith("#")]
    if len(rows) != n_kf:
        fail(f"trajectory.txt has {len(rows)} rows for {n_kf} keyframes")
    for name in kernels.KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    n_windowed = sum(1 for e in ba_events if not e.get("global_ba"))
    if not n_windowed <= launches["ba_window_lm"] <= len(ba_events):
        fail(f"{n_windowed} windowed of {len(ba_events)} BA solves on the main path but "
             f"{launches['ba_window_lm']} K3 launches: every windowed BA of the default "
             "configuration is inside the kernel's gate")
    if "jax" in sys.modules:
        fail("the port imported jax")
    ba_s = sum(e.get("elapsed_s", 0.0) for e in ba_events)
    print(f"time in BA solves (events' elapsed_s): {ba_s:.2f} s of "
          f"{fm.sum() / 1e3 + finalize_s:.2f} s for all frames and finalize; per solve "
          + ", ".join(f"{e.get('elapsed_s', 0.0) * 1e3:.0f}" for e in ba_events) + " ms")

    # -- 7. the earlier path: the grid solver -------------------------------
    cfg_grid = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, use_pallas_ba=False))
    log_grid = EventLog(echo=False)
    pipe_grid = VisualOdometryPipeline(cfg_grid, log=log_grid, device="cuda")
    before = kernels.LAUNCHES["ba_window_lm"]
    run_grid = drive(torch, pipe_grid, frames, until_first_ba=True)
    grid_ba = [e for e in log_grid.events if e["event"] in ("ba_complete", "ba_diverged")]
    if not grid_ba:
        fail(f"the grid-solver path ran no windowed BA in {len(frames)} frames")
    if kernels.LAUNCHES["ba_window_lm"] != before:
        fail("use_pallas_ba=False launched the window LM kernel")
    print(f"earlier path (use_pallas_ba=False): {len(run_grid['statuses'])} frames, statuses "
          f"{''.join(s[0] for s in run_grid['statuses'])}, first windowed BA "
          f"{grid_ba[0]['event']} in {grid_ba[0].get('elapsed_s', 0.0) * 1e3:.0f} ms")
    if run_grid["statuses"] != statuses[: len(run_grid["statuses"])]:
        print("  (its statuses part from the main path's before the first BA)")

    # -- 8. determinism ------------------------------------------------------
    twins = []
    for _ in range(2):
        p2 = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device="cuda")
        st = drive(torch, p2, frames[:12])["statuses"]
        twins.append((st,) + keyframe_state(np, p2))
    (st_a, ids_a, poses_a), (st_b, ids_b, poses_b) = twins
    if st_a != st_b or ids_a != ids_b or not np.array_equal(poses_a, poses_b):
        fail(f"two runs of the first 12 frames differ: statuses {st_a == st_b}, "
             f"keyframe ids {ids_a == ids_b}, poses equal "
             f"{poses_a.shape == poses_b.shape and np.array_equal(poses_a, poses_b)}")
    if st_a != statuses[:12]:
        fail("the first 12 frames of a fresh pipeline differ from the main path's")
    print(f"determinism: two fresh pipelines over 12 frames: statuses "
          f"{''.join(s[0] for s in st_a)}, {len(ids_a)} keyframes, ids and poses bit-equal")

    if args.profile:
        profile_frames(torch, frames[: args.profile], cfg, VisualOdometryPipeline, EventLog)

    record = {"kernels": [
        dict(name="hamming_knn2", route="cuda",
             source="bundle_adjustment_tpu_torch/csrc/hamming_knn2.cu",
             replaces="bundle_adjustment_tpu/ops/hamming_pallas.py:87",
             launches=launches["hamming_knn2"], library_ms=None, **k1),
        dict(name="orb_gather40", route="cuda",
             source="bundle_adjustment_tpu_torch/csrc/orb_gather.cu",
             replaces="bundle_adjustment_tpu/ops/orb_pallas.py:97",
             launches=launches["orb_gather40"], library_ms=None, **k2),
        dict(name="ba_window_lm", route="cuda",
             source="bundle_adjustment_tpu_torch/csrc/ba_window_lm.cu",
             replaces="bundle_adjustment_tpu/ops/ba_pallas.py:521",
             launches=launches["ba_window_lm"], library_ms=None, **k3),
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
