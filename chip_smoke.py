#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bundle_adjustment_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--frames 40] [--seed 0] [--profile N]
    python3 chip_smoke.py --kernel-times [--tree DIR]

Phases, each of which exits non-zero when it fails:

1. the card's name and power limit, torch and CUDA versions, TF32 flags;
2. build every CUDA kernel of the port from ``bundle_adjustment_tpu_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all at once; the four roles of
   K4 share one source);
3. K1, the Hamming 2-NN kernel, against its plain PyTorch version on the
   card at 4000 x 4000 (invalid train slots, planted ties) and at a ragged
   size: exact equality; kernel and plain times from CUDA events, the
   kernel's device time under the profiler;
4. K2, the ORB patch gather, against its plain version on a 1280 x 720
   level with 2067 keypoints, edge starts included: exact equality;
5. K3, the window LM solve, against its plain version on seeded synthetic
   windows: one LM iteration and a full solve at the main path's shape
   (C = 5, n_fixed = 2, P = 8192), at C = 9 / n_fixed = 1 (6C' = 48) with a
   ragged P, at D = 12 and at the widest window the gate admits (C = 10,
   n_fixed = 2, P = 53,430), all with padding points and dead slots; one point
   on a camera centre; two launches bit-equal; times per solve and per LM
   iteration from CUDA events, at the main shape and at the widest window;
5b. K4, the four global-BA PCG roles (setup, matvec, backsub, cost), each
   against its plain version at the global path's shape (200 cameras, 30,000
   points bucketed to P = 32,768, D = 4, n_fixed = 2) and at a ragged one
   (37 cameras, P = 1777, dead slots, n_fixed = 1), norm-wise; the whole
   solve against ``solve_plain``; two launches and two solves bit-equal;
   times per launch from CUDA events;
6. the main path: the port's numpy-rendered strafe sequence at 1280 x 720,
   ``preset_video`` (4000 features, 8 levels) with the camera fitted to the
   render and the default ``BAConfig``, through
   ``VisualOdometryPipeline.process_frame`` and ``finalize``, with the
   kernels' launch counters set to 0 just before and read just after, and
   what came out: keyframes, map points, BA results, trajectory against the
   ground truth, outputs on disk; then an untimed second run over the same
   frames records the inputs of K1 and K3, must give the same statuses, and
   prints the shapes of its K3 launches and the time per launch of K1 and K3
   on those inputs, each replayed several times (the spread of CUDA-event
   times, and the device time under the profiler);
7. the earlier path, ``BAConfig(use_pallas_ba=False)`` (the grid solver), on
   the same frames until its first windowed BA completes;
8. determinism: the first 12 frames through two fresh pipelines give equal
   statuses, keyframe ids and keyframe poses, bit for bit;
9. the global path at full width: a map of 200 keyframes, 30,000 points and
   120,000 observations (``synthetic_global_map``) in a
   ``VisualOdometryPipeline(preset_video(cam))``, then ``finalize``: global BA
   over 199 cameras and full BA over 200 through the K4 kernels, each LM
   iteration after the first a replay of one CUDA graph, with the launch
   counters set to 0 just before and read just after; squared costs within
   1 % of the earlier runs'; per solve its host reads (at most one per LM
   iteration and ``camera_index``'s), graph replays and live CG iterations;
   a second fresh run must give bit-equal poses and the same records;
10. the same path through a real VO run: the rendered frames with
   ``BAConfig(pcg_min_cameras=3)`` until a windowed BA completes, so that
   every windowed BA takes the PCG branch, K4 and its graph, then
   ``finalize``.

``--kernel-times [--tree DIR]`` only builds and times K1, K3 and K4's setup,
matvec and cost (``kernel_times``: K3 per LM iteration over a sweep of C' and
P as well; K4a, K4b and K4d at the global path's shape) on this checkout or
on another commit's tree, for comparing two commits in one call.

The line before the last is the kernels' JSON record, the line before that
the card's name and power limit; the last line is the ``{"ok": true, ...}``
record.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

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


def each_call_ms(torch, fn, n: int) -> list:
    """CUDA-event ms of each of ``n`` calls of ``fn()``, one at a time after a
    warm-up call."""
    fn()
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def k3_iteration_ms(ba_kernel, g, n_fixed: int, opts: dict, k_it: int = 12) -> float:
    """K3's ms per LM iteration on the window ``g`` by the marginal protocol:
    ``k_it`` iterations with ftol = xtol = 0 minus one, over the iterations
    run between them."""
    free = dict(opts, ftol=0.0, xtol=0.0)
    it = int(ba_kernel.launch(g, n_fixed, **dict(free, max_iterations=k_it))[3][4])
    tk = cuda_ms(lambda: ba_kernel.launch(g, n_fixed, **dict(free, max_iterations=k_it)))
    t1 = cuda_ms(lambda: ba_kernel.launch(g, n_fixed, **dict(free, max_iterations=1)))
    return (tk - t1) / max(it - 1, 1)


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
    device_ms, records = per_call(device_ms_per_launch(
        torch, [lambda: hamming_kernel.knn2_fused(d1, d2, valid2)] * 20, ("knn2",)))
    # bytes: both word arrays and the mask read once, three (N1,) outputs
    nbytes = (n1 + n2) * 32 + n2 + 3 * n1 * 4
    # operations: XOR + POPC + ADD per word, 8 words, for every pair
    ops = n1 * n2 * 8 * 3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rows = hamming_kernel.split_plan(n1, n2, sms)
    print(f"K1 hamming_knn2 {n1}x{n2}: exact (ties {ties}, invalid train "
          f"{int((~valid2).sum())}); kernel {ms:.4f} ms (device {device_ms:.4f} ms, {records} "
          f"of 20 launches recorded), plain "
          f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms; grid "
          f"{-(-n1 // hamming_kernel.QUERY_TILE)} query tiles x {splits} train splits of "
          f"{rows} rows over {sms} SMs")
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
        # the widest window the gate admits: 32 MiB of scratch at C' = 8
        ("widest C=10 n_fixed=2 P=53430 D=5", 2, dict(C=10, n_pts=50000, P=53430, D=5)),
    ]
    main_err = None
    for name, n_fixed, kw in shapes:
        _, g = window(seed + 1, **kw)
        dead = float((g.mask == 0).float().mean())
        # (a) one LM iteration: rvecs and tvecs 1e-5, points 1e-4 absolute,
        # costs 1e-5 relative.  Measured on one H100 over the four shapes
        # (cluster of 16 CTAs): rvecs 3.0e-07 to 8.1e-07, tvecs 9.5e-07 to
        # 4.6e-06, points 6.7e-06 to 5.8e-05, costs 2.8e-07 to 4.6e-06
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
    _, g_wide = window(seed + 1, **shapes[3][2])
    wide_solve = cuda_ms(lambda: ba_kernel.launch(g_wide, n_fixed, **opts))
    wide_it = k3_iteration_ms(ba_kernel, g_wide, n_fixed, opts)
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
    print(f"K3 widest window (C=10, n_fixed=2, P=53430, D=5): solve {wide_solve:.4f} ms, per "
          f"LM iteration {wide_it:.4f} ms, {wide_it / ((t_k - t_1) / (it_k - 1)):.2f} times "
          "the main shape's")
    return dict(max_abs_err=main_err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def global_grid(torch, mods, seed: int, C: int, n_pts: int, P: int, drop: float, dev):
    """A band-visibility chain of ``C`` cameras and ``n_pts`` points padded to
    ``P`` points, a share ``drop`` of its observations left out (dead slots),
    in the grid layout on ``dev``."""
    pr = mods.synthetic_global_problem(seed, C=C, P=n_pts, drop=drop, pad_to=P)
    return mods.from_flat(mods.BAProblem(**{k: torch.as_tensor(v, device=dev)
                                            for k, v in pr.items()}))


def global_work(g, n_fixed: int) -> dict:
    """role -> (bytes, operations) of one launch on the grid ``g``, counted
    from its shapes and masks.  Bytes: every input read once, every output
    written once (scratch rows are neither).  Operations (a multiply and an
    add count one each):

    * setup, per live slot: residual 29, Huber weights 6, projection Jacobian
      8, point Jacobian 30, dXc/dr 45, camera Jacobian 30, V 36, g_p 18
      (202); per live slot of an adjustable camera: Y 108, U's upper triangle
      126, g_c 36, Y z_p 30, Y V^-1 90, the preconditioner's upper triangle
      105, the 54 adds of the camera sum; per point: damping and the 3x3
      inverse 50, z_p 15;
    * matvec, per live slot of an adjustable camera: Y^T x 36, Y z 30, the 6
      adds of the camera sum; per point V^-1 q 15;
    * backsub, per live slot of an adjustable camera 36; per point 21;
    * cost, per live slot: residual and rho 35."""
    C = g.rvecs.shape[0]
    P, D = g.cam_slot.shape
    c_adj = C - n_fixed
    live = (g.mask > 0) & (g.cam_slot >= 0) & (g.cam_slot < C)
    L = float(live.sum())
    La = float((live & (g.cam_slot >= n_fixed)).sum())
    grid_b = P * D * (4 + 4)                  # cam_slot, mask
    index_b = P * D * 4 + (c_adj + 1) * 4     # pairs, offsets
    y_b = 18 * D * P * 4
    return {
        "ba_global_setup": (
            C * 39 * 4 + P * 12 + grid_b + P * D * 8 + P * 4 + 32 + index_b
            + y_b + 9 * P * 4 + c_adj * 54 * 4,
            L * 202 + La * (108 + 126 + 36 + 30 + 90 + 105 + 54) + P * 65),
        "ba_global_matvec": (
            y_b + 6 * P * 4 + grid_b + index_b + 2 * c_adj * 24,
            La * (36 + 30 + 6) + P * 15),
        "ba_global_backsub": (
            y_b + 9 * P * 4 + grid_b + c_adj * 24 + 3 * P * 4,
            La * 36 + P * 21),
        "ba_global_cost": (
            C * 12 * 4 + P * 12 + grid_b + P * D * 8 + 32 + 8,
            L * 35),
    }


# K4: the bound on each output's gap to its plain version, norm-wise within
# one scale group (see check_global), and beside it the widest gap measured
# on one H100 over the two shapes and all the groups it covers.  The widest
# is Y's: a pixel residual is the difference of two numbers near 600, and the
# Huber weight 1/|r| of a residual of a pixel or two carries that rounding
# relatively.
K4_BOUNDS = {"Y": 2e-3,         # 6.0e-4 (translation rows; rotation rows 3.5e-4)
             "Vinv": 1e-3,      # 1.4e-4
             "zp": 1e-3,        # 5.4e-5
             "red": 1e-4,       # 2.1e-5 (DO.tt; the other nine groups 3.9e-6 to 1.6e-5)
             "matvec": 2e-5,    # 9.4e-7
             "backsub": 2e-4,   # 8.5e-6
             "cost": 1e-5}      # 1.1e-7


def check_global(torch, np, mods, seed: int, dev) -> dict:
    """K4: each role against its plain version on the card.  Every output is
    compared in groups of one scale, each by its largest absolute difference
    over the group's largest absolute value: a camera's rotation lanes are
    larger than its translation lanes by the scene's depth, and the 54 lanes
    of the setup reduction span five orders of magnitude, so one norm over a
    whole output would hide an error as large as its small lanes.  The groups
    are Y's rotation and translation rows, V^-1, z_p, the ten groups of
    ``ba_global_kernel.red_lane_groups``, the matvec's rotation and
    translation lanes, dp, and each of the two costs.  The gaps are printed
    and held to ``K4_BOUNDS``.
    Returns role -> the kernels line's numbers at the full-width shape."""
    gk = mods.gk
    shapes = [   # name, C, n_pts, P, drop, n_fixed
        ("C=200 n_fixed=2 P=32768 D=4", 200, 30000, 32768, 0.0, 2),
        ("C=37 n_fixed=1 P=1777 D=4, 15 % dead slots", 37, 1531, 1777, 0.15, 1),
    ]
    records = None
    for name, C, n_pts, P, drop, n_fixed in shapes:
        g = global_grid(torch, mods, seed + 3, C, n_pts, P, drop, dev)
        lay = gk.layout(g)
        index = gk.camera_index(lay.slotT, lay.maskT, C, n_fixed)
        ptT = g.points.T.contiguous()
        scal = gk.with_lambda(lay.scal, 1e-3)
        cam = gk.camera_rows(g.rvecs, g.tvecs, True)
        camc = gk.camera_rows(g.rvecs, g.tvecs, False)
        x = torch.as_tensor(np.random.default_rng(seed).normal(0, 1e-2, (C - n_fixed, 6))
                            .astype(np.float32), device=dev)

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

        def run_setup(fn, *extra):
            return fn(cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask, scal, n_fixed, *extra)

        # every role's output on the card is the index's, which its next
        # call overwrites: clone what is kept
        ks = tuple(t.clone() for t in run_setup(gk.setup, index))
        ps = run_setup(gk.setup_plain)
        YT, VinvT, zpT, _ = ps
        outs = {
            "ba_global_setup": (ks, ps),
            "ba_global_matvec": (     # the kernel's output is the index's scratch
                (gk.matvec(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed, index).clone(),),
                (gk.matvec_plain(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed),)),
            "ba_global_backsub": (
                (gk.backsub(YT, VinvT, zpT, lay.slotT, lay.maskT, x, n_fixed, index).clone(),),
                (gk.backsub_plain(YT, VinvT, zpT, lay.slotT, lay.maskT, x, n_fixed),)),
            "ba_global_cost": (
                (gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal, index).clone(),),
                (gk.cost_plain(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal),)),
        }
        torch.cuda.synchronize()

        def y_part(Y, rows):      # rows of the 6x3 blocks: 0-2 rotation, 3-5 translation
            return Y.reshape(D, 6, 3, -1)[:, rows]

        def parts(role, o):
            """label -> (the part of this role's outputs that has one scale, bound)"""
            if role == "ba_global_setup":
                out = {"Y.r": (y_part(o[0], slice(0, 3)), K4_BOUNDS["Y"]),
                       "Y.t": (y_part(o[0], slice(3, 6)), K4_BOUNDS["Y"]),
                       "Vinv": (o[1], K4_BOUNDS["Vinv"]), "zp": (o[2], K4_BOUNDS["zp"])}
                out.update({k: (o[3][:, lanes], K4_BOUNDS["red"])
                            for k, lanes in gk.red_lane_groups().items()})
                return out
            if role == "ba_global_matvec":
                return {"r": (o[0][:, :3], K4_BOUNDS["matvec"]),
                        "t": (o[0][:, 3:], K4_BOUNDS["matvec"])}
            if role == "ba_global_backsub":
                return {"dp": (o[0], K4_BOUNDS["backsub"])}
            return {"huber": (o[0][:1], K4_BOUNDS["cost"]), "sq": (o[0][1:], K4_BOUNDS["cost"])}

        D = lay.slotT.shape[0]
        errs = {}
        for role, (outs_k, outs_p) in outs.items():
            errs[role] = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_p))
            if not all(bool(torch.isfinite(a).all()) for a in outs_k):
                fail(f"K4 {role} {name}: non-finite output")
            pk, pp = parts(role, outs_k), parts(role, outs_p)
            gaps = {k: rel(pk[k][0], pp[k][0]) for k in pk}
            print(f"K4 {role} {name}: relative err " + " ".join(
                f"{k} {v:.2e}" for k, v in gaps.items()) + f", max abs err {errs[role]:.3e}")
            over = {k: (v, pk[k][1]) for k, v in gaps.items() if not v <= pk[k][1]}
            if over:
                fail(f"K4 {role} {name}: differs from the plain version: (relative gap, "
                     f"bound) {over}")
        if ks[1][:, n_pts:].any() or ks[2][:, n_pts:].any():
            fail(f"K4 setup {name}: a padding point has a non-zero V^-1 or z_p")

        # two launches on the same input: equal bits; every counter back at 0
        again = run_setup(gk.setup, index) + (
            gk.matvec(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed, index),
            gk.backsub(YT, VinvT, zpT, lay.slotT, lay.maskT, x, n_fixed, index),
            gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal, index))
        first = ks + outs["ba_global_matvec"][0] + outs["ba_global_backsub"][0] \
            + outs["ba_global_cost"][0]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)) or index.ticket.any() \
                or index.cost_ticket.any():
            fail(f"K4 {name}: two launches on the same input differ")

        # the whole solve: kernels against plain versions, and twice
        a = gk.solve(g, n_fixed=n_fixed, max_iterations=12)
        a2 = gk.solve(g, n_fixed=n_fixed, max_iterations=12)
        b = gk.solve_plain(g, n_fixed=n_fixed, max_iterations=12)
        torch.cuda.synchronize()
        ca, cb = float(a[3].final_cost), float(b[3].final_cost)
        ia, ib = int(a[3].iterations), int(b[3].iterations)
        print(f"K4 {name}: solve: cost {float(a[3].initial_cost):.2f} -> kernels {ca:.4f} in "
              f"{ia} iterations, plain {cb:.4f} in {ib}; launches equal bits")
        if not (abs(float(a[3].initial_cost) - float(b[3].initial_cost))
                <= 1e-5 * float(b[3].initial_cost) and abs(ca - cb) <= 1e-2 * cb
                and abs(ia - ib) <= 2 and bool(a[3].accepted) and ca < float(a[3].initial_cost)
                and all(bool(torch.isfinite(t).all()) for t in a[:3])):
            fail(f"K4 {name}: the solve differs from solve_plain")
        if not all(torch.equal(t1, t2)
                   for t1, t2 in zip(a[:3] + tuple(a[3]), a2[:3] + tuple(a2[3]))):
            fail(f"K4 {name}: two solves of one problem differ")

        if records is not None:
            continue
        # times at the full-width shape
        calls = {
            "ba_global_setup": (lambda: run_setup(gk.setup, index),
                                lambda: run_setup(gk.setup_plain)),
            "ba_global_matvec": (
                lambda: gk.matvec(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed, index),
                lambda: gk.matvec_plain(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed)),
            "ba_global_backsub": (
                lambda: gk.backsub(YT, VinvT, zpT, lay.slotT, lay.maskT, x, n_fixed, index),
                lambda: gk.backsub_plain(YT, VinvT, zpT, lay.slotT, lay.maskT, x, n_fixed)),
            "ba_global_cost": (
                lambda: gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal, index),
                lambda: gk.cost_plain(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal)),
        }
        work = global_work(g, n_fixed)
        records = {}
        for role, (kernel_fn, plain_fn) in calls.items():
            ms = cuda_ms(kernel_fn)
            plain_ms = cuda_ms(plain_fn, warmup=1, reps=3, trials=3)
            nbytes, ops = work[role]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
            print(f"K4 {role} {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; "
                  f"{ops / 1e6:.1f} Mop, {nbytes / 1e6:.2f} MB, bound "
                  f"{max(t_bytes, t_ops):.5f} ms")
            records[role] = dict(max_abs_err=errs[role], ms=ms, plain_ms=plain_ms,
                                 bound_ms=max(t_bytes, t_ops),
                                 bound_by="bytes" if t_bytes > t_ops else "operations")
        t_solve = cuda_ms(lambda: gk.solve(g, n_fixed=n_fixed, max_iterations=12),
                          warmup=1, reps=2, trials=3)
        print(f"K4 {name}: solve of {ia} LM iterations {t_solve:.2f} ms "
              f"({t_solve / ia:.3f} ms per LM iteration, host control included)")
    return records


K_NAMES = ("knn2_split_kernel", "knn2_merge_kernel", "gather40_kernel", "ba_window_lm_kernel",
           "setup_points_kernel", "setup_tiles_kernel", "matvec_points_kernel",
           "matvec_tiles_kernel", "backsub_points_kernel", "cost_kernel")


def profile_call(torch, label: str, fn) -> None:
    """``fn()`` under torch.profiler: the device's busy share of the wall
    time, the kernels by device time and the port's own kernels, printed.
    Runs after the paths whose launches are counted, so it adds nothing to
    their counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    print(f"profile over {label}: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.1f} ms ({100 * dev_us / wall_us:.1f} %)")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    for e in events:
        if e.device_type == DeviceType.CUDA and any(k in e.key for k in K_NAMES):
            print(f"{e.key[:60]}: {e.count} launches, device time "
                  f"{e.self_device_time_total / max(e.count, 1) / 1e3:.4f} ms each")


def recorded(module, name: str, keep):
    """Replace ``module.name`` by a function that hands its arguments to
    ``keep`` and calls it; returns the original, to be put back."""
    orig = getattr(module, name)

    def call(*a, **kw):
        keep(a, kw)
        return orig(*a, **kw)

    setattr(module, name, call)
    return orig


def device_ms_per_launch(torch, calls, keys) -> dict:
    """Each of ``calls`` once under torch.profiler: for each CUDA kernel whose
    name contains one of ``keys``, (device ms per recorded launch, records).
    A profile can come back with fewer records than launches (none of a few
    short K1 launches, some of K3's), so the mean is over the records, and
    their count is kept to be printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / e.count, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count and any(k in e.key for k in keys)}


def device_spans(torch, calls, keys) -> tuple:
    """Each of ``calls`` once under torch.profiler: the device span of each
    call, from the start of its first kernel whose name contains one of
    ``keys`` to the end of its last, and the ms per record of each such
    kernel.  Kernels chained by programmatic dependent launch overlap (the
    second starts while the first runs), so the span, not the sum of the
    kernels' times, is the call's time on the device.  Returns (median span
    ms or None when the records do not split evenly into the calls, spans,
    {kernel: ms per record})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                if e.device_type == DeviceType.CUDA and any(k in e.name for k in keys))
    per_kernel = {}
    for t0, t1, name in ev:
        short = re.search(r"(\w+_kernel(<[^>]*>)?)", name)
        per_kernel.setdefault(short.group(1) if short else name[:48], []).append((t1 - t0) / 1e3)
    per_kernel = {k: statistics.mean(v) for k, v in per_kernel.items()}
    k = len(ev) // max(len(calls), 1)
    if k == 0 or len(ev) != k * len(calls):
        return None, 0, per_kernel
    spans = [(max(e[1] for e in ev[i:i + k]) - ev[i][0]) / 1e3 for i in range(0, len(ev), k)]
    return statistics.median(spans), len(spans), per_kernel


def queued_ms(torch, fn, n: int = 20, trials: int = 5) -> tuple:
    """ms per call of ``fn()`` with ``n`` calls queued behind a kernel that
    sleeps on the device, so that the device runs them back to back without
    waiting on the host: its time per call, the gaps between its kernels
    included.  Returns (median ms, the host's ms to queue the n calls, the
    sleep's ms): the reading holds while the first is below the second."""
    fn()
    torch.cuda.synchronize()
    times, host = [], []
    sleep = torch.cuda.Event(enable_timing=True)
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sleep.record()
        torch.cuda._sleep(20_000_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times), max(host), sleep.elapsed_time(start)


def per_call(rec: dict) -> tuple:
    """(device ms per call, fewest records of a kernel) from
    ``device_ms_per_launch`` for calls that launch each kernel once; ms 0.0
    and records 0 when no record came back."""
    return (sum(ms for ms, _ in rec.values()),
            min((n for _, n in rec.values()), default=0))


def pooled(rec: dict) -> tuple:
    """(device ms per recorded launch, records) over all kernels of
    ``device_ms_per_launch``'s result."""
    n = sum(c for _, c in rec.values())
    return (sum(ms * c for ms, c in rec.values()) / n if n else 0.0, n)


def k4_times(torch, seed: int, dev) -> dict:
    """K4a (setup), K4b (matvec) and K4d (cost) at the global path's shape
    (C = 200, n_fixed = 2, 30,000 points bucketed to P = 32,768, D = 4)
    through ``camera_index``, ``setup(..., index)``, ``matvec(..., index)``
    and ``cost``, calls that every tree of the port since K4 has (the cost
    takes the index where the tree's ``cost`` has that parameter): CUDA-event
    ms per call, and device ms per call under the profiler (the sum over the
    role's kernels of ms per record) with the fewest records of one of its
    kernels in 20 calls, the device span per call (``device_spans``) and the
    time per call queued behind a sleeping kernel (``queued_ms``)."""
    import inspect

    import numpy as np

    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk
    from bundle_adjustment_tpu_torch.ops.ba import BAProblem
    from bundle_adjustment_tpu_torch.ops.ba_grid import from_flat
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_problem

    mods = types.SimpleNamespace(BAProblem=BAProblem, from_flat=from_flat,
                                 synthetic_global_problem=synthetic_global_problem)
    C, n_fixed = 200, 2
    g = global_grid(torch, mods, seed + 3, C, 30000, 32768, 0.0, dev)
    lay = gk.layout(g)
    ptT = g.points.T.contiguous()
    scal = gk.with_lambda(lay.scal, 1e-3)
    cam = gk.camera_rows(g.rvecs, g.tvecs, True)
    x = torch.as_tensor(np.random.default_rng(seed).normal(0, 1e-2, (C - n_fixed, 6))
                        .astype(np.float32), device=dev)

    camc = gk.camera_rows(g.rvecs, g.tvecs, False)
    plain = gk.setup_plain(cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask, scal, n_fixed)
    plain_mv = gk.matvec_plain(plain[0], plain[1], lay.slotT, lay.maskT, x, n_fixed)
    plain_cost = gk.cost_plain(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal)

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    def measure(index, tag_a, tag_b):
        def setup_call():
            return gk.setup(cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask, scal, n_fixed,
                            index)

        YT, VinvT, _, red = setup_call()

        def matvec_call():
            return gk.matvec(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed, index)

        takes_index = "index" in inspect.signature(gk.cost).parameters

        def cost_call():
            return gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal,
                           *((index,) if takes_index else ()))

        # the widest gap to the plain version (red per scale group)
        out = {f"k4a{tag_a}_gap": max(gap(red[:, lanes], plain[3][:, lanes])
                                      for lanes in gk.red_lane_groups().values()),
               f"k4b{tag_b}_gap": max(
                   gap(gk.matvec(plain[0], plain[1], lay.slotT, lay.maskT, x, n_fixed,
                                 index)[:, sl], plain_mv[:, sl])
                   for sl in (slice(0, 3), slice(3, 6))),
               "k4d_gap": max(gap(cost_call()[i:i + 1], plain_cost[i:i + 1]) for i in (0, 1))}
        for tag, fn, keys in (("k4a" + tag_a, setup_call, ("setup", "camera_sum")),
                              ("k4b" + tag_b, matvec_call, ("matvec", "camera_sum")),
                              ("k4d", cost_call, ("cost_",))):
            out[f"{tag}_ms"] = cuda_ms(fn)
            out[f"{tag}_device_ms"], out[f"{tag}_device_records"] = per_call(
                device_ms_per_launch(torch, [fn] * 20, keys))
            out[f"{tag}_span_ms"], out[f"{tag}_spans"], out[f"{tag}_kernels_ms"] = device_spans(
                torch, [fn] * 20, keys)
            out[f"{tag}_queued_ms"], out[f"{tag}_queue_host_ms"], out[f"{tag}_sleep_ms"] = \
                queued_ms(torch, fn)
        return out

    out = measure(gk.camera_index(lay.slotT, lay.maskT, C, n_fixed), "", "")
    return out


def kernel_times(torch, seed: int, dev) -> dict:
    """K1 at 4000 x 4000 and K3 at the main path's window (C = 5, n_fixed =
    2, P = 8192, D = 5) and at the widest one the gate admits (C = 10, P =
    53,430), through the wrappers' calls that every tree of the port since K3
    has: CUDA-event ms per call, device ms per launch under the profiler, ms
    per LM iteration by the marginal protocol, the last also over C' = 3, 7,
    8 (C = 5, 9, 10, n_fixed = 2) at P = 8192 and 53,430, which splits the
    widest window's cost between its points and its cameras; then K4a, K4b
    and K4d (``k4_times``).  ``--kernel-times --tree DIR`` runs it on another
    commit's tree."""
    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch.ops import ba_kernel, hamming_kernel
    from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_window

    kernels.build_all()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d1, d2 = (torch.randint(-2 ** 31, 2 ** 31, (4000, 8), generator=gen, dtype=torch.int64,
                            device=dev).to(torch.int32) for _ in range(2))
    valid2 = torch.rand(4000, generator=gen, device=dev) > 0.1
    out = dict(k1_ms=cuda_ms(lambda: hamming_kernel.knn2_fused(d1, d2, valid2)))
    out["k1_device_ms"], out["k1_device_records"] = per_call(device_ms_per_launch(
        torch, [lambda: hamming_kernel.knn2_fused(d1, d2, valid2)] * 20, ("knn2",)))
    opts = dict(max_iterations=50, huber_delta=1.0, lambda_init=1e-3, lambda_up=4.0,
                lambda_down=0.5, lambda_min=1e-10, lambda_max=1e8, ftol=1e-5, xtol=1e-5)
    windows = {}
    for C in (5, 9, 10):
        for P, n_pts in ((8192, 6000), (53430, 50000)):
            w = synthetic_window(seed + 1, C=C, n_pts=n_pts, P=P, D=5)
            windows[C - 2, P] = BAProblemGrid(**{k: torch.as_tensor(v, device=dev)
                                                 for k, v in w.items()})
    out["k3_iteration_ms"] = {f"C'={c} P={p}": k3_iteration_ms(ba_kernel, g, 2, opts)
                              for (c, p), g in windows.items()}
    for tag, key in (("k3", (3, 8192)), ("k3_wide", (8, 53430))):
        g = windows[key]
        out[f"{tag}_solve_ms"] = cuda_ms(lambda: ba_kernel.launch(g, 2, **opts))
        out[f"{tag}_solve_iterations"] = int(ba_kernel.launch(g, 2, **opts)[3][4])
        out[f"{tag}_device_ms"], out[f"{tag}_device_records"] = per_call(device_ms_per_launch(
            torch, [lambda: ba_kernel.launch(g, 2, **opts)] * 5, ("ba_window_lm",)))
    out.update(k4_times(torch, seed, dev))
    return out


def profile_frames(torch, frames, cfg, pipeline_cls, log_cls) -> None:
    """A fresh pipeline over ``frames[1:]`` under the profiler."""
    pipe = pipeline_cls(cfg, log=log_cls(echo=False), device="cuda")
    pipe.process_frame(frames[0])

    def rest():
        for f in frames[1:]:
            pipe.process_frame(f)

    profile_call(torch, f"{len(frames) - 1} frames", rest)


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
                         "first N frames and one finalize of the global path's "
                         "map (default 0: no profile)")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only build the kernels and time K1, K3, K4a, K4b and K4d "
                         "(kernel_times), print one JSON line and exit")
    ap.add_argument("--tree", default=None, metavar="DIR",
                    help="with --kernel-times: import the port from DIR (a git archive of "
                         "another commit) instead of this checkout")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA card")
    if args.kernel_times:
        if args.tree:
            sys.path.insert(0, os.path.abspath(args.tree))
        from bundle_adjustment_tpu_torch import device as device_mod
        device_mod.set_float32_numerics()
        import bundle_adjustment_tpu_torch
        times = kernel_times(torch, args.seed, torch.device("cuda", 0))
        print(json.dumps(dict(tree=os.path.dirname(bundle_adjustment_tpu_torch.__file__),
                              card=nvidia_smi_line(), **times)))
        return 0

    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch.config import CAMERA_LEHMAN, CameraModel, preset_video
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel, ba_kernel, hamming_kernel, orb, \
        orb_kernel
    from bundle_adjustment_tpu_torch.ops.ba import BAProblem
    from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid, from_flat
    from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog, read_events
    from bundle_adjustment_tpu_torch.utils.metrics import ate_rmse
    from bundle_adjustment_tpu_torch.utils.synthetic import (
        synthetic_global_map, synthetic_global_problem, synthetic_sequence, synthetic_window)

    K4_ROLES = (ba_global_kernel.SETUP, ba_global_kernel.MATVEC, ba_global_kernel.BACKSUB,
                ba_global_kernel.COST)
    mods = types.SimpleNamespace(gk=ba_global_kernel, BAProblem=BAProblem, from_flat=from_flat,
                                 synthetic_global_problem=synthetic_global_problem)

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
          f"(per kernel: { {k: round(v, 2) for k, v in built.items()} }); registers and "
          "shared memory per kernel in ptxas's lines above")
    print(f"K3 launches one cluster of "
          f"{kernels.library_const(ba_kernel.NAME, 'ba_window_lm_cluster_size')} CTAs")

    # -- 3./4./5. kernels against their plain versions -----------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    k1 = check_knn2(torch, hamming_kernel, gen, 4000, 4000, dev)
    check_knn2(torch, hamming_kernel, gen, 1237, 3001, dev)
    budgets = orb.level_budgets(int(4000 * 1.6), 8, 1.2)
    k2 = check_gather(torch, orb_kernel, gen, 720, 1280, budgets[0], dev)
    k3 = check_window_lm(torch, np, ba_kernel, BAProblemGrid, synthetic_window,
                         so3_exp_np, args.seed, dev)
    k4 = check_global(torch, np, mods, args.seed, dev)

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

    if n_kf < 3:
        fail(f"{n_kf} keyframes, expected at least 3")
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
    for name in ("hamming_knn2", "orb_gather40", "ba_window_lm"):
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

    # an untimed second run over the same frames records the first K1 inputs
    # and every K3 window (clones), which are then replayed alone
    k1_shapes, k1_calls, k3_calls = [], [], []

    def keep_k1(a, kw):
        k1_shapes.append((a[0].shape[0], a[1].shape[0]))
        if len(k1_calls) < 12:
            k1_calls.append((tuple(t.clone() for t in a), kw))

    orig_k1 = recorded(hamming_kernel, "launch", keep_k1)
    orig_k3 = recorded(ba_kernel, "launch", lambda a, kw: k3_calls.append(
        ((BAProblemGrid(*(t.clone() for t in a[0])),) + a[1:], kw)))
    try:
        rec = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device="cuda")
        rec_statuses = drive(torch, rec, frames)["statuses"]
        rec.finalize(tempfile.mkdtemp(prefix="chip_smoke_rec_"))
        torch.cuda.synchronize()
    finally:
        hamming_kernel.launch, ba_kernel.launch = orig_k1, orig_k3
    if rec_statuses != statuses or len(k3_calls) != launches["ba_window_lm"] \
            or len(k1_shapes) != launches["hamming_knn2"]:
        fail("the recording run's statuses or K1/K3 launches differ from the main path's")
    print("K3 launches on the main path (C, P, D, n_fixed): " + ", ".join(
        f"({a[0].rvecs.shape[0]}, {a[0].cam_slot.shape[0]}, {a[0].cam_slot.shape[1]}, {a[1]})"
        for a, _ in k3_calls))
    # each recorded K1 input three times: a profile of a few short launches
    # has come back without their device records
    dev_k1 = device_ms_per_launch(torch, [lambda a=a, kw=kw: hamming_kernel.launch(*a, **kw)
                                          for a, kw in k1_calls] * 3, ("knn2",))
    # each K3 window five times alone by CUDA events (a launch of a
    # millisecond or more, so the events read the device), then all of them
    # once under the profiler, three times over: the spread of each reading
    K3_REPS = 5
    k3_each = [each_call_ms(torch, lambda a=a, kw=kw: ba_kernel.launch(*a, **kw), K3_REPS)
               for a, kw in k3_calls]
    k3_work = []                # (LM iterations, bound ms) of each window
    for a, kw in k3_calls:
        its = int(ba_kernel.launch(*a, **kw)[3][4])
        nbytes, ops = window_work(torch, a[0], a[1], its)
        k3_work.append((its, max(nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S) * 1e3))
    dev_k3 = [pooled(device_ms_per_launch(
        torch, [lambda a=a, kw=kw: ba_kernel.launch(*a, **kw) for a, kw in k3_calls],
        ("ba_window_lm",))) for _ in range(3)]

    def shown(ms, records, launches):
        return (f"{ms:.4f} ms ({records} of {launches} launches recorded)" if records
                else "not measured (no device records)")

    k1_ms, k1_records = per_call(dev_k1)
    print(f"K1 on the main path's own inputs, replayed: device time per launch "
          f"{shown(k1_ms, k1_records, 3 * len(k1_calls))} ("
          + ", ".join(f"{k[:60]} {ms:.4f}" for k, (ms, _) in dev_k1.items())
          + f") over the first {len(k1_calls)} of {len(k1_shapes)} launches, three times each "
          f"(shapes {sorted(set(k1_shapes))})")
    print(f"K3 on the main path's own windows, replayed: event ms per launch (min, median, max "
          f"of {K3_REPS}) " + "; ".join(
              f"{min(t):.4f}, {statistics.median(t):.4f}, {max(t):.4f}" for t in k3_each)
          + f"; mean of the medians {statistics.mean(statistics.median(t) for t in k3_each):.4f}"
          " ms; LM iterations and bound ms " + "; ".join(f"{i}, {b:.5f}" for i, b in k3_work)
          + f"; device time per recorded launch under the profiler in three passes: "
          + ", ".join(shown(ms, n, len(k3_calls)) for ms, n in dev_k3))
    del k1_calls, k3_calls, rec      # the clones stay out of the later phases' peak memory

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

    # -- 9. the global path at full width -------------------------------------
    N_KF, N_PT, N_OBS = 200, 30000, 120000

    def global_pipe():
        gmap, gK = synthetic_global_map(args.seed, C=N_KF, P=N_PT, obs_per_pt=4, device="cuda")
        gcam = CameraModel(fx=float(gK[0, 0]), fy=float(gK[1, 1]), cx=float(gK[0, 2]),
                           cy=float(gK[1, 2]), width=W, height=H)
        gpipe = VisualOdometryPipeline(preset_video(gcam), log=EventLog(echo=False),
                                       device="cuda")
        gmap.log = gpipe.log
        gpipe.map = gmap
        return gpipe

    def global_run():
        gpipe = global_pipe()
        glog = gpipe.log
        gout = tempfile.mkdtemp(prefix="chip_smoke_global_")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        ba_global_kernel.SOLVES.clear()
        t0 = time.perf_counter()
        gsummary = gpipe.finalize(gout)
        torch.cuda.synchronize()
        return dict(pipe=gpipe, seconds=time.perf_counter() - t0, out=gout, summary=gsummary,
                    launches=dict(kernels.LAUNCHES), peak=torch.cuda.max_memory_allocated(),
                    solves=[dict(r, cg_iterations=int(r["cg_iterations"]))
                            for r in ba_global_kernel.SOLVES],
                    events=[e for e in glog.events
                            if e["event"] in ("ba_complete", "ba_diverged")])

    t0 = time.perf_counter()
    g1 = global_run()
    g_launches = g1["launches"]
    if (g1["pipe"].map.num_keyframes, g1["pipe"].map.num_points) != (N_KF, N_PT) \
            or g1["summary"]["num_observations"] > N_OBS:
        fail(f"the global map is not {N_KF} keyframes, {N_PT} points: {g1['summary']}")
    if len(g1["events"]) != 2 or any(e["event"] != "ba_complete" for e in g1["events"]):
        fail(f"global path: expected two completed BA solves, got {g1['events']}")
    if len(g1["solves"]) != 2:
        fail(f"global path: expected two records of K4 solves, got {g1['solves']}")
    # the squared costs the two solves reached at seed 0 on one NVIDIA H100
    # with the host-driven LM loop; the kernels' sum order moves the last
    # bits, which may move an LM stop, so they are held within 1 %
    reference_sq = (38041.8, 38040.2) if args.seed == 0 else (None, None)
    for e, rec, ref, what in zip(g1["events"], g1["solves"], reference_sq,
                                 ("global BA, 199 cameras", "full BA, 200 cameras")):
        if not (math.isfinite(e["final_cost"]) and e["final_cost"] < e["initial_cost"]):
            fail(f"global path, {what}: cost not finite and reduced: {e}")
        its = e["iterations"]
        print(f"global path, {what}: squared cost {e['initial_cost']:.1f} -> "
              f"{e['final_cost']:.1f} in {its} LM iterations, {e['elapsed_s']:.3f} s; "
              f"{1e3 * rec['replay_s'] / max(rec['graph_replays'], 1):.3f} ms per replayed LM "
              f"iteration (host clock, its read of the stop flag included), the first "
              f"iteration {1e3 * rec['first_s']:.1f} ms, the capture {1e3 * rec['capture_s']:.1f} "
              f"ms; host reads {rec['host_reads']}, graph replays {rec['graph_replays']}, live "
              f"CG iterations {rec['cg_iterations']}")
        if ref is not None and abs(e["final_cost"] - ref) > 1e-2 * ref:
            fail(f"global path, {what}: squared cost {e['final_cost']} not within 1 % of {ref}")
        # the code's bound: one read of the stop flag per LM iteration, and
        # camera_index's read of the pair counts
        if rec["lm_iterations"] != its \
                or rec["host_reads"] > its + ba_global_kernel.HOST_READS_OUTSIDE_LOOP \
                or rec["graph_replays"] != its - 1:
            fail(f"global path, {what}: {its} LM iterations but the solve's record {rec}")
    for name in K4_ROLES:
        if g_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the global path")
    if any(e["event"] == "pcg_plain_solver" for e in g1["pipe"].log.events):
        fail("the global path took a plain PCG solver on the card")
    if g_launches["ba_window_lm"] != 0:
        fail("the global path launched the window LM kernel")
    lm_its = sum(e["iterations"] for e in g1["events"])
    if g_launches[K4_ROLES[0]] != lm_its or g_launches[K4_ROLES[2]] != lm_its:
        fail(f"{lm_its} LM iterations on the global path but launches {g_launches}")
    with open(f"{g1['out']}/trajectory.txt") as fh:
        g_rows = [ln for ln in fh if not ln.startswith("#")]
    g_traj = g1["pipe"].map.trajectory(True)
    if len(g_rows) != N_KF or not np.isfinite(g_traj).all():
        fail(f"global path: trajectory.txt has {len(g_rows)} rows or is not finite")
    g2 = global_run()
    ids1, poses1 = keyframe_state(np, g1["pipe"])
    ids2, poses2 = keyframe_state(np, g2["pipe"])
    if ids1 != ids2 or not np.array_equal(poses1, poses2) \
            or not np.array_equal(g1["pipe"].map.points(), g2["pipe"].map.points()) \
            or g1["launches"] != g2["launches"]:
        fail("global path: a second fresh run gives other poses, points or launch counts")
    counts = ("lm_iterations", "graph_replays", "host_reads", "cg_iterations")
    if [[r[k] for k in counts] for r in g1["solves"]] \
            != [[r[k] for k in counts] for r in g2["solves"]]:
        fail(f"global path: the second fresh run's solves differ: {g2['solves']}")
    print(f"global path: {N_KF} keyframes, {N_PT} points, "
          f"{g1['summary']['num_observations']} observations; finalize {g1['seconds']:.2f} s and "
          f"{g2['seconds']:.2f} s; {lm_its} LM iterations, "
          f"{sum(r['cg_iterations'] for r in g1['solves'])} live CG iterations, host reads "
          f"{sum(r['host_reads'] for r in g1['solves'])}, graph replays "
          f"{sum(r['graph_replays'] for r in g1['solves'])}; launches "
          f"{({k: g_launches[k] for k in K4_ROLES})}; peak device memory "
          f"{g1['peak'] / 2 ** 20:.1f} MiB; a second fresh run: poses and points bit-equal "
          f"(phase {time.perf_counter() - t0:.1f} s)")

    # -- 10. the PCG branch through a real VO run -----------------------------
    cfg_pcg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, pcg_min_cameras=3))
    log_pcg = EventLog(echo=False)
    pipe_pcg = VisualOdometryPipeline(cfg_pcg, log=log_pcg, device="cuda")
    kernels.reset_launches()
    ba_global_kernel.SOLVES.clear()
    st_pcg = []
    for f in frames:
        st_pcg.append(pipe_pcg.process_frame(f)["status"])
        if any(e["event"] == "ba_complete" for e in log_pcg.events):
            break
    torch.cuda.synchronize()
    windowed = [e for e in log_pcg.events if e["event"] == "ba_complete"]
    pcg_launches = dict(kernels.LAUNCHES)
    if not windowed:
        fail(f"pcg_min_cameras=3: no windowed BA completed in {len(frames)} frames")
    if pcg_launches["ba_window_lm"] != 0 or any(pcg_launches[k] <= 0 for k in K4_ROLES) \
            or any(e["event"] == "pcg_plain_solver" for e in log_pcg.events):
        fail(f"pcg_min_cameras=3: the windowed BA did not go through K4: {pcg_launches}")
    pipe_pcg.finalize(tempfile.mkdtemp(prefix="chip_smoke_pcg_"))
    torch.cuda.synchronize()
    traj_pcg = pipe_pcg.map.trajectory(cfg.consistent_convention)
    if not np.isfinite(traj_pcg).all() or kernels.LAUNCHES["ba_window_lm"] != 0:
        fail("pcg_min_cameras=3: trajectory not finite, or K3 launched in finalize")
    print(f"PCG branch in a VO run (pcg_min_cameras=3): {len(st_pcg)} frames, statuses "
          f"{''.join(s[0] for s in st_pcg)}, first windowed BA through K4: squared cost "
          f"{windowed[0]['initial_cost']:.1f} -> {windowed[0]['final_cost']:.1f} in "
          f"{windowed[0]['iterations']} LM iterations, {windowed[0]['elapsed_s'] * 1e3:.0f} ms; "
          f"{pipe_pcg.map.num_keyframes} keyframes, trajectory finite; launches "
          f"{({k: kernels.LAUNCHES[k] for k in K4_ROLES})}; {len(ba_global_kernel.SOLVES)} K4 "
          f"solves, graph replays {[r['graph_replays'] for r in ba_global_kernel.SOLVES]}")
    if not any(r["graph_replays"] > 0 for r in ba_global_kernel.SOLVES):
        fail("pcg_min_cameras=3: no K4 solve replayed its LM graph")
    if "jax" in sys.modules:
        fail("the port imported jax")

    if args.profile:
        profile_frames(torch, frames[: args.profile], cfg, VisualOdometryPipeline, EventLog)
        gpipe = global_pipe()
        profile_call(torch, f"finalize of the {N_KF}-keyframe map",
                     lambda: gpipe.finalize(tempfile.mkdtemp(prefix="chip_smoke_prof_")))

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
    ] + [
        dict(name=role, route="cuda",
             source="bundle_adjustment_tpu_torch/csrc/ba_global_pcg.cu",
             replaces=f"bundle_adjustment_tpu/ops/ba_global_pallas.py:{line}",
             launches=g_launches[role], library_ms=None, **k4[role])
        for role, line in zip(K4_ROLES, (339, 522, 583, 621))
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
