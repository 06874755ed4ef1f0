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
5. the main path: the port's numpy-rendered strafe sequence at 1280 x 720,
   ``preset_video`` (4000 features, 8 levels) with the camera fitted to the
   render and ``BAConfig(use_pallas_ba=False)``, through
   ``VisualOdometryPipeline.process_frame`` and ``finalize``, with the
   kernels' launch counters set to 0 just before and read just after;
6. what came out: keyframes, map points, BA results, trajectory against the
   ground truth, outputs on disk.

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
        if e.device_type == DeviceType.CUDA and ("knn2_kernel" in e.key
                                                 or "gather40_kernel" in e.key):
            print(f"{e.key[:60]}: {e.count} launches, device time "
                  f"{e.self_device_time_total / max(e.count, 1) / 1e3:.4f} ms each")


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
    from bundle_adjustment_tpu_torch.ops import hamming_kernel, orb, orb_kernel
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog, read_events
    from bundle_adjustment_tpu_torch.utils.metrics import ate_rmse
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_sequence

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

    # -- 3./4. kernels against their plain versions --------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    k1 = check_knn2(torch, hamming_kernel, gen, 4000, 4000, dev)
    check_knn2(torch, hamming_kernel, gen, 1237, 3001, dev)
    budgets = orb.level_budgets(int(4000 * 1.6), 8, 1.2)
    k2 = check_gather(torch, orb_kernel, gen, 720, 1280, budgets[0], dev)

    # -- 5. the main path ----------------------------------------------------
    W, H = 1280, 720
    t0 = time.perf_counter()
    frames, K, gt_C, _ = synthetic_sequence(
        n_frames=args.frames, width=W, height=H, fx=CAMERA_LEHMAN.fx,
        seed=args.seed, motion="strafe")
    print(f"rendered {len(frames)} frames {W}x{H} in "
          f"{time.perf_counter() - t0:.1f} s")
    cam = CameraModel(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                      cy=float(K[1, 2]), width=W, height=H)
    base = preset_video(cam)
    cfg = dataclasses.replace(base, ba=dataclasses.replace(base.ba, use_pallas_ba=False))
    log = EventLog(echo=False)
    pipe = VisualOdometryPipeline(cfg, log=log, device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    frame_ms, frame_of_kf, statuses = [], {}, []
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        r = pipe.process_frame(f)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        statuses.append(r["status"])
        if r["status"] in ("initialized", "keyframe"):
            frame_of_kf[r["kf_id"]] = i
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    summary = pipe.finalize(out_dir)
    torch.cuda.synchronize()
    finalize_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()

    # -- 6. what came out ----------------------------------------------------
    n_kf = pipe.map.num_keyframes
    n_pts = pipe.map.num_points
    events = read_events(f"{out_dir}/events.jsonl")
    n_ba = sum(1 for e in events if e["event"] == "ba_complete")
    gba = summary["global_ba"] or {}
    final_cost = float(gba.get("final", float("nan")))
    traj = pipe.map.trajectory(cfg.consistent_convention)
    gt = np.stack([gt_C[frame_of_kf[k]] for k in pipe.map.sorted_kf_ids()])
    ate = ate_rmse(traj, gt, with_scale=True)
    scale = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    fm = np.asarray(frame_ms)
    print(f"statuses: {''.join(s[0] for s in statuses)} "
          "(i=initialized k=keyframe t=tracked d=discarded)")
    print(f"per-frame ms: median {np.median(fm):.1f}, p90 "
          f"{np.percentile(fm, 90):.1f}, first {fm[0]:.1f}, max {fm.max():.1f}; "
          f"finalize {finalize_s:.2f} s")
    slowest = np.argsort(-fm)[:4]
    print("slowest frames: " + ", ".join(
        f"#{i} {statuses[i]} {fm[i]:.1f} ms" for i in slowest))
    print(f"keyframes {n_kf}, map points {n_pts}, observations "
          f"{pipe.map.num_observations}, ba_complete events {n_ba}, final BA "
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
    if "jax" in sys.modules:
        fail("the port imported jax")
    ba_s = sum(e.get("elapsed_s", 0.0) for e in events
               if e["event"] in ("ba_complete", "ba_diverged"))
    print(f"time in BA solves (events' elapsed_s): {ba_s:.2f} s of "
          f"{fm.sum() / 1e3 + finalize_s:.2f} s for all frames and finalize")
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
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
