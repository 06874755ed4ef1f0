#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bundle_adjustment_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--frames 40] [--seed 0] [--profile N]
    python3 chip_smoke.py --kernel-times [--tree DIR]

Phases, each of which exits non-zero when it fails:

1. the card's name and power limit, torch and CUDA versions, TF32 flags;
2. build every CUDA kernel of the port from ``bundle_adjustment_tpu_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all at once; the four roles of
   K4 share one source), and the host runtime ``csrc/ba_host.cpp`` with g++;
3. K1, the Hamming 2-NN kernel, against its plain PyTorch version on the
   card at 4000 x 4000 (invalid train slots, planted ties) and at a ragged
   size: exact equality; kernel and plain times from CUDA events, the
   kernel's device time under the profiler;
4. K2, the ORB patch gather, against its plain version on a 1280 x 720
   level with 2067 keypoints, edge starts included: exact equality;
5. K3, the window LM solve, against its plain version on seeded synthetic
   windows: one LM iteration and a full solve at the main path's shape
   (C = 5, n_fixed = 2, P = 8192), at C = 9 / n_fixed = 1 (6C' = 48) with a
   ragged P, at D = 12, at the widest window the gate admits (C = 10,
   n_fixed = 2, P = 53,430) and at D = 15 (each observation in 3 slots),
   all with padding points and dead slots; one point
   on a camera centre; two launches bit-equal; times per solve and per LM
   iteration from CUDA events, at the main shape and at the widest window;
5b. K4, the four global-BA PCG roles (setup, matvec, backsub, cost), each
   against its plain version at the global path's shape (200 cameras, 30,000
   points bucketed to P = 32,768, D = 4, n_fixed = 2) and at a ragged one
   (37 cameras, P = 1777, dead slots, n_fixed = 1), norm-wise; the whole
   solve against ``solve_plain``; two launches and two solves bit-equal;
   times per launch from CUDA events; then the same checks on rings of 280
   cameras and 30,000 points seen by D = 14, 54 and 91 keyframes each (the
   long drive's slot counts, past the TPU's 12-slot gate), each group held
   to ``K4_BOUNDS`` against the float32 plain version and, where it misses
   them, against float64;
6. the main path through its CLI: the port's rendered strafe sequence
   at 1280 x 720, written as a folder of PNG files (the port's
   standard-library encoder and decoder, ``utils/io``), through
   ``run.main(["--preset", "video", "--images", ...])`` with the camera
   fitted to the render (``preset_video``: 4000 features, 8 levels, the
   default ``BAConfig``), pipelined (``process_stream``), ``--no-pipelined``
   and pipelined again (the first run pays the process's first uses), the
   kernels' launch counters set to 0 just before each and read just after:
   statuses, keyframe ids and poses bit-equal between the three; per-frame median and p90, frames per second; the
   tracked-frame step's graph captures (one) and replays (one per frame past
   the first, plus the dropped speculative steps when pipelined), one host
   read per tracked frame, K1 and K2 counted once per replay; keyframes, map
   points, BA results, trajectory against the ground truth, outputs on
   disk.  6b: on the first tracked frames a replay's ``packed``,
   ``insert_packed`` and ``kp_desc`` equal eager ``track_step``'s bit for
   bit; eager ``track_step``'s ms per call, split by stage, beside one
   dispatch of the graph.  6c: the first tracked frame of the CLI in two
   fresh processes, without and with ``--prewarm``.  Then an untimed run
   over the same frames records the inputs of K1 (outside the capture) and
   K3, must give the same statuses, and prints the shapes of its K3 launches
   and the time per launch of K1 and K3 on those inputs, each replayed
   several times (the spread of CUDA-event times, and the device time under
   the profiler);
7. the earlier path, ``BAConfig(use_pallas_ba=False)`` (the grid solver), on
   the same frames until its first windowed BA completes;
8. determinism: the first 12 frames through two fresh pipelines (each
   tracked frame a replay of its own graph) give equal statuses, keyframe
   ids and keyframe poses, bit for bit;
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
   ``finalize``;
11. ``preset_lehman_indoor`` as it ships (1280 x 720, 4000 features, 8
   levels, the default ``BAConfig``, relocalization, culling and loop
   closure on), the launch counters set to 0 just before each part and read
   just after: (a) the first 150 of 600 frames of the room
   (``synthetic_sequence(motion="room")``, rendered on the card, written as
   PNG files; all 600 at first, then 300, cut for the script's time limit)
   through
   ``run.main(["--preset", "lehman_indoor", ...])`` with the camera fitted,
   pipelined: per-frame median and p90, frames per second, keyframes, live
   and culled points, relocalizations, ``loop_reject`` counts by stage,
   closures, ATE over the path extent, launches of K1 to K4, the polish BAs'
   LM iterations and host reads, peak memory, the window and pose-refine
   solves by solver, and each global solve (the closure polishes and
   finalize's two: (C, P, D), LM iterations, the test that stopped it,
   seconds, K4 launches), none on the plain solver and each through all four
   K4 roles, beside the numbers of the runs on the plain solvers; (a2) the
   same with
   ``--consistent-convention``, as the JAX package's own long-sequence
   harness runs the preset; (a)'s final global BA and (a2)'s largest
   polish solved again by the plain grid PCG solver on the card (one LM
   iteration within 1 %, K4's capped solve at most 1 % above it and within
   1 % of the grid solver's in float64 or at most twice as far from it as
   the float32 grid solver's), and
   (a2)'s first window past 12 slots by K3 against its plain version; each
   run held to ``LEHMAN_BOUNDS`` (keyframes,
   ATE, closures), (a2) to the 360 keyframes and 5 closures it makes with
   every solve through K3 and K4 (``LEHMAN_DECISIONS``), and K1's first launch
   against a bank of more than 8000 descriptors held to the plain version
   exactly; (b) a closure that always happens: the drifted ring of
   ``tests/test_loop_closure.py`` with as many keyframes as (a) made over
   600 frames (542), 4000 keypoints each, through ``try_close_loop``:
   anchor 0, the scale within 0.05 of 1/s, points fused, the polish BA
   through K4, whose four roles on the polish's problem are then held
   against their plain versions in float32, and where a group misses its
   bound in float64
   (``check_k4_roles``); (c) forced relocalizations after blackout frames,
   one with a bank above ``reloc_ann_threshold`` (the coarse-to-fine
   search, no K1 launch) and one at most at it (one K1 launch, its inputs
   held to the plain version exactly); (d) the CLI with ``--checkpoint`` and
   ``--consistent-convention`` over the first 450 frames, then over all
   600: keyframe ids, poses and the loop and relocalization events
   bit-equal to (a2)'s;
12. the native observation table and the parallel paths: (a) on phase 9's
   200-keyframe map and on (a2)'s final map, ``gather_window`` of every
   window a drive over it runs (each window BA, pose refine and final
   window) with the C++ mirror and with the numpy table: equal rows,
   map-point ids and problems, ms per call of both;
   ``voxel_downsample_native`` equal to ``utils.io.voxel_downsample`` on
   (a2)'s cloud; a ``finalize`` with ``export_voxel=0.05`` writes the
   voxelized PCD.  (b) two ranks on the one card (``parallel.launch.
   run_ranks``; the backend NCCL would refuse two ranks on one device, so
   gloo): 1. the main path's last window point-sharded, within 1e-3 of the
   single-rank plain solve, the ranks bit-equal; 2. ``finalize`` of the
   200-keyframe map with ``mesh_shape=(1, 2)`` (the flat PCG, one
   ``all_reduce`` per CG iteration) within 1 % of phase 9's costs; 3.
   ``run_partitioned_global_ba`` over (win 2, pt 1), bit-equal to the two
   windows solved alone and reconciled on one rank; 4. ``match_sharded``
   and ``match_ring`` at 4000 x 16,000 equal to one K1 call (rank 1's ring
   at equal distances), one and two K1 launches per rank; 5. the CLI with
   ``--multihost --mesh 2`` over phase 6's frames in two ranks: the ranks
   bit-equal, keyframes and ATE within phase 6's bounds, K1 and K2 through
   the graph on each rank.  Prints the backend, world size, ranks per card,
   each part's seconds and the ``all_reduce`` calls per sharded LM
   iteration.

13. ``--debug``, the run's plots, log analytics and the cv2 features: (a)
   the CLI with ``--debug`` over phase 6's 40 frames, the launch counters set
   to 0 just before and read just after: every artifact the JAX package's
   debug run writes (``debug_keyframes/``, ``debug_matches/``,
   ``debug_depth/``, ``debug_sparsity/``, ``trajectory_2d/``,
   ``trajectory_3d/``, ``lba_steps/``; the three videos, or where cv2 is
   not installed the ``debug_videos_skipped`` event and summary field that
   name them), each PNG decoded by ``utils/io.read_png`` at its size, a ring
   pixel changed at every drawn keypoint, ``trajectory.txt`` bit-equal to
   phase 6's, K1, K2 and K3 launched; (b) ``utils/analyze_log`` over (a)'s
   ``events.jsonl``: its counts equal those tallied from the events, the
   plot written; (c) ``features_source="cv2"``: without cv2 the
   constructor raises naming it, with cv2 12 frames through the staged
   path with K1 launched; (d) one line of JSON: the host ms per keyframe of
   the debug drawing and encoding in (a) (each call timed to a
   synchronise), per window of the sparsity spy and the map PCD, of the
   videos, the wall ms per keyframe added against phase 6's run, and the
   last keyframe's drawing redone alone: host ms (the PNG encoding's share
   apart), device ms under the profiler, two draws' files equal, and its
   overlays drawn on the card and on the CPU within one intensity level.

14. the stress harness (``bundle_adjustment_tpu_torch.tools.stress``) on the
   JAX package's seed-2 cell, its committed 600-frame video
   ``.dedup_study/s2_d3_cpu/sequence.mp4`` read as it is (cv2), flag for
   flag as the JAX harness ran it: the result's keys beside the JAX cell's,
   each global solve's (C, P, D), LM iterations and stop test; fails on a
   crash, a non-finite ATE, a ``pcg_plain_solver`` event or a global solve
   without K4 (the one seed's ATE is not gated); then the study over the JAX
   cells' five seeds (``tools.dedup_study --seeds 2 3 4 5 6 --dedup 3
   --against .dedup_study``, seed 2 read from the run above, the four
   others as four processes at once): each seed beside the JAX cell, and
   the study's gate, the port's five-seed mean ATE over the path length at
   most the JAX cells' worst seed (12.51 %), no cell failed;
15. the global scale sweep (``tools.global_scale_sweep``) at C = 2048 and on
   a 91-slot ring of 280 cameras and 120,000 points: per size LM and CG
   iterations, ms per replayed LM iteration, each K4 role's ms beside its
   bound, peak memory.  Then the seconds of every phase.

``--kernel-times [--tree DIR]`` only builds and times K1, K3 and K4's setup,
matvec and cost (``kernel_times``: K3 per LM iteration over a sweep of C' and
P as well; K4a, K4b and K4d at the global path's shape) on this checkout or
on another commit's tree, for comparing two commits in one call.

``--routes NAME [NAME ...]`` only drives phase 11's run (a2) under the named
routings of its solves (``ROUTES``): K3's and K4's gates each held to the
TPU's 12 slots again (a window past them takes the grid solver, a global
solve the plain PCG solvers), or K3's windows past 12 slots through K3's
plain version on the card; per routing keyframes, closures, ATE, the
longest frame, ``finalize``, the solves by solver and each global solve.
About four minutes per routing on one H100.

The line before the last is the kernels' JSON record (``launches``: the
main path's, phase 6, for K1 to K3 and the global path's, phase 9, for K4;
``launches_lehman_indoor``: phase 11's run (a); ``launches_parallel``: rank
0's in phase 12 (b) 4 and 5; ``launches_debug``: phase 13 (a);
``launches_lehman_a2``: phase 11's run (a2); ``launches_stress``: phase
14), the line
before that the
card's name and power limit; the last line is the ``{"ok": true, ...}``
record.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib.util
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


def near_float64(gaps: dict, plain_gaps: dict, bounds: dict) -> dict:
    """The float64 test, for the groups of a kernel's output whose gap to
    the float32 plain version passes its bound (a sum of so many terms that
    float32 rounding alone passes it): a group passes when the kernel's gap
    to the plain version in float64 is within its bound, or at most twice
    the float32 plain version's gap to float64.  Each argument maps a
    group's label to its number; returns the groups that fail, label ->
    (kernel gap, plain gap, bound)."""
    return {k: (gaps[k], plain_gaps[k], bounds[k]) for k in gaps
            if not (gaps[k] <= bounds[k] or gaps[k] <= 2 * plain_gaps[k])}


def check_window_lm(torch, np, ba_kernel, grid_cls, synthetic_window, so3_exp_np,
                    seed: int, dev) -> dict:
    """K3 against its plain version on seeded synthetic windows."""

    from bundle_adjustment_tpu_torch.utils.synthetic import repeat_slots

    def window(seed_, repeat=1, **kw):
        w = synthetic_window(seed_, **kw)
        if repeat > 1:
            w = repeat_slots(w, repeat, seed_)
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
        # past the TPU's 12 slots: each observation in 3 slots (a keyframe
        # seeing a point through several keypoints, as the long drive's are)
        ("C=5 n_fixed=2 P=8192 D=15 (each observation in 3 slots)", 2,
         dict(C=5, n_pts=6000, P=8192, D=5, repeat=3)),
    ]
    # the windows whose one-iteration gaps past the bounds below are held to
    # the plain version in float64 (``near_float64``: three times the terms
    # per sum)
    f64_ref = {shapes[-1][0]}
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
        errs = dict(rvecs=e_rv, tvecs=e_tv, points=e_pt, costs=e_cost)
        bounds = dict(rvecs=1e-5, tvecs=1e-5, points=1e-4, costs=1e-5)
        missed = [k for k in errs if not errs[k] <= bounds[k]]
        if missed and name in f64_ref:
            g64 = grid_cls(*(t.double() if t.is_floating_point() else t for t in g))
            r64 = ba_kernel.lm_solve_plain(g64, n_fixed=n_fixed, max_iterations=1)
            torch.cuda.synchronize()

            def gaps(x):
                return {k: v for k, v in zip(errs, (
                    float((x[0].double() - r64[0]).abs().max()),
                    float((x[1].double() - r64[1]).abs().max()),
                    float((x[2].double() - r64[2]).abs().max()),
                    float(np.max(np.abs(costs(x[3]) - costs(r64[3])) / np.abs(costs(r64[3])))))
                    ) if k in missed}

            ka, pa = gaps(a), gaps(b)
            print(f"K3 {name}: one iteration against float64, kernel / float32 plain: "
                  + " ".join(f"{k} {ka[k]:.2e} / {pa[k]:.2e}" for k in missed))
            over = near_float64(ka, pa, bounds)
            if over:
                fail(f"K3 {name}: one iteration further from float64 than its bounds and "
                     f"than twice the float32 plain version: (kernel gap, plain gap, bound) "
                     f"{over}")
        elif missed:
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


#: phase 5b's rings at the long drive's slot counts (finalize's D = 14 and 54
#: in run (a), 91 in (a2); the closure polishes' 73 to 91)
RING_CAMS, RING_POINTS, RING_SLOTS = 280, 30000, (14, 54, 91)


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


def check_k4_roles(torch, np, gk, g, n_fixed: int, seed: int, name: str,
                   against_f64: bool = False):
    """K4: each role launched once on the grid ``g`` and held against its
    plain version on the card.  Every output is compared in groups of one
    scale, each by its largest absolute difference over the group's largest
    absolute value: a camera's rotation lanes are larger than its
    translation lanes by the scene's depth, and the 54 lanes of the setup
    reduction span five orders of magnitude, so one norm over a whole output
    would hide an error as large as its small lanes.  The groups are Y's
    rotation and translation rows, V^-1, z_p, the ten groups of
    ``ba_global_kernel.red_lane_groups``, the matvec's rotation and
    translation lanes, dp, and each of the two costs.  The gaps are printed
    and held to ``K4_BOUNDS``.

    ``against_f64``: for a problem whose float32 rounding alone can exceed
    those bounds (a near-converged one, whose pixel residuals of a hundredth
    of a pixel are differences of two numbers near 600; the long drive's
    slot counts, where a camera sums thousands of pairs, in another order in
    each version), a group that misses its bound against the float32 plain
    version is held to the float64 test instead (``near_float64``, against
    the plain version in float64 on the same inputs).  Returns the launch's inputs and
    outputs, each role's max abs error and the groups held to float64, as a
    namespace."""
    C = g.rvecs.shape[0]
    lay = gk.layout(g)
    index = gk.camera_index(lay.slotT, lay.maskT, C, n_fixed)
    ptT = g.points.T.contiguous()
    scal = gk.with_lambda(lay.scal, 1e-3)
    cam = gk.camera_rows(g.rvecs, g.tvecs, True)
    camc = gk.camera_rows(g.rvecs, g.tvecs, False)
    x = torch.as_tensor(np.random.default_rng(seed).normal(0, 1e-2, (C - n_fixed, 6))
                        .astype(np.float32), device=g.rvecs.device)

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
    if against_f64:
        f64 = torch.float64
        ptT64, maskT64, uvT64 = ptT.to(f64), lay.maskT.to(f64), lay.uvT.to(f64)
        YT64, VinvT64, x64 = YT.to(f64), VinvT.to(f64), x.to(f64)
        outs64 = {
            "ba_global_setup": gk.setup_plain(cam.to(f64), ptT64, lay.slotT, maskT64, uvT64,
                                              lay.pmask.to(f64), scal.to(f64), n_fixed),
            "ba_global_matvec": (gk.matvec_plain(YT64, VinvT64, lay.slotT, maskT64, x64,
                                                 n_fixed),),
            "ba_global_backsub": (gk.backsub_plain(YT64, VinvT64, zpT.to(f64), lay.slotT,
                                                   maskT64, x64, n_fixed),),
            "ba_global_cost": (gk.cost_plain(camc.to(f64), ptT64, lay.slotT, maskT64, uvT64,
                                             lay.scal.to(f64)),),
        }
    torch.cuda.synchronize()
    D = lay.slotT.shape[0]

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

    errs, to_f64 = {}, []
    for role, (outs_k, outs_p) in outs.items():
        errs[role] = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_p))
        if not all(bool(torch.isfinite(a).all()) for a in outs_k):
            fail(f"K4 {role} {name}: non-finite output")
        pk, pp = parts(role, outs_k), parts(role, outs_p)
        gaps = {k: rel(pk[k][0], pp[k][0]) for k in pk}
        print(f"K4 {role} {name}: relative err " + " ".join(
            f"{k} {v:.2e}" for k, v in gaps.items()) + f", max abs err {errs[role]:.3e}")
        missed = [k for k, v in gaps.items() if not v <= pk[k][1]]
        if against_f64 and missed:
            to_f64 += [f"{role}.{k}" for k in missed]
            p64 = parts(role, outs64[role])
            ka = {k: rel(pk[k][0], p64[k][0]) for k in missed}
            pa = {k: rel(pp[k][0], p64[k][0]) for k in missed}
            print(f"K4 {role} {name}: relative err to float64, kernel / float32 plain " + " ".join(
                f"{k} {ka[k]:.2e} / {pa[k]:.2e}" for k in missed))
            over = near_float64(ka, pa, {k: pk[k][1] for k in missed})
            if over:
                fail(f"K4 {role} {name}: further from float64 than its bound and than twice "
                     f"the float32 plain version: (kernel gap, plain gap, bound) {over}")
            continue
        over = {k: (gaps[k], pk[k][1]) for k in missed}
        if over:
            fail(f"K4 {role} {name}: differs from the plain version: (relative gap, "
                 f"bound) {over}")
    return types.SimpleNamespace(lay=lay, index=index, ptT=ptT, cam=cam, camc=camc, x=x,
                                 run_setup=run_setup, ks=ks, YT=YT, VinvT=VinvT, zpT=zpT,
                                 outs=outs, errs=errs, to_f64=to_f64)


def check_global(torch, np, mods, seed: int, dev) -> dict:
    """K4: each role against its plain version on the card
    (``check_k4_roles``) at two shapes; two launches on one input, and two
    solves of one problem, equal bits; the solve against ``solve_plain``.
    Returns role -> the kernels line's numbers at the full-width shape."""
    gk = mods.gk

    def ring(D):
        pr = mods.synthetic_ring_problem(seed + 5, C=RING_CAMS, P=RING_POINTS, D=D)
        return mods.from_flat(mods.BAProblem(**{k: torch.as_tensor(v, device=dev)
                                                for k, v in pr.items()}))

    shapes = [   # name, the grid, its live points, n_fixed, against_f64
        ("C=200 n_fixed=2 P=32768 D=4", lambda: global_grid(
            torch, mods, seed + 3, 200, 30000, 32768, 0.0, dev), 30000, 2, False),
        ("C=37 n_fixed=1 P=1777 D=4, 15 % dead slots", lambda: global_grid(
            torch, mods, seed + 3, 37, 1531, 1777, 0.15, dev), 1531, 1, False),
    ] + [(f"ring C={RING_CAMS} n_fixed=1 P={RING_POINTS} D={D}", functools.partial(ring, D),
          RING_POINTS, 1, True) for D in RING_SLOTS]
    records = None
    t_ring = time.perf_counter()
    for name, make, n_pts, n_fixed, mode in shapes:
        g = make()
        r = check_k4_roles(torch, np, gk, g, n_fixed, seed, name, against_f64=mode)
        lay, index, ptT, camc, x, run_setup = r.lay, r.index, r.ptT, r.camc, r.x, r.run_setup
        ks, YT, VinvT, zpT, outs, errs = r.ks, r.YT, r.VinvT, r.zpT, r.outs, r.errs
        if mode:
            print(f"K4 {name}: groups held to float64 (past K4_BOUNDS against the float32 "
                  f"plain version): {r.to_f64 or 'none'}")
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
        if mode:
            print(f"K4 {name}: checked in {time.perf_counter() - t_ring:.1f} s")
            t_ring = time.perf_counter()

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
        work = gk.role_work(g, n_fixed)
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


def cli_args(folder: str, K, W: int, H: int, preset: str = "video") -> list:
    """``run.main``'s arguments for ``preset`` with the camera fitted to the
    render."""
    return ["--preset", preset, "--images", folder, "--fx", repr(float(K[0, 0])),
            "--fy", repr(float(K[1, 1])), "--cx", repr(float(K[0, 2])), "--cy",
            repr(float(K[1, 2])), "--size", f"{W}x{H}"]


def write_pngs(folder: str, frames) -> None:
    """``frames`` as ``folder``/00000.png, ... with the port's standard-library
    encoder (no cv2 needed; zlib releases the interpreter lock: eight
    threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from bundle_adjustment_tpu_torch.utils.io import write_png

    os.makedirs(folder, exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        for fut in [pool.submit(write_png, os.path.join(folder, f"{i:05d}.png"), f)
                    for i, f in enumerate(frames)]:
            fut.result()


def run_cli(torch, argv: list, keep: tuple = (), main=None, run_dir: str = None) -> dict:
    """``run.main(argv)`` (or ``main(argv)``) with the launch counters and
    the global solves' records set to 0 just before and read just after;
    the pipeline it ran, kept by wrapping ``finalize``, with the number of
    global solves made before ``finalize``.  Every solve above
    ``pcg_min_cameras`` cameras (``_solve_pcg``: the closure polishes and
    finalize's two) is recorded with its (C, P, D), seconds, LM iterations,
    stop test, costs, K4 launches and whether finalize made it
    (``pcg``); ``keep`` names the solves whose grid and solver arguments
    are kept (``kept``), to be solved again: "polish", the largest closure
    polish (by P * D, its grid one-hot within ``GRID_ONEHOT_MAX``), and
    "finalize", finalize's global BA.  What the CLI prints (its event log's
    lines) goes to ``OUT.stdout.txt`` beside its output folder.  ``main``
    and ``run_dir``: a harness that calls ``run.main`` with ``run_dir`` as
    its output folder."""
    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch import run as run_mod
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.ops import ba, ba_global_kernel
    from bundle_adjustment_tpu_torch.utils.event_log import read_events

    k4 = (ba_global_kernel.SETUP, ba_global_kernel.MATVEC, ba_global_kernel.BACKSUB,
          ba_global_kernel.COST)
    out = argv[argv.index("--out") + 1]
    kept, pcg, problems, fin = [], [], {}, {}
    orig = VisualOdometryPipeline.finalize

    def finalize(self, *a, **kw):
        kept.append((self, len(ba_global_kernel.SOLVES)))
        t = time.perf_counter()
        try:
            return orig(self, *a, **kw)
        finally:
            fin["seconds"] = time.perf_counter() - t

    VisualOdometryPipeline.finalize = finalize
    orig_pcg = VisualOdometryPipeline._solve_pcg

    def solve_pcg(self, grid, problem, n_fixed, n_cams, solver_kwargs):
        before = {k: kernels.LAUNCHES[k] for k in k4}
        t = time.perf_counter()
        res = orig_pcg(self, grid, problem, n_fixed, n_cams, solver_kwargs)
        st = res[3]
        P, D = grid.cam_slot.shape
        rec = dict(C=n_cams, P=P, D=D, n_fixed=n_fixed, seconds=time.perf_counter() - t,
                   finalize=bool(kept), iterations=int(st.iterations),
                   stop=ba.STOP_TESTS[int(st.stop)], initial_cost=float(st.initial_cost),
                   final_cost=float(st.final_cost), initial_sq=float(st.initial_sq),
                   final_sq=float(st.final_sq),
                   k4={k: kernels.LAUNCHES[k] - before[k] for k in k4})
        pcg.append(rec)
        if "finalize" in keep and kept and "finalize" not in problems:
            problems["finalize"] = (grid, n_fixed, dict(solver_kwargs), rec)
        elif "polish" in keep and not kept \
                and 4 * P * D * (n_cams - n_fixed) <= GRID_ONEHOT_MAX \
                and ("polish" not in problems
                     or P * D > problems["polish"][0].cam_slot.numel()):
            problems["polish"] = (grid, n_fixed, dict(solver_kwargs), rec)
        return res

    VisualOdometryPipeline._solve_pcg = solve_pcg
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        ba_global_kernel.SOLVES.clear()
        t0 = time.perf_counter()
        with open(out.rstrip("/") + ".stdout.txt", "w") as fh, contextlib.redirect_stdout(fh):
            summary = (main or run_mod.main)(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        VisualOdometryPipeline.finalize = orig
        VisualOdometryPipeline._solve_pcg = orig_pcg
    return dict(out=out, summary=summary, pipe=kept[0][0], launches=launches,
                peak=torch.cuda.max_memory_allocated(), seconds=seconds,
                frames=frame_records(read_events, run_dir or out),
                solves=[dict(r, cg_iterations=int(r["cg_iterations"]))
                        for r in ba_global_kernel.SOLVES],
                solves_before_finalize=kept[0][1], pcg=pcg, kept=problems,
                finalize_s=fin["seconds"])


def frame_records(read_events, out: str) -> list:
    """The ``frame_timing`` events of a CLI run, each with ``wall_ms``: the
    wall time since the previous frame's result (the first frame's own
    time for the first)."""
    recs = [e for e in read_events(f"{out}/events.jsonl") if e["event"] == "frame_timing"]
    for i, e in enumerate(recs):
        e["wall_ms"] = e["total_ms"] if i == 0 else (e["t"] - recs[i - 1]["t"]) * 1e3
    return recs


def bit_equal(torch, a, b) -> bool:
    """Equal bits, NaNs included (``torch.equal`` calls two NaNs unequal)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def step_check_and_times(torch, np, pipe_cls, cfg, frames, log_cls, n_check: int = 3) -> dict:
    """A fresh pipeline's first frame, then on each of the next ``n_check``
    frames one replay of the tracked-frame graph against eager
    ``track_step`` on the same static inputs (``packed``, ``insert_packed``,
    ``kp_desc``; fails on any difference); then the ms per call of eager
    ``track_step`` (whole, and split by stage with a synchronise around
    each) and of one replay, host clock to a synchronise, median of 5."""
    from bundle_adjustment_tpu_torch.models import frontend
    from bundle_adjustment_tpu_torch.models.pipeline import bgr_to_gray
    from bundle_adjustment_tpu_torch.ops import ransac

    pipe = pipe_cls(cfg, log=log_cls(echo=False), device="cuda")
    pipe.process_frame(frames[0])
    step = pipe.track
    u = step.u_buffer(ransac.pnp_draw_shape(cfg.pnp_iters))
    for i in range(1, n_check + 1):
        gray = bgr_to_gray(frames[i])
        res = pipe._fused_dispatch(gray, i)
        eager = frontend.track_step(step._images[gray.shape], step.state, step._K, u,
                                    **pipe.track_args(*gray.shape))
        torch.cuda.synchronize()
        for name in ("packed", "insert_packed", "kp_desc"):
            a, b = getattr(res, name), getattr(eager, name)
            if not bit_equal(torch, a, b):
                fail(f"frame {i}: the graph replay's {name} differs from eager track_step by "
                     f"up to {(a.double() - b.double()).abs().max().item()}")

    def median_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    args = (step._images[gray.shape], step.state, step._K, u)
    kw = pipe.track_args(*gray.shape)
    times = dict(eager_ms=median_ms(lambda: frontend.track_step(*args, **kw)),
                 replay_ms=median_ms(lambda: pipe._fused_dispatch(gray, n_check)))
    stages = {"orb extract": (frontend.orb, "extract"), "match": (frontend.hamming, "match"),
              "pnp ransac + polish": (frontend.ransac, "estimate_pnp_pose")}
    spent = {k: [] for k in stages}
    originals = {}
    for name, (mod, attr) in stages.items():
        originals[name] = getattr(mod, attr)

        def timed(*a, _f=originals[name], _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _f(*a, **k)
            torch.cuda.synchronize()
            spent[_name].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(mod, attr, timed)
    try:
        total = median_ms(lambda: frontend.track_step(*args, **kw))
    finally:
        for name, (mod, attr) in stages.items():
            setattr(mod, attr, originals[name])
    split = {k: statistics.median(v) for k, v in spent.items()}
    split["the rest"] = total - sum(split.values())
    times["split_ms"] = split
    times["split_total_ms"] = total
    return times


def fresh_process_first_frames(out_root: str, folder: str, K, W: int, H: int) -> dict:
    """The CLI over ``folder`` in two fresh processes, without and with
    ``--prewarm``: each run's first tracked frame's ms (frame 1), the
    prewarm's seconds, and each process's wall seconds."""
    from bundle_adjustment_tpu_torch.utils.event_log import read_events

    out = {}
    for tag, extra in (("cold", []), ("prewarm", ["--prewarm"])):
        o = os.path.join(out_root, f"fresh_{tag}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "bundle_adjustment_tpu_torch.run"]
                              + cli_args(folder, K, W, H) + ["--out", o] + extra,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"the CLI in a fresh process ({tag}) failed:\n{proc.stderr[-3000:]}")
        recs = frame_records(read_events, o)
        warm = [e for e in read_events(f"{o}/events.jsonl") if e["event"] == "prewarm"]
        out[tag] = dict(first_tracked_ms=recs[1]["total_ms"], frame0_ms=recs[0]["total_ms"],
                        process_s=time.perf_counter() - t0,
                        prewarm_s=warm[0]["prewarm_s"] if warm else None)
    return out


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


#: the lehman_indoor drive: the room render's length and seed (the JAX
#: package's tools/stress.py defaults), and the frames of the checkpointed
#: first run of (d)
LEHMAN_FRAMES, LEHMAN_SEED, LEHMAN_HEAD = 600, 2, 450
#: run (a)'s frames: the first half of the room (the whole script's time
#: limit), and the drifted ring's keyframes of (b): (a)'s count over all 600
#: frames (run 8e)
LEHMAN_A_FRAMES, RING_KEYFRAMES = 150, 542
#: the largest (C', P*D) float32 one-hot of a closure polish that phase 11
#: solves again with the plain grid PCG solver
GRID_ONEHOT_MAX = 8 << 30
#: the solves of phase 11's runs held to the plain grid PCG solver: (a2)'s
#: largest polish that fits, and (a)'s final global BA ((a2)'s, at a
#: one-hot of 34 GB, would pass the card's 80 GB in the grid solver)
HOLD_TO_GRID = {"a": ("finalize",), "a2": ("polish",)}
#: the runs on the plain solvers, before K3 and K4 took every slot count
#: (PERF.md section 5), printed beside this run's
PLAIN_SOLVER_LEHMAN = {
    "a": "300 frames: 248 keyframes, 0 closures, ATE 21.44 %, finalize's BAs 0.615-0.628 s "
         "(D = 54, 13), 1 LM iteration",
    "a2": "280 keyframes, 6 closures, ATE 15.52 %, longest frame 65.5-66.0 s, "
          "finalize's BAs 3.06-3.14 s (D = 91), 1 LM iteration each",
}
#: what (a2) decides, keyframes and closures, which a change that should
#: move no decision must leave as they are: (360, 5) with every window
#: through K3 and every global solve through K4 (the drive parts from the
#: 280 keyframes and 6 closures of the windows past 12 slots on the grid
#: solver once the first such window is summed in another order, PERF.md
#: section 5, ``--routes``)
LEHMAN_DECISIONS = {"a2": (360, 5)}
# phase 11's bounds per CLI run: at most so many keyframes, an ATE of at
# most so many % of the path extent, at least so many loop closures ((a)'s
# keyframes rescaled with its frames: 560 over 600 at first).  A ceiling
# against a broken drive, not an accuracy gate: one seed's ATE moves with
# the order of float32 sums ((a2): 15.52 % with the plain solvers, 15.93 %
# with K4 alone, 27.41 % with K3 and K4, ``--routes``).  Accuracy is gated
# on the mean over the JAX stress cell's five seeds, in phase 14; (a2)'s
# ceiling was 20 % while its windows past 12 slots took the grid solver
LEHMAN_BOUNDS = {"a": (280, 40.0, 0), "a2": (400, 40.0, 1)}


def event_key(e: dict) -> tuple:
    """An event's fields without its clock time, for comparing two runs."""
    return tuple(sorted((k, json.dumps(v)) for k, v in e.items() if k != "t"))


def drifted_ring(np, torch, pipe, C: int, n_kp: int, seed: int):
    """``tests/test_loop_closure.py``'s drifted ring at a real size in
    ``pipe``'s map: ``C`` keyframes on a ring of radius 5 around a cloud,
    each with ``n_kp`` keypoint slots (its own ``n_kp // 2`` anchor points,
    then the previous keyframe's), poses and points under a sim(3) drift
    that grows along the ring to (1.18, 0.12 rad about y, (0.35, 0, -0.2));
    then a closing keyframe at the first view under the full drift, whose
    keypoints see the first keyframe's points as new duplicate points with
    the same descriptors.  Returns (closing keyframe, 1 / drift scale)."""
    from bundle_adjustment_tpu_torch.models.loop_closure import _interp_sim3
    from bundle_adjustment_tpu_torch.models.map_store import Keyframe
    from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np

    rng = np.random.default_rng(seed)
    K, dev = pipe.K, pipe.device
    half = n_kp // 2
    P = C * half
    X = rng.normal(size=(P, 3)) * [1.5, 1.0, 1.5]
    X *= np.minimum(1.0, 3.5 / np.linalg.norm(X, axis=1))[:, None]   # depth >= 1.5
    desc = torch.as_tensor(rng.integers(0, 2 ** 32, size=(P, 8), dtype=np.uint64)
                           .astype(np.uint32).view(np.int32), device=dev)
    drift = (1.18, so3_exp_np(np.array([0.0, 0.12, 0.0])), np.array([0.35, 0.0, -0.2]))

    def true_pose(i):
        ang = 2 * np.pi * i / C
        c = np.array([5 * np.sin(ang), 0.0, -5 * np.cos(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        return R, -R @ c

    def keyframe(kf_id, R, t, alpha, seen):
        # slots 0.. hold the points ``seen``; the keyframe's pose under the drift
        sa, Ra, ta = _interp_sim3(*drift, alpha)
        Xc = X[seen] @ R.T + t
        xy = np.zeros((n_kp, 2))
        xy[: len(seen)] = Xc[:, :2] / Xc[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        valid = np.arange(n_kp) < len(seen)
        d = torch.zeros((n_kp, 8), dtype=torch.int32, device=dev)
        d[: len(seen)] = desc[torch.as_tensor(seen, device=dev)]
        Rs = R @ Ra.T
        return Keyframe(kf_id=kf_id, R=Rs, t=sa * t - Rs @ ta, xy=xy, desc=d,
                        kp_valid=valid, frame_idx=kf_id)

    def drifted(pts, alpha):
        sa, Ra, ta = _interp_sim3(*drift, alpha)
        return sa * (pts @ Ra.T) + ta

    mp_ids = pipe.map.add_map_points(np.zeros((P, 3)))
    for i in range(C):
        own = np.arange(i * half, (i + 1) * half)
        pipe.map._pts[own] = drifted(X[own], i / (C - 1))
        seen = np.concatenate([own, np.arange((i - 1) * half, i * half) if i else own[:0]])
        kf = keyframe(i, *true_pose(i), i / (C - 1), seen)
        pipe.map.add_keyframe(kf)
        pipe.map.add_observations(i, mp_ids[seen], np.arange(len(seen)), kf.xy[: len(seen)])
    own = np.arange(half)
    dup = pipe.map.add_map_points(drifted(X[own], 1.0))
    new_kf = keyframe(C, *true_pose(0), 1.0, own)
    pipe.map.add_keyframe(new_kf)
    pipe.map.add_observations(C, dup, own, new_kf.xy[:half])
    return new_kf, 1.0 / drift[0]


def global_solves(tag: str, a: dict) -> None:
    """Print each solve above ``pcg_min_cameras`` cameras of the CLI run
    ``a`` (``run_cli``'s ``pcg``: the closure polishes, then finalize's
    global and full BA): its (C, P, D) and K4's scratch, squared costs, LM
    iterations, the test that stopped it, seconds and K4 launches; fail
    where one did not launch all four K4 roles or the run left a
    ``pcg_plain_solver`` event (the plain solver on the card)."""
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk

    for i, r in enumerate(a["pcg"]):
        print(f"{tag}: global solve {i} ({'finalize' if r['finalize'] else 'polish'}): "
              f"C={r['C']} n_fixed={r['n_fixed']} P={r['P']} D={r['D']} (K4 scratch "
              f"{gk.scratch_bytes(r['P'], r['D'], r['C']) / 2 ** 20:.1f} MiB), squared cost "
              f"{r['initial_sq']:.6g} -> {r['final_sq']:.6g} in {r['iterations']} LM iterations, "
              f"stopped by {r['stop']}, {r['seconds']:.3f} s, K4 launches {r['k4']}")
    plain = [e for e in a["pipe"].log.events if e["event"] == "pcg_plain_solver"]
    if plain:
        fail(f"{tag}: {len(plain)} solves took the plain solver on the card: "
             f"{[e['why'] for e in plain]}")
    left = [r for r in a["pcg"] if not all(v > 0 for v in r["k4"].values())]
    if left or not any(r["finalize"] for r in a["pcg"]):
        fail(f"{tag}: a global solve launched no K4 role, or finalize made none: {a['pcg']}")


def solver_split(torch):
    """Wrap the window solvers to count each call by solver: the window LM
    kernel K3 (``ba_kernel.lm_solve`` on a window inside its gate; apart,
    the windows of more than 12 slots per point and the largest D), the
    grid LM (dense camera solve, by shape, or PCG), the flat LM (the pose
    refine's masked loop, or not); returns (counts, a function that puts
    them back, the first K3 window past 12 slots as (grid, its arguments)
    in a list)."""
    from bundle_adjustment_tpu_torch.ops import ba, ba_grid, ba_kernel
    from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid

    counts, wide = {}, []

    def add(key):
        counts[key] = counts.get(key, 0) + 1

    def k3(a, kw):
        g = a[0]
        P, D = g.cam_slot.shape
        if not ba_kernel.kernel_eligible(g, kw.get("n_fixed", 1)):
            add(f"lm_solve outside K3's gate C={g.rvecs.shape[0]} P={P} D={D}")
        elif D > 12:        # the grid solver took these before K3's gate lost D <= 12
            add("K3, D > 12")
            counts["K3, largest D"] = max(counts.get("K3, largest D", 0), D)
            if not wide:
                wide.append((BAProblemGrid(*(t.clone() for t in g)), dict(kw)))
        else:
            add("K3")

    def grid(a, kw):
        g = a[0]
        P, D = g.cam_slot.shape
        add("grid PCG" if kw.get("cg_iters", 0) > 0
            else f"grid dense C={g.rvecs.shape[0]} D={D}")

    def flat(a, kw):
        add("flat masked (pose refine)" if kw.get("masked") else "flat")

    origs = [(ba_kernel, "lm_solve", recorded(ba_kernel, "lm_solve", k3)),
             (ba_grid, "ba_solve_grid_impl", recorded(ba_grid, "ba_solve_grid_impl", grid)),
             (ba, "ba_solve_impl", recorded(ba, "ba_solve_impl", flat))]

    def restore():
        for mod, name, fn in origs:
            setattr(mod, name, fn)

    return counts, restore, wide


def hold_wide_window(torch, wide: list) -> None:
    """The drive's first window of more than 12 slots per point (a keyframe
    seeing a point through several keypoints), which the grid solver took
    before K3's gate lost the TPU's D <= 12: K3 against its plain version,
    final cost within 1 % and LM iterations within 2 as in phase 5, the
    grid solver's solve printed beside them."""
    from bundle_adjustment_tpu_torch.ops import ba_grid, ba_kernel

    if not wide:
        fail("lehman_indoor (a2): no window past 12 slots went through K3")
    g, kw = wide.pop()
    runs = {"K3": ba_kernel.lm_solve, "its plain version": ba_kernel.lm_solve_plain,
            "the grid solver": ba_grid.ba_solve_grid_impl}
    res = {}
    for name, fn in runs.items():
        st = fn(g, **kw)[3]
        torch.cuda.synchronize()
        res[name] = (float(st.initial_cost), float(st.final_cost), int(st.iterations))
    P, D = g.cam_slot.shape
    print(f"lehman_indoor (a2): the first window past 12 slots, C={g.rvecs.shape[0]} P={P} D={D} "
          f"({int((g.mask > 0).sum())} live slots): " + "; ".join(
              f"{name} {c0:.6g} -> {c1:.6g} in {n}" for name, (c0, c1, n) in res.items()))
    (_, k, nk), (_, p, np_) = res["K3"], res["its plain version"]
    if not (math.isfinite(k) and abs(k - p) <= 1e-2 * p and abs(nk - np_) <= 2):
        fail(f"lehman_indoor (a2): K3 on the window past 12 slots differs from its plain "
             f"version: {res}")


def hold_to_grid(torch, tag: str, kept: dict, bacfg) -> None:
    """The kept solves of run ``tag`` (``run_cli``'s ``kept``: a closure
    polish, finalize's global BA) on the plain grid PCG solver on the card
    (``ba_grid.ba_solve_grid_impl``, which took such solves before K4 took
    any slot count), from the same start.  One LM iteration with CG to its
    cap (``cg_tol`` 0: no early stop, so both take the same step up to the
    order of their sums): final costs within 1 %.  The pipeline's solve
    (its LM cap and Eisenstat-Walker CG) beside the grid solver's with the
    same arguments: K4's final cost at most 1 % above the grid solver's
    (a solve stopped by its cap before it converges lands where its path
    leads: the gap is printed); and, as the witness to which of the two
    float32 solves the path in exact arithmetic lands nearer, the grid
    solver's in float64 with the same arguments: K4's final cost within 1 %
    of it, or at most twice as far from it as the float32 grid solver's
    (``near_float64``)."""
    from bundle_adjustment_tpu_torch.ops import ba, ba_grid
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk

    if sorted(kept) != sorted(HOLD_TO_GRID[tag]):
        fail(f"lehman_indoor ({tag}): kept {sorted(kept)} of the solves "
             f"{HOLD_TO_GRID[tag]} to hold to the grid solver")
    for which in sorted(kept):
        g, n_fixed, skw, rec = kept[which]
        kw = dict(skw, n_fixed=n_fixed, cg_iters=bacfg.cg_iters, cg_tol=bacfg.cg_tol)
        step = dict(kw, max_iterations=1, cg_forcing=False, cg_tol=0.0)
        P, D = g.cam_slot.shape
        name = f"lehman_indoor ({tag}): {which} C={rec['C']} P={P} D={D}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        one_k = gk.solve(g, **step)[3]
        one_g = ba_grid.ba_solve_grid_impl(g, cg_precond_group=1, **step)[3]
        t = time.perf_counter()
        st = ba_grid.ba_solve_grid_impl(g, cg_forcing=True, cg_precond_group=1, **kw)[3]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        k1, g1 = float(one_k.final_cost), float(one_g.final_cost)
        got, want = rec["final_cost"], float(st.final_cost)
        print(f"{name}: one LM iteration (CG to its cap) from {float(one_g.initial_cost):.6g}: "
              f"K4 {k1:.6g}, the plain grid PCG solver {g1:.6g}, gap "
              f"{abs(k1 - g1) / max(g1, 1e-30):.2e}; the pipeline's solve: K4 -> {got:.6g} in "
              f"{rec['iterations']} LM iterations ({rec['stop']}), {rec['seconds']:.3f} s, the "
              f"grid solver -> {want:.6g} in {int(st.iterations)} "
              f"({ba.STOP_TESTS[int(st.stop)]}), {sec:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; K4 "
              f"{100 * (got - want) / max(want, 1e-30):+.2f} % against it")
        if not (math.isfinite(k1) and abs(k1 - g1) <= 1e-2 * g1
                and bool(one_k.accepted) == bool(one_g.accepted)):
            fail(f"{name}: one LM iteration through K4 ({k1}) is not within 1 % of the plain "
                 f"grid PCG solver's ({g1})")
        if not (math.isfinite(got) and got <= 1.01 * want):
            fail(f"{name}: the pipeline's solve through K4 ends at {got}, more than 1 % above "
                 f"the plain grid PCG solver's {want}")
        del st
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g64 = type(g)(*(x.double() if x.is_floating_point() else x for x in g))
        t = time.perf_counter()
        st = ba_grid.ba_solve_grid_impl(g64, cg_forcing=True, cg_precond_group=1, **kw)[3]
        torch.cuda.synchronize()
        sec, w = time.perf_counter() - t, float(st.final_cost)
        print(f"{name}: the witness, the grid solver in float64 -> {w:.6g} in "
              f"{int(st.iterations)} ({ba.STOP_TESTS[int(st.stop)]}), {sec:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; against it K4 "
              f"{100 * (got - w) / w:+.2f} %, the float32 grid solver {100 * (want - w) / w:+.2f} "
              f"%: nearer {'K4' if abs(got - w) < abs(want - w) else 'the grid solver'}")
        over = near_float64({"cost": abs(got - w) / w}, {"cost": abs(want - w) / w},
                            {"cost": 1e-2})
        if not math.isfinite(w) or over:
            fail(f"{name}: the pipeline's solve through K4 ends further from the grid solver's "
                 f"in float64 ({w}) than 1 % and than twice the float32 grid solver: (K4's "
                 f"gap, the grid solver's, bound) {over}")
        del g, g64, st
    kept.clear()
    gc.collect()
    torch.cuda.empty_cache()


def lehman_indoor_phase(torch, np, work: str) -> dict:
    """Phase 11: ``preset_lehman_indoor`` as it ships on the card (see the
    module docstring).  Returns the launches of run (a) and of the whole
    phase per kernel."""
    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch import run as run_mod
    from bundle_adjustment_tpu_torch.config import CAMERA_LEHMAN, CameraModel, \
        preset_lehman_indoor
    from bundle_adjustment_tpu_torch.models.loop_closure import try_close_loop
    from bundle_adjustment_tpu_torch.models.map_store import Map
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline, bgr_to_gray
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel, hamming_kernel
    from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog
    from bundle_adjustment_tpu_torch.utils.metrics import ate_rmse
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_sequence

    K4_ROLES = (ba_global_kernel.SETUP, ba_global_kernel.MATVEC, ba_global_kernel.BACKSUB,
                ba_global_kernel.COST)
    W, H = 1280, 720
    phase_t0 = time.perf_counter()
    total = {name: 0 for name in kernels.LAUNCHES}

    def tally(launches):
        for k, v in launches.items():
            total[k] += v

    # K1's inputs at the bank searches: the first launch of each run below
    # against a bank of more than 8000 descriptors (a loop-detection or
    # relocalization bank; the tracked frame's matches are 4000 x 4000),
    # cloned, to be held against the plain version after the run's counts
    # are read
    k1_banks = {}

    def keep_k1(tag):
        def keep(a, kw):
            if tag not in k1_banks and a[1].shape[0] > 8000 \
                    and not torch.cuda.is_current_stream_capturing():
                k1_banks[tag] = tuple(t.clone() for t in a)
        return keep

    def check_k1_bank(tag):
        if tag not in k1_banks:
            print(f"lehman_indoor ({tag}): no K1 launch against a bank above 8000 descriptors")
            return
        d1, d2, valid2 = k1_banks.pop(tag)
        got = hamming_kernel.launch(d1, d2, valid2)
        want = hamming_kernel.knn2_plain(d1, d2, valid2)
        torch.cuda.synchronize()
        bad = {what: int((a != b).sum()) for what, a, b in zip(("best", "idx", "second"),
                                                                got, want)}
        sms = torch.cuda.get_device_properties(d1.device).multi_processor_count
        splits, rows = hamming_kernel.split_plan(d1.shape[0], d2.shape[0], sms)
        print(f"lehman_indoor ({tag}): K1 at the bank search {d1.shape[0]}x{d2.shape[0]} "
              f"({int((~valid2).sum())} invalid bank slots, {splits} train splits of {rows} "
              f"rows) against the plain version: rows differing {bad}")
        if any(bad.values()):
            fail(f"lehman_indoor ({tag}): K1 at {d1.shape[0]}x{d2.shape[0]} differs from "
                 f"the plain version: {bad}")

    # -- (a) the CLI run over 600 frames of the room ------------------------
    t0 = time.perf_counter()
    frames, K, gt_C, _ = synthetic_sequence(
        n_frames=LEHMAN_FRAMES, width=W, height=H, fx=CAMERA_LEHMAN.fx, seed=LEHMAN_SEED,
        motion="room", device="cuda")
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    folder = os.path.join(work, "room")
    t0 = time.perf_counter()
    write_pngs(folder, frames)
    png_s = time.perf_counter() - t0
    print(f"lehman_indoor: rendered {len(frames)} room frames {W}x{H} on the card in "
          f"{render_s:.1f} s (146 planes each), wrote them as PNG files in {png_s:.1f} s")
    cam = CameraModel(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                      cy=float(K[1, 2]), width=W, height=H)
    cfg = dataclasses.replace(preset_lehman_indoor(), camera=cam)
    if not (cfg.reloc_enabled and cfg.cull_enabled and cfg.loop_closure
            and cfg.num_features == 4000 and cfg.pyramid_levels == 8
            and cfg.ba == type(cfg.ba)()):
        fail(f"preset_lehman_indoor no longer ships as this phase expects: {cfg}")
    argv = cli_args(folder, K, W, H, preset="lehman_indoor")
    if run_mod._config(run_mod.build_parser().parse_args(argv + ["--out", work])) != \
            dataclasses.replace(cfg, output_dir=work):
        fail("the CLI's arguments do not give preset_lehman_indoor with the fitted camera")

    merges = []
    orig_merge = Map.merge_points

    def timed_merge(self, dst, src):
        t = time.perf_counter()
        n = orig_merge(self, dst, src)
        merges.append(time.perf_counter() - t)
        return n

    def cli_drive(tag: str, extra: list, consistent: bool, argv=argv, n_frames=len(frames)):
        """Run ``tag``: the CLI over ``n_frames`` of the room with ``extra``
        arguments; prints its numbers and holds it to ``LEHMAN_BOUNDS[tag]``
        (and to ``LEHMAN_DECISIONS[tag]``)."""
        Map.merge_points = timed_merge
        merges.clear()
        orig_k1 = recorded(hamming_kernel, "launch", keep_k1(tag))
        split, restore, wide = solver_split(torch)
        try:
            a = run_cli(torch, argv + extra + ["--out", os.path.join(work, f"lehman_{tag}")],
                        keep=HOLD_TO_GRID[tag])
        finally:
            Map.merge_points = orig_merge
            hamming_kernel.launch = orig_k1
            restore()
        tally(a["launches"])
        check_k1_bank(tag)
        pipe, summary, events = a["pipe"], a["summary"], a["pipe"].log.events
        fm = np.asarray([e["wall_ms"] for e in a["frames"]])
        statuses = [e["status"] for e in a["frames"]]
        ids = pipe.map.sorted_kf_ids()
        traj = pipe.map.trajectory(consistent)
        gt = np.stack([gt_C[pipe.map.keyframes[k].frame_idx] for k in ids])
        ate = ate_rmse(traj, gt, with_scale=True)
        extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
        culled = sum(e["culled"] for e in events if e["event"] == "cull")
        relocs = [e for e in events if e["event"] == "relocalization"]
        rejects = {}
        for e in events:
            if e["event"] == "loop_reject":
                rejects[e["stage"]] = rejects.get(e["stage"], 0) + 1
        closures = [e for e in events if e["event"] == "loop_closure"]
        plain = [e for e in events if e["event"] == "pcg_plain_solver"]
        polish = a["solves"][: a["solves_before_finalize"]]
        print(f"lehman_indoor ({tag}), the CLI {' '.join(extra)} over {n_frames} frames, "
              f"pipelined: {summary['frames_per_s']} frames/s over {summary['elapsed_s']} s, "
              f"run.main {a['seconds']:.1f} s; per-frame wall ms median {np.median(fm):.1f}, "
              f"p90 {np.percentile(fm, 90):.1f}, max {fm.max():.1f}; statuses " + ", ".join(
                  f"{k} {statuses.count(k)}" for k in dict.fromkeys(statuses)))
        triggers = {}
        for e in events:
            if e["event"] == "keyframe_trigger":
                triggers[e["reason"]] = triggers.get(e["reason"], 0) + 1
        windows = [e for e in events if e["event"] in ("ba_complete", "ba_diverged")
                   and not e.get("global_ba")]
        print(f"lehman_indoor ({tag}): per-frame ms by status (median, p90, count) " + "; ".join(
            f"{k} {np.median(v):.1f}, {np.percentile(v, 90):.1f}, {len(v)}" for k, v in (
                (k, [w for w, st in zip(fm, statuses) if st == k])
                for k in dict.fromkeys(statuses)))
              + f"; keyframe triggers {triggers}; window BAs {len(windows)}, diverged "
              f"{sum(e['event'] == 'ba_diverged' for e in windows)}, the completed ones' median "
              f"{1e3 * np.median([e['elapsed_s'] for e in windows if 'elapsed_s' in e]):.1f} ms")
        print(f"lehman_indoor ({tag}): keyframes {len(ids)}, live map points "
              f"{pipe.map.num_points} of {pipe.map._n_pts}, culled {culled}, observations "
              f"{pipe.map.num_observations}; relocalizations tried {len(relocs)}, succeeded "
              f"{sum(1 for e in relocs if e['success'])}; loop_reject by stage {rejects}; "
              f"closures {len(closures)}: " + "; ".join(
                  f"KF {e['kf_id']} -> anchor {e['anchor_kf']}, scale {e['scale']}, fused "
                  f"{e['fused']}, +{e['added_obs']} obs, {e['chain_corrected']} poses corrected"
                  for e in closures)
              + f"; merge_points {len(merges)} calls, {sum(merges):.2f} s")
        print(f"lehman_indoor ({tag}): keyframe-centre ATE after similarity alignment "
              f"{ate:.4f} over a path extent of {extent:.3f} ({100 * ate / extent:.2f} %); "
              f"launches {a['launches']}; polish BAs {len(polish)}: " + "; ".join(
                  f"LM iterations {r['lm_iterations']}, host reads {r['host_reads']}, graph "
                  f"replays {r['graph_replays']}, capture {1e3 * r['capture_s']:.1f} ms"
                  for r in polish)
              + f"; global solves in finalize {len(a['solves']) - len(polish)}"
              + f"; plain PCG solves on the card {len(plain)} "
              f"({sorted({e['why'] for e in plain})})"
              + f"; peak device memory {a['peak'] / 2 ** 20:.1f} MiB; host reads "
              f"{summary['host_reads']}; tracked-frame graph {summary['track_step']}")
        if summary["frames"] != n_frames or len(ids) < 3 or pipe.map.num_points <= 100:
            fail(f"lehman_indoor ({tag}): {summary['frames']} frames, {len(ids)} keyframes, "
                 f"{pipe.map.num_points} points")
        if not (np.isfinite(traj).all() and math.isfinite(ate)):
            fail(f"lehman_indoor ({tag}): trajectory not finite")
        # finalize's global and full BA: finite; a solve whose cost rose is
        # rejected by the pipeline (the map is kept) and reported here
        final_ba = [e for e in events if e["event"] in ("ba_complete", "ba_diverged")
                    and e.get("global_ba")][-2:]
        print(f"lehman_indoor ({tag}): finalize's global and full BA: " + "; ".join(
            f"{e['event']} over KF {e['kf_id']}, squared cost {e['initial_cost']:.1f} -> "
            f"{e['final_cost']:.1f} in {e.get('iterations')} LM iterations, "
            f"{e.get('elapsed_s', 0.0):.3f} s" for e in final_ba))
        if len(final_ba) != 2 or not all(math.isfinite(e["initial_cost"])
                                         and math.isfinite(e["final_cost"]) for e in final_ba):
            fail(f"lehman_indoor ({tag}): finalize's BA is not two finite solves: {final_ba}")
        if culled <= 0:
            fail(f"lehman_indoor ({tag}): culling removed no point")
        print(f"lehman_indoor ({tag}): solves by solver {split} against {len(windows)} window "
              f"BAs, {len(polish)} polishes and {len(final_ba)} finalize BAs")
        global_solves(f"lehman_indoor ({tag})", a)
        print(f"lehman_indoor ({tag}): keyframes {len(ids)}, closures {len(closures)}, ATE "
              f"{100 * ate / extent:.2f} % of the path extent; longest frame {fm.max() / 1e3:.2f} "
              f"s; finalize {a['finalize_s']:.2f} s (its BAs " + ", ".join(
                  f"{r['seconds']:.3f}" for r in a["pcg"] if r["finalize"]) + " s); polishes "
              + "; ".join(f"{r['seconds']:.3f} s, {r['iterations']} LM iterations, {r['stop']}"
                          for r in a["pcg"] if not r["finalize"])
              + f" -- on the plain solvers: {PLAIN_SOLVER_LEHMAN[tag]}")
        hold_to_grid(torch, tag, a["kept"], cfg.ba)
        if tag == "a2":
            hold_wide_window(torch, wide)
        max_kf, max_ate, min_closures = LEHMAN_BOUNDS[tag]
        if len(ids) > max_kf or 100 * ate / extent > max_ate or len(closures) < min_closures:
            fail(f"lehman_indoor ({tag}): {len(ids)} keyframes (at most {max_kf}), ATE "
                 f"{100 * ate / extent:.2f} % of the path (at most {max_ate} %), "
                 f"{len(closures)} closures (at least {min_closures})")
        if tag in LEHMAN_DECISIONS and (len(ids), len(closures)) != LEHMAN_DECISIONS[tag]:
            fail(f"lehman_indoor ({tag}): {len(ids)} keyframes and {len(closures)} closures, "
                 f"where every window through K3 and every global solve through K4 made "
                 f"{LEHMAN_DECISIONS[tag]}")
        for name in ("hamming_knn2", "orb_gather40", "ba_window_lm"):
            if a["launches"][name] <= 0:
                fail(f"lehman_indoor ({tag}): kernel {name} was not launched")
        a.pop("kept")
        return dict(state=keyframe_state(np, pipe), launches=a["launches"], map=pipe.map,
                    events=[event_key(e) for e in events if e["event"]
                            in ("relocalization", "loop_closure", "loop_reject")])

    # as it ships: the reference pose convention, over the first half of the
    # room (the script's time limit)
    folder_a = os.path.join(work, "room_a")
    os.makedirs(folder_a)
    for name in sorted(os.listdir(folder))[:LEHMAN_A_FRAMES]:
        os.symlink(os.path.join(folder, name), os.path.join(folder_a, name))
    run_a = cli_drive("a", [], False, argv=cli_args(folder_a, K, W, H, preset="lehman_indoor"),
                      n_frames=LEHMAN_A_FRAMES)
    run_a.pop("map")
    gc.collect()
    # the JAX package's own long-sequence harness (tools/stress.py) runs the
    # preset with --consistent-convention: PnP poses as extrinsics
    cfg2 = dataclasses.replace(cfg, consistent_convention=True)
    if run_mod._config(run_mod.build_parser().parse_args(
            argv + ["--consistent-convention", "--out", work])) != \
            dataclasses.replace(cfg2, output_dir=work):
        fail("the CLI's arguments do not give preset_lehman_indoor with the consistent "
             "convention")
    run_a2 = cli_drive("a2", ["--consistent-convention"], True)
    head_frames = frames[:30]
    del frames
    gc.collect()

    # -- (b) a closure that always happens: the drifted ring -----------------
    t0 = time.perf_counter()
    n_ring = RING_KEYFRAMES
    ring = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device="cuda")
    new_kf, inv_scale = drifted_ring(np, torch, ring, n_ring, cfg.num_features, LEHMAN_SEED)
    build_s = time.perf_counter() - t0
    merges.clear()
    Map.merge_points = timed_merge
    # the polish's problem, cloned, to hold K4's roles on it afterwards
    polish_in = []
    orig_solve = recorded(ba_global_kernel, "solve", lambda a, kw: polish_in.append(
        (BAProblemGrid(*(t.clone() for t in a[0])), kw.get("n_fixed", 1))))
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        ba_global_kernel.SOLVES.clear()
        t0 = time.perf_counter()
        info = try_close_loop(ring, new_kf)
        torch.cuda.synchronize()
        close_s = time.perf_counter() - t0
    finally:
        Map.merge_points = orig_merge
        ba_global_kernel.solve = orig_solve
    ring_launches = dict(kernels.LAUNCHES)
    tally(ring_launches)
    if info is None:
        fail(f"lehman_indoor (b): no closure on the drifted ring: "
             f"{[e for e in ring.log.events if e['event'] == 'loop_reject']}")
    rec = list(ba_global_kernel.SOLVES)
    ba = info.get("ba") or {}
    print(f"lehman_indoor (b), the drifted ring: {n_ring} keyframes of {cfg.num_features} "
          f"keypoints, {ring.map._n_pts} points, built in {build_s:.1f} s; closure in "
          f"{close_s:.2f} s: anchor {info['anchor_kf']}, scale {info['scale']} (1/s = "
          f"{inv_scale:.4f}), matches {info['matches']}, PnP inliers {info['pnp_inliers']}, "
          f"fused {info['fused']} ({len(merges)} merge_points calls, {sum(merges):.2f} s), "
          f"+{info['added_obs']} obs, {info['chain_corrected']} poses corrected; polish BA "
          f"{json.dumps(ba)}; its solve: " + "; ".join(
              f"LM iterations {r['lm_iterations']}, host reads {r['host_reads']}, graph "
              f"replays {r['graph_replays']}, live CG iterations {int(r['cg_iterations'])}, "
              f"first iteration {1e3 * r['first_s']:.1f} ms, capture {1e3 * r['capture_s']:.1f} "
              f"ms, replays {1e3 * r['replay_s']:.1f} ms" for r in rec)
          + f"; launches {ring_launches}")
    if info["anchor_kf"] != 0 or abs(info["scale"] - inv_scale) > 0.05 or info["fused"] <= 0:
        fail(f"lehman_indoor (b): the ring's closure is off: {info}")
    if not ba or ba.get("diverged") or any(ring_launches[k] <= 0 for k in K4_ROLES) \
            or any(e["event"] == "pcg_plain_solver" for e in ring.log.events):
        fail(f"lehman_indoor (b): the polish BA did not go through K4: {ba}, {ring_launches}")
    del ring, new_kf
    gc.collect()
    # K4's four roles on the polish's problem against their plain versions,
    # at the bounds of phase 5, and a group that misses them against float64
    # (the problem is near its minimum: its residuals are a hundredth of a
    # pixel)
    if len(polish_in) != 1:
        fail(f"lehman_indoor (b): {len(polish_in)} global solves in the closure, expected 1")
    g, n_fixed = polish_in.pop()
    t0 = time.perf_counter()
    check_k4_roles(torch, np, ba_global_kernel, g, n_fixed, LEHMAN_SEED,
                   f"(b)'s polish C={g.rvecs.shape[0]} n_fixed={n_fixed} "
                   f"P={g.cam_slot.shape[0]} D={g.cam_slot.shape[1]}", against_f64=True)
    print(f"lehman_indoor (b): K4's roles on the polish's problem checked in "
          f"{time.perf_counter() - t0:.1f} s")
    del g
    gc.collect()

    # -- (c) forced relocalizations after blackout frames --------------------
    # as tests/test_reloc_cull.py runs it: the consistent pose convention
    # (PnP poses as extrinsics), so that a keyframe's points and pose agree
    t0 = time.perf_counter()
    frames = head_frames
    kernels.reset_launches()
    rp = VisualOdometryPipeline(dataclasses.replace(cfg, consistent_convention=True),
                                log=EventLog(echo=False), device="cuda")
    for f in frames:
        rp.process_frame(f)
    black = np.random.default_rng(0).integers(0, 30, size=frames[0].shape, dtype=np.uint8)
    reloc_out = []
    # the second bank (4 keyframes of 4000 slots) is at most the threshold
    for bank_size in (cfg.reloc_bank_size, 4):
        rp.cfg = dataclasses.replace(rp.cfg, reloc_bank_size=bank_size)
        for _ in range(2):
            if rp.process_frame(black)["status"] != "discarded":
                fail("lehman_indoor (c): a blackout frame was not discarded")
        # the view of the bank keyframe with the most map points, among those
        # of the 30 frames (not a relocalized one) and not used already
        bank_ids = rp.map.sorted_kf_ids()[-bank_size:]
        seen = [o["target"] for o in reloc_out]
        best = max((k for k in bank_ids if rp.map.keyframes[k].frame_idx < len(frames)
                    and rp.map.keyframes[k].frame_idx not in seen),
                   key=lambda k: int((rp.map.keyframes[k].kp_to_mp >= 0).sum()))
        target = rp.map.keyframes[best].frame_idx
        bank = sum(rp.map.keyframes[k].desc.shape[0] for k in bank_ids)
        rp.frame_idx += 1
        kp = rp._extract(bgr_to_gray(frames[target]))
        before = kernels.LAUNCHES[hamming_kernel.NAME]
        rp._lost_frames = 1
        # the K1 search's inputs, for the check below
        orig_k1 = recorded(hamming_kernel, "launch", keep_k1("c"))
        t = time.perf_counter()
        try:
            r = rp._tracking_lost(frames[target], kp, "forced")
            torch.cuda.synchronize()
        finally:
            hamming_kernel.launch = orig_k1
        reloc_out.append(dict(bank=bank, target=target, result=r,
                              k1=kernels.LAUNCHES[hamming_kernel.NAME] - before,
                              ms=1e3 * (time.perf_counter() - t)))
    tally(kernels.LAUNCHES)
    failed_blackout = [e for e in rp.log.events if e["event"] == "relocalization"
                       and not e["success"]]
    print(f"lehman_indoor (c): {len(frames)} frames, {rp.map.num_keyframes} keyframes, "
          f"{len(failed_blackout)} failed relocalizations on blackout frames; forced: " + "; ".join(
              f"bank {o['bank']} descriptors ({'K1' if o['bank'] <= cfg.reloc_ann_threshold else 'ANN'}"
              f", K1 launches {o['k1']}), frame {o['target']}: {o['result']['status']}, anchor "
              f"{o['result'].get('anchor_kf')}, PnP inliers {o['result'].get('inliers')}, "
              f"{o['ms']:.1f} ms" for o in reloc_out)
          + f" (phase (c) {time.perf_counter() - t0:.1f} s)")
    ann, k1 = reloc_out
    if not (ann["bank"] > cfg.reloc_ann_threshold >= k1["bank"]):
        fail(f"lehman_indoor (c): banks {ann['bank']}, {k1['bank']} do not straddle "
             f"{cfg.reloc_ann_threshold}")
    if any(o["result"]["status"] != "relocalized" for o in reloc_out) \
            or ann["k1"] != 0 or k1["k1"] != 1 or not failed_blackout:
        fail(f"lehman_indoor (c): forced relocalizations {reloc_out}")
    if "c" not in k1_banks or k1_banks["c"][1].shape[0] != k1["bank"]:
        fail(f"lehman_indoor (c): K1's inputs at the forced relocalization's bank of "
             f"{k1['bank']} descriptors were not recorded")
    check_k1_bank("c")
    del rp, frames
    gc.collect()

    # -- (d) checkpoint resume of (a2): 450 frames, then all 600 ------------
    # (a2) is the run with closures and relocalizations, whose cooldown and
    # lost-frame counter the checkpoint must carry
    head = os.path.join(work, "room_head")
    os.makedirs(head)
    for name in sorted(os.listdir(folder))[:LEHMAN_HEAD]:
        os.symlink(os.path.join(folder, name), os.path.join(head, name))
    ck = os.path.join(work, "lehman.npz")
    d1 = run_cli(torch, cli_args(head, K, W, H, preset="lehman_indoor")
                 + ["--consistent-convention", "--out", os.path.join(work, "lehman_d1"),
                    "--checkpoint", ck])
    ck_mb = os.path.getsize(ck) / 2 ** 20
    d2 = run_cli(torch, argv + ["--consistent-convention", "--out",
                                os.path.join(work, "lehman_d2"), "--checkpoint", ck])
    tally(d1["launches"])
    tally(d2["launches"])
    state_a, events_a = run_a2["state"], run_a2["events"]
    state_d = keyframe_state(np, d2["pipe"])
    events_d = [event_key(e) for r in (d1, d2) for e in r["pipe"].log.events
                if e["event"] in ("relocalization", "loop_closure", "loop_reject")]
    same = (state_a[0] == state_d[0] and state_a[1].shape == state_d[1].shape
            and np.array_equal(state_a[1], state_d[1]) and events_a == events_d)
    print(f"lehman_indoor (d): --checkpoint over {LEHMAN_HEAD} frames ({d1['seconds']:.1f} s, "
          f"checkpoint {ck_mb:.1f} MiB), resumed over {LEHMAN_FRAMES} "
          f"({d2['summary']['resumed_frames']} skipped, {d2['summary']['frames']} run, "
          f"{d2['seconds']:.1f} s): keyframe ids, poses and {len(events_d)} loop and "
          f"relocalization events {'bit-equal to' if same else 'DIFFERENT from'} run (a2)'s")
    if not same:
        fail(f"lehman_indoor (d): the resumed run differs from the straight run: keyframe ids "
             f"{state_a[0] == state_d[0]}, events {events_a == events_d}")
    if d2["summary"]["resumed_frames"] != LEHMAN_HEAD:
        fail(f"lehman_indoor (d): resumed {d2['summary']['resumed_frames']} frames")
    print(f"lehman_indoor: launches over the phase {total} "
          f"(phase {time.perf_counter() - phase_t0:.1f} s)")
    missing = [k for k, v in total.items() if v <= 0]
    if missing:
        fail(f"lehman_indoor: kernels {missing} were not launched in the phase")
    if "jax" in sys.modules:
        fail("the port imported jax")
    return dict(launches_a=run_a["launches"], launches_a2=run_a2["launches"], total=total,
                a2_map=run_a2.pop("map"), K=K)


# -- phase 12: the native observation table and the parallel paths ----------

#: phase 12's ranks: two on the one card
PARALLEL_RANKS = 2
#: the matching of phase 12 (b): queries and bank rows, as phase 11 (c)'s
#: K1 bank search
MATCH_Q, MATCH_T = 4000, 16000
# phase 9's global map, which phase 12 takes again
N_KF, N_PT, N_OBS = 200, 30000, 120000


def synchronize(torch, dev) -> None:
    torch.cuda.synchronize(dev)


def kernel_launches() -> dict:
    from bundle_adjustment_tpu_torch import kernels

    return dict(kernels.LAUNCHES)


def drive_windows(m, window_size: int) -> list:
    """The windows a drive over ``m``'s keyframes ran, on its final table:
    every window BA (the ``window_size`` keyframes before the newest, as
    ``run_local_ba`` takes them at each keyframe), every pose refine (the
    newest keyframe alone), and finalize's global and full windows."""
    ids = m.sorted_kf_ids()
    wins = [ids[max(0, n - window_size - 1): n - 1] for n in range(window_size, len(ids) + 1)]
    return ([w for w in wins if len(w) >= 2] + [[k] for k in ids] + [ids[:-1], ids])


def compare_mirror(torch, np, m, K, windows, max_points: int, max_obs: int) -> dict:
    """``gather_window`` of every window with the map's C++ mirror and with
    the numpy table (the mirror set aside): equal rows, map-point ids and
    problems (bit for bit, on the card), or a failure.  Returns ms per call
    of both, whole and of the row lookup alone."""
    from bundle_adjustment_tpu_torch.models.map_store import Map

    mirror = m._native
    if mirror is None:
        fail("the map has no native mirror: Map(use_native=True) is the default")
    whole = {"native": 0.0, "numpy": 0.0}
    rows_s = {"native": 0.0, "numpy": 0.0}
    n_obs = m._n_obs
    for w in windows:
        cap_p, cap_o = max_points, max_obs
        if len(w) > 24:   # finalize's windows: every point and observation
            cap_p, cap_o = max(max_points, m.num_points), max(max_obs, m.num_observations)
        got = {}
        for how in ("native", "numpy"):
            m._native = mirror if how == "native" else None
            try:
                t = time.perf_counter()
                got[how] = m.gather_window(w, K, cap_p, cap_o)
                whole[how] += time.perf_counter() - t
                t = time.perf_counter()
                if how == "native":
                    np.sort(mirror.gather_window(np.unique(w)))
                else:
                    np.flatnonzero(np.isin(m._obs_kf[:n_obs], w) & m._obs_alive[:n_obs])
                rows_s[how] += time.perf_counter() - t
            finally:
                m._native = mirror
        a, b = got["native"], got["numpy"]
        if (a is None) != (b is None):
            fail(f"gather_window({w[:3]}..): the mirror gives {a is None}, numpy {b is None}")
        if a is None:
            continue
        same = (np.array_equal(a[2], b[2]) and np.array_equal(a[1], b[1])
                and all(bit_equal(torch, x, y) for x, y in zip(a[0], b[0])))
        if not same:
            fail(f"gather_window of window {w[:3]}.. ({len(w)} keyframes) differs between "
                 "the C++ mirror and the numpy table")
    synchronize(torch, m.device)
    n = len(windows)
    return dict(windows=n, native_ms=1e3 * whole["native"] / n, numpy_ms=1e3 * whole["numpy"] / n,
                native_rows_ms=1e3 * rows_s["native"] / n,
                numpy_rows_ms=1e3 * rows_s["numpy"] / n, table_rows=n_obs)


def parallel_rank(job: dict) -> dict:
    """One rank of phase 12 (b) 1-4 (``parallel.launch.run_ranks`` on the
    card): the sharded window BA, finalize of the 200-keyframe map with
    ``mesh_shape=(1, 2)``, ``run_partitioned_global_ba`` over (win 2, pt 1)
    (rank 0 also solves the windows alone for the reference) and the
    sharded and ring matching.  Counts this rank's ``all_reduce`` calls and
    K1 launches; returns numpy."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch.config import CameraModel, preset_video
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.ops import ba, hamming_kernel
    from bundle_adjustment_tpu_torch.parallel import dist_ba, dist_match, mesh as mesh_mod
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_map

    dev = torch.device("cuda", torch.cuda.current_device())
    device_mod.set_float32_numerics()
    rank, world = dist.get_rank(), dist.get_world_size()
    out = dict(rank=rank, backend=dist.get_backend(), world_size=world,
               ranks_per_card=mesh_mod.ranks_per_card("cuda", world), device=str(dev))
    calls = [0]
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        calls[0] += 1
        return all_reduce(*a, **kw)

    def host(t):
        return t.detach().cpu().numpy()

    dist.all_reduce = counted
    try:
        # 1. the main path's window, point-sharded over the two ranks
        prob = ba.BAProblem(**{k: torch.as_tensor(v, device=dev)
                               for k, v in job["window"].items()})
        mesh_pt = mesh_mod.make_mesh(1, world, "cuda")
        # twice: the first solve in the process pays its first uses
        solves = []
        for _ in range(2):
            synchronize(torch, dev)
            calls[0] = 0
            t = time.perf_counter()
            rv, tv, pts, st = dist_ba.ba_solve_sharded(dist_ba.shard_problem(prob, world),
                                                       mesh_pt, "pt", n_fixed=job["n_fixed"])
            synchronize(torch, dev)
            solves.append((time.perf_counter() - t, host(rv), host(tv), host(pts)))
        same = all(np.array_equal(a, b) for a, b in zip(solves[0][1:], solves[1][1:]))
        out["window"] = dict(first_s=solves[0][0], seconds=solves[1][0], rv=host(rv),
                             tv=host(tv), pts=host(pts), initial_cost=float(st.initial_cost),
                             final_cost=float(st.final_cost), iterations=int(st.iterations),
                             all_reduce=calls[0], repeat_equal=same)

        # 2. finalize of the 200-keyframe map, its solves point-sharded
        def global_pipe(**change):
            gmap, gK = synthetic_global_map(job["seed"], C=N_KF, P=N_PT,
                                            obs_per_pt=4, device=dev)
            gcam = CameraModel(fx=float(gK[0, 0]), fy=float(gK[1, 1]), cx=float(gK[0, 2]),
                               cy=float(gK[1, 2]), width=job["W"], height=job["H"])
            cfg = dataclasses.replace(preset_video(gcam), **change)
            gpipe = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device=dev)
            gmap.log = gpipe.log
            gpipe.map = gmap
            return gpipe

        gpipe = global_pipe(mesh_shape=(1, world))
        kernels.reset_launches()
        synchronize(torch, dev)
        calls[0] = 0
        t = time.perf_counter()
        gpipe.finalize(job["out"] if rank == 0 else tempfile.mkdtemp(prefix="chip_smoke_rank_"))
        synchronize(torch, dev)
        ids = gpipe.map.sorted_kf_ids()
        out["finalize"] = dict(
            seconds=time.perf_counter() - t, all_reduce=calls[0], launches=kernel_launches(),
            events=[e for e in gpipe.log.events if e["event"] in ("ba_complete", "ba_diverged")],
            ids=ids, poses=np.stack([np.r_[gpipe.map.keyframes[k].R.ravel(),
                                           gpipe.map.keyframes[k].t] for k in ids]),
            mesh=mesh_mod.shape(gpipe._mesh))
        del gpipe

        # 3. the partitioned global BA over (win 2, pt 1); rank 0 also
        # solves each window alone and reconciles them
        ppipe = global_pipe()
        ref = None
        if rank == 0:
            all_ids = ppipe.map.sorted_kf_ids()
            parts = dist_ba.partition_windows(len(all_ids), world, 2)
            window_kf_ids = [np.asarray(all_ids)[w] for w in parts]
            problems, _ = ppipe.partition_problems(window_kf_ids, 1)
            n_fixed = max(1, min(ppipe.cfg.ba.n_fixed, len(window_kf_ids[0]) - 1))
            t = time.perf_counter()
            sols = [ba.ba_solve_impl(p, n_fixed=n_fixed, max_iterations=ppipe.cfg.ba.max_iterations,
                                     huber_delta=ppipe.cfg.ba.huber_delta) for p in problems]
            poses, _ = dist_ba.reconcile_windows_sim3(
                window_kf_ids, np.stack([host(s[0]) for s in sols]),
                np.stack([host(s[1]) for s in sols]))
            synchronize(torch, dev)
            ref = dict(poses=poses, seconds=time.perf_counter() - t)
        mesh_win = mesh_mod.make_mesh(world, 1, "cuda")
        kernels.reset_launches()
        calls[0] = 0
        synchronize(torch, dev)
        t = time.perf_counter()
        result = ppipe.run_partitioned_global_ba(n_windows=world, mesh=mesh_win, overlap=2)
        synchronize(torch, dev)
        ids = ppipe.map.sorted_kf_ids()
        out["partitioned"] = dict(
            seconds=time.perf_counter() - t, result=result, ref=ref, all_reduce=calls[0],
            launches=kernel_launches(), ids=ids,
            R=np.stack([ppipe.map.keyframes[k].R for k in ids]),
            t=np.stack([ppipe.map.keyframes[k].t for k in ids]))
        del ppipe

        # 4. matching: the queries over "win", the bank over "pt"
        rng = np.random.default_rng(job["seed"])
        n_q, n_t = MATCH_Q, MATCH_T
        d1 = torch.as_tensor(rng.integers(0, 2 ** 32, (n_q, 8), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32), device=dev)
        d2 = torch.as_tensor(rng.integers(0, 2 ** 32, (n_t, 8), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32), device=dev)
        valid2 = torch.as_tensor(rng.random(n_t) > 0.05, device=dev)
        valid1 = torch.ones(n_q, dtype=torch.bool, device=dev)
        kernels.reset_launches()
        synchronize(torch, dev)
        t = time.perf_counter()
        sharded = dist_match.match_sharded(d1, d2, valid1, valid2, mesh_win, axis="win")
        synchronize(torch, dev)
        sharded_s = time.perf_counter() - t
        k1_sharded = kernels.LAUNCHES[hamming_kernel.NAME]
        s = mesh_mod.axis_index(mesh_pt, "pt")
        block = n_t // world
        mine = slice(s * block, (s + 1) * block)
        kernels.reset_launches()
        synchronize(torch, dev)
        t = time.perf_counter()
        ring = dist_match.match_ring(d1, d2[mine].contiguous(), valid2[mine].contiguous(),
                                     mesh_pt, axis="pt")
        synchronize(torch, dev)
        ring_s = time.perf_counter() - t
        k1_ring = kernels.LAUNCHES[hamming_kernel.NAME]
        # the reference: one K1 call over the whole bank (not counted)
        best, idx, second = hamming_kernel.knn2_fused(d1, d2, valid2)
        mask = (best < 0.75 * second) & (best < 1e9)
        out["match"] = dict(
            sharded=[host(x) for x in sharded], ring=[host(x) for x in ring],
            single=[host(idx), host(mask), host(best)], sharded_s=sharded_s, ring_s=ring_s,
            k1_sharded=k1_sharded, k1_ring=k1_ring, d1=host(d1) if rank else None,
            d2=host(d2) if rank else None)
    finally:
        dist.all_reduce = all_reduce
    return out


def cli_rank(argv: list) -> dict:
    """One rank of phase 12 (b) 5: ``run.main(argv)`` with ``--multihost``
    (the rank joins the group from its environment), the launch counters set
    to 0 just before and read just after; its keyframe poses and statuses.
    The CLI's printing goes to a file per rank beside ``--out``."""
    import numpy as np
    import torch

    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch import run as run_mod
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline

    rank = int(os.environ["RANK"])
    out = argv[argv.index("--out") + 1]
    kept = []
    orig = recorded(VisualOdometryPipeline, "finalize", lambda a, kw: kept.append(a[0]))
    try:
        kernels.reset_launches()
        t = time.perf_counter()
        with open(f"{out.rstrip('/')}.rank{rank}.stdout.txt", "w") as fh, \
                contextlib.redirect_stdout(fh):
            summary = run_mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = kernel_launches()
    finally:
        VisualOdometryPipeline.finalize = orig
    pipe = kept[0]
    ids, poses = keyframe_state(np, pipe)
    return dict(rank=rank, summary=summary, seconds=seconds, launches=launches, ids=ids,
                poses=poses, frame_idx=[pipe.map.keyframes[k].frame_idx for k in ids],
                traj=pipe.map.trajectory(pipe.cfg.consistent_convention),
                statuses=[e["status"] for e in pipe.log.events if e["event"] == "frame_timing"],
                captures=len(pipe.track.captures), replays=pipe.track.replays)


def native_parallel_phase(torch, np, work: str, seed: int, folder: str, K, W: int, H: int,
                          gt_C, main_window: dict, lehman: dict, global_sq: list) -> dict:
    """Phase 12 (see the module docstring); ``global_sq`` holds phase 9's
    final squared costs of its two solves on the same map.  Returns the
    launches per kernel on rank 0 of the parallel paths ((b) 4 and 5) and
    the ranks' backend, world size and ranks per card."""
    from bundle_adjustment_tpu_torch import native
    from bundle_adjustment_tpu_torch.config import CameraModel, preset_video
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.ops import ba, hamming_kernel
    from bundle_adjustment_tpu_torch.parallel import mesh as mesh_mod
    from bundle_adjustment_tpu_torch.parallel.launch import run_ranks
    from bundle_adjustment_tpu_torch.utils import io
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog
    from bundle_adjustment_tpu_torch.utils.metrics import ate_rmse
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_map

    phase_t0 = time.perf_counter()
    dev = torch.device("cuda")

    # -- (a) the native observation table and the voxel export ---------------
    t0 = time.perf_counter()
    gmap, gK = synthetic_global_map(seed, C=N_KF, P=N_PT, obs_per_pt=4, device=dev)
    a2_map, a2_K = lehman["a2_map"], lehman["K"]
    for tag, m, mK in (("phase 9's map", gmap, gK), ("(a2)'s final map", a2_map, a2_K)):
        r = compare_mirror(torch, np, m, mK, drive_windows(m, 5), 8192, 32768)
        print(f"native (a), {tag} ({m.num_keyframes} keyframes, {r['table_rows']} table rows, "
              f"{m.num_observations} live): gather_window of {r['windows']} windows (every "
              f"window BA, pose refine and final window of a drive over it) equal with and "
              f"without the C++ mirror (rows, map-point ids, problems bit for bit); ms per "
              f"call: mirror {r['native_ms']:.3f}, numpy table {r['numpy_ms']:.3f}; the row "
              f"lookup alone {r['native_rows_ms']:.3f} and {r['numpy_rows_ms']:.3f}")
    pts, cols = a2_map.get_pcd()
    t = time.perf_counter()
    p_n, c_n = native.voxel_downsample_native(pts, cols, 0.05)
    nat_s = time.perf_counter() - t
    t = time.perf_counter()
    p_np, c_np = io.voxel_downsample(pts, cols, 0.05)
    np_s = time.perf_counter() - t
    o1, o2 = np.lexsort(p_n.T), np.lexsort(p_np.T)
    if len(p_n) != len(p_np) or not (np.array_equal(p_n[o1], p_np[o2])
                                     and np.array_equal(c_n[o1], c_np[o2])):
        fail(f"voxel_downsample_native differs from io.voxel_downsample on (a2)'s cloud: "
             f"{len(p_n)} and {len(p_np)} voxels")
    print(f"native (a): voxel_downsample at 0.05 of (a2)'s {len(pts)} points: {len(p_n)} "
          f"voxels, the C++ one equal to the numpy one (sorted), {1e3 * nat_s:.1f} ms and "
          f"{1e3 * np_s:.1f} ms")
    gcam = CameraModel(fx=float(gK[0, 0]), fy=float(gK[1, 1]), cx=float(gK[0, 2]),
                       cy=float(gK[1, 2]), width=W, height=H)
    vpipe = VisualOdometryPipeline(dataclasses.replace(preset_video(gcam), export_voxel=0.05),
                                   log=EventLog(echo=False), device=dev)
    gmap.log = vpipe.log
    vpipe.map = gmap
    vout = os.path.join(work, "voxel_export")
    vpipe.finalize(vout)
    want, _ = native.voxel_downsample_native(*vpipe.map.get_pcd(), 0.05)
    got, _ = io.read_pcd(os.path.join(vout, "final_map_global_ba.pcd"))
    if got.shape != want.shape or not np.allclose(got, want, rtol=1e-6, atol=1e-5):
        fail(f"finalize with export_voxel=0.05 wrote {got.shape} points, the voxels are "
             f"{want.shape}")
    print(f"native (a): finalize with export_voxel=0.05 wrote {len(got)} voxels of "
          f"{vpipe.map.num_points} points ({os.path.getsize(os.path.join(vout, 'final_map_global_ba.pcd'))} "
          f"bytes); (a) {time.perf_counter() - t0:.1f} s")
    del vpipe, gmap, a2_map
    lehman.pop("a2_map")
    gc.collect()

    # -- (b) two ranks on the one card ---------------------------------------
    t0 = time.perf_counter()
    pout = os.path.join(work, "parallel_finalize")
    prob_np = main_window["problem"]
    job = dict(window=prob_np, n_fixed=main_window["n_fixed"], seed=seed, W=W, H=H, out=pout)
    res = run_ranks(parallel_rank, PARALLEL_RANKS, job, timeout=400.0)
    spawn_s = time.perf_counter() - t0
    r0, r1 = res
    print(f"parallel (b): {r0['world_size']} ranks on {r0['device']} and {r1['device']}, "
          f"backend {r0['backend']}, {r0['ranks_per_card']} ranks per card; parts 1-4 in "
          f"{spawn_s:.1f} s with the processes' start")
    if r0["backend"] != mesh_mod.backend_for("cuda", PARALLEL_RANKS):
        fail(f"the ranks took {r0['backend']}")

    # 1. the window against the single-rank plain solve on the card
    prob = ba.BAProblem(**{k: torch.as_tensor(v, device=dev) for k, v in prob_np.items()})
    single_s = []
    for _ in range(2):
        synchronize(torch, dev)
        t = time.perf_counter()
        rv1, tv1, pts1, st1 = ba.ba_solve_impl(prob, n_fixed=main_window["n_fixed"])
        synchronize(torch, dev)
        single_s.append(time.perf_counter() - t)
    w0, w1 = r0["window"], r1["window"]
    rel = abs(w0["final_cost"] - float(st1.final_cost)) / max(float(st1.final_cost), 1.0)
    P_w = prob_np["points"].shape[0]
    per_it = (w0["all_reduce"] - 4) / max(w0["iterations"], 1)
    print(f"parallel (b) 1: the main path's last window (C={prob_np['rvecs'].shape[0]}, "
          f"n_fixed={main_window['n_fixed']}, P={P_w}, O={prob_np['uv'].shape[0]}) point-sharded "
          f"over 2 ranks: cost {w0['initial_cost']:.2f} -> {w0['final_cost']:.4f} in "
          f"{w0['iterations']} LM iterations, {1e3 * w0['seconds']:.1f} ms (the first solve in "
          f"the process {1e3 * w0['first_s']:.1f} ms; the two bit-equal: "
          f"{w0['repeat_equal']}); the single-rank plain solve {float(st1.initial_cost):.2f} -> "
          f"{float(st1.final_cost):.4f} in {int(st1.iterations)}, {1e3 * single_s[1]:.1f} ms "
          f"({1e3 * single_s[0]:.1f} the first time); relative gap {rel:.2e}; "
          f"all_reduce calls {w0['all_reduce']} ({per_it:.1f} per LM iteration beside the "
          "initial and final costs and the points' exchange)")
    if rel > 1e-3:
        fail(f"parallel (b) 1: the sharded window's cost is {rel:.2e} from the single-rank one")
    if not all(np.array_equal(w0[k], w1[k]) for k in ("rv", "tv", "pts")) \
            or w0["final_cost"] != w1["final_cost"]:
        fail("parallel (b) 1: the two ranks' solutions differ")

    # 2. finalize of the 200-keyframe map, sharded
    f0, f1 = r0["finalize"], r1["finalize"]
    print(f"parallel (b) 2: finalize of the {N_KF}-keyframe map with mesh_shape=(1, 2) "
          f"(mesh {f0['mesh']}): " + "; ".join(
              f"{e['event']} {e['initial_cost']:.1f} -> {e['final_cost']:.1f} in "
              f"{e['iterations']} LM iterations, {e['elapsed_s']:.2f} s" for e in f0["events"])
          + f"; all_reduce calls {f0['all_reduce']} "
          f"({(f0['all_reduce'] - 8) / max(sum(e['iterations'] for e in f0['events']), 1):.1f} "
          f"per LM iteration beside each solve's costs and exchange); launches "
          f"{f0['launches']}; {f0['seconds']:.2f} s")
    if len(f0["events"]) != 2 or any(e["event"] != "ba_complete" for e in f0["events"]):
        fail(f"parallel (b) 2: expected two completed solves: {f0['events']}")
    if len(global_sq) != 2:
        fail(f"parallel (b) 2: phase 9's costs are missing: {global_sq}")
    for e, ref in zip(f0["events"], global_sq):
        if not abs(e["final_cost"] - ref) <= 1e-2 * ref:
            fail(f"parallel (b) 2: squared cost {e['final_cost']} not within 1 % of phase "
                 f"9's {ref}")
    if f0["ids"] != f1["ids"] or not np.array_equal(f0["poses"], f1["poses"]):
        fail("parallel (b) 2: the two ranks' maps differ after finalize")
    if any(f0["launches"][k] for k in f0["launches"]):
        fail(f"parallel (b) 2: the sharded solves launched kernels {f0['launches']}")

    # 3. the partitioned global BA against the windows alone on one rank
    p0, p1 = r0["partitioned"], r1["partitioned"]
    from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np

    same_ref = all(np.array_equal(p0["R"][i], so3_exp_np(p0["ref"]["poses"][k][0]))
                   and np.array_equal(p0["t"][i], p0["ref"]["poses"][k][1])
                   for i, k in enumerate(p0["ids"]))
    print(f"parallel (b) 3: run_partitioned_global_ba over (win 2, pt 1): "
          f"{json.dumps(p0['result'])}; all_reduce calls {p0['all_reduce']}; "
          f"{p0['seconds']:.2f} s (the two windows alone on rank 0: "
          f"{p0['ref']['seconds']:.2f} s); poses {'bit-equal to' if same_ref else 'DIFFERENT from'} "
          "the windows solved alone and reconciled on one rank")
    if not same_ref or p0["result"] is None or p0["result"]["diverged"]:
        fail("parallel (b) 3: the partitioned BA differs from the windows solved alone")
    if not (np.array_equal(p0["R"], p1["R"]) and np.array_equal(p0["t"], p1["t"])):
        fail("parallel (b) 3: the two ranks' maps differ")

    # 4. the sharded and ring matching against one K1 call
    m0, m1 = r0["match"], r1["match"]
    single = m0["single"]
    d1, d2 = m1["d1"].view(np.uint8), m1["d2"].view(np.uint8)

    def dist_at(idx):
        return np.unpackbits(d1 ^ d2[idx.astype(np.int64)], axis=1).sum(1)

    for tag, m in (("rank 0", m0), ("rank 1", m1)):
        for what, got in (("sharded", m["sharded"]), ("ring", m["ring"])):
            exact = all(np.array_equal(a, b) for a, b in zip(got, single))
            if what == "ring" and tag == "rank 1" and not exact:
                # rank 1 folds the blocks from its own: a tie between blocks
                # may name the other copy; the distances and masks are exact
                exact = (np.array_equal(got[2], single[2]) and np.array_equal(got[1], single[1])
                         and np.array_equal(dist_at(got[0])[single[2] < 1e9],
                                            single[2][single[2] < 1e9]))
            if not exact:
                fail(f"parallel (b) 4: match_{what} on {tag} differs from one K1 call")
    print(f"parallel (b) 4: {MATCH_Q} x {MATCH_T}: match_sharded (queries over 'win') and "
          f"match_ring (bank over 'pt', blocks through host memory under gloo) equal one K1 "
          f"call on both ranks (rank 1's ring at equal distances); K1 launches per rank "
          f"{m0['k1_sharded']} and {m0['k1_ring']}, {m1['k1_sharded']} and {m1['k1_ring']}; "
          f"{1e3 * m0['sharded_s']:.1f} and {1e3 * m0['ring_s']:.1f} ms on rank 0")
    if (m0["k1_sharded"], m0["k1_ring"], m1["k1_sharded"], m1["k1_ring"]) != (1, 2, 1, 2):
        fail("parallel (b) 4: expected one K1 launch per rank sharded and two in the ring")

    # 5. the CLI over phase 6's frames, two ranks with --multihost --mesh 2
    t0 = time.perf_counter()
    out = os.path.join(work, "multihost")
    argv = cli_args(folder, K, W, H) + ["--multihost", "--mesh", "2", "--out", out]
    c0, c1 = run_ranks(cli_rank, PARALLEL_RANKS, argv, timeout=400.0, join=False)
    cli_s = time.perf_counter() - t0
    gt = np.stack([gt_C[f] for f in c0["frame_idx"]])
    ate = ate_rmse(c0["traj"], gt, with_scale=True)
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    print(f"parallel (b) 5: the CLI --multihost --mesh 2 over {len(c0['statuses'])} frames in "
          f"two ranks ({cli_s:.1f} s with the processes' start; run.main {c0['seconds']:.1f} "
          f"and {c1['seconds']:.1f} s): summary {c0['summary'].get('distributed')}; statuses "
          f"{''.join(s[0] for s in c0['statuses'])}; {len(c0['ids'])} keyframes; ATE "
          f"{ate:.4f} over an extent of {extent:.3f}; launches rank 0 {c0['launches']}, rank 1 "
          f"{c1['launches']}; graph captures {c0['captures']}, {c1['captures']}, replays "
          f"{c0['replays']}, {c1['replays']}")
    if c0["ids"] != c1["ids"] or not np.array_equal(c0["poses"], c1["poses"]) \
            or c0["statuses"] != c1["statuses"]:
        fail("parallel (b) 5: the two ranks' trajectories differ")
    if len(c0["ids"]) < 3 or not ate <= 0.25 * extent:
        fail(f"parallel (b) 5: {len(c0['ids'])} keyframes, ATE {ate} of {extent}")
    for c in (c0, c1):
        if c["replays"] <= 0 or c["launches"]["hamming_knn2"] < c["replays"] \
                or c["launches"]["orb_gather40"] < c["replays"]:
            fail(f"parallel (b) 5: rank {c['rank']}: K1 and K2 not launched through the "
                 f"graph: {c['launches']}, {c['replays']} replays")
    if c0["summary"].get("distributed", {}).get("world_size") != PARALLEL_RANKS:
        fail(f"parallel (b) 5: summary {c0['summary'].get('distributed')}")
    with open(os.path.join(out, "summary.json")) as fh:
        if json.load(fh)["distributed"]["backend"] != r0["backend"]:
            fail("parallel (b) 5: summary.json lacks the backend")
    launches = {k: m0["k1_sharded"] + m0["k1_ring"] if k == hamming_kernel.NAME else 0
                for k in c0["launches"]}
    for k, v in c0["launches"].items():
        launches[k] += v
    print(f"native and parallel: rank 0's launches on the parallel paths {launches} "
          f"(phase {time.perf_counter() - phase_t0:.1f} s)")
    return dict(launches=launches, backend=r0["backend"], world_size=r0["world_size"],
                ranks_per_card=r0["ranks_per_card"])


# -- phase 13: --debug, the run's plots, log analytics, cv2 features --------

#: what a ``--debug`` run writes beside the plain outputs, as the JAX
#: package's does: folder -> (file prefix, canvas size (H, W) or None for the
#: frame's size, or "pair" for two frames side by side)
DEBUG_ARTIFACTS = {"debug_keyframes": ("keyframe_", None), "debug_matches": ("matches_", "pair"),
                   "debug_depth": ("depth_", None), "debug_sparsity": ("sparsity_", (600, 600)),
                   "trajectory_2d": ("trajectory_2d_", (800, 800)),
                   "trajectory_3d": ("trajectory_3d_", (900, 900)),
                   "lba_steps": ("map_after_lba_kf_", None)}
DEBUG_VIDEOS = ("keypoint_video.mp4", "match_video.mp4", "depth_video.mp4")


def timed_calls(torch, spent: list, module, name: str, when=lambda a, kw: True):
    """Replace ``module.name`` by a function that adds the host ms of each
    call for which ``when`` holds, from a synchronise before it to one after
    it, to ``spent``; returns the original, to be put back."""
    orig = getattr(module, name)

    def call(*a, **kw):
        if not when(a, kw):
            return orig(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(module, name, call)
    return orig


def keyframe_drawing(torch, np, pipe, frames_dir: str, out: str) -> dict:
    """The debug drawing of one keyframe, redone on the run's last keyframe
    into ``out``: ``_debug_keyframe`` (the two trajectory plots, the match,
    keypoint and depth overlays) and the sparsity spy of the last window,
    once to warm up and then under torch.profiler.  Returns the host ms
    (to a synchronise) and the device ms (the CUDA kernels' and copies'
    time in the profile), and the host ms of the PNG files' encoding and
    writing in the unprofiled draw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bundle_adjustment_tpu_torch.utils import io, viz

    ids = pipe.map.sorted_kf_ids()
    last, prev = pipe.map.keyframes[ids[-1]], pipe.map.keyframes[ids[-2]]
    names = sorted(os.listdir(frames_dir))
    frame = io.read_png(os.path.join(frames_dir, names[last.frame_idx]))
    prev_frame = io.read_png(os.path.join(frames_dir, names[prev.frame_idx]))
    n = int(min(prev.kp_valid.sum(), last.kp_valid.sum()))
    cfg = pipe.cfg
    pipe.cfg = dataclasses.replace(cfg, output_dir=out)
    problem, mp_ids, _ = pipe.map.gather_window(ids[-6:-1], pipe.K, cfg.ba.max_points,
                                                cfg.ba.max_obs)

    def draw():
        pipe._last_debug_frame = prev_frame
        pipe._debug_keyframe(frame, prev, last, last.xy, last.kp_valid, np.arange(len(last.xy)),
                             np.arange(n))
        viz.plot_and_save_sparsity(problem.cam_idx, problem.pnt_idx, 5, len(mp_ids),
                                   os.path.join(out, "debug_sparsity"), "redo", device="cuda")
        torch.cuda.synchronize()

    def pngs():
        found = {}
        for root, _, files in os.walk(out):
            for f in files:
                with open(os.path.join(root, f), "rb") as fh:
                    found[os.path.join(root, f)] = fh.read()
        return found

    encode = []
    try:
        draw()
        first = pngs()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            draw()
        host_ms = (time.perf_counter() - t0) * 1e3
        orig = timed_calls(torch, encode, viz, "write_png")
        try:
            t0 = time.perf_counter()
            draw()
            bare_ms = (time.perf_counter() - t0) * 1e3
        finally:
            viz.write_png = orig
    finally:
        pipe.cfg = cfg
    if pngs() != first:
        fail("debug (d): two draws of one keyframe on the card give other files")
    # the same overlays drawn on the CPU: the same float32 formulas, so a pixel
    # may differ only where a last-bit difference flips its rounding
    kp = last.xy[last.kp_valid]
    depths = pipe.map.points()[last.kp_to_mp[last.kp_to_mp >= 0]] @ last.R[2] + last.t[2]
    gaps = {}
    for name, draw_one in (
            ("keypoints", lambda d, path: viz.draw_keypoints(frame, kp, path, device=d)),
            ("matches", lambda d, path: viz.draw_matches(prev_frame, prev.xy[:n], frame,
                                                         last.xy[:n], path, device=d)),
            ("depth", lambda d, path: viz.draw_depth_overlay(
                frame, last.xy[last.kp_to_mp >= 0], depths, path, device=d))):
        imgs = []
        for d in ("cuda", "cpu"):
            draw_one(d, os.path.join(out, f"{name}_{d}.png"))
            imgs.append(io.read_png(os.path.join(out, f"{name}_{d}.png")).astype(np.int16))
        diff = np.abs(imgs[0] - imgs[1])
        gaps[name] = (int(diff.max()), int((diff > 0).any(2).sum()))
        if diff.max() > 1:
            fail(f"debug (d): {name} drawn on the card and on the CPU differ by up to "
                 f"{diff.max()} levels at {(diff > 0).any(2).sum()} pixels")
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    return dict(host_ms=bare_ms, profiled_host_ms=host_ms, device_ms=dev_us / 1e3,
                encode_ms=sum(encode), images=len(encode), keypoints=int(last.kp_valid.sum()),
                points=len(mp_ids), card_vs_cpu=gaps)


def debug_phase(torch, np, work: str, folder: str, K, W: int, H: int, plain: dict) -> dict:
    """Phase 13 (see the module docstring).  ``plain``: phase 6's pipelined
    run (its output folder, keyframes and run seconds).  Returns the debug
    run's launches per kernel."""
    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch.config import CameraModel, preset_video
    from bundle_adjustment_tpu_torch.models import pipeline as pipeline_mod
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.utils import analyze_log, io, viz
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog, read_events

    phase_t0 = time.perf_counter()

    # -- (a) the CLI with --debug over phase 6's frames -----------------------
    spent = {"keyframe": [], "sparsity": [], "lba_steps": [], "videos": []}
    originals = [
        (VisualOdometryPipeline, "_debug_keyframe",
         timed_calls(torch, spent["keyframe"], VisualOdometryPipeline, "_debug_keyframe")),
        (viz, "plot_and_save_sparsity",
         timed_calls(torch, spent["sparsity"], viz, "plot_and_save_sparsity")),
        (pipeline_mod, "write_pcd",
         timed_calls(torch, spent["lba_steps"], pipeline_mod, "write_pcd",
                     lambda a, kw: "lba_steps" in a[0])),
        (VisualOdometryPipeline, "_write_debug_videos",
         timed_calls(torch, spent["videos"], VisualOdometryPipeline, "_write_debug_videos")),
    ]
    try:
        r = run_cli(torch, cli_args(folder, K, W, H) + ["--out", os.path.join(work, "debug"),
                                                        "--debug"])
    finally:
        for mod, name, orig in originals:
            setattr(mod, name, orig)
    out, pipe, launches = r["out"], r["pipe"], r["launches"]
    with open(os.path.join(out, "trajectory.txt")) as fa, \
            open(os.path.join(plain["out"], "trajectory.txt")) as fb:
        if fa.read() != fb.read():
            fail("debug (a): trajectory.txt differs from phase 6's run without --debug")
    n_kf = pipe.map.num_keyframes
    names = sorted(os.listdir(folder))
    checked = 0
    for sub, (prefix, size) in DEBUG_ARTIFACTS.items():
        path = os.path.join(out, sub)
        files = sorted(os.listdir(path)) if os.path.isdir(path) else []
        if not files or not all(f.startswith(prefix) for f in files):
            fail(f"debug (a): {sub}/ holds {files[:5]}, expected {prefix}* files")
        for f in files:
            if not f.endswith(".png"):
                continue
            want = (H, 2 * W) if size == "pair" else size or (H, W)
            img = io.read_png(os.path.join(path, f))
            if img.shape != want + (3,):
                fail(f"debug (a): {sub}/{f} decodes to {img.shape}, expected {want}")
            checked += 1
    kf_files = sorted(os.listdir(os.path.join(out, "debug_keyframes")))
    if len(kf_files) != n_kf - 1:
        fail(f"debug (a): {len(kf_files)} keyframe overlays for {n_kf} keyframes")
    all_differ, rings = 0, 0
    offsets = np.asarray([[3, 0], [-3, 0], [0, 3], [0, -3]])
    for f in kf_files:
        kf = pipe.map.keyframes[int(f[len("keyframe_"):-4])]
        drawn = io.read_png(os.path.join(out, "debug_keyframes", f))
        frame = io.read_png(os.path.join(folder, names[kf.frame_idx]))
        c = np.round(kf.xy[kf.kp_valid]).astype(np.int64)
        p = (c[:, None, :] + offsets[None]).reshape(-1, 2)
        inside = ((p >= 0) & (p < [W, H])).all(1)
        differ = np.zeros(len(p), bool)
        differ[inside] = (drawn[p[inside, 1], p[inside, 0]]
                          != frame[p[inside, 1], p[inside, 0]]).any(1)
        differ = differ.reshape(-1, 4)
        if not differ.any(1).all():
            fail(f"debug (a): {f}: {int((~differ.any(1)).sum())} of {len(c)} keypoints with "
                 "no ring pixel changed")
        all_differ += int(differ.all(1).sum())
        rings += len(c)
    events = read_events(os.path.join(out, "events.jsonl"))
    skipped = [e for e in events if e["event"] == "debug_videos_skipped"]
    videos = [v for v in DEBUG_VIDEOS if os.path.isfile(os.path.join(out, v))]
    if skipped:
        if videos or skipped[0]["needs"] != "cv2" or sorted(skipped[0]["files"]) \
                != sorted(DEBUG_VIDEOS) or r["summary"].get("debug_videos_skipped") is None:
            fail(f"debug (a): the videos' absence is not announced as expected: {skipped}")
    elif len(videos) != 3:
        fail(f"debug (a): videos {videos} and no debug_videos_skipped event")
    for name in ("hamming_knn2", "orb_gather40", "ba_window_lm"):
        if launches[name] <= 0:
            fail(f"debug (a): kernel {name} was not launched")
    spent_kf = statistics.mean(spent["keyframe"]) if spent["keyframe"] else float("nan")
    print(f"debug (a): the CLI with --debug over {len(names)} frames: {n_kf} keyframes, "
          f"trajectory.txt bit-equal to phase 6's; {checked} PNGs decoded at their sizes; "
          f"at {rings} drawn keypoints a ring pixel changed ({all_differ} with all four); "
          + (f"videos not written (no cv2), announced for {skipped[0]['files']}" if skipped
             else f"videos {videos}")
          + f"; launches {launches}; run.main {r['seconds']:.2f} s, {r['summary']['elapsed_s']} s "
          f"for the frames (phase 6 pipelined: {plain['elapsed_s']} s)")

    # -- (b) analyze_log over (a)'s events ------------------------------------
    png = os.path.join(work, "analysis.png")
    summary = analyze_log.analyze_and_plot(analyze_log.load_events(
        os.path.join(out, "events.jsonl")), png, device="cuda")
    reasons = {}
    for e in events:
        if e["event"] == "keyframe_trigger":
            reasons[e["reason"]] = reasons.get(e["reason"], 0) + 1
    tally = dict(frames=sum(e["event"] == "frame" for e in events), keyframes=sum(reasons.values()),
                 trigger_reasons=reasons, ba_runs=sum(e["event"] == "ba_complete" for e in events),
                 ba_divergences=sum(e["event"] == "ba_diverged" for e in events))
    if {k: summary[k] for k in tally} != tally or tally["keyframes"] != n_kf \
            or tally["frames"] != len(names):
        fail(f"debug (b): analyze_log's counts {summary} differ from the events' {tally}")
    if io.read_png(png).shape != (880, 1320, 3):
        fail("debug (b): the analysis plot is not 1320 x 880")
    print(f"debug (b): analyze_log over (a)'s events equals the tally {tally}; plot written")

    # -- (c) features_source="cv2" --------------------------------------------
    cam = CameraModel(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
                      width=W, height=H)
    cfg_cv2 = dataclasses.replace(preset_video(cam), features_source="cv2")
    found = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "matplotlib")}
    print(f"debug (c): installed on this machine: {found}")
    if not found["cv2"]:
        try:
            VisualOdometryPipeline(cfg_cv2, log=EventLog(echo=False), device="cuda")
        except ImportError as e:
            if "cv2" not in str(e):
                fail(f"debug (c): the constructor's error does not name cv2: {e}")
            print(f"debug (c): no cv2 here; the constructor raises: {e}")
        else:
            fail("debug (c): features_source='cv2' built without cv2")
        cv2_launches = None
    else:
        pipe_cv2 = VisualOdometryPipeline(cfg_cv2, log=EventLog(echo=False), device="cuda")
        kernels.reset_launches()
        st = drive(torch, pipe_cv2, [io.read_png(os.path.join(folder, n)) for n in names[:12]])
        cv2_launches = dict(kernels.LAUNCHES)
        if cv2_launches["hamming_knn2"] <= 0 or pipe_cv2.track.replays:
            fail(f"debug (c): cv2 features: K1 not launched or the graph replayed: "
                 f"{cv2_launches}")
        print(f"debug (c): cv2 features over 12 frames, staged: statuses "
              f"{''.join(x[0] for x in st['statuses'])}, launches {cv2_launches}")

    # -- (d) what the debug drawing costs per keyframe ------------------------
    redo = keyframe_drawing(torch, np, pipe, folder, os.path.join(work, "debug_redo"))
    added = (r["summary"]["elapsed_s"] - plain["elapsed_s"]) * 1e3 / max(n_kf - 1, 1)
    per_window = statistics.mean(spent["sparsity"]) if spent["sparsity"] else 0.0
    print("debug (d): " + json.dumps(dict(
        keyframes=n_kf, in_run_host_ms_per_keyframe=round(spent_kf, 3),
        sparsity_host_ms_per_window=round(per_window, 3), windows=len(spent["sparsity"]),
        lba_steps_host_ms_per_window=round(statistics.mean(spent["lba_steps"]), 3)
        if spent["lba_steps"] else None,
        videos_host_ms=round(sum(spent["videos"]), 3),
        added_wall_ms_per_keyframe_vs_phase6=round(added, 3),
        redo_host_ms=round(redo["host_ms"], 3), redo_png_encode_host_ms=round(redo["encode_ms"], 3),
        redo_images=redo["images"], redo_device_ms=round(redo["device_ms"], 3),
        redo_keypoints=redo["keypoints"],
        card_vs_cpu_max_level_and_pixels=redo["card_vs_cpu"])))
    print(f"debug: phase {time.perf_counter() - phase_t0:.1f} s")
    return dict(launches=launches, cv2_launches=cv2_launches)


# -- phase 14: the stress harness on the JAX package's seed-2 cell ----------

#: the JAX stress study, the cell whose committed input video phase 14
#: drives in the script's process, and its frames
STRESS_STUDY, STRESS_FRAMES = ".dedup_study", 600
STRESS_CELL = os.path.join(STRESS_STUDY, "s2_d3_cpu")
#: the study's seeds, run as so many processes at once after seed 2
STRESS_SEEDS, STRESS_JOBS = (2, 3, 4, 5, 6), 4


def stress_phase(torch, np, work: str) -> dict:
    """Phase 14: the port's stress harness (``tools/stress``) on the JAX
    cell's own 600-frame video (seed 2, 3 px dedup cell, 640 x 480, 1500
    features, ``--consistent-convention``), read as it is through cv2, the
    launch counters set to 0 just before and read just after; its result
    beside the JAX cell's ``stress_result.json``, each global solve's
    (C, P, D), LM iterations and stop test, the window solves by solver.
    Fails on a crash, a non-finite ATE, a ``pcg_plain_solver`` event or a
    global solve without K4.  The one seed's ATE is not gated.  Then the
    five seeds' study (``tools/dedup_study``, seed 2 read from this run),
    which fails on its gate: the mean.  Returns the launches."""
    from bundle_adjustment_tpu_torch.tools import dedup_study, stress

    t0 = time.perf_counter()
    cell = os.path.join(os.path.dirname(os.path.abspath(__file__)), STRESS_CELL)
    video = os.path.join(cell, "sequence.mp4")
    if not os.path.exists(video):
        fail(f"stress: {video} is missing")
    study = os.path.join(work, "dedup_study")
    os.makedirs(study)
    out = os.path.join(study, dedup_study.cell_name(2, 3.0, "cuda"))
    split, restore, _ = solver_split(torch)
    try:
        a = run_cli(torch, ["--video", video, "--seed", "2", "--dedup-px", "3", "--out", out],
                    main=stress.main, run_dir=os.path.join(out, "run"))
    finally:
        restore()
    r = a["summary"]
    with open(os.path.join(cell, "stress_result.json")) as f:
        ref = json.load(f)
    print("stress (seed 2, the JAX cell's video): port | JAX (CPU) -- " + "; ".join(
        f"{k} {r.get(k)} | {ref.get(k)}" for k in list(ref) + ["ate_pct_of_extent", "device"]))
    fm = np.asarray([e["wall_ms"] for e in a["frames"]])
    print(f"stress: per-frame wall ms median {np.median(fm):.1f}, p90 "
          f"{np.percentile(fm, 90):.1f}, max {fm.max():.1f}; solves by solver {split}; "
          f"finalize {a['finalize_s']:.2f} s; launches {a['launches']}; peak device memory "
          f"{a['peak'] / 2 ** 20:.1f} MiB; phase {time.perf_counter() - t0:.1f} s")
    global_solves("stress", a)
    if r["frames"] != STRESS_FRAMES or not math.isfinite(r["ate_rmse"]):
        fail(f"stress: {r['frames']} frames, ATE {r['ate_rmse']}")
    t1 = time.perf_counter()
    rec = dedup_study.main(
        ["--seeds", *map(str, STRESS_SEEDS), "--dedup", "3", "--frames", str(STRESS_FRAMES),
         "--against", os.path.join(os.path.dirname(os.path.abspath(__file__)), STRESS_STUDY),
         "--out", study, "--jobs", str(STRESS_JOBS)])
    print(f"stress: the five seeds' study in {time.perf_counter() - t1:.1f} s, "
          f"{STRESS_JOBS} seeds at once; gate {json.dumps(rec['gate'])}")
    if not rec["gate"]["passed"]:
        fail(f"stress: the five seeds' study fails its gate: {rec['gate']}")
    if "jax" in sys.modules:
        fail("the port imported jax")
    return a["launches"]


def sweep_phase(torch) -> None:
    """Phase 15: the global scale sweep (``tools/global_scale_sweep``) at
    C = 2048 and on the 91-slot ring; every time and cost finite, the cost
    down.  C = 4096 and 8192 run from the command line."""
    from bundle_adjustment_tpu_torch.tools import global_scale_sweep

    out = global_scale_sweep.main(["--cams", "2048", "--slots", "91", "--repeats", "2"])
    for res in list(out["sizes"].values()) + list(out["slots"].values()):
        times = [res["ms_per_replayed_lm_iteration"]] + [
            v["ms"] for v in res["roles"].values()]
        if not (res["path"] == "kernels" and res["final_sq"] < res["initial_sq"]
                and all(math.isfinite(t) and t > 0 for t in times)):
            fail(f"global scale sweep: {res}")


#: the routings of ``--routes``: (K3's gate held to D <= 12, K4's gate held
#: to D <= 12, K3's windows past 12 slots through its plain version)
ROUTES = {"as shipped": (False, False, False), "K3 at D <= 12": (True, False, False),
          "K4 at D <= 12": (False, True, False), "both at D <= 12": (True, True, False),
          "K3 plain past 12": (False, False, True)}


def routes_study(torch, np, names) -> int:
    """``--routes``: phase 11's run (a2) once per routing in ``names``."""
    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch.config import CAMERA_LEHMAN
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk
    from bundle_adjustment_tpu_torch.ops import ba_kernel
    from bundle_adjustment_tpu_torch.utils.metrics import ate_rmse
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_sequence

    print(nvidia_smi_line(), flush=True)
    device_mod.set_float32_numerics()
    kernels.build_all()
    W, H = 1280, 720
    frames, K, gt_C, _ = synthetic_sequence(
        n_frames=LEHMAN_FRAMES, width=W, height=H, fx=CAMERA_LEHMAN.fx, seed=LEHMAN_SEED,
        motion="room", device="cuda")
    work = tempfile.mkdtemp(prefix="chip_smoke_routes_")
    folder = os.path.join(work, "room")
    write_pngs(folder, frames)
    del frames
    argv = cli_args(folder, K, W, H, preset="lehman_indoor") + ["--consistent-convention"]
    k3, k4, solve3 = ba_kernel.eligible_shape, gk.eligible_shape_global, ba_kernel.lm_solve

    def k3_12(C, P, D, n_fixed=1):
        return D <= 12 and k3(C, P, D, n_fixed)

    def k4_12(C, P, D, n_fixed=1):
        return D <= 12 and k4(C, P, D, n_fixed)

    def plain_past_12(g, **kw):
        return (ba_kernel.lm_solve_plain if g.cam_slot.shape[1] > 12 else solve3)(g, **kw)

    try:
        for name in names:
            cut3, cut4, plain3 = ROUTES[name]
            ba_kernel.eligible_shape = k3_12 if cut3 else k3
            gk.eligible_shape_global = k4_12 if cut4 else k4
            ba_kernel.lm_solve = plain_past_12 if plain3 else solve3
            t0 = time.perf_counter()
            split, restore, _ = solver_split(torch)
            try:
                a = run_cli(torch, argv + ["--out", os.path.join(work, name.replace(" ", "_"))])
            finally:
                restore()
            pipe = a["pipe"]
            ids = pipe.map.sorted_kf_ids()
            gt = np.stack([gt_C[pipe.map.keyframes[k].frame_idx] for k in ids])
            ate = ate_rmse(pipe.map.trajectory(True), gt, with_scale=True)
            extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
            ev = pipe.log.events
            closures = [e for e in ev if e["event"] == "loop_closure"]
            fm = np.asarray([e["wall_ms"] for e in a["frames"]])
            print(f"== {name}: keyframes {len(ids)}, closures {len(closures)} (scale, keyframe, "
                  f"anchor: {[(e['scale'], e['kf_id'], e['anchor_kf']) for e in closures]}), "
                  f"ATE {100 * ate / extent:.2f} % of the extent; divergences "
                  f"{sum(e['event'] == 'ba_diverged' for e in ev)}; longest frame "
                  f"{fm.max() / 1e3:.2f} s; finalize {a['finalize_s']:.2f} s; solves by solver "
                  f"{split}; pcg_plain_solver events "
                  f"{sum(e['event'] == 'pcg_plain_solver' for e in ev)}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for i, r in enumerate(a["pcg"]):
                print(f"   solve {i} ({'finalize' if r['finalize'] else 'polish'}) C={r['C']} "
                      f"P={r['P']} D={r['D']}: {r['initial_sq']:.6g} -> {r['final_sq']:.6g} in "
                      f"{r['iterations']} ({r['stop']}), {r['seconds']:.3f} s, K4 launches "
                      f"{sum(r['k4'].values())}", flush=True)
            del a, pipe
    finally:
        ba_kernel.eligible_shape, gk.eligible_shape_global, ba_kernel.lm_solve = k3, k4, solve3
    return 0


def main() -> int:
    script_t0 = time.perf_counter()
    phase_marks = []       # (phase, its start on the host clock)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the checks, run the CLI with --profile over the "
                         "first N frames and profile one finalize of the global "
                         "path's map (default 0: no profile)")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only build the kernels and time K1, K3, K4a, K4b and K4d "
                         "(kernel_times), print one JSON line and exit")
    ap.add_argument("--tree", default=None, metavar="DIR",
                    help="with --kernel-times: import the port from DIR (a git archive of "
                         "another commit) instead of this checkout")
    ap.add_argument("--routes", nargs="+", default=None, choices=sorted(ROUTES), metavar="NAME",
                    help="only drive phase 11's run (a2) under these routings of its solves "
                         f"(routes_study; {', '.join(repr(k) for k in ROUTES)}) and exit")
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
    if args.routes:
        return routes_study(torch, np, args.routes)

    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch import kernels, native
    from bundle_adjustment_tpu_torch import run as run_mod
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
        synthetic_global_map, synthetic_global_problem, synthetic_ring_problem,
        synthetic_sequence, synthetic_window)

    K4_ROLES = (ba_global_kernel.SETUP, ba_global_kernel.MATVEC, ba_global_kernel.BACKSUB,
                ba_global_kernel.COST)
    mods = types.SimpleNamespace(gk=ba_global_kernel, BAProblem=BAProblem, from_flat=from_flat,
                                 synthetic_global_problem=synthetic_global_problem,
                                 synthetic_ring_problem=synthetic_ring_problem)

    if "jax" in sys.modules:
        fail("the port imported jax")

    phase_marks.append(("1", time.perf_counter()))
    # -- 1. the card ---------------------------------------------------------
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    device_mod.set_float32_numerics()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    phase_marks.append(("2", time.perf_counter()))
    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build_all(verbose=True)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"(per kernel: { {k: round(v, 2) for k, v in built.items()} }); registers and "
          "shared memory per kernel in ptxas's lines above")
    print(f"K3 launches one cluster of "
          f"{kernels.library_const(ba_kernel.NAME, 'ba_window_lm_cluster_size')} CTAs")
    t0 = time.perf_counter()
    native.build()
    print(f"built the host runtime {native.SOURCE.name} with g++ in "
          f"{time.perf_counter() - t0:.2f} s")

    phase_marks.append(("3-5", time.perf_counter()))
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

    phase_marks.append(("6", time.perf_counter()))
    # -- 6. the main path, through the CLI ------------------------------------
    W, H = 1280, 720
    t0 = time.perf_counter()
    frames, K, gt_C, _ = synthetic_sequence(
        n_frames=args.frames, width=W, height=H, fx=CAMERA_LEHMAN.fx,
        seed=args.seed, motion="strafe")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    folder = os.path.join(work, "frames")
    write_pngs(folder, frames)
    print(f"rendered {len(frames)} frames {W}x{H} and wrote them as PNG files in "
          f"{time.perf_counter() - t0:.1f} s")
    cam = CameraModel(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                      cy=float(K[1, 2]), width=W, height=H)
    cfg = preset_video(cam)
    if not (cfg.ba.use_pallas_ba and cfg.ba.window_size == 5 and cfg.ba.n_fixed == 2):
        fail(f"preset_video no longer ships the default BAConfig: {cfg.ba}")
    argv = cli_args(folder, K, W, H)
    if run_mod._config(run_mod.build_parser().parse_args(argv + ["--out", work])) != \
            dataclasses.replace(cfg, output_dir=work):
        fail("the CLI's arguments do not give preset_video with the fitted camera")

    def cli_run(tag: str, extra: list) -> dict:
        return run_cli(torch, argv + ["--out", os.path.join(work, tag)] + extra)

    # the first run in the process pays the first uses (the 5-point solver's
    # kernels, cuSOLVER): a second pipelined run, after the sequential one,
    # compares the two at equal footing
    runs = {tag: cli_run(tag, extra) for tag, extra in
            (("pipelined", []), ("sequential", ["--no-pipelined"]), ("pipelined again", []))}
    main_run = runs["pipelined"]
    pipe, summary, launches = main_run["pipe"], main_run["summary"], main_run["launches"]
    statuses = [e["status"] for e in main_run["frames"]]
    for tag, r in runs.items():
        st = [e["status"] for e in r["frames"]]
        ids, poses = keyframe_state(np, r["pipe"])
        print(f"CLI run, {tag}: statuses {''.join(x[0] for x in st)} (i=initialized "
              f"k=keyframe t=tracked d=discarded); {r['summary']['frames_per_s']} frames/s over "
              f"{r['summary']['elapsed_s']} s, run.main {r['seconds']:.2f} s")
    ids_a, poses_a = keyframe_state(np, runs["pipelined"]["pipe"])
    for tag in ("sequential", "pipelined again"):
        ids_b, poses_b = keyframe_state(np, runs[tag]["pipe"])
        st_b = [e["status"] for e in runs[tag]["frames"]]
        if statuses != st_b or ids_a != ids_b or not np.array_equal(poses_a, poses_b):
            fail(f"the pipelined and the {tag} CLI runs differ: statuses {statuses == st_b}, "
                 f"keyframe ids {ids_a == ids_b}, poses equal "
                 f"{poses_a.shape == poses_b.shape and np.array_equal(poses_a, poses_b)}")
    print(f"pipelined, sequential, pipelined again: statuses, {len(ids_a)} keyframe ids and "
          "poses bit-equal")

    frame_of_kf = {k: pipe.map.keyframes[k].frame_idx for k in pipe.map.sorted_kf_ids()}
    out_dir = main_run["out"]
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
    for tag, r in runs.items():
        fm = np.asarray([e["wall_ms"] for e in r["frames"]])
        print(f"{tag}: per-frame wall ms median {np.median(fm):.1f}, p90 "
              f"{np.percentile(fm, 90):.1f}, first {fm[0]:.1f}, first tracked (frame 1) "
              f"{fm[1]:.1f}, max {fm.max():.1f}; frames 2 on {fm[2:].sum() / 1e3:.3f} s; "
              "median by status " + ", ".join(
                  f"{k} {np.median([w for w, e in zip(fm, r['frames']) if e['status'] == k]):.1f}"
                  f" ({sum(e['status'] == k for e in r['frames'])})"
                  for k in dict.fromkeys(e["status"] for e in r["frames"]))
              + "; slowest " + ", ".join(
                  f"#{i} {r['frames'][i]['status']} {fm[i]:.1f}" for i in np.argsort(-fm)[:4]))
    print(f"keyframes {n_kf}, map points {n_pts}, observations "
          f"{pipe.map.num_observations}, ba_complete events {n_ba} of "
          f"{len(ba_events)} BA solves, K3 launches {launches['ba_window_lm']}, final BA "
          f"{json.dumps(gba)}")
    print(f"keyframe-centre ATE after similarity alignment {ate:.4f} "
          f"(motion scale {scale:.3f})")
    print(f"launches on the main path (pipelined CLI run): {launches}; peak device memory "
          f"{main_run['peak'] / 2 ** 20:.1f} MiB")

    # the tracked-frame graph: one capture, one replay per fused frame (the
    # pipelined run also replays for a speculative step it drops), one host
    # read per frame that is tracked by the step's PnP and not a keyframe
    # (the essential-RANSAC fallback stays eager and reads more)
    fused = sum(1 for x in statuses if x != "initialized")
    for tag, r in runs.items():
        ts = r["summary"]["track_step"]
        reads = {}
        for e in r["frames"]:
            key = e["status"] + (f" ({e['pose']})" if e.get("pose") else "")
            reads.setdefault(key, []).append(e["host_reads"])
        print(f"{tag}: tracked-frame graph captures {ts['captures']} "
              f"({', '.join(f'{c:.2f}' for c in ts['capture_s'])} s with the warm-up), replays "
              f"{ts['replays']} for {fused} frames past the first; host reads per frame by "
              f"status: " + "; ".join(f"{k} {sorted(set(v))} (mean {statistics.mean(v):.2f})"
                                       for k, v in reads.items())
              + f"; host reads in all {r['summary']['host_reads']}")
        if ts["captures"] != 1:
            fail(f"{tag}: {ts['captures']} captures of the tracked-frame step, expected 1")
        if any(n != 1 for n in reads.get("tracked (pnp)", [])):
            fail(f"{tag}: a frame tracked by the fused step's PnP read the host other than "
                 f"once: {reads['tracked (pnp)']}")
        n_kf_frames = sum(1 for x in statuses if x == "keyframe")
        dropped = ts["replays"] - fused
        if (tag == "sequential" and dropped != 0) or not 0 <= dropped <= n_kf_frames:
            fail(f"{tag}: {ts['replays']} replays of the tracked-frame graph for {fused} frames")
    per_replay = pipe.track.captures[0]["launches_per_replay"]
    n_dropped = runs["pipelined"]["summary"]["track_step"]["replays"] - fused
    print(f"a replay launches {per_replay}; pipelined run: {n_dropped} speculative steps "
          "dropped and reissued")

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
    with open(f"{out_dir}/summary.json") as fh:
        on_disk = json.load(fh)
    if not all(k in on_disk for k in ("frames", "elapsed_s", "frames_per_s")) \
            or on_disk["frames"] != len(frames):
        fail(f"summary.json lacks frames, elapsed_s or frames_per_s: {on_disk}")
    for name in ("hamming_knn2", "orb_gather40", "ba_window_lm"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    replays = summary["track_step"]["replays"]
    if launches["hamming_knn2"] < replays * per_replay.get("hamming_knn2", 0) \
            or launches["orb_gather40"] < replays * per_replay.get("orb_gather40", 0) \
            or per_replay.get("hamming_knn2") != 1 \
            or per_replay.get("orb_gather40") != cfg.pyramid_levels:
        fail(f"K1 and K2 not counted once per replay: {launches}, {replays} replays of "
             f"{per_replay}")
    n_windowed = sum(1 for e in ba_events if not e.get("global_ba"))
    if not n_windowed <= launches["ba_window_lm"] <= len(ba_events):
        fail(f"{n_windowed} windowed of {len(ba_events)} BA solves on the main path but "
             f"{launches['ba_window_lm']} K3 launches: every windowed BA of the default "
             "configuration is inside the kernel's gate")
    if "jax" in sys.modules:
        fail("the port imported jax")
    ba_s = sum(e.get("elapsed_s", 0.0) for e in ba_events)
    print(f"time in BA solves (events' elapsed_s): {ba_s:.2f} s of "
          f"{summary['elapsed_s']:.2f} s for all frames; per solve "
          + ", ".join(f"{e.get('elapsed_s', 0.0) * 1e3:.0f}" for e in ba_events) + " ms")

    # 6b. the graph against eager track_step, and the step's times
    st = step_check_and_times(torch, np, VisualOdometryPipeline, cfg, frames, EventLog)
    print(f"graph replay vs eager track_step on frames 1-3: packed, insert_packed and kp_desc "
          f"bit-equal; eager track_step {st['eager_ms']:.2f} ms per call, one dispatch of the "
          f"graph (image upload, draw, replay, output copies) {st['replay_ms']:.2f} ms "
          f"(host clock to a synchronise, median of 5); eager split by stage (synchronised, "
          f"{st['split_total_ms']:.2f} ms in all): " + ", ".join(
              f"{k} {v:.2f}" for k, v in st["split_ms"].items()))

    # 6c. the first tracked frame in fresh processes, without and with --prewarm
    short = os.path.join(work, "frames_short")
    os.makedirs(short)
    for name in sorted(os.listdir(folder))[:8]:
        os.symlink(os.path.join(folder, name), os.path.join(short, name))
    fresh = fresh_process_first_frames(work, short, K, W, H)
    print("first tracked frame in a fresh process (CLI over 8 frames): " + "; ".join(
        f"{tag} {r['first_tracked_ms']:.1f} ms (frame 0 {r['frame0_ms']:.1f} ms"
        + (f", prewarm {r['prewarm_s']:.2f} s" if r["prewarm_s"] is not None else "")
        + f", process {r['process_s']:.1f} s)" for tag, r in fresh.items()))

    # an untimed second run over the same frames records the first K1 inputs
    # launched outside a capture (the tracked-frame step's warm-up, the
    # covisibility matches) and every K3 window (clones), which are then
    # replayed alone
    k1_shapes, k1_calls, k3_calls = [], [], []

    def keep_k1(a, kw):
        if torch.cuda.is_current_stream_capturing():
            return
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
    if rec_statuses != statuses or len(k3_calls) != launches["ba_window_lm"]:
        fail("the recording run's statuses or K3 launches differ from the main path's")
    # exact K1 count: the main path's launches outside the graph are the
    # recording run's (one warm-up, the covisibility matches), and each replay
    # adds one
    k1_expected = len(k1_shapes) + replays * per_replay["hamming_knn2"]
    if launches["hamming_knn2"] != k1_expected:
        fail(f"{launches['hamming_knn2']} K1 launches on the main path, expected "
             f"{len(k1_shapes)} outside the graph + {replays} replays x "
             f"{per_replay['hamming_knn2']} = {k1_expected}")
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
    # the main path's last window BA, for phase 12's sharded solve
    win_ids = pipe.map.sorted_kf_ids()[-(cfg.ba.window_size + 1):-1]
    problem_w = pipe.map.gather_window(win_ids, pipe.K, cfg.ba.max_points, cfg.ba.max_obs)[0]
    main_window = dict(problem={k: getattr(problem_w, k).cpu().numpy()
                                for k in problem_w._fields},
                       n_fixed=max(1, min(cfg.ba.n_fixed, len(win_ids) - 1)))
    # phase 13's comparison: the trajectory (the three runs are bit-equal) and
    # the frames' seconds of a run that did not pay the process's first uses
    plain = dict(out=out_dir, elapsed_s=runs["pipelined again"]["summary"]["elapsed_s"])
    # the clones, and the pipelines with their graphs' memory pools, stay out
    # of the later phases' peak memory
    del k1_calls, k3_calls, rec, runs, main_run, pipe, problem_w
    gc.collect()

    phase_marks.append(("7", time.perf_counter()))
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

    phase_marks.append(("8", time.perf_counter()))
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

    del pipe_grid, p2
    gc.collect()

    phase_marks.append(("9", time.perf_counter()))
    # -- 9. the global path at full width -------------------------------------

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

    phase_marks.append(("10", time.perf_counter()))
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

    phase_marks.append(("11", time.perf_counter()))
    # -- 11. preset_lehman_indoor at full width ----------------------------
    del pipe_pcg
    gc.collect()
    lehman = lehman_indoor_phase(torch, np, work)

    phase_marks.append(("12", time.perf_counter()))
    # -- 12. the native observation table and the parallel paths ------------
    gc.collect()
    parallel = native_parallel_phase(torch, np, work, args.seed, folder, K, W, H, gt_C,
                                     main_window, lehman, [e["final_cost"] for e in g1["events"]])

    phase_marks.append(("13", time.perf_counter()))
    # -- 13. --debug, analyze_log, cv2 features ------------------------------
    gc.collect()
    debug = debug_phase(torch, np, work, folder, K, W, H, plain)

    # -- 14. the stress harness on the JAX cell of seed 2 ---------------------
    phase_marks.append(("14", time.perf_counter()))
    gc.collect()
    stress_launches = stress_phase(torch, np, work)

    # -- 15. the global scale sweep at C = 2048 and D = 91 --------------------
    phase_marks.append(("15", time.perf_counter()))
    sweep_phase(torch)
    phase_marks.append(("end", time.perf_counter()))

    if args.profile:
        # the CLI over the first N frames under torch.profiler
        pfolder = os.path.join(work, "frames_profiled")
        os.makedirs(pfolder)
        for name in sorted(os.listdir(folder))[: args.profile]:
            os.symlink(os.path.join(folder, name), os.path.join(pfolder, name))
        prof = run_mod.main(cli_args(pfolder, K, W, H)
                            + ["--out", os.path.join(work, "profiled"), "--profile"])["profile"]
        print(f"profile of the CLI over {args.profile} frames (pipelined): wall "
              f"{prof['wall_ms']:.1f} ms, device busy {prof['device_ms']:.1f} ms "
              f"({100 * prof['device_busy']:.1f} %)")
        gpipe = global_pipe()
        profile_call(torch, f"finalize of the {N_KF}-keyframe map",
                     lambda: gpipe.finalize(tempfile.mkdtemp(prefix="chip_smoke_prof_")))

    record = {"kernels": [
        dict(name="hamming_knn2", route="cuda",
             source="bundle_adjustment_tpu_torch/csrc/hamming_knn2.cu",
             replaces="bundle_adjustment_tpu/ops/hamming_pallas.py:87",
             launches=launches["hamming_knn2"], library_ms=None, **k1,
             launches_lehman_indoor=lehman["launches_a"]["hamming_knn2"],
             launches_parallel=parallel["launches"]["hamming_knn2"],
             launches_debug=debug["launches"]["hamming_knn2"],
             launches_lehman_a2=lehman["launches_a2"]["hamming_knn2"],
             launches_stress=stress_launches["hamming_knn2"]),
        dict(name="orb_gather40", route="cuda",
             source="bundle_adjustment_tpu_torch/csrc/orb_gather.cu",
             replaces="bundle_adjustment_tpu/ops/orb_pallas.py:97",
             launches=launches["orb_gather40"], library_ms=None, **k2,
             launches_lehman_indoor=lehman["launches_a"]["orb_gather40"],
             launches_parallel=parallel["launches"]["orb_gather40"],
             launches_debug=debug["launches"]["orb_gather40"],
             launches_lehman_a2=lehman["launches_a2"]["orb_gather40"],
             launches_stress=stress_launches["orb_gather40"]),
        dict(name="ba_window_lm", route="cuda",
             source="bundle_adjustment_tpu_torch/csrc/ba_window_lm.cu",
             replaces="bundle_adjustment_tpu/ops/ba_pallas.py:521",
             launches=launches["ba_window_lm"], library_ms=None, **k3,
             launches_lehman_indoor=lehman["launches_a"]["ba_window_lm"],
             launches_parallel=parallel["launches"]["ba_window_lm"],
             launches_debug=debug["launches"]["ba_window_lm"],
             launches_lehman_a2=lehman["launches_a2"]["ba_window_lm"],
             launches_stress=stress_launches["ba_window_lm"]),
    ] + [
        dict(name=role, route="cuda",
             source="bundle_adjustment_tpu_torch/csrc/ba_global_pcg.cu",
             replaces=f"bundle_adjustment_tpu/ops/ba_global_pallas.py:{line}",
             launches=g_launches[role], library_ms=None, **k4[role],
             launches_lehman_indoor=lehman["launches_a"][role],
             launches_parallel=parallel["launches"][role],
             launches_debug=debug["launches"][role],
             launches_lehman_a2=lehman["launches_a2"][role],
             launches_stress=stress_launches[role])
        for role, line in zip(K4_ROLES, (339, 522, 583, 621))
    ]}
    print(f"parallel paths: backend {parallel['backend']}, world size "
          f"{parallel['world_size']}, {parallel['ranks_per_card']} ranks per card")
    print("seconds per phase: " + ", ".join(
        f"{a}: {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(phase_marks, phase_marks[1:])))
    print(f"chip_smoke.py: {time.perf_counter() - script_t0:.1f} s in all")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
