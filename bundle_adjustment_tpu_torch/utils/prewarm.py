"""Cold-start work done ahead of the frame loop (counterpart of
``bundle_adjustment_tpu.utils.prewarm.prewarm``; ``run.py --prewarm``).

A run's first frames pay for what the process does the first time: the
kernels' build with nvcc and their load, the tracked-frame step's warm-up
and CUDA-graph capture, and every operation's first launch (cuBLAS and
cuSOLVER handles, the 5-point solver's complex kernels).  ``prewarm`` pays
them before the real frames: it builds the kernels and drives a short
synthetic sequence at the configuration's camera geometry through a scratch
pipeline that shares the real pipeline's ``TrackStep``, so the graph it
captures at the configuration's shape is the one the real frames replay.

Two segments, as in the JAX package: frames that are forced to be
keyframes walk initialisation, the essential-RANSAC fallback of the first
tracked frame, insertion, covisibility and the window BA of every window
length up to ``ba.window_size`` with the pose refine; then frames that are
never keyframes run the tracked path.  There is no on-disk cache:
``enable_persistent_cache`` has no counterpart (a process builds the
kernels into ``build/kernels`` once; graphs live with the process).
"""

from __future__ import annotations

import dataclasses
import tempfile
import time


def prewarm(cfg, device="cuda", track=None, echo: bool = False) -> dict:
    """Build the kernels and run the pipeline's first-use paths on a
    synthetic sequence.  ``track``: the real pipeline's ``TrackStep``, whose
    graph is captured here.  Returns timings and counts for the log."""
    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch import kernels
    from bundle_adjustment_tpu_torch.config import KeyframeCriteria
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_sequence

    dev = device_mod.resolve(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        kernels.build_all()
    build_s = time.perf_counter() - t0
    cam = cfg.camera
    n_forced = cfg.ba.window_size + 4   # windows of every length, and the refine
    n_tracked = 4
    frames, _, _, _ = synthetic_sequence(
        n_frames=n_forced + n_tracked, width=cam.width, height=cam.height,
        fx=cam.fx, motion="strafe")

    force_kf = KeyframeCriteria(min_feature_ratio=2.0)   # always a keyframe
    never_kf = KeyframeCriteria(min_parallax_deg=1e9, min_median_displacement_px=1e9,
                                min_rotation_rad=1e9, min_feature_ratio=0.0)
    with tempfile.TemporaryDirectory(prefix="ba_prewarm_") as tmp:
        warm_cfg = dataclasses.replace(
            cfg, output_dir=tmp, debug=False, export_pcd_series=False, keyframe=force_kf,
            # keep the scratch run moving where the synthetic scene tracks
            # more thinly than the preset expects
            min_tracked_features=min(cfg.min_tracked_features, 12),
            pose_inlier_numbers=min(cfg.pose_inlier_numbers, 12))
        pipe = VisualOdometryPipeline(warm_cfg, log=EventLog(echo=echo), device=dev)
        if track is not None:
            pipe.track = track
        for f in frames[:n_forced]:
            pipe.process_frame(f)
        # the keyframe criteria are read on the host per frame: swapping
        # them routes the last frames to the tracked path
        pipe.cfg = dataclasses.replace(warm_cfg, keyframe=never_kf)
        for f in frames[n_forced:]:
            pipe.process_frame(f)
        kfs = pipe.map.num_keyframes
    return {
        "prewarm_s": round(time.perf_counter() - t0, 3),
        "build_s": round(build_s, 3),
        "frames": n_forced + n_tracked,
        "keyframes": kfs,
        "graph_captures": len(pipe.track.captures),
    }
