"""Frames/s harness: the counterpart of the JAX package's
``tools/fps_bench.py``, with its flags (``--frames``, ``--warmup``,
``--seed``, ``--first-run-probe``, ``--prewarm``) and its JSON keys
(metric "frontend_fps": ``pipelined_fps``, ``fused_fps``, ``staged_fps``,
their ``*_tracked_ms``, ``pp_overlap_speedup``, ``tracked_speedup``,
``tracked_frames``, ``keyframes``, ``frames``, ``backend``; metric
"first_run_fps" with ``--first-run-probe``).

The same synthetic sequence (``utils/synthetic``'s strafe render) runs
through pipelines that differ only in ``fused_frontend``: fused (each
tracked frame one replay of the step's CUDA graph, ``models/frontend.
TrackStep``), the same through ``process_stream`` (pipelined), and staged
(``fused_frontend=False``: the step's stages as separate calls).  The
steady-state loop is timed on the host clock after a warm-up prefix (the
graph's capture, the kernels' first launches and the map's bootstrap), with
the JAX tool's configuration: 1500 features, 4 levels, strict keyframe
criteria so that most frames take the tracked path.  ``--device`` is the
card by default (``--device cpu`` for the tests); the JAX tool's
``--platform`` has no counterpart.  ``--first-run-probe`` times one
pipelined pass of the fused pipeline in a fresh process (with
``--prewarm``, after an unmeasured pass over another sequence of the same
shapes, as ``run.py --prewarm`` does before frame 0).

    python -m bundle_adjustment_tpu_torch.tools.fps_bench --frames 40
    python -m bundle_adjustment_tpu_torch.tools.fps_bench --device cpu --frames 8 \\
        --warmup 3 --size 320x240 --features 300
"""

from __future__ import annotations

import argparse
import json
import time


def run_mode(frames, K, fused: bool, warmup: int, dev, features: int,
             pipelined: bool = False) -> tuple:
    """(frames/s over the frames after ``warmup``, median ms of a tracked
    frame, tracked frames, keyframes) of one pipeline over ``frames``."""
    from bundle_adjustment_tpu_torch.config import BAConfig, CameraModel, KeyframeCriteria, \
        PipelineConfig
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog

    cfg = PipelineConfig(
        camera=CameraModel(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                           cy=float(K[1, 2]), width=frames[0].shape[1],
                           height=frames[0].shape[0]),
        num_features=features, pyramid_levels=4,
        min_tracked_features=15, pose_inlier_ratio=0.4, pose_inlier_numbers=15,
        consistent_convention=True,
        # the JAX tool's strict criteria: most frames take the tracked path
        keyframe=KeyframeCriteria(min_parallax_deg=8.0, min_median_displacement_px=80.0,
                                  min_rotation_rad=0.8, min_feature_ratio=0.05),
        ba=BAConfig(window_size=4, max_points=4096, max_obs=16384),
        fused_frontend=fused,
    )
    pipe = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device=dev)
    for f in frames[:warmup]:
        pipe.process_frame(f)
    statuses, per_frame = [], []
    t0 = time.perf_counter()
    if pipelined:
        # the per-frame time is the gap between two results
        t1 = t0
        for r in pipe.process_stream(frames[warmup:]):
            now = time.perf_counter()
            statuses.append(r.get("status"))
            per_frame.append(now - t1)
            t1 = now
    else:
        for f in frames[warmup:]:
            t1 = time.perf_counter()
            statuses.append(pipe.process_frame(f).get("status"))
            per_frame.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0
    tracked = sorted(1e3 * t for t, s in zip(per_frame, statuses) if s == "tracked")
    median = tracked[len(tracked) // 2] if tracked else float("nan")
    return (len(frames) - warmup) / dt, median, len(tracked), pipe.map.num_keyframes


def ms_or_none(ms: float):
    """A median ms rounded as the JAX tool prints it; None where no frame
    was tracked (the JAX tool prints NaN, which JSON does not have)."""
    return round(ms, 1) if ms == ms else None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", default="640x480",
                    help="the render's WxH (the JAX tool's synthetic_sequence default)")
    ap.add_argument("--features", type=int, default=1500)
    ap.add_argument("--first-run-probe", action="store_true",
                    help="one pipelined pass of the fused pipeline in this fresh process")
    ap.add_argument("--prewarm", action="store_true",
                    help="with --first-run-probe: an unmeasured pass over another sequence "
                         "of the same shapes first")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch.tools.stress import device_name
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_sequence

    dev = device_mod.resolve(args.device)
    if dev.type == "cuda":
        device_mod.set_float32_numerics()
    W, H = (int(v) for v in args.size.split("x"))

    def sequence(seed):
        return synthetic_sequence(n_frames=args.frames, width=W, height=H, motion="strafe",
                                  seed=seed, device=dev)[:2]

    frames, K = sequence(args.seed)
    if args.first_run_probe:
        pw_s = None
        if args.prewarm:
            t0 = time.perf_counter()
            run_mode(*sequence(args.seed + 1), True, args.warmup, dev, args.features,
                     pipelined=True)
            pw_s = round(time.perf_counter() - t0, 1)
        fps1, ms1, nt1, kf1 = run_mode(frames, K, True, args.warmup, dev, args.features,
                                       pipelined=True)
        out = {"metric": "first_run_fps", "first_run_fps": round(fps1, 3),
               "tracked_ms": ms_or_none(ms1),
               "tracked_frames": nt1, "keyframes": kf1, "prewarm_s": pw_s,
               "frames": args.frames, "backend": dev.type, "device": device_name(dev.type)}
        print(json.dumps(out))
        return out

    # fused first, so that it pays the process's first uses; the pipelined
    # run then measures the overlap alone
    fps_f, ms_f, nt_f, kf_f = run_mode(frames, K, True, args.warmup, dev, args.features)
    fps_p, ms_p, nt_p, kf_p = run_mode(frames, K, True, args.warmup, dev, args.features,
                                       pipelined=True)
    fps_s, ms_s, nt_s, kf_s = run_mode(frames, K, False, args.warmup, dev, args.features)
    out = {
        "metric": "frontend_fps",
        "pipelined_fps": round(fps_p, 3),
        "fused_fps": round(fps_f, 3),
        "staged_fps": round(fps_s, 3),
        "pipelined_tracked_ms": ms_or_none(ms_p),
        "fused_tracked_ms": ms_or_none(ms_f),
        "staged_tracked_ms": ms_or_none(ms_s),
        "pp_overlap_speedup": round(ms_f / ms_p, 2) if ms_p == ms_p else None,
        "tracked_speedup": round(ms_s / ms_f, 2) if ms_f == ms_f else None,
        "tracked_frames": [nt_p, nt_f, nt_s],
        "keyframes": [kf_p, kf_f, kf_s],
        "frames": args.frames,
        "backend": dev.type,
        "device": device_name(dev.type),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
