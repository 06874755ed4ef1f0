"""Command-line entry point of the port (counterpart of ``bundle_adjustment_tpu.run``):
frames from a folder of images or a video through ``VisualOdometryPipeline``,
then ``finalize``; writes the trajectory, the map, ``events.jsonl`` and
``summary.json`` (with ``frames``, ``elapsed_s`` and ``frames_per_s``) into
``--out``.

Usage:
    python -m bundle_adjustment_tpu_torch.run --preset video --images DIR --out OUT
    python -m bundle_adjustment_tpu_torch.run --preset video --images DIR --device cpu

Runs on the card (``--device cuda``, the default) and raises where there is
none; ``--device cpu`` runs the plain PyTorch path.  A folder of 8-bit PNG
files is read without cv2 (``utils/io.read_png``); other images and videos
need cv2.  By default the frames are pipelined (``process_stream``: frame
N+1's tracked-frame step is issued before frame N's read); ``--no-pipelined``
runs ``process_frame`` one frame after another.  ``--prewarm`` builds the
kernels, captures the tracked-frame step's CUDA graph and runs the first-use
paths on a synthetic sequence before the frame loop (``utils/prewarm``).
``--profile`` runs the frame loop under ``torch.profiler``: the trace goes
to ``OUT/torch_trace.json`` and the device's busy share into the summary.
``--checkpoint PATH`` resumes from PATH when it exists (skipping the source
frames already consumed) and saves the pipeline there after the frame loop,
before ``finalize`` (``utils/checkpoint``).

``--mesh N`` shards bundle adjustment's points over N ranks
(``mesh_shape=(1, N)``, ``parallel/dist_ba``).  ``--multihost`` joins the
process group of a ``torchrun`` launch (``env://``); every rank runs the
same frames, each on ``cuda:{LOCAL_RANK % device_count}`` (or the CPU with
``--device cpu``), and rank 0 writes the outputs (the others finalize into
a temporary folder that is removed).  The backend is NCCL when every rank
has a card of its own and gloo when ranks share one (``parallel/mesh``);
it is printed and kept in ``summary.json`` with the world size and the
ranks per card:

    torchrun --nproc-per-node 2 -m bundle_adjustment_tpu_torch.run \
        --multihost --mesh 2 --preset video --images DIR --out OUT

``--debug`` writes the JAX package's debug artifacts (per-keyframe
trajectory plots and overlays, the sparsity spy of every BA window, the map
after each window BA), drawn on the pipeline's device, and the overlay
videos where cv2 is installed (where it is not, a ``debug_videos_skipped``
event and summary field name them).  ``--features-from-cv2`` takes OpenCV's
ORB features (needs cv2).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import shutil
import tempfile
import time

from bundle_adjustment_tpu_torch import config as cfg_mod

PRESETS = {
    "desk": cfg_mod.preset_desk,
    "scout": cfg_mod.preset_scout,
    "video": cfg_mod.preset_video,
    "lehman_indoor": cfg_mod.preset_lehman_indoor,
}

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", choices=sorted(PRESETS), default="video")
    p.add_argument("--video", help="video file input (needs cv2)")
    p.add_argument("--images", help="image folder input (sorted by name)")
    p.add_argument("--start", type=int, default=0, help="first video frame")
    p.add_argument("--end", type=int, default=None, help="last video frame (exclusive)")
    p.add_argument("--out", default="output_map")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the pipeline runs (default: the card; raises where there is none)")
    p.add_argument("--debug", action="store_true",
                   help="per-keyframe debug artifacts (plots, overlays, sparsity spies, "
                        "videos where cv2 is installed)")
    p.add_argument("--pcd-series", action="store_true",
                   help="write a per-keyframe PCD series")
    p.add_argument("--consistent-convention", action="store_true",
                   help="use the geometrically consistent pose chain instead of the "
                        "reference-parity one (see config.py)")
    p.add_argument("--features", type=int, default=None)
    p.add_argument("--features-from-cv2", action="store_true",
                   help="cv2.ORB features (needs cv2)")
    p.add_argument("--fx", type=float, default=None,
                   help="override camera intrinsics (use with --fy/--cx/--cy)")
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--size", default=None, metavar="WxH",
                   help="frame size for the camera model, e.g. 640x480")
    p.add_argument("--no-clean", action="store_true",
                   help="keep existing output dir contents")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="shard bundle adjustment's points over N ranks (mesh_shape=(1, N))")
    p.add_argument("--profile", action="store_true",
                   help="run the frame loop under torch.profiler (trace in "
                        "<out>/torch_trace.json, device busy share in the summary)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group of a torchrun launch (env://); rank 0 "
                        "writes the outputs")
    p.add_argument("--checkpoint", default=None,
                   help="resume from this checkpoint when it exists, and save to it "
                        "after the frame loop")
    p.add_argument("--prewarm", action="store_true",
                   help="build the kernels, capture the tracked-frame graph and run the "
                        "first-use paths on a synthetic sequence before the frame loop")
    p.add_argument("--no-pipelined", action="store_true",
                   help="issue frame N+1's tracked-frame step only after frame N's read")
    return p


def _config(args) -> cfg_mod.PipelineConfig:
    cfg = PRESETS[args.preset]()
    overrides = {"output_dir": args.out, "debug": args.debug,
                 "export_pcd_series": args.pcd_series}
    if args.consistent_convention:
        overrides["consistent_convention"] = True
    if args.features:
        overrides["num_features"] = args.features
    if args.features_from_cv2:
        overrides["features_source"] = "cv2"
    if args.mesh:
        overrides["mesh_shape"] = (1, args.mesh)
    if args.fx is not None:
        w, h = cfg.camera.width, cfg.camera.height
        if args.size:
            w, h = (int(x) for x in args.size.lower().split("x"))
        overrides["camera"] = cfg_mod.CameraModel(
            fx=args.fx, fy=args.fy if args.fy is not None else args.fx,
            cx=args.cx if args.cx is not None else w / 2,
            cy=args.cy if args.cy is not None else h / 2, width=w, height=h)
    return dataclasses.replace(cfg, **overrides)


def _device_busy(prof, wall_s: float) -> dict:
    """The profiled window's wall time, the device's kernel time in it and
    the busy share."""
    from torch.autograd import DeviceType

    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    return {"wall_ms": round(wall_s * 1e3, 3), "device_ms": round(dev_us / 1e3, 3),
            "device_busy": round(dev_us / 1e6 / max(wall_s, 1e-9), 4)}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if not (args.images or args.video):
        raise SystemExit("provide --video or --images")

    import torch

    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch.parallel import mesh as mesh_mod

    dist_info = None
    if args.multihost:
        device, dist_info = mesh_mod.init_from_env(args.device)
    else:
        device = device_mod.resolve(args.device)
    try:
        return _run(args, device, dist_info)
    finally:
        if dist_info is not None:
            torch.distributed.destroy_process_group()


def _run(args, device, dist_info) -> dict:
    """``main`` after the device (and under ``--multihost`` the process
    group) is set up."""
    import torch

    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog
    from bundle_adjustment_tpu_torch.utils.io import image_folder_frames, prefetch, video_frames
    from bundle_adjustment_tpu_torch.utils.prewarm import prewarm

    lead = dist_info is None or dist_info["rank"] == 0
    # rank 0 writes the outputs; another rank finalizes into a folder of its own
    out = args.out if lead else tempfile.mkdtemp(prefix=f"rank{dist_info['rank']}_")
    cfg = dataclasses.replace(_config(args), output_dir=out)
    if lead and not args.no_clean and os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out, exist_ok=True)

    log = EventLog(os.path.join(out, "events.jsonl"), echo=lead)
    resumed_frames = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        pipe = load_checkpoint(args.checkpoint, cfg, log=log, device=device)
        # frame_idx counts the frames already consumed (0-based): skip as
        # many source frames, or they would enter the restored map twice
        resumed_frames = pipe.frame_idx + 1
        print(f"Resumed from {args.checkpoint}: frame {pipe.frame_idx}, "
              f"{pipe.map.num_keyframes} keyframes; skipping the first {resumed_frames} "
              "source frames")
    else:
        pipe = VisualOdometryPipeline(cfg, log=log, device=device)
    if args.prewarm:
        info = prewarm(cfg, device=device, track=pipe.track)
        log.emit("prewarm", f"Prewarm: {info['frames']} synthetic frames in "
                 f"{info['prewarm_s']} s (kernels built, tracked-frame graph captured)",
                 **info)

    if args.images:
        frames = image_folder_frames(args.images)
    else:
        frames = video_frames(args.video, start=args.start, end=args.end)
    frames = prefetch(itertools.islice(frames, resumed_frames, None))

    profiler = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))

    n_frames = 0
    with profiler as prof:
        t0 = time.perf_counter()
        if args.no_pipelined:
            for frame in frames:
                pipe.process_frame(frame)
                n_frames += 1
        else:
            for _ in pipe.process_stream(frames):
                n_frames += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0

    if args.checkpoint and lead:
        save_checkpoint(pipe, args.checkpoint)
    summary = pipe.finalize(out)
    summary["frames"] = n_frames
    summary["resumed_frames"] = resumed_frames
    summary["elapsed_s"] = round(elapsed, 3)
    summary["frames_per_s"] = round(n_frames / max(elapsed, 1e-9), 3)
    summary["host_reads"] = pipe.host_reads
    summary["track_step"] = {"captures": len(pipe.track.captures),
                             "replays": pipe.track.replays,
                             "capture_s": [round(c["seconds"], 3) for c in pipe.track.captures]}
    if dist_info is not None:
        summary["distributed"] = dist_info
    if args.profile:
        prof.export_chrome_trace(os.path.join(out, "torch_trace.json"))
        summary["profile"] = _device_busy(prof, elapsed)
    log.metric("frames_per_s", summary["frames_per_s"], frames=n_frames)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log.close()
    if lead:
        print(json.dumps(summary))
    else:
        shutil.rmtree(out)
    return summary


if __name__ == "__main__":
    main()
