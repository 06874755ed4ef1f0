"""Long-sequence stress harness: the counterpart of the JAX package's
``tools/stress.py``, with its flags and its JSON keys.

Drives ``preset_lehman_indoor`` (culling, relocalization, loop closure)
end to end through the port's CLI, ``bundle_adjustment_tpu_torch.run``, flag
for flag as the JAX harness drives its own (``--preset lehman_indoor --size
640x480 --consistent-convention --features 1500``, the camera of the
render), on a 600-frame render of the closed textured room, and scores the
run: keyframes, culled points, pruned observations, divergences,
relocalizations, capacity drops, closures, ATE against the ground truth over
the path length, frames/s.  Two keys more than the JAX harness's:
``ate_pct_of_extent`` (ATE over the extent of the keyframes' ground-truth
centres, the denominator PERF.md uses) and ``device`` (the card's name and
power limit as ``nvidia-smi`` gives them, or "cpu").

    python -m bundle_adjustment_tpu_torch.tools.stress --out OUT
    python -m bundle_adjustment_tpu_torch.tools.stress --video \\
        .dedup_study/s2_d3_cpu/sequence.mp4 --seed 2 --out OUT

The input is the port's render (``utils/synthetic.synthetic_sequence``),
written as ``OUT/sequence.mp4`` through cv2 as the JAX harness writes it, or
with ``--png`` as a folder of PNG files that needs no cv2; or, with
``--video``, a sequence written earlier (a JAX cell's ``sequence.mp4``, read
as it is through cv2, which is then needed: without it the harness stops
and names it), scored against the ground truth of ``--seed`` and
``--frames``.  ``--device cpu`` runs the pipeline on the CPU (for the
tests); by default it runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np

#: the render's camera: ``synthetic_sequence``'s defaults, 640 x 480
WIDTH, HEIGHT, FX = 640, 480, 450.0


def device_name(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or "cpu"."""
    if device == "cpu":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        import torch

        return f"{torch.cuda.get_device_name(0)} (nvidia-smi not read)"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--motion", default="room", choices=["room", "strafe", "orbit"])
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--out", default="stress_out")
    ap.add_argument("--preset", default="lehman_indoor")
    ap.add_argument("--features", type=int, default=1500)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--staged", action="store_true",
                    help="disable the fused frontend (for A/B comparison)")
    ap.add_argument("--dedup-px", type=float, default=None,
                    help="override ops.orb._DEDUP_CELL_PX for this run")
    ap.add_argument("--video", default=None,
                    help="a sequence written earlier (e.g. a JAX cell's sequence.mp4), read "
                         "as it is through cv2, in place of a render")
    ap.add_argument("--png", action="store_true",
                    help="write the render as a folder of PNG files (no cv2 needed) in "
                         "place of sequence.mp4")
    return ap


def score(run_out: str, summary: dict, gt_C: np.ndarray) -> dict:
    """The JAX harness's score of a run (``tools/stress.py``), and the ATE
    over the extent of the keyframes' ground-truth centres."""
    from bundle_adjustment_tpu_torch.utils.event_log import read_events
    from bundle_adjustment_tpu_torch.utils.metrics import ate_rmse

    events = read_events(os.path.join(run_out, "events.jsonl"))

    def count(ev):
        return sum(1 for e in events if e["event"] == ev)

    closures = [e for e in events if e["event"] == "loop_closure"]
    est, gt = [], []
    with open(os.path.join(run_out, "trajectory.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            v = line.split()
            fi = int(v[0])
            if 0 <= fi < len(gt_C):
                est.append([float(v[2]), float(v[3]), float(v[4])])
                gt.append(gt_C[fi])
    est, gt = np.asarray(est), np.asarray(gt)
    ate = ate_rmse(est, gt) if len(est) >= 3 else float("nan")
    path_len = float(np.sum(np.linalg.norm(np.diff(gt_C, axis=0), axis=1)))
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0))) if len(gt) else float("nan")
    return {
        "keyframes": summary["num_keyframes"],
        "map_points": summary["num_points"],
        "observations": summary["num_observations"],
        "culled_points": int(sum(e.get("culled", 0) for e in events if e["event"] == "cull")),
        "pruned_obs": int(sum(e.get("pruned", 0) for e in events if e["event"] == "prune")),
        "capacity_drops": int(sum(e.get("dropped_obs", 0) + e.get("dropped_points", 0)
                                  for e in events if e["event"] == "capacity_drop")),
        "divergences": count("ba_diverged"),
        "reloc_success": sum(1 for e in events
                             if e["event"] == "relocalization" and e.get("success")),
        "reloc_fail": sum(1 for e in events
                          if e["event"] == "relocalization" and not e.get("success")),
        "loop_closures": len(closures),
        "loop_fused_points": int(sum(e.get("fused", 0) for e in closures)),
        "frames_discarded": count("frame_discarded"),
        "ate_rmse": round(float(ate), 4),
        "ate_pct_of_path": round(100.0 * float(ate) / max(path_len, 1e-9), 3),
        "ate_pct_of_extent": round(100.0 * float(ate) / max(extent, 1e-9), 3),
        "gt_path_len": round(path_len, 3),
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch import run as run_mod
    from bundle_adjustment_tpu_torch.ops import orb as orb_mod
    from bundle_adjustment_tpu_torch.utils.io import _cv2, write_png
    from bundle_adjustment_tpu_torch.utils.synthetic import camera_path, synthetic_sequence, \
        write_video

    dev = device_mod.resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    gt_C = np.stack([C for _, _, C in camera_path(args.frames, args.motion)])
    if args.video:
        _cv2(f"--video {args.video} (a sequence written earlier is read as it is, "
             "never rendered again)")
        source = ["--video", args.video]
    else:
        print(f"rendering {args.frames}-frame '{args.motion}' sequence...", flush=True)
        frames, K, gt_C, _ = synthetic_sequence(
            n_frames=args.frames, width=WIDTH, height=HEIGHT, fx=FX, motion=args.motion,
            seed=args.seed, device=dev)
        if args.png:
            folder = os.path.join(args.out, "sequence")
            os.makedirs(folder, exist_ok=True)
            for i, f in enumerate(frames):
                write_png(os.path.join(folder, f"{i:05d}.png"), f)
            source = ["--images", folder]
        else:
            video = os.path.join(args.out, "sequence.mp4")
            write_video(frames, video)
            source = ["--video", video]
        del frames

    run_out = os.path.join(args.out, "run")
    cli = ["--preset", args.preset, *source, "--out", run_out, "--fx", str(FX),
           "--size", f"{WIDTH}x{HEIGHT}", "--consistent-convention",
           "--features", str(args.features), "--device", dev.type]

    orig_dedup, orig_preset = orb_mod._DEDUP_CELL_PX, run_mod.PRESETS[args.preset]
    if args.dedup_px is not None:
        orb_mod._DEDUP_CELL_PX = float(args.dedup_px)
    if args.staged:
        import dataclasses

        run_mod.PRESETS[args.preset] = lambda: dataclasses.replace(orig_preset(),
                                                                   fused_frontend=False)
    try:
        t0 = time.perf_counter()
        summary = run_mod.main(cli)
        elapsed = time.perf_counter() - t0
    finally:
        orb_mod._DEDUP_CELL_PX = orig_dedup
        run_mod.PRESETS[args.preset] = orig_preset
    if summary["frames"] != args.frames:
        raise ValueError(f"{summary['frames']} frames ran, the ground truth is of "
                         f"--frames {args.frames}")

    result = {"frames": args.frames, "seed": args.seed, "dedup_px": args.dedup_px,
              "motion": args.motion, "fused_frontend": not args.staged}
    result.update(score(run_out, summary, gt_C))
    result.update(frames_per_s=summary["frames_per_s"], elapsed_s=round(elapsed, 1),
                  backend=dev.type, device=device_name(dev.type))
    with open(os.path.join(args.out, "stress_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
