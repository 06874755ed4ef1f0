#!/usr/bin/env python3
"""Is a tree of the PyTorch/CUDA port deterministic on the card?

    python3 chip_determinism.py [--tree DIR] [--frames 12] [--runs 4] [--grid-solver]

Imports ``bundle_adjustment_tpu_torch`` from ``DIR`` (default: the directory
of this script), renders the first frames of ``chip_smoke.py``'s sequence
(1280 x 720 strafe, ``preset_video`` widths) and

1. runs them once with ``torch.use_deterministic_algorithms(True,
   warn_only=True)`` and prints every op PyTorch names.  An op that PyTorch
   silently replaces by a deterministic form in that mode (``index_add_`` on
   a CUDA tensor is one) is not named: an empty list proves nothing;
2. runs them ``--runs`` times through fresh pipelines in the default mode and
   compares statuses, keyframe ids and keyframe poses with the first run,
   bit for bit.  Exits 1 if any run differs.

``--grid-solver`` sets ``BAConfig(use_pallas_ba=False)``, which every tree of
the port can run.  Needs one NVIDIA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import warnings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--grid-solver", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: needs an NVIDIA card",
              file=sys.stderr)
        return 1

    import bundle_adjustment_tpu_torch as pkg
    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch.config import CAMERA_LEHMAN, CameraModel, preset_video
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_sequence

    print(f"tree: {os.path.dirname(pkg.__file__)}; card: {torch.cuda.get_device_name(0)}")
    device_mod.set_float32_numerics()
    W, H = 1280, 720
    frames, K, _, _ = synthetic_sequence(n_frames=40, width=W, height=H,
                                         fx=CAMERA_LEHMAN.fx, seed=0, motion="strafe")
    frames = frames[: args.frames]
    cam = CameraModel(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                      cy=float(K[1, 2]), width=W, height=H)
    cfg = preset_video(cam)
    if args.grid_solver:
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, use_pallas_ba=False))

    def run():
        pipe = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device="cuda")
        statuses = [pipe.process_frame(f)["status"] for f in frames]
        torch.cuda.synchronize()
        ids = pipe.map.sorted_kf_ids()
        poses = np.stack([np.r_[pipe.map.keyframes[k].R.ravel(), pipe.map.keyframes[k].t]
                          for k in ids])
        return statuses, ids, poses

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split(". You can")[0] for w in caught
                    if "deterministic" in str(w.message)})
    print(f"warn-only deterministic mode over {len(frames)} frames names {len(named)} ops")
    for msg in named:
        print(f"  {msg}")

    first = run()
    print(f"run 0: statuses {''.join(s[0] for s in first[0])}, {len(first[1])} keyframes")
    differ = 0
    for i in range(1, args.runs):
        st, ids, poses = run()
        same_shape = poses.shape == first[2].shape
        equal = st == first[0] and ids == first[1] and same_shape \
            and np.array_equal(poses, first[2])
        gap = float(np.abs(poses - first[2]).max()) if same_shape else float("nan")
        differ += not equal
        print(f"run {i}: statuses {''.join(s[0] for s in st)}, equal to run 0: statuses "
              f"{st == first[0]}, keyframe ids {ids == first[1]}, poses bit-equal "
              f"{equal}, max abs pose difference {gap:.3e}")
    print(f"{differ} of {args.runs - 1} repeat runs differ from run 0")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
