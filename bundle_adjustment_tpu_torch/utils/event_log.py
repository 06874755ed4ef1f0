"""Structured event log with a reference-compatible printed grammar.

The reference's observability layer is its print stream, whose lines form a
de-facto parsed contract (SURVEY §3.5: the strings at src/pipeline.py:56,76,86,
src/pose_estimator.py:36, src/keyframe_detector.py:68-85,
src/bundle_adjuster.py:178,184 are regex-parsed by src/analyze_log.py:6-55).

Here every event is (a) appended as one JSON line to ``events.jsonl`` —
the machine contract — and (b) optionally printed as a human line using the
same vocabulary (frame ids, inlier ratios, keyframe trigger reasons, LBA
improvement %) so log-scraping habits from the reference carry over.
``bundle_adjustment_tpu_torch.utils.analyze_log`` consumes either form.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class EventLog:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self.events: list[dict] = []

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def emit(self, event: str, text: Optional[str] = None, **fields):
        rec = {"t": time.time(), "event": event, **fields}
        self.events.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if self.echo and text:
            print(text, flush=True)

    # -- typed emitters (the grammar) -------------------------------------

    def frame(self, frame_idx: int):
        self.emit("frame", f"Processing frame {frame_idx}...", frame_idx=frame_idx)

    def frame_discarded(self, frame_idx: int, why: str):
        self.emit("frame_discarded", f"    -> Frame Discarded: {why}",
                  frame_idx=frame_idx, why=why)

    def pose(self, frame_idx: int, num_inliers: int, num_matches: int, ratio: float):
        self.emit(
            "pose",
            f"    -> Pose Estimation: {num_inliers}/{num_matches} inliers. "
            f"Inlier Ratio: {ratio:.2f}",
            frame_idx=frame_idx, num_inliers=num_inliers,
            num_matches=num_matches, inlier_ratio=round(float(ratio), 6),
        )
        if ratio < 0.4:  # the reference's low-ratio warning (pose_estimator.py:38-40)
            self.emit("pose_warning",
                      f"    -> WARNING: Low inlier ratio ({ratio:.2f})",
                      frame_idx=frame_idx)

    def keyframe_trigger(self, frame_idx: int, kf_id: int, reason: str, metrics: dict):
        detail = ", ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in metrics.items())
        self.emit(
            "keyframe_trigger",
            f"    -> Keyframe Trigger: {reason} ({detail})",
            frame_idx=frame_idx, kf_id=kf_id, reason=reason, **{
                k: (round(v, 6) if isinstance(v, float) else v) for k, v in metrics.items()
            },
        )

    def triangulated(self, frame_idx: int, kept: int, total: int):
        self.emit(
            "triangulation",
            f"    -> Triangulation: Kept {kept} of {total} points.",
            frame_idx=frame_idx, kept=kept, total=total,
        )

    def lba(self, kf_id: int, initial_cost: float, final_cost: float,
            iterations: int, diverged: bool, elapsed_s: float, global_ba: bool = False,
            stop: Optional[str] = None):
        """A BA solve's ``ba_complete`` or ``ba_diverged`` record; ``stop``:
        the test that ended its LM loop (``ops/ba.STOP_TESTS``), where the
        solver records it."""
        tag = "Global BA" if global_ba else "LBA"
        extra = {} if stop is None else {"stop": stop}
        if diverged:
            self.emit(
                "ba_diverged",
                f"    -> {tag} Diverged! Cost increased from {initial_cost:.2f} "
                f"to {final_cost:.2f}. Discarding results.",
                kf_id=kf_id, initial_cost=float(initial_cost),
                final_cost=float(final_cost), global_ba=global_ba, **extra,
            )
        else:
            imp = 100.0 * (initial_cost - final_cost) / (initial_cost + 1e-8)
            self.emit(
                "ba_complete",
                f"    -> {tag} Complete. Initial Cost: {initial_cost:.2f}, "
                f"Final Cost: {final_cost:.2f}, Improvement: {imp:.2f}%",
                kf_id=kf_id, initial_cost=float(initial_cost),
                final_cost=float(final_cost), improvement=float(imp),
                iterations=int(iterations), elapsed_s=round(elapsed_s, 4),
                global_ba=global_ba, **extra,
            )

    def lba_skipped(self, why: str):
        self.emit("ba_skipped", f"    -> LBA Skipped: {why}", why=why)

    def reloc(self, frame_idx: int, success: bool, kf_id: int = -1, inliers: int = 0):
        self.emit(
            "relocalization",
            f"    -> Relocalization {'succeeded against KF ' + str(kf_id) if success else 'failed'}"
            f" ({inliers} inliers)",
            frame_idx=frame_idx, success=success, kf_id=kf_id, inliers=inliers,
        )

    def metric(self, name: str, value: float, **fields):
        self.emit("metric", None, name=name, value=float(value), **fields)


def read_events(path: str) -> list[dict]:
    """The records of an ``events.jsonl`` file, in order; raises on a line
    that is not one JSON object with an ``event`` field."""
    events = []
    with open(path) as fh:
        for n, line in enumerate(fh, 1):
            rec = json.loads(line)
            if not isinstance(rec, dict) or "event" not in rec:
                raise ValueError(f"{path}:{n}: not an event record")
            events.append(rec)
    return events
