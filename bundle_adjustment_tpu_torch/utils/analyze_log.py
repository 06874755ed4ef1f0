"""Run-log analytics: parse the event stream, summarize, plot (port of
``bundle_adjustment_tpu.utils.analyze_log``).

The machine contract is ``events.jsonl`` (``utils/event_log.py``); a text
parser for the printed lines is kept so that tee'd console logs work the
same way.  The two-panel quality plot (the pose inlier ratio per frame with
the keyframe triggers coloured by reason; the improvement of each BA) is
drawn with ``utils/viz`` on a device, not with matplotlib: its title, axis
labels and legend go into the PNG's text chunks.

CLI:  python -m bundle_adjustment_tpu_torch.utils.analyze_log events.jsonl [out.png]
      [--device cpu]   (the plot is drawn on the card by default)
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Optional

import numpy as np

from bundle_adjustment_tpu_torch.utils import viz
from bundle_adjustment_tpu_torch.utils.io import write_png

# trigger-reason taxonomy (ref: src/analyze_log.py:80-85) + the JAX package's additions
REASON_COLORS = {
    "Initialization": "tab:gray",
    "Parallax": "tab:green",
    "Pixel Displacement": "tab:blue",
    "Rotation": "tab:orange",
    "Feature Ratio": "tab:red",
    "Relocalization": "tab:purple",
}

#: matplotlib's tab: colours as RGB
TAB_RGB = {
    "tab:blue": (31, 119, 180), "tab:orange": (255, 127, 14), "tab:green": (44, 160, 44),
    "tab:red": (214, 39, 40), "tab:purple": (148, 103, 189), "tab:brown": (140, 86, 75),
    "tab:gray": (127, 127, 127),
}

_TEXT_PATTERNS = [
    ("frame", re.compile(r"Processing frame (\d+)\.\.\."), ("frame_idx",)),
    ("pose", re.compile(
        r"Pose Estimation: (\d+)/(\d+) inliers\. Inlier Ratio: ([\d.]+)"),
     ("num_inliers", "num_matches", "inlier_ratio")),
    ("keyframe_trigger", re.compile(r"Keyframe Trigger: ([A-Za-z ]+?) \("),
     ("reason",)),
    ("ba_complete", re.compile(
        r"(?:LBA|Global BA) Complete\. Initial Cost: ([\d.]+), Final Cost: "
        r"([\d.]+), Improvement: ([-\d.]+)%"),
     ("initial_cost", "final_cost", "improvement")),
    ("ba_diverged", re.compile(
        r"(?:LBA|Global BA) Diverged! Cost increased from ([\d.]+) to ([\d.]+)"),
     ("initial_cost", "final_cost")),
]


def parse_text_log(path: str) -> list[dict]:
    """Parse a tee'd console log into events (reference-style ingestion)."""
    events = []
    frame_idx = None
    with open(path) as f:
        for line in f:
            for event, pat, fields in _TEXT_PATTERNS:
                m = pat.search(line)
                if not m:
                    continue
                rec = {"event": event}
                for name, val in zip(fields, m.groups()):
                    try:
                        rec[name] = float(val) if "." in val or name == "improvement" else int(val)
                    except ValueError:
                        rec[name] = val.strip()
                if event == "frame":
                    frame_idx = rec["frame_idx"]
                elif frame_idx is not None:
                    rec.setdefault("frame_idx", frame_idx)
                events.append(rec)
                break
    return events


def load_events(path: str) -> list[dict]:
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    return parse_text_log(path)


def summarize(events: list[dict]) -> dict:
    poses = [e for e in events if e["event"] == "pose"]
    triggers = [e for e in events if e["event"] == "keyframe_trigger"]
    bas = [e for e in events if e["event"] == "ba_complete"]
    divs = [e for e in events if e["event"] == "ba_diverged"]
    reasons: dict[str, int] = {}
    for t in triggers:
        reasons[t.get("reason", "?")] = reasons.get(t.get("reason", "?"), 0) + 1
    out = {
        "frames": sum(1 for e in events if e["event"] == "frame"),
        "keyframes": len(triggers),
        "trigger_reasons": reasons,
        "ba_runs": len(bas),
        "ba_divergences": len(divs),
    }
    if poses:
        ratios = [e["inlier_ratio"] for e in poses]
        out["mean_inlier_ratio"] = sum(ratios) / len(ratios)
        out["min_inlier_ratio"] = min(ratios)
    if bas:
        imps = [e.get("improvement", 0.0) for e in bas]
        out["mean_ba_improvement_pct"] = sum(imps) / len(imps)
        if any("elapsed_s" in e for e in bas):
            ts = [e["elapsed_s"] for e in bas if "elapsed_s" in e]
            its = [e.get("iterations", 0) for e in bas if "elapsed_s" in e]
            out["ba_total_s"] = sum(ts)
            out["ba_iters_per_s"] = sum(its) / max(sum(ts), 1e-9)
    return out


def _bgr(tab: str) -> tuple:
    r, g, b = TAB_RGB[tab]
    return b, g, r


def analyze_and_plot(events: list[dict], out_png: Optional[str] = None,
                     device="cuda") -> dict:
    """Two-panel quality plot on a 1320 x 880 canvas (matplotlib's figsize
    12 x 8 at 110 dpi), drawn on ``device``: the per-frame pose inlier
    ratio (a black line with dots) with a vertical line at each keyframe
    trigger coloured by its reason (half opaque), and a bar per BA of its
    improvement %."""
    summary = summarize(events)
    if out_png:
        poses = [e for e in events if e["event"] == "pose"]
        triggers = [e for e in events if e["event"] == "keyframe_trigger"]
        bas = [e for e in events if e["event"] == "ba_complete"]
        fx = np.asarray([e.get("frame_idx", i) for i, e in enumerate(poses)], np.float64)
        ratio = np.asarray([e["inlier_ratio"] for e in poses], np.float64)
        tx = np.asarray([t.get("frame_idx", 0) for t in triggers], np.float64)
        imp = np.asarray([e.get("improvement", 0.0) for e in bas], np.float64)
        xs = np.concatenate([fx, tx])
        W, H = 1320, 880
        ax1, ax2 = viz.two_panel_axes(
            (W, H), viz.padded(xs.min(), xs.max()) if len(xs) else (0, 1),
            viz.padded(min(ratio.min(initial=0.0), 0.0), max(ratio.max(initial=1.0), 1.0)),
            viz.padded(-0.4, len(bas) - 0.6), viz.padded(min(imp.min(initial=0.0), 0.0),
                                                        max(imp.max(initial=0.0), 1.0)))
        canvas = viz.Canvas.blank(H, W, device)
        for ax in (ax1, ax2):
            ax.frame(canvas)
        if len(poses):
            p = ax1.to_px(fx, ratio)
            canvas.add_segments(p[:-1], p[1:], viz.BLACK)
            canvas.add_discs(p, 1.0, viz.BLACK)
        if len(triggers):
            _, t, _, b = ax1.box
            x = ax1.to_px(tx, np.zeros(len(tx)))[:, 0]
            colors = [_bgr(REASON_COLORS.get(e.get("reason", ""), "tab:brown"))
                      for e in triggers]
            canvas.add_segments(np.stack([x, np.full(len(x), t)], 1),
                                np.stack([x, np.full(len(x), b)], 1), colors, opacity=0.5)
        if len(bas):
            i = np.arange(len(bas), dtype=np.float64)
            lo, hi = ax2.to_px(i - 0.4, np.zeros(len(bas))), ax2.to_px(i + 0.4, imp)
            canvas.add_rects(lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], _bgr("tab:green"))
        write_png(out_png, canvas.render(), text={
            "Title": "Keyframe quality (triggers color-coded by reason)",
            "ylabel": "pose inlier ratio", "ylabel2": "BA improvement %", "xlabel2": "BA run",
            "legend": ", ".join(f"{r}: {c}" for r, c in REASON_COLORS.items())
            + (", inlier ratio: black" if poses else "")})
    return summary


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("events", help="events.jsonl, or a tee'd console log")
    ap.add_argument("out_png", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", help="where the plot is drawn")
    args = ap.parse_args(argv)
    events = load_events(args.events)
    print(json.dumps(analyze_and_plot(events, args.out_png, args.device), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
