"""Multi-seed long-drive study: the counterpart of the JAX package's
``tools/dedup_study.py``, with its flags and its JSON keys.

Runs the port's stress harness (``tools/stress``) over seeds x ORB dedup
cells, each (seed, dedup) cell as its own subprocess, and aggregates the
cells' ATE over the path length as the JAX study does (``by_dedup``: n,
mean, stdev, min, max, all, closures).  Where ``--against`` names the JAX
study's folder (``.dedup_study``), each cell runs on that cell's committed
video (``s{seed}_d{dedup}_cpu/sequence.mp4``, read as it is), and the study
prints each seed's result beside the JAX cell's ``stress_result.json``,
keyframe triggers, divergences and closures of both runs read from their
``events.jsonl`` by the port's ``utils/analyze_log``, and the two means.

The study is gated on the mean, never seed by seed (the JAX package itself
lands far apart on one seed across backends): it exits with 1 when a cell
failed or when, for a dedup cell size, the port's mean ATE over the path
length is above ``--max-mean-ate``, which defaults with ``--against`` to
the JAX cells' worst seed at that size (12.51 % at 3 px).

    python -m bundle_adjustment_tpu_torch.tools.dedup_study --seeds 2 3 4 5 6 \\
        --dedup 3 --against .dedup_study --out OUT --jobs 4

A cell whose ``stress_result.json`` exists in ``--out`` is read, not run
again; ``--jobs`` cells run at once.  By default the cells run on the card
(``--device``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

#: the directory that holds the package, where each cell's subprocess starts
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: the keys of a cell printed per seed, beside the JAX cell's
CELL_KEYS = ("seed", "dedup_px", "ate_pct_of_path", "ate_pct_of_extent", "keyframes",
             "loop_closures", "divergences", "frames_discarded", "failed")


def cell_name(seed: int, dedup: float, platform: str) -> str:
    return f"s{seed}_d{dedup:g}_{platform}"


def run_cell(seed: int, dedup: float, frames: int, out_dir: str, device: str,
             video: str | None = None) -> dict:
    """One cell: its ``stress_result.json`` in ``out_dir``, or a subprocess
    of the port's stress harness that writes it (the failure's output on
    stderr and ``failed`` in the record when it does not)."""
    cell = os.path.join(out_dir, cell_name(seed, dedup, device))
    res_path = os.path.join(cell, "stress_result.json")
    if os.path.exists(res_path):
        with open(res_path) as f:
            return json.load(f)
    cmd = [sys.executable, "-m", "bundle_adjustment_tpu_torch.tools.stress",
           "--frames", str(frames), "--seed", str(seed), "--dedup-px", str(dedup),
           "--out", os.path.abspath(cell), "--device", device] + (
               ["--video", os.path.abspath(video)] if video else [])
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    if p.returncode != 0:
        sys.stderr.write(p.stdout[-2000:] + p.stderr[-4000:])
        return {"seed": seed, "dedup_px": dedup, "failed": True,
                "elapsed_s": round(time.perf_counter() - t0, 1)}
    with open(res_path) as f:
        return json.load(f)


def aggregate(cells: list, dedups) -> dict:
    """``by_dedup`` of the JAX study: per dedup cell size the ATE over the
    path length of the cells that did not fail, and their mean closures."""
    by = {}
    for dedup in dedups:
        ok = [r for r in cells if r.get("dedup_px") == dedup and not r.get("failed")]
        ates = [r["ate_pct_of_path"] for r in ok]
        if not ates:
            continue
        by[f"{dedup:g}"] = {
            "n": len(ates),
            "ate_pct_mean": round(statistics.mean(ates), 2),
            "ate_pct_stdev": round(statistics.stdev(ates), 2) if len(ates) > 1 else 0.0,
            "ate_pct_min": min(ates),
            "ate_pct_max": max(ates),
            "ate_pct_all": ates,
            "closures_mean": round(statistics.mean([r["loop_closures"] for r in ok]), 2),
        }
    return by


def event_tally(events_path: str) -> dict:
    """Keyframe triggers by reason, BA runs, divergences and closures of one
    run's ``events.jsonl``, read by the port's ``utils/analyze_log``."""
    from bundle_adjustment_tpu_torch.utils.analyze_log import load_events, summarize

    events = load_events(events_path)
    s = summarize(events)
    return {"keyframe_triggers": s["trigger_reasons"], "ba_runs": s["ba_runs"],
            "divergences": s["ba_divergences"],
            "closures": sum(1 for e in events if e["event"] == "loop_closure")}


def side_by_side(cells: list, against: str, dedups) -> dict:
    """Each port cell beside the JAX cell of its seed and dedup in
    ``against`` (its ``stress_result.json`` and ``run/events.jsonl``), and
    the two studies' ``by_dedup``."""
    rows, jax_cells = [], []
    for r in cells:
        jdir = os.path.join(against, cell_name(r["seed"], r["dedup_px"], "cpu"))
        with open(os.path.join(jdir, "stress_result.json")) as f:
            j = json.load(f)
        jax_cells.append(j)
        row = {"seed": r["seed"], "dedup_px": r["dedup_px"],
               "port": {k: r.get(k) for k in CELL_KEYS[2:]},
               "jax": {k: j.get(k) for k in CELL_KEYS[2:]},
               "jax_events": event_tally(os.path.join(jdir, "run", "events.jsonl"))}
        if not r.get("failed") and "run_dir" in r:
            row["port_events"] = event_tally(os.path.join(r["run_dir"], "events.jsonl"))
        rows.append(row)
    return {"cells": rows, "port": aggregate(cells, dedups),
            "jax": aggregate(jax_cells, dedups)}


def gate(port: dict, limits: dict, cells: list) -> dict:
    """The study's verdict: no cell failed, and for each dedup cell size
    with a limit the port's mean ATE over the path length (``port``, an
    ``aggregate``) at most that limit (``limits``: size -> percent)."""
    means = {k: port[k]["ate_pct_mean"] if k in port else None for k in limits}
    failed = [[r["seed"], r["dedup_px"]] for r in cells if r.get("failed")]
    over = {k: [m, limits[k]] for k, m in means.items() if m is None or m > limits[k]}
    return {"max_mean_ate": limits, "mean_ate": means, "failed_cells": failed,
            "over": over, "passed": not failed and not over}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[2, 3, 4, 5, 6])
    ap.add_argument("--dedup", type=float, nargs="+", default=[1.0, 3.0])
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--out", default="dedup_study")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--against", default=None,
                    help="the JAX study's folder (.dedup_study): run each cell on its "
                         "committed video and print the two side by side")
    ap.add_argument("--max-mean-ate", type=float, default=None, metavar="PCT",
                    help="the most the port's mean ATE over the path length may be, for "
                         "every dedup cell size (default with --against: the JAX cells' "
                         "worst seed at that size; without: no limit)")
    ap.add_argument("--jobs", type=int, default=1, help="cells run at once")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from bundle_adjustment_tpu_torch import device as device_mod

    device_mod.resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    todo = [(seed, dedup) for dedup in args.dedup for seed in args.seeds]

    def one(cell):
        seed, dedup = cell
        video = None
        if args.against:
            video = os.path.join(args.against, cell_name(seed, dedup, "cpu"), "sequence.mp4")
        r = run_cell(seed, dedup, args.frames, args.out, args.device, video)
        r["run_dir"] = os.path.join(args.out, cell_name(seed, dedup, args.device), "run")
        return r

    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        cells = list(pool.map(one, todo))
    for r in cells:
        print(json.dumps({k: r.get(k) for k in CELL_KEYS}), flush=True)

    summary = {"frames": args.frames, "platform": args.device, "seeds": args.seeds,
               "by_dedup": aggregate(cells, args.dedup)}
    record = {"summary": summary, "cells": cells}
    if args.against:
        record["against"] = side_by_side(cells, args.against, args.dedup)
        for row in record["against"]["cells"]:
            print(json.dumps(row), flush=True)
        print(json.dumps({"port": record["against"]["port"],
                          "jax": record["against"]["jax"]}), flush=True)
    limits = {}
    if args.max_mean_ate is not None:
        limits = {f"{d:g}": args.max_mean_ate for d in args.dedup}
    elif args.against:
        limits = {k: v["ate_pct_max"] for k, v in record["against"]["jax"].items()}
    record["gate"] = gate(summary["by_dedup"], limits, cells)
    with open(os.path.join(args.out, "dedup_study.json"), "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps(summary))
    print(json.dumps({"gate": record["gate"]}))
    return record


if __name__ == "__main__":
    sys.exit(0 if main()["gate"]["passed"] else 1)
