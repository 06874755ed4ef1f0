"""The port's long-drive harnesses (``bundle_adjustment_tpu_torch/tools``)
on the CPU: the stress harness on a short room render written as PNG files
(no cv2), the dedup study's aggregation and side-by-side report on the
committed JAX cells (``.dedup_study``, read, never written), the global
scale sweep's problem generator against ``bench.make_global_problem``, and
the sweep at a tiny size."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch.tools import dedup_study, global_scale_sweep, stress
from bundle_adjustment_tpu_torch.utils.synthetic import camera_path, synthetic_global_problem, \
    synthetic_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDY = os.path.join(REPO, ".dedup_study")
TOOLS = os.path.join(REPO, "tools")

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other.
torch.set_num_threads(1)


def test_stress_on_a_short_room_render_without_cv2(tmp_path, monkeypatch):
    """12 frames of the room (one loop) rendered, written as PNG files and
    driven through the port's CLI on the CPU with cv2 made unimportable;
    the result has the JAX harness's keys and the two ATE denominators."""
    import bundle_adjustment_tpu_torch.utils.io as io_mod

    def no_cv2(what, hint=""):
        raise ImportError(f"{what} needs cv2 (OpenCV), which is not installed{hint}")

    monkeypatch.setattr(io_mod, "_cv2", no_cv2)
    r = stress.main(["--device", "cpu", "--frames", "12", "--png", "--features", "300",
                     "--out", str(tmp_path)])
    with open(os.path.join(STUDY, "s2_d3_cpu", "stress_result.json")) as f:
        jax_keys = set(json.load(f))
    assert jax_keys <= set(r) and set(r) - jax_keys == {"ate_pct_of_extent", "device"}
    assert r["frames"] == 12 and r["keyframes"] >= 3 and r["device"] == "cpu"
    assert np.isfinite(r["ate_rmse"]) and r["ate_pct_of_extent"] > r["ate_pct_of_path"]
    assert len(os.listdir(tmp_path / "sequence")) == 12
    assert json.loads((tmp_path / "stress_result.json").read_text()) == r
    with pytest.raises(ImportError, match="cv2"):      # a written sequence needs cv2
        stress.main(["--device", "cpu", "--frames", "12", "--video", str(tmp_path / "x.mp4"),
                     "--out", str(tmp_path / "v")])


def test_stress_ground_truth_is_the_renders():
    """``--video`` scores against ``camera_path``: the render's own centres."""
    _, _, gt_C, gt_R = synthetic_sequence(3, width=32, height=24, motion="room", seed=2)
    path = camera_path(3, "room")
    assert np.array_equal(gt_C, np.stack([C for _, _, C in path]))
    assert np.array_equal(gt_R, np.stack([R for R, _, _ in path]))


def _committed_cells():
    return [dedup_study.run_cell(seed, dedup, 600, STUDY, "cpu")
            for dedup in (1.0, 3.0) for seed in (2, 3, 4, 5, 6)]


def test_dedup_study_aggregates_the_committed_cells_as_jax_does():
    """The committed cells are read (no subprocess), and aggregate to the
    JAX study's ``by_dedup`` (``.dedup_study/dedup_study.json``, which
    ``tools/dedup_study.py`` wrote from them)."""
    with open(os.path.join(STUDY, "dedup_study.json")) as f:
        want = json.load(f)["summary"]["by_dedup"]
    assert dedup_study.aggregate(_committed_cells(), [1.0, 3.0]) == want
    assert want["3"]["ate_pct_mean"] == 8.41 and want["3"]["n"] == 5


def test_dedup_study_side_by_side_reads_both_runs_events():
    """The report sets each cell beside the JAX cell of its seed; the JAX
    runs' events read by the port's ``analyze_log`` give the committed
    cells' divergences and closures."""
    cells = [c for c in _committed_cells() if c["dedup_px"] == 3.0]
    for c in cells:
        c["run_dir"] = os.path.join(STUDY, dedup_study.cell_name(c["seed"], 3.0, "cpu"), "run")
    rep = dedup_study.side_by_side(cells, STUDY, [3.0])
    assert rep["port"] == rep["jax"] and rep["jax"]["3"]["ate_pct_mean"] == 8.41
    assert [row["seed"] for row in rep["cells"]] == [2, 3, 4, 5, 6]
    for row, c in zip(rep["cells"], cells):
        assert row["jax"]["ate_pct_of_path"] == c["ate_pct_of_path"]
        assert row["jax_events"] == row["port_events"]
        assert row["jax_events"]["divergences"] == c["divergences"] == 0
        assert row["jax_events"]["closures"] == c["loop_closures"]
        assert sum(row["jax_events"]["keyframe_triggers"].values()) >= c["keyframes"] - 1


def _copy_cells(dst, dedup=3.0):
    """The committed cells' results and events, copied to ``dst`` as a
    port study's output (``.dedup_study`` is never written)."""
    import shutil

    for seed in (2, 3, 4, 5, 6):
        name = dedup_study.cell_name(seed, dedup, "cpu")
        os.makedirs(dst / name / "run")
        shutil.copy(os.path.join(STUDY, name, "stress_result.json"), dst / name)
        shutil.copy(os.path.join(STUDY, name, "run", "events.jsonl"), dst / name / "run")


@pytest.mark.parametrize("limit, passed", [(None, True), (8.41, True), (8.4, False)])
def test_dedup_study_gates_on_the_mean(tmp_path, limit, passed):
    """``main`` over copies of the committed 3 px cells (read, not run):
    the gate holds the five-seed mean (8.41 %) to ``--max-mean-ate``, by
    default the JAX cells' worst seed (12.513 %), and the record says so."""
    _copy_cells(tmp_path)
    argv = ["--device", "cpu", "--dedup", "3", "--out", str(tmp_path), "--against", STUDY,
            "--jobs", "3"] + ([] if limit is None else ["--max-mean-ate", str(limit)])
    rec = dedup_study.main(argv)
    want = 12.513 if limit is None else limit
    assert rec["gate"] == {"max_mean_ate": {"3": want}, "mean_ate": {"3": 8.41},
                           "failed_cells": [], "over": {} if passed else {"3": [8.41, want]},
                           "passed": passed}
    assert [c["seed"] for c in rec["cells"]] == [2, 3, 4, 5, 6]
    assert json.loads((tmp_path / "dedup_study.json").read_text())["gate"] == rec["gate"]


def test_dedup_study_exits_nonzero_past_its_limit_or_on_a_failed_cell(tmp_path):
    """As a command the study exits with 1 when the mean passes its limit,
    and the gate fails a study with a failed cell whatever its mean."""
    import subprocess

    _copy_cells(tmp_path)
    cmd = [sys.executable, "-m", "bundle_adjustment_tpu_torch.tools.dedup_study", "--device",
           "cpu", "--dedup", "3", "--out", str(tmp_path)]
    assert subprocess.run(cmd + ["--max-mean-ate", "9"], cwd=REPO).returncode == 0
    assert subprocess.run(cmd + ["--max-mean-ate", "8"], cwd=REPO).returncode == 1
    cells = _committed_cells()[5:]
    by = dedup_study.aggregate(cells, [3.0])
    assert dedup_study.gate(by, {"3": 12.0}, cells)["passed"]
    cells[1] = {"seed": 3, "dedup_px": 3.0, "failed": True}
    v = dedup_study.gate(dedup_study.aggregate(cells, [3.0]), {"3": 12.0}, cells)
    assert not v["passed"] and v["failed_cells"] == [[3, 3.0]] and v["over"] == {}


def test_global_problem_equals_benchs():
    """The sweep's problem: ``synthetic_global_problem`` given the JAX
    sweep's generator gives ``bench.make_global_problem``'s arrays."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench

    want = bench.make_global_problem(np.random.default_rng(13), C=40, P=40 * 12)
    got = synthetic_global_problem(np.random.default_rng(13), C=40, P=40 * 12)
    for k in want._fields:
        a, b = np.asarray(getattr(want, k)), got[k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_global_scale_sweep_runs_the_plain_version_on_the_cpu():
    out = global_scale_sweep.main(["--device", "cpu", "--cams", "16", "--pts-per-cam", "8",
                                   "--slots", "14", "--ring-cams", "20", "--ring-points", "60",
                                   "--repeats", "1"])
    for res, D in ((out["sizes"]["16"], 4), (out["slots"]["14"], 14)):
        assert res["path"] == "plain (cpu)" and res["D"] == D
        assert res["lm_iterations"] == 21 and res["stop"] == "cap"
        assert res["final_sq"] < 0.05 * res["initial_sq"]
        assert "ms_per_replayed_lm_iteration" not in res    # no time from the CPU
    assert out["device"] == "cpu"
