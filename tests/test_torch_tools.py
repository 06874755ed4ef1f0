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
    the result has the JAX harness's keys, the two ATE denominators, the
    routing it ran under and its breakdowns."""
    import bundle_adjustment_tpu_torch.utils.io as io_mod

    def no_cv2(what, hint=""):
        raise ImportError(f"{what} needs cv2 (OpenCV), which is not installed{hint}")

    monkeypatch.setattr(io_mod, "_cv2", no_cv2)
    r = stress.main(["--device", "cpu", "--frames", "12", "--png", "--features", "300",
                     "--out", str(tmp_path)])
    with open(os.path.join(STUDY, "s2_d3_cpu", "stress_result.json")) as f:
        jax_keys = set(json.load(f))
    assert jax_keys <= set(r) and set(r) - jax_keys == {"ate_pct_of_extent", "device",
                                                         "route", "breakdowns"}
    assert r["route"] == "as shipped" and r["breakdowns"]["culled_points"] == r["culled_points"]
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


@pytest.mark.parametrize("cell, want", [
    # counted by hand in the committed events.jsonl (grep): the JAX CPU cell
    # of seed 3 and the JAX TPU cell of seed 2
    ("s3_d3_cpu", dict(rotation_triggers=[[12, 3.141593, 0, 473]],
                       discarded_frames=[201, 202, 203, 207, 393, 394, 397, 398, 420, 421,
                                         426, 427, 434, 435, 443],
                       pruned_obs=506, culled_points=9, reloc_fail=0, divergences=0)),
    ("s2_d3_tpu", dict(rotation_triggers=[],
                       discarded_frames=[202, 219, 235, 236, 237, 238, 370, 383, 384, 405,
                                         407],
                       pruned_obs=2213, culled_points=None, reloc_fail=2, divergences=3)),
])
def test_breakdowns_of_a_committed_jax_log_equal_a_hand_count(cell, want):
    """``stress.breakdowns`` (the tally phase 14 and the dedup study print
    per seed) on a committed JAX run's events: every Rotation trigger with
    its frame, angle, tracked points and inliers, every discarded frame, and
    the maintenance counts, as counted by hand; the pruned and culled
    counts equal the cell's own ``stress_result.json``."""
    from bundle_adjustment_tpu_torch.utils.event_log import read_events

    run = os.path.join(STUDY, cell)
    got = stress.breakdowns(read_events(os.path.join(run, "run", "events.jsonl")))
    with open(os.path.join(run, "stress_result.json")) as f:
        res = json.load(f)
    want = dict(want, culled_points=res["culled_points"] if want["culled_points"] is None
                else want["culled_points"])
    assert got == want
    for k in ("pruned_obs", "culled_points", "divergences", "reloc_fail"):
        assert got[k] == res[k], k
    assert len(got["discarded_frames"]) == res["frames_discarded"]
    row = {"seed": 2, "port_breakdowns": got, "jax_breakdowns": got}
    assert dedup_study.tally_line(row).count(f"Rotation {len(got['rotation_triggers'])}") == 2


def test_routes_switch_the_solvers_and_put_them_back():
    """Each routing of ``stress.ROUTES`` switches what it names inside the
    block (the CLI's preset, K3's and K4's gates, K3's function, the graph
    replay, the step's null vectors and SVDs) and puts everything back
    after it; a switched null vector is still the smallest eigenvalue's."""
    from bundle_adjustment_tpu_torch import run as run_mod
    from bundle_adjustment_tpu_torch.models import frontend
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk
    from bundle_adjustment_tpu_torch.ops import ba_kernel, small_linalg

    A = torch.tensor(np.random.default_rng(0).normal(size=(3, 4, 4)), dtype=torch.float32)
    want = torch.linalg.svd(A.double())[2][..., -1, :]
    before = (run_mod.PRESETS["lehman_indoor"], ba_kernel.eligible_shape,
              gk.eligible_shape_global, ba_kernel.lm_solve, frontend.TrackStep._replay,
              small_linalg.null_vector, small_linalg.svd)
    for name, route in stress.ROUTES.items():
        with stress.routed("lehman_indoor", **route):
            cfg = run_mod.PRESETS["lehman_indoor"]()
            assert cfg.ba.use_pallas_ba == (not route.get("grid_windows", False)), name
            assert cfg.fused_frontend == (not route.get("staged", False)), name
            assert (frontend.TrackStep._replay is before[4]) == (
                not route.get("eager_step", False)), name
            assert ba_kernel.eligible_shape(5, 8192, 13, 2) == (
                route.get("k3_max_slots") is None), name
            assert gk.eligible_shape_global(200, 30000, 13, 1) == (
                route.get("k4_max_slots") is None), name
            assert (ba_kernel.lm_solve is before[3]) == (route.get("k3_plain_past") is None)
            linalg = set(route.get("host_linalg", ())) | set(route.get("linalg64", ()))
            assert (small_linalg.null_vector is before[5]) == (
                "eigh" not in linalg and not route.get("null")), name
            assert (small_linalg.svd is before[6]) == ("svd" not in linalg), name
            v = small_linalg.null_vector(A)
            assert v.dtype == A.dtype and v.shape == (3, 4), name
            assert torch.allclose(torch.abs(torch.sum(v.double() * want, -1)),
                                  torch.ones(3, dtype=torch.float64), atol=1e-5), name
        assert (run_mod.PRESETS["lehman_indoor"], ba_kernel.eligible_shape,
                gk.eligible_shape_global, ba_kernel.lm_solve, frontend.TrackStep._replay,
                small_linalg.null_vector, small_linalg.svd) == before, name


def test_profile_orb_splits_every_stage_of_the_step():
    """``profile_orb`` at 320x240 with 500 features on the CPU: the JAX
    tool's keys, every stage of ``utils/stages.STAGES`` run (the ORB ones
    once per pyramid level), and their host times adding up to the step's
    less the Python between them."""
    from bundle_adjustment_tpu_torch.tools import profile_orb
    from bundle_adjustment_tpu_torch.utils.stages import STAGES

    out = profile_orb.main(["--device", "cpu", "--size", "320x240", "--features", "500",
                            "--steps", "1"])
    assert out["metric"] == "orb_extract_breakdown" and out["time"] == "host (cpu)"
    assert list(out["stage_ms"]) == list(STAGES) == list(out["calls_per_step"])
    per_level = STAGES[:STAGES.index("dedup + select")]
    assert all(out["calls_per_step"][k] == 8 for k in per_level)
    assert out["calls_per_step"]["dedup + select"] == 9        # 8 levels, then the select
    assert all(out["calls_per_step"][k] == 1 for k in STAGES[len(per_level) + 1:])
    assert all(v > 0 for v in out["stage_ms"].values())
    assert 0.8 * out["step_ms"] < out["sum_of_stages_ms"] <= out["step_ms"]


def test_profile_ba_prints_the_jax_tools_keys():
    """``profile_ba`` on a C = 5, P = 256 window and ``--global-pcg`` on a
    small chain, on the CPU: the JAX tool's metrics and keys, every stage
    timed and counted; K4's roles are their plain versions there."""
    from bundle_adjustment_tpu_torch.tools import profile_ba

    out = profile_ba.main(["--device", "cpu", "--points", "256"])
    stages = ["terms", "assemble", "schur", "solve", "backsub", "cost", "full_lm_iter"]
    assert out["metric"] == "ba_lm_iteration_breakdown" and out["problem"].startswith("C=5 ")
    for key in ("stage_us", "stage_flops", "stage_bytes"):
        assert list(out[key]) == stages, key
    assert all(v > 0 for v in out["stage_us"].values())
    assert out["stage_flops"]["assemble"] > 0 and "k3_phases" not in out
    g = profile_ba.main(["--device", "cpu", "--global-pcg", "--cams", "20", "--points", "400"])
    assert g["metric"] == "ba_global_pcg_breakdown" and g["lm_iterations"] == 21
    assert g["time"].startswith("not measured")
