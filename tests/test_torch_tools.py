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


def _committed_rows():
    """``side_by_side``'s rows for the committed 3 px cells read as port cells."""
    cells = [c for c in _committed_cells() if c["dedup_px"] == 3.0]
    for c in cells:
        c["run_dir"] = os.path.join(STUDY, dedup_study.cell_name(c["seed"], 3.0, "cpu"), "run")
    return dedup_study.side_by_side(cells, STUDY, [3.0])["cells"]


@pytest.mark.parametrize("extra_rot, extra_disc, rot_ok, disc_ok", [
    (0, 0, True, True), (11 * 5, 0, True, True), (11 * 5 + 1, 0, False, True),
    (0, 14 * 5 + 2, True, True), (0, 14 * 5 + 3, True, False)])
def test_breakdown_gate_holds_the_means_to_the_jax_cells_worst_seed(extra_rot, extra_disc,
                                                                     rot_ok, disc_ok):
    """On the committed JAX cells' breakdowns (Rotation keyframes 1, 1, 1,
    15, 2: mean 4, worst 15; discarded frames 7, 15, 0, 26, 10: mean 11.6,
    worst 26) the gate's limits are the worst seeds; a port row whose
    five-seed mean reaches a limit passes, one past it fails (the extra
    counts added to seed 2's port breakdowns), and ``passed`` follows both
    gates."""
    rows = _committed_rows()
    port = rows[0]["port_breakdowns"]
    port["rotation_triggers"] = port["rotation_triggers"] + [[0, 0.1, 0, 0]] * extra_rot
    port["discarded_frames"] = port["discarded_frames"] + [0] * extra_disc
    v = dedup_study.breakdown_gate(rows)
    rot, disc = v["by_dedup"]["3"]["rotation_keyframes"], v["by_dedup"]["3"]["discarded_frames"]
    assert (rot["limit"], rot["jax_mean"], disc["limit"], disc["jax_mean"]) == (15, 4, 26, 11.6)
    assert rot["port_mean"] == (4 * 5 + extra_rot) / 5
    assert disc["port_mean"] == (58 + extra_disc) / 5
    assert (rot["passed"], disc["passed"], v["passed"]) == (rot_ok, disc_ok, rot_ok and disc_ok)
    ate = {"passed": True}
    assert dedup_study.passed({"gate": ate, "breakdown_gate": v}) == (rot_ok and disc_ok)
    assert not dedup_study.passed({"gate": {"passed": False}, "breakdown_gate": v})
    assert dedup_study.passed({"gate": ate})             # no --against: the ATE gate alone


def test_dedup_study_records_the_breakdown_gate_and_exits_on_it(tmp_path):
    """With ``--against`` the study records ``breakdown_gate`` in
    ``dedup_study.json`` and exits with 1 when it fails, the ATE gate
    passing: the committed cells as the port's pass it, and with seed 3's
    run swapped for one that discards 80 frames more they do not."""
    import subprocess

    _copy_cells(tmp_path)
    cmd = [sys.executable, "-m", "bundle_adjustment_tpu_torch.tools.dedup_study", "--device",
           "cpu", "--dedup", "3", "--out", str(tmp_path), "--against", STUDY]
    assert subprocess.run(cmd, cwd=REPO, capture_output=True).returncode == 0
    rec = json.loads((tmp_path / "dedup_study.json").read_text())
    assert rec["gate"]["passed"] and rec["breakdown_gate"]["passed"]
    events = tmp_path / dedup_study.cell_name(3, 3.0, "cpu") / "run" / "events.jsonl"
    lines = events.read_text().splitlines()
    extra = [json.dumps({"event": "frame_discarded", "frame_idx": 1000 + i, "t": 0.0})
             for i in range(80)]
    events.write_text("\n".join(lines + extra) + "\n")
    assert len(dedup_study.cell_breakdowns(str(events.parent))["discarded_frames"]) == \
        15 + 80
    assert subprocess.run(cmd, cwd=REPO, capture_output=True).returncode == 1
    rec = json.loads((tmp_path / "dedup_study.json").read_text())
    assert rec["gate"]["passed"] and not rec["breakdown_gate"]["passed"]
    assert rec["breakdown_gate"]["by_dedup"]["3"]["discarded_frames"]["port_mean"] == 27.6


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


@pytest.mark.parametrize("cell", ["s3_d3_cpu", "s2_d3_tpu"])
def test_tally_of_a_committed_jax_log_agrees_with_its_result(cell):
    """``stress.tally`` (what ``chip_smoke.py --pnp-study`` and the room
    drive script print for both packages) on a committed JAX run's events:
    its discards, Rotation keyframes and failed relocalizations are
    ``breakdowns``' counts, and its relocalizations, discards, closures and
    statuses agree with the cell's own ``stress_result.json``."""
    from bundle_adjustment_tpu_torch.utils.event_log import read_events

    run = os.path.join(STUDY, cell)
    events = read_events(os.path.join(run, "run", "events.jsonl"))
    with open(os.path.join(run, "stress_result.json")) as f:
        res = json.load(f)
    got = stress.tally(events, res["keyframes"])
    b = stress.breakdowns(events)
    assert (got["discarded"], got["rotation"], got["reloc_fail"]) == \
        (len(b["discarded_frames"]), len(b["rotation_triggers"]), b["reloc_fail"])
    assert got["first_discarded"] == b["discarded_frames"][0]
    attempts = res["reloc_success"] + res["reloc_fail"]
    assert got["relocalizations"] == f"{res['reloc_success']}/{attempts}"
    assert (got["discarded"], got["closures"]) == (res["frames_discarded"], res["loop_closures"])
    assert sum(got["discarded_why"].values()) == got["discarded"]
    assert sum(got["statuses"].values()) == res["frames"]


def test_routes_switch_the_solvers_and_put_them_back():
    """Each routing of ``stress.ROUTES`` (and two joined by "+") switches
    what it names inside the block (the CLI's preset, K3's and K4's gates,
    K3's function, the graph replay, the step's null vectors and SVDs, at
    one call site or both, K4's solve under the planted defect) and puts
    everything back after it; a switched null vector is still the smallest
    eigenvalue's."""
    from bundle_adjustment_tpu_torch import run as run_mod
    from bundle_adjustment_tpu_torch.models import frontend
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk
    from bundle_adjustment_tpu_torch.ops import ba_kernel, ransac, small_linalg, triangulation

    A = torch.tensor(np.random.default_rng(0).normal(size=(3, 4, 4)), dtype=torch.float32)
    want = torch.linalg.svd(A.double())[2][..., -1, :]
    before = (run_mod.PRESETS["lehman_indoor"], ba_kernel.eligible_shape,
              gk.eligible_shape_global, ba_kernel.lm_solve, frontend.TrackStep._replay,
              small_linalg.null_vector, small_linalg.svd, gk.solve)
    for name, route in list(stress.ROUTES.items()) + [
            ("cuSOLVER eigh+K4 setup defect", stress.routing("cuSOLVER eigh+K4 setup defect"))]:
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
            at = route.get("null_at")
            assert (small_linalg.null_vector is before[5]) == (
                "eigh" not in linalg and not (route.get("null") and not at)), name
            assert (small_linalg.svd is before[6]) == ("svd" not in linalg), name
            assert (gk.solve is before[7]) == (not route.get("k4_defect")), name
            sites = dict(pnp=ransac, triangulation=triangulation)
            for site, mod in sites.items():
                assert (mod.small_linalg is small_linalg) == (at != site), (name, site)
                assert mod.small_linalg.svd is small_linalg.svd, (name, site)
            for null_vector in [small_linalg.null_vector] + [
                    mod.small_linalg.null_vector for mod in sites.values()]:
                v = null_vector(A)
                assert v.dtype == A.dtype and v.shape == (3, 4), name
                assert torch.allclose(torch.abs(torch.sum(v.double() * want, -1)),
                                      torch.ones(3, dtype=torch.float64), atol=1e-5), name
        assert (run_mod.PRESETS["lehman_indoor"], ba_kernel.eligible_shape,
                gk.eligible_shape_global, ba_kernel.lm_solve, frontend.TrackStep._replay,
                small_linalg.null_vector, small_linalg.svd, gk.solve) == before, name
        assert ransac.small_linalg is triangulation.small_linalg is small_linalg, name


@pytest.mark.parametrize("name, passes", [("as shipped", True), ("K4 setup defect", False)])
def test_phase_11s_hold_passes_k4_and_catches_the_planted_defect(monkeypatch, name, passes):
    """``chip_smoke.hold_to_grid`` on a ring of 40 cameras seen 14 times each
    on the CPU (K4's plain versions, ``torch.cuda``'s calls stubbed), under
    a routing as ``chip_smoke.py --routes`` runs it: K4 as it ships passes
    every rule; with the planted defect of ``stress.ROUTES``' "K4 setup
    defect" (its Huber weights dropped in the setup role) one LM iteration
    from the start misses the grid solver's, and so does the hold; as
    ``--routes`` studies it, along K4's path no state of the shipped K4
    misses, and the converged rule, run though the capped end points hold,
    finds K4 and the float64 witness converged."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from bundle_adjustment_tpu_torch.config import preset_lehman_indoor
    from bundle_adjustment_tpu_torch.ops import ba
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk
    from bundle_adjustment_tpu_torch.ops.ba_grid import from_flat
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_ring_problem

    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    cfg = preset_lehman_indoor().ba
    pr = synthetic_ring_problem(0, C=40, P=300, D=14)
    g = from_flat(ba.BAProblem(**{k: torch.as_tensor(v) for k, v in pr.items()}))
    skw = dict(max_iterations=20, huber_delta=cfg.huber_delta, lambda_init=cfg.lambda_init,
               lambda_up=cfg.lambda_up, lambda_down=cfg.lambda_down,
               lambda_min=cfg.lambda_min, lambda_max=cfg.lambda_max, ftol=cfg.ftol,
               xtol=cfg.xtol)
    with stress.routed("lehman_indoor", **stress.routing(name)):
        st = gk.solve(g, cg_forcing=True, n_fixed=1, cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
                      **skw)[3]
        rec = dict(C=40, initial_cost=float(st.initial_cost), final_cost=float(st.final_cost),
                   iterations=int(st.iterations), stop=ba.STOP_TESTS[int(st.stop)],
                   seconds=0.0)
        v = chip_smoke.hold_to_grid(torch, "a", {"finalize": (g, 1, skw, rec)}, cfg)["finalize"]
        s = chip_smoke.hold_to_grid(torch, "a", {"finalize": (g, 1, skw, rec)}, cfg,
                                    study=True)["finalize"]
    assert v["from_start"] == v["passed"] == passes, v
    assert v["capped_cost"] and v["capped_witness"] and v["converged"] is None, v
    assert v["path_misses"] is None, v
    assert {k: s[k] for k in ("from_start", "capped_cost", "capped_witness", "passed")} == \
        {k: v[k] for k in ("from_start", "capped_cost", "capped_witness", "passed")}, s
    if passes:
        assert s["path_misses"] == 0 and s["converged"] is True, s


@pytest.mark.parametrize("defect", [False, True, "K3"])
def test_phase_11s_wide_window_hold_keeps_saves_and_rules(monkeypatch, tmp_path, defect):
    """``chip_smoke.solver_split`` keeps the K3 windows past 12 slots that a
    drive solves (here two synthetic windows whose observations each sit in
    three slots, through ``ba_kernel.lm_solve`` on the CPU) and
    ``hold_wide_windows`` holds them: one record and one saved window each,
    ``windows.json`` beside them, every rule passing (the solves in two
    worker processes, ``stress.window_holds``); with K3's plain
    version adding only the first slot of a camera repeated on a point (the
    step only: the cost is right), rule (b) fails on both windows and the
    hold fails as phase 11 runs it; with K3 alone taking 0.9 of the right
    step after the drive, rule (a) fails, K3 ends otherwise than in the
    drive on both windows, and the hold fails."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from bundle_adjustment_tpu_torch.ops import ba_kernel
    from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid
    from bundle_adjustment_tpu_torch.utils.synthetic import repeat_slots, synthetic_window

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    counts, restore, kept = chip_smoke.solver_split(torch, keep_windows=True)
    kw = dict(n_fixed=2, max_iterations=50, huber_delta=1.0, lambda_init=1e-3,
              lambda_up=4.0, lambda_down=0.5, lambda_min=1e-10, lambda_max=1e8, ftol=1e-5,
              xtol=1e-5)
    try:
        for seed in (0, 1):
            w = repeat_slots(synthetic_window(seed, C=5, n_pts=120, P=128, D=5), 3, seed)
            ba_kernel.lm_solve(BAProblemGrid(**{k: torch.as_tensor(v) for k, v in w.items()}),
                               **kw)
    finally:
        restore()
    assert counts["K3, D > 12"] == 2 and len(kept) == 2
    solve_step, plain = ba_kernel._solve_step, ba_kernel.lm_solve_plain
    if defect is True:
        def first_slot_only(rv, tv, pts, p, live, onehot, *a):
            first = (torch.cumsum(onehot, dim=1) == 1).to(onehot.dtype)
            return solve_step(rv, tv, pts, p, live, onehot * first, *a)
        monkeypatch.setattr(ba_kernel, "_solve_step", first_slot_only)
    elif defect == "K3":
        def short_k3(grid, **opts):
            ba_kernel._solve_step = lambda *a: tuple(0.9 * d for d in solve_step(*a))
            try:
                return plain(grid, **opts)
            finally:
                ba_kernel._solve_step = solve_step
        monkeypatch.setattr(ba_kernel, "lm_solve", short_k3)
    # the planted defects live in this process; the shipped solvers are held
    # in two worker processes, as phase 11 holds them in six
    workers = 0 if defect else 2
    out = chip_smoke.hold_wide_windows(torch, kept, 2, 0, str(tmp_path), study=True,
                                       workers=workers)
    rule = out["rule"]
    assert out["records"] == 2 and rule["b"]["windows"] == 2
    assert sorted(os.listdir(tmp_path)) == ["w0000.npz", "w0001.npz", "windows.json"]
    if defect is True:
        assert rule["b"]["failures"] == [0, 1] and not rule["passed"], rule
        # on the CPU K3 is its plain version: the defect moves its solves too
        assert rule["a"]["passed"] and out["redone"] == [0, 1], (rule, out)
    elif defect == "K3":
        assert not rule["a"]["passed"] and rule["b"]["passed"], rule
        assert out["redone"] == [0, 1], out
    else:
        assert rule["passed"] and rule["b"]["worst_path"] < 1e-9 and out["redone"] == [], rule
        assert rule["a"]["worst"] == 0.0, rule
    if defect is not False:
        with pytest.raises(SystemExit):
            chip_smoke.hold_wide_windows(torch, kept, 2, 0, str(tmp_path), workers=0)


@pytest.mark.parametrize("k4, grid32, grid64, met, limit", [
    ((100.5, "ftol"), (103.0, "xtol"), (100.0, "ftol"), True, 0.06),
    ((105.0, "xtol"), (103.0, "xtol"), (100.0, "ftol"), True, 0.06),
    ((107.0, "xtol"), (103.0, "xtol"), (100.0, "ftol"), False, 0.06),
    ((95.0, "ftol"), (103.0, "cap"), (100.0, "xtol"), False, 0.01),   # float32 grid at its cap
    ((100.5, "ftol"), (103.0, "cap"), (100.0, "xtol"), True, 0.01),
    ((100.0, "ftol"), (100.0, "ftol"), (100.0, "cap"), False, None),  # the witness at its cap
    ((100.0, "cap"), (100.0, "ftol"), (100.0, "ftol"), False, None),  # K4 at its cap
    ((100.0, "stuck"), (100.0, "ftol"), (100.0, "ftol"), False, None),
])
def test_converged_rule_counts_only_converged_solves(k4, grid32, grid64, met, limit):
    """``chip_smoke.converged_rule``: K4 within 1 % of the float64 witness or
    at most twice as far as the float32 grid solver, met only where K4 and
    the witness stopped by ``ftol`` or ``xtol``; a float32 grid solver that
    stopped by its cap widens nothing."""
    sys.path.insert(0, REPO)
    import chip_smoke

    r = chip_smoke.converged_rule(k4, grid32, grid64)
    assert r["met"] is met, r
    assert r["limit"] == pytest.approx(limit) if limit is not None else r["limit"] is None, r


def test_window_floor_prints_the_jax_tools_keys():
    """``window_floor`` at two tiny windows on the CPU (K3's plain version):
    the JAX tool's keys per P and on the verdict line, 4 observations per
    point, each solve run to its cap (10 and 50 LM iterations)."""
    from bundle_adjustment_tpu_torch.tools import window_floor

    out = window_floor.main(["--device", "cpu", "--points", "32", "64", "--reps", "1",
                             "--trials", "1"])
    assert {"metric", "P_span", "time_ratio", "latency_bound", "note"} <= set(out)
    assert out["metric"] == "window_kernel_floor" and out["P_span"] == "32->64 (2x points)"
    assert out["time"] == "host (cpu)" and out["beyond"] is None
    for row, P in zip(out["rows"], (32, 64)):
        assert row["P"] == P and row["obs"] == 4 * P and row["lm_iterations"] == [10, 50]
        assert np.isfinite(row["us_per_lm_iteration"])
    assert out["latency_bound"] == (out["time_ratio"] < 2.0)


def test_fps_bench_prints_the_jax_tools_keys():
    """``fps_bench`` over 6 frames at 192x144 on the CPU: the JAX tool's
    keys, the three modes (pipelined, fused, staged) in its order."""
    from bundle_adjustment_tpu_torch.tools import fps_bench

    out = fps_bench.main(["--device", "cpu", "--frames", "6", "--warmup", "2", "--size",
                          "192x144", "--features", "150"])
    assert set(out) == {"metric", "pipelined_fps", "fused_fps", "staged_fps",
                        "pipelined_tracked_ms", "fused_tracked_ms", "staged_tracked_ms",
                        "pp_overlap_speedup", "tracked_speedup", "tracked_frames",
                        "keyframes", "frames", "backend", "device"}
    assert out["metric"] == "frontend_fps" and out["frames"] == 6 and out["backend"] == "cpu"
    assert all(out[k] > 0 for k in ("pipelined_fps", "fused_fps", "staged_fps"))
    assert len(out["tracked_frames"]) == len(out["keyframes"]) == 3
    assert all(k >= 1 for k in out["keyframes"])


def test_fps_bench_first_run_probe_with_prewarm():
    """``fps_bench --first-run-probe --prewarm`` on the CPU: one pipelined
    pass after an unmeasured one over another sequence, the JAX tool's
    keys."""
    from bundle_adjustment_tpu_torch.tools import fps_bench

    out = fps_bench.main(["--device", "cpu", "--frames", "5", "--warmup", "2", "--size",
                          "192x144", "--features", "150", "--first-run-probe", "--prewarm"])
    assert set(out) == {"metric", "first_run_fps", "tracked_ms", "tracked_frames",
                        "keyframes", "prewarm_s", "frames", "backend", "device"}
    assert out["metric"] == "first_run_fps" and out["first_run_fps"] > 0
    assert out["prewarm_s"] > 0 and out["keyframes"] >= 1


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
