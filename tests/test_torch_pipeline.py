"""The slice as a whole: the port's ``VisualOdometryPipeline`` against the JAX
package's on the same synthetic frames, with the JAX RANSAC draws replayed.

Both run ``preset``-style defaults at a small size (10 frames at 320x240,
300 features, 3 levels, ``BAConfig(use_pallas_ba=False)``, window 4) on
the CPU.  One more port run keeps ``use_pallas_ba=True``, the default: on the
CPU its windows go through the plain version of the window LM kernel
(``ops.ba_kernel.lm_solve``) inside ``_solve_window``; it is held to the same
JAX run by the first statuses and the same ATE bounds.  The two packages agree bit for bit only up to the first place
where float32 evaluation order decides a discrete choice (a descriptor bit
near zero, a RANSAC argmax between near-equal hypotheses, an LM
accept/reject), so the free-running comparison is held at what a user sees
(the decisions of the first frames, trajectory accuracy against ground
truth), and the global BA is held to 1 % on one shared map:

* the first four frames' statuses are equal (initialization, the essential
  fallback with triangulation, a PnP-tracked frame, a keyframe);
* each pipeline's keyframe-centre ATE after similarity alignment is within
  0.25 of the ground-truth path's extent, and the port's exceeds the JAX
  pipeline's by at most 0.1 of it;
* the JAX pipeline's final map, carried into the port by ``convert``,
  gives the same global-BA problem (cameras, points, observations exactly,
  initial cost within 1e-5) and a final cost within 1 %;
* ``finalize`` writes the trajectory, the PCD, ``summary.json`` and an
  ``events.jsonl`` that the port's event log reads back;
* with ``BAConfig(pcg_min_cameras=3)`` every BA over more than 3 cameras
  takes the matrix-free PCG branch of ``_solve_window`` (on the CPU the grid
  PCG solver; on the card the global-BA kernels): a free run ends in a
  finite full BA that did not diverge, and on a copy of the JAX pipeline's
  map taken before any final BA the port's ``run_full_ba`` agrees with the
  JAX pipeline's (same problem, initial cost within 1e-5, final cost within
  1 %).
"""

import copy
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import bundle_adjustment_tpu.config as jcfg
from bundle_adjustment_tpu.models.map_store import Map as JaxMap
from bundle_adjustment_tpu.models.pipeline import VisualOdometryPipeline as JaxPipeline
from bundle_adjustment_tpu.utils.event_log import EventLog as JaxEventLog
from bundle_adjustment_tpu.utils.synthetic import synthetic_sequence
import bundle_adjustment_tpu_torch.config as tcfg
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
from bundle_adjustment_tpu_torch.utils.event_log import EventLog, read_events
from bundle_adjustment_tpu_torch.utils.metrics import ate_rmse

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)

W, H = 320, 240


class JaxDraws:
    """The JAX pipeline's key schedule as the port's ``draws``: PRNGKey(0)
    split once per sequential RANSAC call, fold_in(PRNGKey(1), frame) for
    the fused step."""

    def __init__(self):
        self._key = jax.random.PRNGKey(0)
        self._dispatch = jax.random.PRNGKey(1)

    def next(self, shape):
        self._key, k = jax.random.split(self._key)
        return torch.as_tensor(np.array(jax.random.uniform(k, shape)))

    def for_frame(self, frame_idx, shape, out=None):
        k = jax.random.fold_in(self._dispatch, frame_idx)
        u = torch.as_tensor(np.array(jax.random.uniform(k, shape)))
        return u if out is None else out.copy_(u)


def _config(mod, K, use_pallas_ba=False):
    return mod.PipelineConfig(
        camera=mod.CameraModel(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                               width=W, height=H),
        num_features=300, pyramid_levels=3,
        ba=mod.BAConfig(use_pallas_ba=use_pallas_ba, window_size=4))


def _keyframe_ate(pipe, gt_centres):
    ids = pipe.map.sorted_kf_ids()
    traj = pipe.map.trajectory(pipe.cfg.consistent_convention)
    gt = np.stack([gt_centres[pipe.map.keyframes[k].frame_idx] for k in ids])
    return ate_rmse(traj, gt, with_scale=True), float(np.linalg.norm(gt.max(0) - gt.min(0)))


def _copy_jax_map(jmap):
    """A JAX-package ``Map`` with copies of ``jmap``'s host arrays and
    keyframes and the numpy observation table only (the native mirror owns
    memory that must not be copied by reference)."""
    m = JaxMap(use_native=False)
    for k, kf in jmap.keyframes.items():
        kf2 = copy.copy(kf)
        kf2.R, kf2.t, kf2.kp_to_mp = np.array(kf.R), np.array(kf.t), np.array(kf.kp_to_mp)
        m.keyframes[k] = kf2
    for name in convert._MAP_ARRAYS:
        setattr(m, name, np.array(getattr(jmap, name)))
    m._n_pts, m._n_obs = jmap._n_pts, jmap._n_obs
    m.next_keyframe_id, m.next_map_point_id = jmap.next_keyframe_id, jmap.next_map_point_id
    return m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames, K, gt_centres, _ = synthetic_sequence(n_frames=20, width=W, height=H, seed=0)
    frames = frames[:10]
    jp = JaxPipeline(_config(jcfg, K), log=JaxEventLog(echo=False), use_pallas_matcher=False)
    tp = VisualOdometryPipeline(_config(tcfg, K), log=EventLog(echo=False), device="cpu",
                                draws=JaxDraws())
    js = [jp.process_frame(f)["status"] for f in frames]
    ts = [tp.process_frame(f)["status"] for f in frames]
    shared = convert.map_store(jp.map, device="cpu")
    # a second pair of copies for the PCG branch, taken before any final BA
    jax_map = _copy_jax_map(jp.map)
    shared_pcg = convert.map_store(jp.map, device="cpu")
    out = tmp_path_factory.mktemp("port_out")
    summary = tp.finalize(str(out))
    return dict(K=K, gt=gt_centres, jp=jp, tp=tp, js=js, ts=ts, shared=shared,
                jax_map=jax_map, shared_pcg=shared_pcg, frames=frames,
                out=str(out), summary=summary, n_frames=len(frames))


def test_first_decisions_agree(runs):
    assert runs["js"][:4] == runs["ts"][:4]
    assert runs["ts"][0] == "initialized"
    assert "keyframe" in runs["ts"][1:4]


def test_trajectory_accuracy_matches_jax(runs):
    ate_j, extent = _keyframe_ate(runs["jp"], runs["gt"])
    ate_t, _ = _keyframe_ate(runs["tp"], runs["gt"])
    assert runs["tp"].map.num_keyframes >= 4
    assert ate_j <= 0.25 * extent and ate_t <= 0.25 * extent, (ate_j, ate_t, extent)
    assert ate_t <= ate_j + 0.1 * extent, (ate_j, ate_t, extent)


def test_window_kernel_path_matches_jax(runs, monkeypatch):
    """The port with the default ``use_pallas_ba=True`` on the CPU: every
    window BA goes through ``ba_kernel.lm_solve`` (its plain version here)."""
    from bundle_adjustment_tpu_torch.ops import ba_kernel

    calls = []
    solve = ba_kernel.lm_solve
    monkeypatch.setattr(ba_kernel, "lm_solve",
                        lambda grid, **kw: calls.append(kw["n_fixed"]) or solve(grid, **kw))
    frames, K, _, _ = synthetic_sequence(n_frames=20, width=W, height=H, seed=0)
    log = EventLog(echo=False)
    tp = VisualOdometryPipeline(_config(tcfg, K, use_pallas_ba=True), log=log,
                                device="cpu", draws=JaxDraws())
    ts = [tp.process_frame(f)["status"] for f in frames[:10]]
    assert ts[:4] == runs["js"][:4]
    n_ba = sum(e["event"] in ("ba_complete", "ba_diverged") for e in log.events)
    assert n_ba >= 1 and len(calls) == n_ba
    ate_j, extent = _keyframe_ate(runs["jp"], runs["gt"])
    ate_t, _ = _keyframe_ate(tp, runs["gt"])
    assert tp.map.num_keyframes >= 4
    assert ate_t <= 0.25 * extent and ate_t <= ate_j + 0.1 * extent, (ate_j, ate_t, extent)


def test_global_ba_on_the_same_map(runs):
    port = VisualOdometryPipeline(_config(tcfg, runs["K"]), log=EventLog(echo=False),
                                  device="cpu", draws=JaxDraws())
    port.map = runs["shared"]
    b = port.run_global_ba()
    a = runs["jp"].run_global_ba()
    assert a is not None and b is not None
    assert not a["diverged"] and not b["diverged"]
    for key in ("n_cams", "n_points", "n_obs"):
        assert a[key] == b[key], key
    np.testing.assert_allclose(b["initial"], a["initial"], rtol=1e-5)
    np.testing.assert_allclose(b["final"], a["final"], rtol=1e-2)


def test_finalize_writes_outputs(runs):
    out, tp = runs["out"], runs["tp"]
    events = read_events(os.path.join(out, "events.jsonl"))
    kinds = [e["event"] for e in events]
    assert kinds.count("frame_timing") == runs["n_frames"]
    assert "ba_complete" in kinds
    with open(os.path.join(out, "trajectory.txt")) as fh:
        rows = [ln.split() for ln in fh if not ln.startswith("#")]
    assert len(rows) == tp.map.num_keyframes
    assert all(np.isfinite(float(x)) for r in rows for x in r[2:])
    with open(os.path.join(out, "final_map_global_ba.pcd")) as fh:
        header = fh.read(512)
    assert f"POINTS {tp.map.num_points}" in header
    with open(os.path.join(out, "summary.json")) as fh:
        summary = json.load(fh)
    assert summary["num_keyframes"] == tp.map.num_keyframes
    assert summary["frames"] == runs["n_frames"] and summary["device"] == "cpu"
    assert summary == json.loads(json.dumps(runs["summary"]))


def _pcg_config(mod, K):
    cfg = _config(mod, K)
    return dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, pcg_min_cameras=3))


def test_pcg_branch_end_to_end(runs, monkeypatch):
    """A free run whose BAs over more than 3 cameras go through the PCG
    branch: each such solve is seen entering the grid PCG solver with the
    pipeline's ``cg_iters`` and forcing, and the full BA ends finite."""
    from bundle_adjustment_tpu_torch.ops import ba_grid

    calls = []
    solve = ba_grid.ba_solve_grid_impl

    def spy(grid, **kw):
        calls.append((grid.rvecs.shape[0], kw.get("cg_iters", 0), kw.get("cg_forcing")))
        return solve(grid, **kw)

    monkeypatch.setattr(ba_grid, "ba_solve_grid_impl", spy)
    log = EventLog(echo=False)
    tp = VisualOdometryPipeline(_pcg_config(tcfg, runs["K"]), log=log, device="cpu",
                                draws=JaxDraws())
    ts = [tp.process_frame(f)["status"] for f in runs["frames"]]
    assert ts[:4] == runs["js"][:4] and tp.map.num_keyframes >= 4
    before = len(calls)
    full = tp.run_full_ba()
    assert len(calls) == before + 1 and calls[-1] == (tp.map.num_keyframes, 8, True)
    assert all(it == (8 if cams > 3 else 0) for cams, it, _ in calls)
    assert full is not None and not full["diverged"]
    assert np.isfinite(full["final"]) and full["final"] <= full["initial"]
    assert np.isfinite(tp.map.trajectory(True)).all()
    ate_t, extent = _keyframe_ate(tp, runs["gt"])
    assert ate_t <= 0.25 * extent, (ate_t, extent)


def test_pcg_full_ba_on_the_same_map(runs):
    jp = JaxPipeline(_pcg_config(jcfg, runs["K"]), log=JaxEventLog(echo=False),
                     use_pallas_matcher=False)
    jp.map = runs["jax_map"]
    port = VisualOdometryPipeline(_pcg_config(tcfg, runs["K"]), log=EventLog(echo=False),
                                  device="cpu", draws=JaxDraws())
    port.map = runs["shared_pcg"]
    assert port.map.num_keyframes > 3
    a = jp.run_full_ba()
    b = port.run_full_ba()
    assert a is not None and b is not None
    assert not a["diverged"] and not b["diverged"]
    for key in ("n_cams", "n_points", "n_obs"):
        assert a[key] == b[key], key
    np.testing.assert_allclose(b["initial"], a["initial"], rtol=1e-5)
    np.testing.assert_allclose(b["final"], a["final"], rtol=1e-2)
    assert b["final"] < b["initial"]
