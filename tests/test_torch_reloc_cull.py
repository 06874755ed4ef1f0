"""Relocalization, map-point culling and the lehman_indoor configuration
of the port against the JAX package, on the CPU.

* The Map methods the three features need (``colors``, ``point_alive``,
  ``cull_points``, ``observations_of_point``, ``first_observer_per_point``,
  ``anchor_observations``, ``merge_points``, ``observation_count_per_point``)
  on a JAX-package map carried into the port by ``convert.map_store``, and
  ``gather_window`` and ``get_pcd`` once points and observations have died:
  equal exactly.
* ``try_relocalize`` on the JAX pipeline's map, with the same keypoints and
  the JAX pipeline's RANSAC draws replayed: same anchor, same inlier count,
  the inserted keyframe's pose within 1e-4, through the exact 2-NN bank
  search and through the coarse-to-fine one.
* ``_cull_points`` on the same map: the same points, observations and
  back-pointers die, exactly; and a free port run with culling on keeps the
  observation table's invariants (``tests/test_reloc_cull.py``'s).
* The room render's ground-truth poses equal the JAX package's bit for bit.
* ``--preset lehman_indoor`` through the CLI at 320x240.
"""

import copy
import dataclasses
import os
import types

import cv2
import jax
import numpy as np
import pytest
import torch

import bundle_adjustment_tpu.config as jcfg
from bundle_adjustment_tpu.models.map_store import Keyframe as JaxKeyframe
from bundle_adjustment_tpu.models.map_store import Map as JaxMap
from bundle_adjustment_tpu.models.pipeline import VisualOdometryPipeline as JaxPipeline
from bundle_adjustment_tpu.models.relocalize import try_relocalize as jax_try_relocalize
from bundle_adjustment_tpu.utils import synthetic as jsynthetic
from bundle_adjustment_tpu.utils.event_log import EventLog as JaxEventLog
import bundle_adjustment_tpu_torch.config as tcfg
from bundle_adjustment_tpu_torch import convert, run
from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
from bundle_adjustment_tpu_torch.models.relocalize import try_relocalize
from bundle_adjustment_tpu_torch.utils import synthetic
from bundle_adjustment_tpu_torch.utils.event_log import EventLog, read_events

torch.set_num_threads(1)

W, H = 320, 240


class JaxDraws:
    """The JAX pipeline's sequential key schedule from ``key`` on, as the
    port's ``draws``."""

    def __init__(self, key):
        self._key = key

    def next(self, shape):
        self._key, k = jax.random.split(self._key)
        return torch.as_tensor(np.array(jax.random.uniform(k, shape)))

    def for_frame(self, frame_idx, shape, out=None):
        k = jax.random.fold_in(jax.random.PRNGKey(1), frame_idx)
        u = torch.as_tensor(np.array(jax.random.uniform(k, shape)))
        return u if out is None else out.copy_(u)


def _config(mod, K, **kw):
    """``tests/test_reloc_cull.py``'s configuration at the port's test size."""
    base = dict(
        camera=mod.CameraModel(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                               width=W, height=H),
        num_features=300, pyramid_levels=3, ratio_test=0.75,
        min_tracked_features=15, pose_inlier_ratio=0.4, pose_inlier_numbers=15,
        consistent_convention=True,
        keyframe=mod.KeyframeCriteria(min_median_displacement_px=12.0),
        ba=mod.BAConfig(window_size=4, max_points=4096, max_obs=16384))
    base.update(kw)
    return mod.PipelineConfig(**base)


def _copy_jax_map(jmap):
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
def seq():
    frames, K, _, _ = synthetic.synthetic_sequence(n_frames=10, width=W, height=H, fx=300.0,
                                                   seed=0)
    return frames, K


@pytest.fixture(scope="module")
def jax_run(seq):
    """The JAX pipeline over the first 5 frames, with relocalization on."""
    frames, K = seq
    jp = JaxPipeline(_config(jcfg, K, reloc_enabled=True), log=JaxEventLog(echo=False),
                     use_pallas_matcher=False)
    for f in frames[:5]:
        jp.process_frame(f)
    assert jp.map.num_keyframes >= 4
    return jp


def _random_jax_map(seed=0, n_kf=6, n_kp=40, n_pts=60):
    rng = np.random.default_rng(seed)
    m = JaxMap(use_native=False)
    for k in range(n_kf):
        m.add_keyframe(JaxKeyframe(
            kf_id=k, R=np.eye(3), t=rng.normal(size=3), xy=rng.uniform(0, 100, (n_kp, 2)),
            desc=jax.numpy.asarray(rng.integers(0, 2 ** 32, (n_kp, 8), dtype=np.uint64)
                                   .astype(np.uint32)),
            kp_valid=np.ones(n_kp, bool), frame_idx=k))
    m.add_map_points(rng.normal(size=(n_pts, 3)) + [0, 0, 6], rng.random((n_pts, 3)))
    for k in range(n_kf):
        mps = rng.choice(n_pts, size=25, replace=False)
        kps = rng.choice(n_kp, size=25, replace=False)
        m.add_observations(k, mps, kps, rng.uniform(0, 100, (25, 2)))
    return m


def _assert_maps_equal(tm, jm):
    for name in convert._MAP_ARRAYS:
        n = jm._n_pts if name in ("_pts", "_colors", "_pt_alive") else jm._n_obs
        np.testing.assert_array_equal(getattr(tm, name)[:n], getattr(jm, name)[:n], name)
    assert (tm._n_pts, tm._n_obs) == (jm._n_pts, jm._n_obs)
    assert tm.sorted_kf_ids() == jm.sorted_kf_ids()
    for k in jm.keyframes:
        np.testing.assert_array_equal(tm.keyframes[k].kp_to_mp, jm.keyframes[k].kp_to_mp)


def test_map_methods_equal_jax_and_skip_the_dead():
    jm = _random_jax_map()
    tm = convert.map_store(jm, device="cpu")
    np.testing.assert_array_equal(tm.colors(), jm.colors())
    np.testing.assert_array_equal(tm.point_alive(), jm.point_alive())

    def queries():
        for mp in (0, 7, 31, 59):
            for a, b in zip(tm.observations_of_point(mp), jm.observations_of_point(mp)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tm.first_observer_per_point(),
                                      jm.first_observer_per_point())
        np.testing.assert_array_equal(tm.observation_count_per_point(),
                                      jm.observation_count_per_point())
        for cutoff in (0, 2, 5):
            for a, b in zip(tm.anchor_observations(cutoff), jm.anchor_observations(cutoff)):
                np.testing.assert_array_equal(a, b)

    queries()
    dead = np.array([3, 7, 11, 40])
    tm.cull_points(dead)
    jm.cull_points(dead)
    _assert_maps_equal(tm, jm)
    queries()
    counts = jm.observation_count_per_point()
    pairs = [(int(a), int(b)) for a, b in zip(np.flatnonzero(counts > 0)[:6],
                                              np.flatnonzero(counts > 0)[6:12])]
    moved = [(tm.merge_points(a, b), jm.merge_points(a, b)) for a, b in pairs]
    assert [a for a, _ in moved] == [b for _, b in moved] and sum(a for a, _ in moved) > 0
    _assert_maps_equal(tm, jm)
    queries()
    # the readers skip dead points and dead observations as the JAX ones do
    assert not tm.point_alive().all()
    for a, b in zip(tm.get_pcd(), jm.get_pcd()):
        np.testing.assert_array_equal(a, b)
    K = np.array([[300.0, 0, 50], [0, 300.0, 50], [0, 0, 1]])
    tp, tmp, trows = tm.gather_window([1, 2, 4], K, 4096, 16384)
    jp, jmp, jrows = jm.gather_window([1, 2, 4], K, 4096, 16384)
    np.testing.assert_array_equal(tmp, jmp)
    np.testing.assert_array_equal(trows, jrows)
    assert tm.point_alive()[tmp].all()
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      name)


@pytest.mark.parametrize("threshold", [16384, 0], ids=["exact-2nn", "ann"])
def test_try_relocalize_equals_jax(seq, jax_run, threshold):
    frames, K = seq
    jp = copy.copy(jax_run)
    jp.map = _copy_jax_map(jax_run.map)
    jp.cfg = dataclasses.replace(jp.cfg, reloc_ann_threshold=threshold)
    jp.log = JaxEventLog(echo=False)
    jp.map.log = jp.log
    tp = VisualOdometryPipeline(_config(tcfg, K, reloc_enabled=True,
                                        reloc_ann_threshold=threshold),
                                log=EventLog(echo=False), device="cpu",
                                draws=JaxDraws(jp._key))
    tp.map = convert.map_store(jp.map, device="cpu")
    tp.map.log = tp.log
    jp.frame_idx = tp.frame_idx = 5

    jkp = jp._extract(cv2.cvtColor(frames[4], cv2.COLOR_BGR2GRAY))
    tkp = types.SimpleNamespace(xy=torch.as_tensor(np.asarray(jkp.xy)),
                                desc=convert.descriptors(jkp.desc, "cpu"),
                                valid=torch.as_tensor(np.asarray(jkp.valid)))
    j = jax_try_relocalize(jp, frames[4], jkp)
    t = try_relocalize(tp, frames[4], tkp)
    assert j is not None and j["status"] == "relocalized"
    assert t is not None and t["status"] == "relocalized"
    for key in ("kf_id", "anchor_kf", "inliers"):
        assert t[key] == j[key], key
    assert t["inliers"] > 15
    jkf, tkf = jp.map.keyframes[j["kf_id"]], tp.map.keyframes[t["kf_id"]]
    np.testing.assert_allclose(tkf.R, jkf.R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tkf.t, jkf.t, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tkf.kp_to_mp, jkf.kp_to_mp)
    ev = [(e["frame_idx"], e["success"], e["kf_id"], e["inliers"])
          for e in tp.log.events if e["event"] == "relocalization"]
    assert ev == [(e["frame_idx"], e["success"], e["kf_id"], e["inliers"])
                  for e in jp.log.events if e["event"] == "relocalization"]


def test_cull_points_equals_jax(seq, jax_run):
    frames, K = seq
    jp = copy.copy(jax_run)
    jp.map = _copy_jax_map(jax_run.map)
    jp.cfg = _config(jcfg, K, cull_enabled=True, cull_min_observations=3,
                     ba=jcfg.BAConfig(window_size=1))
    jp.log = JaxEventLog(echo=False)
    tp = VisualOdometryPipeline(_config(tcfg, K, cull_enabled=True, cull_min_observations=3,
                                        ba=tcfg.BAConfig(window_size=1)),
                                log=EventLog(echo=False), device="cpu")
    tp.map = convert.map_store(jp.map, device="cpu")
    jp._cull_points()
    tp._cull_points()
    culled = [e["culled"] for e in tp.log.events if e["event"] == "cull"]
    assert culled == [e["culled"] for e in jp.log.events if e["event"] == "cull"]
    assert culled and culled[0] > 0 and tp._front_dirty
    _assert_maps_equal(tp.map, jp.map)


def test_culling_removes_weak_points(seq):
    """``tests/test_reloc_cull.py``'s test on the port: weakly observed
    points outside the active window die, and no observation or
    back-pointer refers to a dead point."""
    frames, K = seq
    cfg = _config(tcfg, K, cull_enabled=True, cull_min_observations=3,
                  ba=tcfg.BAConfig(window_size=2, max_points=4096, max_obs=16384))
    pipe = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device="cpu")
    for f in frames[:8]:
        pipe.process_frame(f)
    culled = [e["culled"] for e in pipe.log.events if e["event"] == "cull"]
    assert culled and sum(culled) > 0
    m = pipe.map
    assert m.num_points == int(m.point_alive().sum()) < m._n_pts
    alive_obs = m._obs_alive[: m._n_obs]
    assert m.point_alive()[m._obs_mp[: m._n_obs][alive_obs]].all()
    for kf in m.keyframes.values():
        live = kf.kp_to_mp[kf.kp_to_mp >= 0]
        assert m.point_alive()[live].all()
    assert len(m.get_pcd()[0]) == m.num_points


def test_room_ground_truth_equals_jax(monkeypatch):
    jf, jK, jC, jR = jsynthetic.synthetic_sequence(n_frames=4, width=160, height=120,
                                                   fx=150.0, seed=2, motion="room")
    tf, tK, tC, tR = synthetic.synthetic_sequence(n_frames=4, width=160, height=120,
                                                  fx=150.0, seed=2, motion="room",
                                                  device="cpu")
    np.testing.assert_array_equal(tK, jK)
    np.testing.assert_array_equal(tC, jC)
    np.testing.assert_array_equal(tR, jR)
    assert [f.shape for f in tf] == [f.shape for f in jf] == [(120, 160, 3)] * 4
    # each plane warped over the whole frame gives the same pixels as over
    # its projected bounding box
    planes = synthetic._room_planes(np.random.default_rng(2))
    R, t, _ = synthetic.room_pose(1, 4)
    warp = synthetic._warp_into
    whole = np.array([[0.0, 0.0], [159.0, 119.0]])
    monkeypatch.setattr(synthetic, "_warp_into",
                        lambda frame, tex, H, uv: warp(frame, tex, H, whole))
    np.testing.assert_array_equal(
        synthetic.render_frame(tK, R, t, planes, 160, 120, depth_sort=True), tf[1])
    # the walls fill the view: few background pixels
    assert all((f == 40).all(-1).mean() < 0.05 for f in tf)


def test_lehman_indoor_cli_on_the_cpu(tmp_path):
    """``--preset lehman_indoor`` as it ships but for the camera and the
    feature count: relocalization, culling and loop closure on."""
    # the first 6 frames of a 150-frame loop of the room
    K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]])
    planes = synthetic._room_planes(np.random.default_rng(2))
    folder = tmp_path / "frames"
    folder.mkdir()
    for i in range(6):
        R, t, _ = synthetic.room_pose(i, 150)
        cv2.imwrite(str(folder / f"{i:04d}.png"),
                    synthetic.render_frame(K, R, t, planes, W, H, depth_sort=True))
    out = str(tmp_path / "out")
    summary = run.main(["--device", "cpu", "--preset", "lehman_indoor", "--images", str(folder),
                        "--out", out, "--features", "300", "--size", f"{W}x{H}",
                        "--fx", str(K[0, 0]), "--cx", str(K[0, 2]), "--cy", str(K[1, 2])])
    cfg = run._config(run.build_parser().parse_args(
        ["--preset", "lehman_indoor", "--images", str(folder)]))
    assert cfg.reloc_enabled and cfg.cull_enabled and cfg.loop_closure
    assert summary["frames"] == 6 and summary["num_keyframes"] >= 3
    events = read_events(os.path.join(out, "events.jsonl"))
    statuses = [e["status"] for e in events if e["event"] == "frame_timing"]
    assert len(statuses) == 6 and statuses.count("keyframe") >= 2
    assert np.isfinite(summary["global_ba"]["final"])
    with open(os.path.join(out, "trajectory.txt")) as fh:
        assert len([ln for ln in fh if not ln.startswith("#")]) == summary["num_keyframes"]
