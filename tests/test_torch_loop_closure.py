"""Loop closure of the port (``models/loop_closure.py``) against the JAX
package's, on the CPU: ``tests/test_loop_closure.py``'s three tests, each
also run through the JAX package on the same inputs.

* ``fit_sim3_ransac`` on the same points: the same fit and inliers (both are
  the same numpy arithmetic: equal to 1e-12), and the JAX test's bounds.
* ``merge_points`` on a small map: the JAX test's invariants, and the same
  arrays as the JAX map after the same merge.
* The drifted ring: cameras on a ring around a point cloud, poses and points
  under a growing sim(3) drift, the last keyframe revisiting the first view
  with duplicate points.  The port's and the JAX package's
  ``try_close_loop`` on the same ring, with the JAX RANSAC draws replayed:
  the same anchor (0), scale within 1e-4 (and within 0.05 of 1/s), the same
  fused and added counts, every pose within 1e-4 after the correction.  With
  the polish BA after it (the port's on the window LM kernel's plain
  version, five LM iterations over 13 cameras) the two solves are held as
  ``tests/test_torch_pipeline.py`` holds a global BA: the same cameras,
  points, observations and iterations, initial cost within 1e-5 and final
  cost within 1 % (float32 LM in two packages; the ring's poses then part by
  up to 3e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bundle_adjustment_tpu.config as jcfg
from bundle_adjustment_tpu.models import loop_closure as jlc
from bundle_adjustment_tpu.models.map_store import Keyframe as JaxKeyframe
from bundle_adjustment_tpu.models.map_store import Map as JaxMap
from bundle_adjustment_tpu.models.pipeline import VisualOdometryPipeline as JaxPipeline
from bundle_adjustment_tpu.utils.event_log import EventLog as JaxEventLog
import bundle_adjustment_tpu_torch.config as tcfg
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.models import loop_closure
from bundle_adjustment_tpu_torch.models.map_store import Keyframe, Map
from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np
from bundle_adjustment_tpu_torch.utils.event_log import EventLog

torch.set_num_threads(1)


class JaxDraws:
    """The JAX pipeline's sequential key schedule, PRNGKey(0) split once per
    RANSAC call, as the port's ``draws``."""

    def __init__(self):
        self._key = jax.random.PRNGKey(0)

    def next(self, shape):
        self._key, k = jax.random.split(self._key)
        return torch.as_tensor(np.array(jax.random.uniform(k, shape)))


def test_fit_sim3_ransac_with_outliers():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 3)) * 2.0
    s, R, t = 1.3, so3_exp_np(np.array([0.1, -0.2, 0.05])), np.array([0.4, -0.1, 0.7])
    Y = (s * (R @ X.T)).T + t + rng.normal(size=X.shape) * 0.002
    Y[:18] += rng.normal(size=(18, 3)) * 3.0  # 30 % outliers
    fit = loop_closure.fit_sim3_ransac(X, Y, tol=0.05)
    jfit = jlc.fit_sim3_ransac(X, Y, tol=0.05)
    assert fit is not None and jfit is not None
    s_f, R_f, t_f, inl = fit
    assert abs(s_f - s) < 0.01
    np.testing.assert_allclose(R_f, R, atol=0.01)
    np.testing.assert_allclose(t_f, t, atol=0.05)
    assert inl.sum() >= 40
    np.testing.assert_array_equal(inl, jfit[3])
    for a, b in zip(fit[:3], jfit[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert loop_closure.fit_sim3_ransac(X[:3], Y[:3], tol=0.05) is None


def _mini_maps():
    """A two-point map in both packages: dst seen by KF0 (kp0) and KF1
    (kp1), src by KF1 (kp2) and KF2 (kp3)."""
    rng = np.random.default_rng(1)
    jm = JaxMap(use_native=False)
    for k in range(3):
        jm.add_keyframe(JaxKeyframe(
            kf_id=k, R=np.eye(3), t=np.zeros(3), xy=rng.uniform(0, 100, size=(8, 2)),
            desc=jnp.asarray(rng.integers(0, 2 ** 31, size=(8, 8)).astype(np.uint32)),
            kp_valid=np.ones(8, bool), frame_idx=k))
    mp = jm.add_map_points(rng.normal(size=(2, 3)))
    jm.add_observations(0, mp[:1], np.array([0]), np.zeros((1, 2)))
    jm.add_observations(1, mp[:1], np.array([1]), np.zeros((1, 2)))
    jm.add_observations(1, mp[1:], np.array([2]), np.zeros((1, 2)))
    jm.add_observations(2, mp[1:], np.array([3]), np.zeros((1, 2)))
    return convert.map_store(jm, device="cpu"), jm, int(mp[0]), int(mp[1])


def test_merge_points_redirects_and_keeps_invariants():
    m, jm, dst, src = _mini_maps()
    n = m.merge_points(dst, src)
    assert n == jm.merge_points(dst, src) == 1
    assert not m.point_alive()[src]
    kfs, kps = m.observations_of_point(dst)
    assert sorted(kfs.tolist()) == [0, 1, 2]
    # back-pointers: one map point per keypoint, consistent with the table
    assert m.keyframes[2].kp_to_mp[3] == dst
    assert m.keyframes[1].kp_to_mp[2] == -1   # the dropped duplicate
    assert m.num_observations == 3
    for name in convert._MAP_ARRAYS:
        np.testing.assert_array_equal(getattr(m, name)[: m._n_obs if "obs" in name else m._n_pts],
                                      getattr(jm, name)[: jm._n_obs if "obs" in name else jm._n_pts])
    for k in range(3):
        np.testing.assert_array_equal(m.keyframes[k].kp_to_mp, jm.keyframes[k].kp_to_mp)


def _project(K, R, t, X):
    Xc = X @ R.T + t
    return (Xc[:, :2] / Xc[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]


def _ring(pipe, kf_cls, desc, C=12, P=240):
    """``tests/test_loop_closure.py``'s drifted ring in ``pipe``'s map;
    returns (closing keyframe, true poses, duplicate point ids, s_d)."""
    rng = np.random.default_rng(2)
    K = pipe.K
    X_true = rng.normal(size=(P, 3)) * np.array([1.5, 1.0, 1.5])

    def true_pose(i):
        ang = 2 * np.pi * i / C
        c = np.array([5 * np.sin(ang), 0.0, -5 * np.cos(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        return R, -R @ c

    s_d, R_d, t_d = 1.18, so3_exp_np(np.array([0.0, 0.12, 0.0])), np.array([0.35, 0.0, -0.2])

    def drift(X, alpha):
        sa, Ra, ta = loop_closure._interp_sim3(s_d, R_d, t_d, alpha)
        return (sa * (X @ Ra.T)) + ta

    true_poses = [true_pose(i) for i in range(C)]
    anchors = np.repeat(np.arange(C), -(-P // C))[:P]
    mp_ids = pipe.map.add_map_points(np.zeros((P, 3)))
    for i, (R, t) in enumerate(true_poses):
        alpha = i / (C - 1)
        sa, Ra, ta = loop_closure._interp_sim3(s_d, R_d, t_d, alpha)
        Rs = R @ Ra.T
        mine = np.flatnonzero(anchors == i)
        pipe.map._pts[mp_ids[mine]] = drift(X_true[mine], alpha)
        prev = np.flatnonzero(anchors == i - 1) if i else np.array([], int)
        seen = np.concatenate([mine, prev]).astype(int)
        uv = _project(K, R, t, X_true[seen])
        kf = kf_cls(kf_id=pipe.map.new_keyframe_id(), R=Rs, t=sa * t - Rs @ ta,
                    xy=np.zeros((P, 2)), desc=desc, kp_valid=np.zeros(P, bool), frame_idx=i)
        kf.xy[seen] = uv
        kf.kp_valid[seen] = True
        pipe.map.add_keyframe(kf)
        pipe.map.add_observations(kf.kf_id, mp_ids[seen], seen, uv)

    R0, t0 = true_poses[0]
    sa, Ra, ta = loop_closure._interp_sim3(s_d, R_d, t_d, 1.0)
    R_c = R0 @ Ra.T
    first = np.flatnonzero(anchors == 0)
    dup_ids = pipe.map.add_map_points(drift(X_true[first], 1.0))
    uv = _project(K, R0, t0, X_true[first])
    new_kf = kf_cls(kf_id=pipe.map.new_keyframe_id(), R=R_c, t=sa * t0 - R_c @ ta,
                    xy=np.zeros((P, 2)), desc=desc, kp_valid=np.zeros(P, bool), frame_idx=C)
    new_kf.xy[first] = uv
    new_kf.kp_valid[first] = True
    pipe.map.add_keyframe(new_kf)
    pipe.map.add_observations(new_kf.kf_id, dup_ids, first, uv)
    return new_kf, true_poses + [true_poses[0]], dup_ids, s_d


def _config(mod, K, polish):
    return mod.PipelineConfig(
        camera=mod.CameraModel(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                               width=640, height=480),
        keyframe=mod.KeyframeCriteria(), ba=mod.BAConfig(window_size=4),
        consistent_convention=True, loop_closure=True, loop_min_gap=6,
        loop_min_matches=20, loop_min_inliers=10,
        loop_run_global_ba=polish, loop_ba_iters=5)


def _chain_ate(pipe, true_poses):
    est = np.stack([-kf.R.T @ kf.t for kf in pipe.map.keyframes.values()])
    gt = np.stack([-R.T @ t for R, t in true_poses])
    return np.linalg.norm(est - gt, axis=1).mean()


@pytest.mark.parametrize("polish", [False, True], ids=["correction", "with-polish-ba"])
def test_loop_closure_on_drifted_ring_equals_jax(polish):
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1.0]])
    desc = np.random.default_rng(2).integers(0, 2 ** 31, size=(240, 8)).astype(np.uint32)

    jp = JaxPipeline(_config(jcfg, K, polish), log=JaxEventLog(echo=False))
    j_new, true_poses, j_dup, s_d = _ring(jp, JaxKeyframe, jnp.asarray(desc))
    tp = VisualOdometryPipeline(_config(tcfg, K, polish), log=EventLog(echo=False),
                                device="cpu", draws=JaxDraws())
    t_new, _, t_dup, _ = _ring(tp, Keyframe, convert.descriptors(desc, "cpu"))
    assert isinstance(tp.map, Map)

    ate_before = _chain_ate(tp, true_poses)
    j = jlc.try_close_loop(jp, j_new)
    t = loop_closure.try_close_loop(tp, t_new)
    assert j is not None and t is not None, "loop not detected"
    assert t["anchor_kf"] == j["anchor_kf"] == 0
    assert abs(t["scale"] - j["scale"]) <= 1e-4
    assert abs(t["scale"] - 1.0 / s_d) < 0.05
    for key in ("matches", "pnp_inliers", "sim3_inliers", "fused", "added_obs",
                "chain_corrected"):
        assert t[key] == j[key], key
    assert t["fused"] > 0
    assert tp._front_dirty
    np.testing.assert_array_equal(tp.map.point_alive(), jp.map.point_alive())
    assert _chain_ate(tp, true_poses) < 0.35 * ate_before
    assert tp.map.point_alive()[t_dup].sum() < len(t_dup) * 0.3
    if polish:
        tb, jb = t["ba"], j["ba"]
        assert not tb["diverged"] and not jb["diverged"]
        for key in ("iterations", "n_cams", "n_points", "n_obs"):
            assert tb[key] == jb[key], key
        assert tb["iterations"] <= 5 and tb["n_cams"] == 13
        assert tb["initial"] == pytest.approx(jb["initial"], rel=1e-5)
        assert tb["final"] == pytest.approx(jb["final"], rel=1e-2)
        assert tb["final"] < 0.01 * tb["initial"]
    else:
        assert "ba" not in t
        for k in jp.map.sorted_kf_ids():
            np.testing.assert_allclose(tp.map.keyframes[k].R, jp.map.keyframes[k].R,
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(tp.map.keyframes[k].t, jp.map.keyframes[k].t,
                                       rtol=0, atol=1e-4)
        np.testing.assert_allclose(tp.map.points(), jp.map.points(), rtol=0, atol=1e-4)
    ev = [e for e in tp.log.events if e["event"] == "loop_closure"]
    assert len(ev) == 1 and ev[0]["anchor_kf"] == 0


def test_loop_reject_names_the_gate():
    """A keyframe whose descriptors match nothing old: a ``loop_reject``
    event at the ratio-test gate, and no change to the map."""
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1.0]])
    rng = np.random.default_rng(2)
    desc = rng.integers(0, 2 ** 31, size=(240, 8)).astype(np.uint32)
    tp = VisualOdometryPipeline(_config(tcfg, K, False), log=EventLog(echo=False),
                                device="cpu", draws=JaxDraws())
    new_kf, _, _, _ = _ring(tp, Keyframe, convert.descriptors(desc, "cpu"))
    new_kf.desc = convert.descriptors(rng.integers(0, 2 ** 31, size=(240, 8)).astype(np.uint32),
                                      "cpu")
    poses = [(kf.R.copy(), kf.t.copy()) for kf in tp.map.keyframes.values()]
    assert loop_closure.try_close_loop(tp, new_kf) is None
    ev = [e for e in tp.log.events if e["event"] == "loop_reject"]
    assert len(ev) == 1 and ev[0]["stage"] == "ratio_matches" and ev[0]["kf_id"] == new_kf.kf_id
    for (R, t), kf in zip(poses, tp.map.keyframes.values()):
        np.testing.assert_array_equal(kf.R, R)
        np.testing.assert_array_equal(kf.t, t)
