"""The port's ``parallel/`` on torch.distributed against the JAX package's
``parallel/`` on the conftest's 8-device CPU mesh (as
``tests/test_parallel.py`` and ``tests/test_multiprocess.py`` hold it).

The port's ranks are fresh processes joined by gloo on the CPU
(``parallel.launch.run_ranks``; what each runs is in ``tests/torch_ranks.py``),
every spawn with its own timeout of at most 120 s.  Inputs come from seeded
numpy.  Tolerances:

* ``shard_problem``: exact; the partition and consensus helpers
  (``chordal_mean``, ``fit_sim3``, ``reconcile_windows_sim3``,
  ``partition_windows``): within 1e-10 in float64;
* the sharded BA over 2 and 4 ranks against JAX's ``ba_solve_sharded`` over
  as many devices and against the port's unsharded solve: final cost within
  1e-3 relative, ``rvecs`` atol 1e-4, ``tvecs`` atol 1e-3 (JAX's own bounds);
  the ranks' results bit-equal to each other;
* ``match_sharded`` and ``match_ring``: exact against JAX's (the ring's
  rank 0 sees the blocks in JAX's order; any rank's distances are exact);
* ``solve_windows_consensus`` over (win 2, pt 2) against JAX's on ``mesh24``
  and the pipeline's sharded window solves (``mesh_shape=(1, 2)``) against
  the JAX pipeline's on the same map: the sharded BA's bounds;
* ``run_partitioned_global_ba`` over (win 2, pt 1) on the map of
  ``synthetic_sequence`` frames: bit-equal to each window solved alone plus
  ``reconcile_windows_sim3`` on one rank; against the JAX pipeline's on the
  same map, the final cost within 1e-3 relative, the rotations within 1e-4
  and the translations within 1e-3 relative (atol 1e-3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bundle_adjustment_tpu.config as jcfg
from bundle_adjustment_tpu.models.map_store import Keyframe as JaxKeyframe, Map as JaxMap
from bundle_adjustment_tpu.models.pipeline import VisualOdometryPipeline as JaxPipeline
from bundle_adjustment_tpu.ops import ba as jba, hamming as jhamming
from bundle_adjustment_tpu.parallel import dist_ba as jdist, dist_match as jmatch, \
    mesh as jmesh
from bundle_adjustment_tpu.utils.event_log import EventLog as JaxEventLog
import bundle_adjustment_tpu_torch.config as tcfg
from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
from bundle_adjustment_tpu_torch.ops import ba
from bundle_adjustment_tpu_torch.parallel import dist_ba, mesh as mesh_mod
from bundle_adjustment_tpu_torch.parallel.launch import run_ranks
from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_map, synthetic_sequence

import torch_ranks
from test_ba import make_problem

torch.set_num_threads(1)

SPAWN_TIMEOUT = 120.0
RATIO = 0.8


def _np_problem(p) -> dict:
    return {k: np.asarray(getattr(p, k)) for k in jba.BAProblem._fields}


def _descriptors(rng, n):
    return np.asarray(jhamming.pack_u8_to_u32(jnp.asarray(
        rng.integers(0, 256, size=(n, 32), dtype=np.uint8))))


def _i32(d_u32):
    return d_u32.view(np.int32)


def _window_problems(rng):
    """Two overlapping windows over a 7-camera chain, as
    ``tests/test_parallel.py::test_windows_consensus`` builds them."""
    prob_full, (rv, tv, X) = make_problem(rng, n_cams=7, n_pts=48, noise=0.1, perturb=0.03)
    wins = jdist.partition_windows(7, 2, overlap=1)
    problems = []
    for w in wins:
        keep = np.isin(np.asarray(prob_full.cam_idx), w)
        remap = {int(k): i for i, k in enumerate(dict.fromkeys(w.tolist()))}
        cam_idx = np.array([remap.get(int(c), 0) for c in np.asarray(prob_full.cam_idx)],
                           np.int32)
        problems.append(prob_full._replace(
            rvecs=jnp.asarray(np.asarray(prob_full.rvecs)[list(remap)], jnp.float32),
            tvecs=jnp.asarray(np.asarray(prob_full.tvecs)[list(remap)], jnp.float32),
            cam_idx=jnp.asarray(cam_idx),
            obs_mask=jnp.asarray(np.asarray(prob_full.obs_mask) * keep, jnp.float32)))
    ids = [np.array(list(dict.fromkeys(w.tolist()))) for w in wins]
    return problems, ids


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    prob, _ = make_problem(rng, n_cams=4, n_pts=64, noise=0.2, perturb=0.05)
    d1, d2 = _descriptors(rng, 256), _descriptors(rng, 192)
    v1, v2 = np.ones(256, bool), np.arange(192) < 150
    windows, window_ids = _window_problems(rng)
    return dict(prob=prob, d1=d1, d2=d2, v1=v1, v2=v2, windows=windows,
                window_ids=window_ids)


def _spawn(fn, world, *args, join=True):
    return run_ranks(fn, world, *args, device_type="cpu", timeout=SPAWN_TIMEOUT, join=join)


@pytest.fixture(scope="module")
def ranks(inputs):
    """The 2- and 4-rank results of ``torch_ranks.solve_and_match`` (4 ranks
    also solve the two windows over (win 2, pt 2))."""
    out = {}
    for world in (2, 4):
        windows = None
        if world == 4:
            windows = ([_np_problem(p) for p in inputs["windows"]], inputs["window_ids"])
        out[world] = _spawn(torch_ranks.solve_and_match, world, _np_problem(inputs["prob"]),
                            _i32(inputs["d1"]), _i32(inputs["d2"]), inputs["v1"],
                            inputs["v2"], RATIO, windows)
    return out


def _assert_bounds(cost, rv, tv, cost_ref, rv_ref, tv_ref):
    assert abs(cost - cost_ref) <= 1e-3 * max(cost_ref, 1.0)
    np.testing.assert_allclose(rv, rv_ref, atol=1e-4)
    np.testing.assert_allclose(tv, tv_ref, atol=1e-3)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shard_problem_equals_jax(inputs, n_shards):
    prob = inputs["prob"]
    want = jdist.shard_problem(prob, n_shards, min_obs_capacity=40)
    got = dist_ba.shard_problem(torch_ranks.problem(_np_problem(prob)), n_shards,
                                min_obs_capacity=40)
    for k in jba.BAProblem._fields:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # each shard's slice is the shard's own block
    P_s, O_s = got.points.shape[0] // n_shards, got.uv.shape[0] // n_shards
    for s in range(n_shards):
        part = dist_ba.shard_of(got, n_shards, s)
        assert part.points.shape[0] == P_s and part.uv.shape[0] == O_s
        live = part.obs_mask > 0
        assert bool((part.pnt_idx[live] < P_s).all())


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ba_equals_jax_and_single(inputs, ranks, world):
    prob = inputs["prob"]
    res = ranks[world]
    assert res[0]["shape"] == {"win": 1, "pt": world}
    rv_j, tv_j, _, st_j = jdist.ba_solve_sharded(
        jdist.shard_problem(prob, world), jmesh.make_mesh(1, world), axis="pt", n_fixed=1,
        max_iterations=30)
    rv1, tv1, pt1, st1 = ba.ba_solve_impl(torch_ranks.problem(_np_problem(prob)), n_fixed=1,
                                          max_iterations=30)
    for r in res:
        _assert_bounds(r["cost"], r["rv"], r["tv"], float(st_j.final_cost), np.asarray(rv_j),
                       np.asarray(tv_j))
        _assert_bounds(r["cost"], r["rv"], r["tv"], float(st1.final_cost), rv1.numpy(),
                       tv1.numpy())
    # the points come back in the shard layout, which keeps each at its index
    P = prob.points.shape[0]
    np.testing.assert_allclose(res[0]["pts"][:P], pt1.numpy(), atol=1e-2)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ranks_are_bit_equal(ranks, world):
    res = ranks[world]
    for r in res[1:]:
        assert r["cost"] == res[0]["cost"]
        for k in ("rv", "tv", "pts"):
            np.testing.assert_array_equal(r[k], res[0][k])
        for k in ("sharded", "ring"):
            for a, b in zip(r[k][1:], res[0][k][1:]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_match_sharded_equals_jax(inputs, ranks, world):
    want = jmatch.match_sharded(jnp.asarray(inputs["d1"]), jnp.asarray(inputs["d2"]),
                                jnp.asarray(inputs["v1"]), jnp.asarray(inputs["v2"]),
                                jmesh.make_mesh(1, world), axis="pt", ratio=RATIO)
    for r in ranks[world]:
        for a, b in zip(r["sharded"], want):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("world", [2, 4])
def test_match_ring_equals_jax(inputs, ranks, world):
    d1, d2 = jnp.asarray(inputs["d1"]), jnp.asarray(inputs["d2"])
    want = jmatch.match_ring(d1, d2, jnp.asarray(inputs["v2"]), jmesh.make_mesh(1, world),
                             axis="pt", ratio=RATIO)
    res = ranks[world]
    # rank 0 folds the blocks in the order JAX's device 0 does: all equal
    for a, b in zip(res[0]["ring"], want):
        np.testing.assert_array_equal(a, np.asarray(b))
    # every rank: the same distances and masks; an index at its distance
    d_at = np.asarray(jhamming.hamming_matrix(d1, d2))
    for r in res:
        idx, mask, best = r["ring"]
        np.testing.assert_array_equal(best, np.asarray(want[2]))
        np.testing.assert_array_equal(mask, np.asarray(want[1]))
        np.testing.assert_array_equal(d_at[np.arange(len(idx)), idx], best.astype(int))


def test_windows_consensus_equals_jax(inputs, ranks):
    """(win 2, pt 2) over 4 ranks against JAX's over mesh24."""
    problems, ids = inputs["windows"], inputs["window_ids"]
    poses_j, sim3s_j, (rvs_j, tvs_j, _, st_j) = jdist.solve_windows_consensus(
        [jdist.shard_problem(p, 4) for p in problems], ids, jmesh.make_mesh(2, 4), n_fixed=1,
        max_iterations=25)
    res = ranks[4]
    for r in res:
        poses, sim3s, rvs, tvs, ptss, st = r["consensus"]
        assert set(poses) == set(poses_j) == set(range(7))
        for w in range(2):
            _assert_bounds(float(st["final_cost"][w]), rvs[w], tvs[w],
                           float(np.asarray(st_j.final_cost)[w]), np.asarray(rvs_j)[w],
                           np.asarray(tvs_j)[w])
        for kf in poses:
            np.testing.assert_allclose(poses[kf][0], poses_j[kf][0], atol=1e-4)
            np.testing.assert_allclose(poses[kf][1], poses_j[kf][1], atol=1e-3)
    # every rank ran the same host consensus on the same exchanged bits
    for r in res[1:]:
        for kf in r["consensus"][0]:
            np.testing.assert_array_equal(r["consensus"][0][kf][0], res[0]["consensus"][0][kf][0])
            np.testing.assert_array_equal(r["consensus"][0][kf][1], res[0]["consensus"][0][kf][1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chordal_mean_and_fit_sim3_equal_jax(seed):
    from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np

    r = np.random.default_rng(seed)
    Rs = [so3_exp_np(r.normal(size=3) * 0.3) for _ in range(5)]
    np.testing.assert_allclose(dist_ba.chordal_mean(Rs), jdist.chordal_mean(Rs), atol=1e-10)
    c_dst, c_src = r.normal(size=(4, 3)), r.normal(size=(4, 3)) * 1.7
    for n in (1, 4):
        got = dist_ba.fit_sim3(c_dst[:n], c_src[:n], Rs[:n])
        want = jdist.fit_sim3(c_dst[:n], c_src[:n], Rs[:n])
        assert abs(got[0] - want[0]) <= 1e-10
        np.testing.assert_allclose(got[1], want[1], atol=1e-10)
        np.testing.assert_allclose(got[2], want[2], atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1])
def test_reconcile_windows_sim3_equals_jax(seed):
    r = np.random.default_rng(seed)
    windows = [np.array([0, 1, 2, 3]), np.array([2, 3, 4, 5]), np.array([5, 6, 7, 7])]
    rvs, tvs = r.normal(size=(3, 4, 3)) * 0.2, r.normal(size=(3, 4, 3))
    poses, sim3s = dist_ba.reconcile_windows_sim3(windows, rvs, tvs)
    poses_j, sim3s_j = jdist.reconcile_windows_sim3(windows, rvs, tvs)
    assert set(poses) == set(poses_j)
    for kf in poses:
        np.testing.assert_allclose(poses[kf][0], poses_j[kf][0], atol=1e-10)
        np.testing.assert_allclose(poses[kf][1], poses_j[kf][1], atol=1e-10)
    for a, b in zip(sim3s, sim3s_j):
        assert abs(a[0] - b[0]) <= 1e-10
        np.testing.assert_allclose(a[1], b[1], atol=1e-10)
        np.testing.assert_allclose(a[2], b[2], atol=1e-10)


@pytest.mark.parametrize("n,w,overlap", [(7, 2, 1), (10, 3, 2), (200, 2, 2), (5, 1, 1),
                                         (9, 4, 1)])
def test_partition_windows_equals_jax(n, w, overlap):
    got = dist_ba.partition_windows(n, w, overlap)
    want = jdist.partition_windows(n, w, overlap)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- the pipeline's sharded paths -------------------------------------------

CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)


def _jax_map(arrays: dict):
    """A JAX-package ``Map`` (numpy table) with ``torch_ranks.map_arrays``'s
    copy of a port map (descriptors empty: BA does not read them)."""
    jm = JaxMap(use_native=False)
    for kf in arrays["keyframes"]:
        jm.add_keyframe(JaxKeyframe(desc=jnp.zeros((kf["xy"].shape[0], 8), jnp.uint32), **kf))
    for name, a in arrays["table"].items():
        setattr(jm, name, a.copy())
    jm._n_pts, jm._n_obs, jm.next_keyframe_id, jm.next_map_point_id = arrays["counts"]
    return jm


def _jax_state(jp):
    ids = jp.map.sorted_kf_ids()
    return ids, np.stack([np.concatenate([jp.map.keyframes[k].R.ravel(), jp.map.keyframes[k].t])
                          for k in ids]), jp.map.points().copy()


def test_sharded_window_solves_equal_jax():
    """``mesh_shape=(1, 2)``: a window BA (dense camera system) and the
    global BA over 29 cameras (above ``pcg_min_cameras``: the flat PCG, one
    all_reduce per CG iteration) on a synthetic map, in two gloo ranks,
    against the JAX pipeline's sharded solves on the same map over two CPU
    devices; both ranks bit-equal."""
    map_args = (3, 30, 400)
    cfg = dataclasses.replace(tcfg.PipelineConfig(camera=tcfg.CameraModel(**CAM)),
                              mesh_shape=(1, 2))
    res = _spawn(torch_ranks.sharded_window_solves, 2, cfg, map_args)
    for r in res:
        assert r["mesh"] == {"win": 1, "pt": 2}
        assert [e["event"] for e in r["events"]] == ["ba_complete", "ba_complete"]
    for k in ("after_local", "after_global"):
        assert res[0][k][0] == res[1][k][0]
        np.testing.assert_array_equal(res[0][k][1], res[1][k][1])
        np.testing.assert_array_equal(res[0][k][2], res[1][k][2])

    m, K = synthetic_global_map(*map_args[:1], C=map_args[1], P=map_args[2], device="cpu")
    jc = dataclasses.replace(jcfg.PipelineConfig(camera=jcfg.CameraModel(**CAM)),
                             mesh_shape=(1, 2))
    jp = JaxPipeline(jc, log=JaxEventLog(echo=False), use_pallas_matcher=False)
    jp.map, jp.K = _jax_map(torch_ranks.map_arrays(m)), K
    for run, key in ((jp.run_local_ba, "local"), (jp.run_global_ba, "glob")):
        want = run()
        got = res[0][key]
        assert not got["diverged"] and not want["diverged"]
        assert abs(got["final"] - want["final"]) <= 1e-3 * max(want["final"], 1.0)
        assert got["n_cams"] == want["n_cams"] and got["n_obs"] == want["n_obs"]
        ids, poses, pts = _jax_state(jp)
        ids_t, poses_t, pts_t = res[0]["after_local" if key == "local" else "after_global"]
        assert ids == ids_t
        R = poses[:, :9].reshape(-1, 3, 3)
        R_t = poses_t[:, :9].reshape(-1, 3, 3)
        np.testing.assert_allclose(R_t, R, atol=1e-4)
        np.testing.assert_allclose(poses_t[:, 9:], poses[:, 9:], atol=1e-3)
    assert jp._mesh is not None and jp._mesh.shape == {"win": 1, "pt": 2}


@pytest.fixture(scope="module")
def partitioned():
    """10 frames of ``synthetic_sequence`` through the pipeline in two gloo
    ranks (the configuration of ``tests/test_parallel.py::
    test_partitioned_global_ba`` at 320x240 and 300 features), then
    ``run_partitioned_global_ba`` over (win 2, pt 1)."""
    frames, K, _, _ = synthetic_sequence(n_frames=10, width=320, height=240, fx=300.0, seed=1)

    def config(mod):
        return mod.PipelineConfig(
            camera=mod.CameraModel(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                                   width=320, height=240),
            num_features=300, pyramid_levels=3, ratio_test=0.75, min_tracked_features=15,
            pose_inlier_ratio=0.4, pose_inlier_numbers=15, consistent_convention=True,
            keyframe=mod.KeyframeCriteria(min_median_displacement_px=6.0),
            ba=mod.BAConfig(window_size=4, max_points=2048, max_obs=8192))

    res = _spawn(torch_ranks.frames_then_partitioned, 2, config(tcfg), frames)
    return dict(res=res, K=K, jcfg=config(jcfg))


def test_partitioned_global_ba_equals_windows_alone(partitioned):
    res = partitioned["res"]
    assert res[0]["statuses"] == res[1]["statuses"]
    for k in ("before", "after"):
        assert res[0][k][0] == res[1][k][0]
        np.testing.assert_array_equal(res[0][k][1], res[1][k][1])
        np.testing.assert_array_equal(res[0][k][2], res[1][k][2])
    r0 = res[0]
    assert len(r0["before"][0]) >= 8
    result = r0["result"]
    assert result is not None and not result["diverged"]
    assert result["windows"] == 2 and result["mesh"] == {"win": 2, "pt": 1}
    # pt = 1: no reduction in another order, so the exchanged windows and
    # the consensus are the one-rank reference's bits
    from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np

    poses_ref, _ = r0["ref"]
    ids, after, _ = r0["after"]
    for i, k in enumerate(ids):
        np.testing.assert_array_equal(after[i, :9], so3_exp_np(poses_ref[k][0]).ravel())
        np.testing.assert_array_equal(after[i, 9:], poses_ref[k][1])
    traj = np.stack([-a[:9].reshape(3, 3).T @ a[9:] for a in after])
    assert np.isfinite(traj).all()
    assert (np.linalg.norm(np.diff(traj, axis=0), axis=1) > 1e-9).all()


def test_partitioned_global_ba_equals_jax(partitioned):
    """The JAX pipeline's ``run_partitioned_global_ba`` over a (2, 1) mesh
    on a copy of the port's map as it was before the port's."""
    r0 = partitioned["res"][0]
    jp = JaxPipeline(partitioned["jcfg"], log=JaxEventLog(echo=False), use_pallas_matcher=False)
    jp.map, jp.K = _jax_map(r0["table"]), partitioned["K"]
    want = jp.run_partitioned_global_ba(n_windows=2, mesh=jmesh.make_mesh(2, 1), overlap=2)
    got = r0["result"]
    assert want is not None and not want["diverged"]
    assert abs(got["final"] - want["final"]) <= 1e-3 * max(want["final"], 1.0)
    j_ids, j_poses, _ = _jax_state(jp)
    assert j_ids == r0["after"][0]
    # two LM runs of 50 iterations per window, each stopping at its own
    # ftol: rotations to 1e-4, translations (up to 1.4 here) to 1e-3 relative
    np.testing.assert_allclose(r0["after"][1][:, :9], j_poses[:, :9], atol=1e-4)
    np.testing.assert_allclose(r0["after"][1][:, 9:], j_poses[:, 9:], rtol=1e-3, atol=1e-3)


def test_partitioned_global_ba_with_point_shards():
    """(win 2, pt 2) over 4 ranks against (win 2, pt 1) over 2 on a
    synthetic map whose windows shard unevenly: every window padded to the
    fullest shard (one shape), the sharded BA's bounds between the two, the
    four ranks bit-equal."""
    cfg = dataclasses.replace(tcfg.PipelineConfig(camera=tcfg.CameraModel(**CAM)),
                              ba=tcfg.BAConfig(max_points=512, max_obs=1024))
    map_args = (4, 12, 400)
    four = _spawn(torch_ranks.partitioned_on_a_synthetic_map, 4, cfg, map_args)
    two = _spawn(torch_ranks.partitioned_on_a_synthetic_map, 2, cfg, map_args)
    # 962 and 724 observations in the two windows' fuller shards: both are
    # padded to 962 per shard (the JAX package runs the full BA instead)
    assert four[0]["obs_slots"] == [2 * 962, 2 * 962]
    assert four[0]["result"]["mesh"] == {"win": 2, "pt": 2}
    assert two[0]["result"]["mesh"] == {"win": 2, "pt": 1}
    for r in four[1:]:
        np.testing.assert_array_equal(r["after"][1], four[0]["after"][1])
    a, b = four[0], two[0]
    assert not a["result"]["diverged"]
    assert abs(a["result"]["final"] - b["result"]["final"]) <= 1e-3 * b["result"]["final"]
    np.testing.assert_allclose(a["after"][1][:, :9], b["after"][1][:, :9], atol=1e-4)
    np.testing.assert_allclose(a["after"][1][:, 9:], b["after"][1][:, 9:], atol=1e-3)


def test_mesh_larger_than_world_raises():
    """The JAX pipeline quietly takes the single-device solve when it has
    fewer devices than ``mesh_shape`` asks for; the port raises."""
    cfg = dataclasses.replace(tcfg.PipelineConfig(camera=tcfg.CameraModel(**CAM)),
                              mesh_shape=(1, 2))
    with pytest.raises(ValueError, match="2 ranks; the world has 1"):
        VisualOdometryPipeline(cfg, device="cpu")
    with pytest.raises(ValueError, match="not initialized"):
        mesh_mod.make_mesh(1, 1, "cpu")
    res = _spawn(torch_ranks.build_pipeline, 2,
                 dataclasses.replace(cfg, mesh_shape=(2, 2)))
    assert all("4 ranks; the world has 2" in r for r in res)
