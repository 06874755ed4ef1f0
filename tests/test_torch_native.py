"""The port's host runtime (``native.py``, ``csrc/ba_host.cpp``) against the
numpy paths and the JAX package's ``native.py``, as ``tests/test_native.py``
holds the JAX one:

* the C++ mirror of the observation table (``Map(use_native=True)``, the
  default) against ``Map(use_native=False)`` and the JAX package's native
  map through appends, culls, ``merge_points``, kills and a checkpoint
  restore: equal rows, problems and map-point ids for every window, equal
  row contents, live counts and per-point counts (exact);
* a repeat-padded window (the partitioned BA's) reads each row once;
* ``voxel_downsample_native`` against the JAX package's (the same C++: the
  same voxels in the same order, exact) and ``utils.io.voxel_downsample``
  against the JAX package's (exact) and against the C++ one (the same
  voxel set once sorted, within 1e-12);
* ``finalize`` with ``export_voxel`` writes the voxelized cloud;
* a source that g++ refuses raises with the compiler's output.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu import native as jnative
from bundle_adjustment_tpu.models.map_store import Keyframe as JaxKeyframe, Map as JaxMap
from bundle_adjustment_tpu.utils import io as jio
from bundle_adjustment_tpu_torch import native
from bundle_adjustment_tpu_torch.config import CameraModel, PipelineConfig
from bundle_adjustment_tpu_torch.models.map_store import Keyframe, Map
from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
from bundle_adjustment_tpu_torch.utils import io
from bundle_adjustment_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from bundle_adjustment_tpu_torch.utils.event_log import EventLog
from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_map

torch.set_num_threads(1)

K = np.array([[450.0, 0, 320], [0, 450.0, 240], [0, 0, 1.0]])
CAM = CameraModel(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
N_KF, N_PT, N_SEEN = 6, 60, 25


def _fill(maps, rng):
    """The same keyframes, points and observations into every map."""
    pts = rng.normal(size=(N_PT, 3)) + [0, 0, 8]
    sels = [rng.permutation(N_PT)[:N_SEEN] for _ in range(N_KF)]
    uvs = [rng.uniform(0, 640, size=(N_SEEN, 2)) for _ in range(N_KF)]
    for m in maps:
        jax_map = isinstance(m, JaxMap)
        for k in range(N_KF):
            kf_cls = JaxKeyframe if jax_map else Keyframe
            desc = jnp.zeros((64, 8), jnp.uint32) if jax_map else torch.zeros(
                (64, 8), dtype=torch.int32)
            m.add_keyframe(kf_cls(kf_id=k, R=np.eye(3), t=np.zeros(3), xy=np.zeros((64, 2)),
                                  desc=desc, kp_valid=np.ones(64, bool), frame_idx=k))
        ids = m.add_map_points(pts)
        for k in range(N_KF):
            m.add_observations(k, ids[sels[k]], np.arange(N_SEEN), uvs[k])
    return ids


WINDOWS = ([0, 1], [1, 2, 3], [4], [0, 1, 2, 3, 4, 5], [5], [2, 4])


def _assert_same_windows(ref: Map, others):
    """Every window gathers the same rows, problem and map-point ids."""
    for window in WINDOWS:
        want = ref.gather_window(window, K, 256, 1024)
        for m in others:
            got = m.gather_window(window, K, 256, 1024)
            assert (got is None) == (want is None), window
            if want is None:
                continue
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_array_equal(got[1], want[1])
            for k in want[0]._fields:
                np.testing.assert_array_equal(np.asarray(getattr(got[0], k)),
                                              np.asarray(getattr(want[0], k)), err_msg=k)


def _assert_mirror_is_the_table(m: Map):
    n = m._n_obs
    assert len(m._native) == n
    assert m._native.live_count() == m.num_observations
    kf, mp, kp, uv = m._native.fetch(np.arange(n))
    np.testing.assert_array_equal(kf, m._obs_kf[:n])
    np.testing.assert_array_equal(mp, m._obs_mp[:n])
    np.testing.assert_array_equal(kp, m._obs_kp[:n])
    np.testing.assert_array_equal(uv, m._obs_uv[:n])
    np.testing.assert_array_equal(m._native.counts_per_point(m._n_pts),
                                  m.observation_count_per_point())


def test_mirror_follows_the_table_and_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    mirrored, plain = Map(device="cpu"), Map(device="cpu", use_native=False)
    jmap = JaxMap(use_native=True)
    assert mirrored._native is not None and plain._native is None
    assert jmap._native is not None, "the JAX package's native library did not load"
    maps = (mirrored, plain, jmap)
    ids = _fill(maps, rng)
    _assert_same_windows(plain, (mirrored, jmap))
    _assert_mirror_is_the_table(mirrored)

    for m in maps:
        m.cull_points(ids[:5])
    _assert_same_windows(plain, (mirrored, jmap))
    # a fusion: the port's merge_points kills src's rows itself, not by
    # cull_points as the JAX package does
    for dst, src in ((ids[10], ids[11]), (ids[12], ids[30]), (ids[6], ids[7])):
        moved = [m.merge_points(int(dst), int(src)) for m in maps]
        assert moved[0] == moved[1] == moved[2]
    _assert_same_windows(plain, (mirrored, jmap))
    rows = plain.gather_window([0, 1, 2], K, 256, 1024)[2]
    for m in maps:
        m.kill_observations(rows[::4])
    _assert_same_windows(plain, (mirrored, jmap))
    _assert_mirror_is_the_table(mirrored)

    # a checkpoint restore sets the arrays directly and refills the mirror
    cfg = PipelineConfig(camera=CAM)
    pipe = VisualOdometryPipeline(cfg, device="cpu")
    pipe.map = mirrored
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(pipe, path)
    restored = load_checkpoint(path, cfg, device="cpu").map
    assert restored._native is not None
    _assert_mirror_is_the_table(restored)
    _assert_same_windows(plain, (restored,))


def test_repeat_padded_window_reads_each_row_once():
    """``run_partitioned_global_ba`` pads a window by repeating its last
    keyframe: the mirror is asked for each keyframe once, so the rows equal
    the numpy table's (the JAX package's native gather, asked for the
    padded list, returns that keyframe's rows twice)."""
    rng = np.random.default_rng(1)
    mirrored, plain, jmap = Map(device="cpu"), Map(device="cpu", use_native=False), \
        JaxMap(use_native=True)
    _fill((mirrored, plain, jmap), rng)
    padded = [1, 2, 3, 3, 3]
    got = mirrored.gather_window(padded, K, 256, 1024)
    want = plain.gather_window(padded, K, 256, 1024)
    np.testing.assert_array_equal(got[2], want[2])
    assert len(np.unique(got[2])) == len(got[2])
    jrows = jmap.gather_window(padded, K, 256, 1024)[2]
    assert len(jrows) == len(want[2]) + 2 * N_SEEN


@pytest.mark.parametrize("with_colors", [True, False])
def test_voxel_downsample_equals_jax(with_colors):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2000, 3)) * 3
    cols = rng.uniform(size=(2000, 3)) if with_colors else None
    p_n, c_n = native.voxel_downsample_native(pts, cols, 0.7)
    p_j, c_j = jnative.voxel_downsample_native(pts, cols, 0.7)
    np.testing.assert_array_equal(p_n, p_j)
    p_np, c_np = io.voxel_downsample(pts, cols, 0.7)
    p_jnp, c_jnp = jio.voxel_downsample(pts, cols, 0.7)
    np.testing.assert_array_equal(p_np, p_jnp)
    assert len(p_n) == len(p_np) < len(pts)
    o1, o2 = np.lexsort(p_n.T), np.lexsort(p_np.T)
    np.testing.assert_allclose(p_n[o1], p_np[o2], rtol=0, atol=1e-12)
    if with_colors:
        np.testing.assert_array_equal(c_n, c_j)
        np.testing.assert_array_equal(c_np, c_jnp)
        np.testing.assert_allclose(c_n[o1], c_np[o2], rtol=0, atol=1e-12)
    else:
        assert c_n is None and c_np is None


def test_finalize_exports_the_voxelized_cloud(tmp_path):
    cfg = dataclasses.replace(PipelineConfig(camera=CAM), export_voxel=0.5, final_full_ba=False)
    pipe = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device="cpu")
    pipe.map, pipe.K = synthetic_global_map(0, C=6, P=300, device="cpu")
    pipe.map.log = pipe.log
    pipe.finalize(str(tmp_path))
    pts, colors = pipe.map.get_pcd()
    want, _ = jnative.voxel_downsample_native(pts, colors, 0.5)
    got, _ = io.read_pcd(str(tmp_path / "final_map_global_ba.pcd"))
    assert len(want) < len(pts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)   # float32 on disk


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "ba_host.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "libba_host.so")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()
    assert not os.path.exists(tmp_path / "build" / "libba_host.so")
