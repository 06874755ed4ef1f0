"""Checkpoint and resume of the port (``utils/checkpoint.py``), on the CPU:
the JAX package's ``tests/test_checkpoint.py`` (which reads recorded images
this repository does not ship) on the port's rendered frames.

* A run interrupted after 4 frames, saved, restored and run on equals the
  straight run exactly: statuses, keyframe ids, poses, points, observations.
* The configuration's fingerprint refuses a changed configuration, unless
  ``strict_config`` is off.
* Two straight runs are equal bit for bit.
* The draws, the loop-closure cooldown and the lost-frame counter
  round-trip, and a restored pipeline refills its tracked-frame state from
  the restored map.

The runs have relocalization, culling and loop closure on.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch.config import BAConfig, CameraModel, KeyframeCriteria, \
    PipelineConfig
from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
from bundle_adjustment_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from bundle_adjustment_tpu_torch.utils.event_log import EventLog
from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_sequence

torch.set_num_threads(1)

W, H = 320, 240
N_FRAMES, SPLIT = 8, 4


def _cfg(K):
    return PipelineConfig(
        camera=CameraModel(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=W, height=H),
        num_features=300, pyramid_levels=3, min_tracked_features=15, pose_inlier_ratio=0.4,
        pose_inlier_numbers=15, consistent_convention=True,
        keyframe=KeyframeCriteria(min_median_displacement_px=12.0),
        ba=BAConfig(window_size=2, max_points=4096, max_obs=16384),
        reloc_enabled=True, cull_enabled=True, cull_min_observations=3,
        loop_closure=True, loop_min_gap=2, loop_cooldown=2)


@pytest.fixture(scope="module")
def seq():
    frames, K, _, _ = synthetic_sequence(n_frames=12, width=W, height=H, fx=300.0, seed=3)
    return frames[:N_FRAMES], K


def _run(pipe, frames):
    return [pipe.process_frame(f)["status"] for f in frames]


def _signature(pipe):
    m = pipe.map
    ids = m.sorted_kf_ids()
    return dict(
        frame_idx=pipe.frame_idx, ids=ids,
        frames=[m.keyframes[k].frame_idx for k in ids],
        poses=np.stack([np.r_[m.keyframes[k].R.ravel(), m.keyframes[k].t] for k in ids]),
        points=m.points().copy(), alive=m.point_alive().copy(),
        obs=np.stack([m._obs_kf[: m._n_obs], m._obs_mp[: m._n_obs], m._obs_kp[: m._n_obs],
                      m._obs_alive[: m._n_obs]]),
        kp_to_mp=np.stack([m.keyframes[k].kp_to_mp for k in ids]),
        last_loop_kf=pipe._last_loop_kf)


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def straight(seq):
    frames, K = seq
    pipe = VisualOdometryPipeline(_cfg(K), log=EventLog(echo=False), device="cpu")
    statuses = _run(pipe, frames)
    assert statuses.count("keyframe") >= 3
    assert any(e["event"] == "cull" for e in pipe.log.events)
    return statuses, _signature(pipe)


def test_resume_equals_straight_run(seq, straight, tmp_path):
    frames, K = seq
    pipe = VisualOdometryPipeline(_cfg(K), log=EventLog(echo=False), device="cpu")
    head = _run(pipe, frames[:SPLIT])
    path = str(tmp_path / "state.npz")
    save_checkpoint(pipe, path)
    restored = load_checkpoint(path, _cfg(K), log=EventLog(echo=False), device="cpu")
    assert restored._front_dirty and restored.frame_idx == SPLIT - 1
    tail = _run(restored, frames[SPLIT:])
    assert head + tail == straight[0]
    _assert_equal(_signature(restored), straight[1])


def test_deterministic_replay(seq, straight):
    frames, K = seq
    pipe = VisualOdometryPipeline(_cfg(K), log=EventLog(echo=False), device="cpu")
    assert _run(pipe, frames) == straight[0]
    _assert_equal(_signature(pipe), straight[1])


def test_config_fingerprint_guard(seq, tmp_path):
    frames, K = seq
    pipe = VisualOdometryPipeline(_cfg(K), log=EventLog(echo=False), device="cpu")
    pipe.process_frame(frames[0])
    path = str(tmp_path / "state.npz")
    save_checkpoint(pipe, path)
    other = dataclasses.replace(_cfg(K), ratio_test=0.5)
    with pytest.raises(ValueError, match="fingerprint"):
        load_checkpoint(path, other, device="cpu")
    # settings that do not change the map's meaning resume
    assert load_checkpoint(path, dataclasses.replace(_cfg(K), output_dir="elsewhere"),
                           device="cpu").map.num_keyframes == 1
    pipe2 = load_checkpoint(path, other, strict_config=False, log=EventLog(echo=False),
                            device="cpu")
    assert pipe2.map.num_keyframes == 1


def test_state_round_trips(seq, tmp_path):
    frames, K = seq
    pipe = VisualOdometryPipeline(_cfg(K), log=EventLog(echo=False), device="cpu")
    _run(pipe, frames[:3])
    pipe._last_loop_kf, pipe._lost_frames = 7, 1
    pipe.draws.next((5, 6))
    path = str(tmp_path / "state.npz")
    save_checkpoint(pipe, path)
    restored = load_checkpoint(path, _cfg(K), device="cpu")
    assert (restored._last_loop_kf, restored._lost_frames) == (7, 1)
    assert restored.draws.seed == pipe.draws.seed
    assert torch.equal(restored.draws.next((9, 6)), pipe.draws.next((9, 6)))
    for k in pipe.map.sorted_kf_ids():
        a, b = pipe.map.keyframes[k], restored.map.keyframes[k]
        assert torch.equal(a.desc, b.desc) and a.frame_idx == b.frame_idx
        np.testing.assert_array_equal(a.xy, b.xy)
        np.testing.assert_array_equal(a.kp_valid, b.kp_valid)
    np.testing.assert_array_equal(restored.map.colors(), pipe.map.colors())
    assert restored.map.next_map_point_id == pipe.map.next_map_point_id
    # the tracked-frame state is refilled from the restored map
    assert restored._front_state is None
    restored._ensure_front_state()
    pipe._front_dirty = True
    pipe._ensure_front_state()
    for a, b in zip(restored.track.state, pipe.track.state):
        assert torch.equal(a, b)
    # a pipeline that draws from something else cannot be saved
    pipe.draws = object()
    with pytest.raises(TypeError, match="Draws"):
        save_checkpoint(pipe, path)
