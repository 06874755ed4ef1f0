"""The slice as a whole: the port's ``VisualOdometryPipeline`` against the JAX
package's on the same synthetic frames, with the JAX RANSAC draws replayed.

Both run ``preset``-style defaults at a small size (10 frames at 320x240,
300 features, 3 levels, ``BAConfig(use_pallas_ba=False)``, window 4) on
the CPU.  The two packages agree bit for bit only up to the first place
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
  ``events.jsonl`` that the port's event log reads back.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import bundle_adjustment_tpu.config as jcfg
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

    def for_frame(self, frame_idx, shape):
        k = jax.random.fold_in(self._dispatch, frame_idx)
        return torch.as_tensor(np.array(jax.random.uniform(k, shape)))


def _config(mod, K):
    return mod.PipelineConfig(
        camera=mod.CameraModel(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                               width=W, height=H),
        num_features=300, pyramid_levels=3,
        ba=mod.BAConfig(use_pallas_ba=False, window_size=4))


def _keyframe_ate(pipe, gt_centres):
    ids = pipe.map.sorted_kf_ids()
    traj = pipe.map.trajectory(pipe.cfg.consistent_convention)
    gt = np.stack([gt_centres[pipe.map.keyframes[k].frame_idx] for k in ids])
    return ate_rmse(traj, gt, with_scale=True), float(np.linalg.norm(gt.max(0) - gt.min(0)))


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
    out = tmp_path_factory.mktemp("port_out")
    summary = tp.finalize(str(out))
    return dict(K=K, gt=gt_centres, jp=jp, tp=tp, js=js, ts=ts, shared=shared,
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
