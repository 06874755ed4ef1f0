"""``features_source="cv2"`` in the port (OpenCV's ORB on the host in front
of the port's matcher, pose and BA) against the JAX package's feature
injection, on the CPU:

- ``_extract_cv2`` gives the JAX pipeline's keypoints and descriptors
  exactly, on the same frames;
- twenty frames of the JAX package's synthetic render at 320x240 through
  both pipelines in cv2 mode, with the JAX RANSAC draws replayed
  (``JaxDraws``, as ``tests/test_torch_pipeline.py`` runs them): the first
  four frames' decisions are equal, and the port never takes the fused
  tracked-frame step in this mode;
- with cv2 hidden the constructor raises naming cv2.
"""

import dataclasses
import sys

import cv2
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
from bundle_adjustment_tpu_torch.utils.event_log import EventLog
from test_torch_pipeline import JaxDraws, _config

torch.set_num_threads(1)

W, H = 320, 240


def _cv2_config(mod, K):
    return dataclasses.replace(_config(mod, K), features_source="cv2")


@pytest.fixture(scope="module")
def frames():
    frames, K, _, _ = synthetic_sequence(n_frames=20, width=W, height=H, seed=0)
    return frames, K


@pytest.mark.parametrize("i", [0, 7, 19])
def test_extract_cv2_equals_jax(frames, i):
    seq, K = frames
    jp = JaxPipeline(_cv2_config(jcfg, K), log=JaxEventLog(echo=False), use_pallas_matcher=False)
    tp = VisualOdometryPipeline(_cv2_config(tcfg, K), log=EventLog(echo=False), device="cpu")
    gray = cv2.cvtColor(seq[i], cv2.COLOR_BGR2GRAY)
    a, b = jp._extract(gray), tp._extract(gray)
    assert int(np.asarray(a.valid).sum()) > 100
    for name in ("xy", "response", "angle", "size", "level", "valid"):
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(convert.descriptors_to_u32(b.desc), np.asarray(a.desc))


def test_first_decisions_agree_with_jax_in_cv2_mode(frames):
    seq, K = frames
    jp = JaxPipeline(_cv2_config(jcfg, K), log=JaxEventLog(echo=False), use_pallas_matcher=False)
    tp = VisualOdometryPipeline(_cv2_config(tcfg, K), log=EventLog(echo=False), device="cpu",
                                draws=JaxDraws())
    js = [jp.process_frame(f)["status"] for f in seq]
    ts = []
    for f in seq:
        ts.append(tp.process_frame(f)["status"])
        assert not tp._fusable()
    assert js[:4] == ts[:4]
    assert ts[0] == "initialized" and "keyframe" in ts[1:4]
    assert tp.track.replays == 0 and not tp.track.captures
    assert tp.map.num_keyframes >= 3


def test_constructor_raises_naming_cv2_without_it(frames, monkeypatch):
    _, K = frames
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        VisualOdometryPipeline(_cv2_config(tcfg, K), device="cpu")
    # the default features need no cv2
    assert VisualOdometryPipeline(_config(tcfg, K), device="cpu")
    with pytest.raises(ValueError, match="features_source"):
        VisualOdometryPipeline(dataclasses.replace(_config(tcfg, K), features_source="sift"),
                               device="cpu")
