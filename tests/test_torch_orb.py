"""Parity of the port's ORB extraction (``bundle_adjustment_tpu_torch.ops.orb``
and the K2 wrapper ``ops.orb_kernel``) with the JAX package.

Tolerances:
- patch gather: exact against the JAX ``dynamic_slice`` path (both copy
  float32 pixels); within 0.25 against the Pallas kernel in interpret mode,
  whose one-hot selection passes round through bf16 (orb_pallas.py:81-85);
- dense maps (blur, FAST, Harris, NMS, moments): exact, since the port
  reproduces XLA's order of additions;
- the antialiased bilinear resize: within 3e-4 on a 0..255 image (about
  1e-6 relative).  XLA's CPU dot sums in an order the port does not
  reproduce; a float64 product lands just as far from it;
- ``extract`` on rendered 320x240 frames: the valid keypoints are the same
  set (xy within 1e-4 px).  The resize's last-bit differences can swap two
  keypoints of near-equal response, so slots are paired by position before
  levels, angles (1e-4 rad, from the resized levels) and descriptor bits
  are compared; the bits agree on >= 99.9 % (the 2-bin steering sum
  ``sel > 0`` may flip where it is within rounding of 0);
- the rBRIEF pattern and the pattern matrix: bit-equal.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.ops import brief_pattern as jbp
from bundle_adjustment_tpu.ops import orb as jorb
from bundle_adjustment_tpu.ops import orb_pallas
from bundle_adjustment_tpu.utils.synthetic import synthetic_sequence
from bundle_adjustment_tpu_torch.ops import brief_pattern as tbp
from bundle_adjustment_tpu_torch.ops import orb as torb
from bundle_adjustment_tpu_torch.ops import orb_kernel

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gray_frames():
    frames, _, _, _ = synthetic_sequence(n_frames=6, width=320, height=240, seed=0)
    return [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames]


def _gather_case(H=96, W=160, B=150, seed=3):
    rng = np.random.default_rng(seed)
    img = (rng.random((H, W)) * 255).astype(np.float32)
    sy = rng.integers(0, H - 37 + 1, B).astype(np.int32)
    sx = rng.integers(0, W - 37 + 1, B).astype(np.int32)
    sy[:20] = H - 37            # rows 37..39 of the window fall off the image
    sx[10:30] = W - 37
    sy[30:40] = 0
    sx[30:40] = 0
    return img, sy, sx


def _dynamic_slice_patches(img, sy, sx):
    p = jnp.pad(jnp.asarray(img), ((0, 3), (0, 3)))
    out = jax.vmap(lambda y, x: jax.lax.dynamic_slice(p, (y, x), (40, 40)))(
        jnp.asarray(sy), jnp.asarray(sx))
    return np.asarray(out - 128.0)


def test_patch_gather_exact_against_dynamic_slice():
    img, sy, sx = _gather_case()
    out = torb._extract_patches(torch.as_tensor(img), torch.as_tensor(sy),
                                torch.as_tensor(sx)).numpy()
    np.testing.assert_array_equal(out, _dynamic_slice_patches(img, sy, sx))
    assert (out[:20, 37:, :] == -128.0).all()   # past the bottom edge


def test_patch_gather_against_pallas_interpret():
    img, sy, sx = _gather_case(B=64)
    ref = np.asarray(orb_pallas.gather_patches40(
        jnp.asarray(img), jnp.asarray(sy), jnp.asarray(sx), interpret=True))
    out = orb_kernel.gather_patches40(torch.as_tensor(img), torch.as_tensor(sy),
                                      torch.as_tensor(sx)).numpy()
    valid = np.s_[:, :37, :37]   # the rows/columns the descriptor reads
    assert np.abs(out[valid] - ref[valid]).max() <= 0.25


def test_gather_wrapper_checks_its_inputs():
    img = torch.zeros((64, 64))
    s = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        orb_kernel.gather_patches40(img.double(), s, s)
    with pytest.raises(ValueError):
        orb_kernel.gather_patches40(img, s.long(), s)
    with pytest.raises(ValueError):
        orb_kernel.gather_patches40(img, s, s[:2])


def test_brief_pattern_and_pattern_matrix_bit_equal():
    np.testing.assert_array_equal(tbp.PATTERN, jbp.PATTERN)
    assert tbp.PATTERN.dtype == jbp.PATTERN.dtype
    np.testing.assert_array_equal(torb._pattern_matrix(), jorb._PATTERN_MATRIX)


def test_level_budgets_match():
    for args in [(6400, 8, 1.2), (480, 3, 1.2), (2400, 4, 1.3)]:
        assert torb.level_budgets(*args) == jorb.level_budgets(*args)
    assert torb.level_budgets(6400, 8, 1.2)[0] == 2067


@pytest.mark.parametrize("name", ["gaussian_blur", "fast_score_map",
                                  "harris_response", "nms3", "moment_maps",
                                  "resize"])
def test_dense_maps_match(gray_frames, name):
    img = gray_frames[0][:120, :200].astype(np.float32)
    j, t = jnp.asarray(img), torch.as_tensor(img)
    if name == "gaussian_blur":
        pairs = [(jorb.gaussian_blur(j), torb.gaussian_blur(t))]
    elif name == "fast_score_map":
        pairs = [(jorb.fast_score_map(j, 20.0), torb.fast_score_map(t, 20.0))]
    elif name == "harris_response":
        pairs = [(jorb.harris_response(j), torb.harris_response(t))]
    elif name == "nms3":
        pairs = [(jorb._nms3(jorb.fast_score_map(j, 20.0)),
                  torb._nms3(torb.fast_score_map(t, 20.0)))]
    elif name == "moment_maps":
        pairs = list(zip(jorb._moment_maps(j), torb._moment_maps(t)))
    else:
        pairs = [(jax.image.resize(j, (100, 167), "bilinear"),
                  torb.resize_bilinear(t, (100, 167))),
                 (jax.image.resize(j, (83, 139), "bilinear"),
                  torb.resize_bilinear(t, (83, 139)))]
    for a, b in pairs:
        if name == "resize":
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=3e-4)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _pair_by_position(xy_a, xy_b):
    """For each keypoint of a, the index of the nearest keypoint of b, and
    that distance."""
    d = np.linalg.norm(xy_a[:, None, :] - xy_b[None, :, :], axis=-1)
    j = d.argmin(axis=1)
    return j, d[np.arange(len(j)), j]


def test_extract_matches_jax(gray_frames):
    kw = dict(num_features=300, levels=3, scale=1.2, threshold=20.0,
              height=240, width=320)
    agree = total = 0
    for g in gray_frames:
        a = jorb.extract(jnp.asarray(g), **kw)
        b = torb.extract(torch.as_tensor(g), **kw)
        av, bv = np.asarray(a.valid), b.valid.numpy()
        assert av.sum() > 200
        assert av.sum() == bv.sum()
        xa, xb = np.asarray(a.xy)[av], b.xy.numpy()[bv]
        j, dist = _pair_by_position(xa, xb)
        assert dist.max() <= 1e-4
        assert len(set(j.tolist())) == len(j)          # the same set
        np.testing.assert_array_equal(b.level.numpy()[bv][j], np.asarray(a.level)[av])
        np.testing.assert_allclose(b.angle.numpy()[bv][j], np.asarray(a.angle)[av],
                                   atol=1e-4, rtol=0)
        da = np.asarray(a.desc).view(np.uint8)[av]
        db = b.desc.numpy().view(np.uint8)[bv][j]
        bits_a, bits_b = np.unpackbits(da, axis=1), np.unpackbits(db, axis=1)
        agree += int((bits_a == bits_b).sum())
        total += bits_a.size
    assert agree / total >= 0.999, f"descriptor bit agreement {agree / total:.5f}"

