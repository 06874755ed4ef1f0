"""Milestone 1 of the port: the fused tracked-frame step.

Given the same ``FrontendState`` (carried across with ``convert``), the same
image and the same PnP uniforms (the JAX key's own draws), the port's
``track_step`` returns the same packed (34,) scalars and (N, 10) insertion
matrix as the JAX package's:

- integer lanes (counts, flags, match indices, masks) exactly;
- poses (R_pnp, t_pnp, R_rel, t_rel) and the rotation magnitude within 1e-4;
- the two medians (parallax degrees, displacement px) within 1e-4 relative;
- keypoint pixels within 1e-4 px, the speculative triangulation within
  1e-4 relative.

The state is the first frame's keypoints with map points ray-cast into the
synthetic scene's two planes (camera 0 is the world frame): 94 % of the
tracked correspondences reproject within 1 px of the ground truth.

PnP is held to that standard only on frames where its hypotheses are sound
(frames 1 and 3 here).  Its 6-point DLT hypotheses come from a float32 eigh
of a badly conditioned 12x12 normal matrix; on frames 2 and 4-6 no
hypothesis reaches more than a few inliers in either package, the winner and
the 5-step polish from it then depend on last-bit differences, and the two
packages end at different poses (a property of the JAX design, recorded in
ROADMAP.md).  On every frame the lanes that do not depend on PnP agree.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.models import frontend as jfe
from bundle_adjustment_tpu.ops import orb as jorb
from bundle_adjustment_tpu.utils.synthetic import synthetic_sequence
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.models import frontend as tfe
from bundle_adjustment_tpu_torch.ops import ransac as tr

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)

W, H, NF, LEVELS = 320, 240, 300, 3
TRACK_KW = dict(num_features=NF, levels=LEVELS, pyramid_scale=1.2, fast_threshold=20.0,
                height=H, width=W, ratio=0.75, cross_check=False, pnp_iters=128,
                pnp_reproj_px=8.0, sampson_thr_px=3.0)
# the two planes of bundle_adjustment_tpu.utils.synthetic (center, ex, ey, half), near first
PLANES = [(np.array([-1.2, -0.4, 4.5]), np.array([1, 0, 0.15]), np.array([0, 1, 0.0]), 1.8),
          (np.array([0.6, 0.0, 9.0]), np.array([1, 0, 0.0]), np.array([0, 1, 0.0]), 6.0)]


@pytest.fixture(scope="module")
def scene():
    frames, K, _, _ = synthetic_sequence(n_frames=12, width=W, height=H, seed=0)
    grays = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames]
    return grays, K.astype(np.float32)


def _ray_cast(xy, K):
    """World points of pixels seen from camera 0 (identity pose) on the
    nearest plane they hit; (N, 3) and a hit mask."""
    d = np.c_[(xy[:, 0] - K[0, 2]) / K[0, 0], (xy[:, 1] - K[1, 2]) / K[1, 1], np.ones(len(xy))]
    pts = np.zeros((len(xy), 3))
    hit = np.zeros(len(xy), bool)
    for c, ex, ey, half in PLANES[::-1]:           # far first, near overwrites
        n = np.cross(ex, ey)
        lam = (c @ n) / (d @ n)
        X = d * lam[:, None]
        a = (X - c) @ ex / (ex @ ex)
        b = (X - c) @ ey / (ey @ ey)
        on = (lam > 0) & (np.abs(a) <= half) & (np.abs(b) <= half)
        pts[on], hit[on] = X[on], True
    return pts.astype(np.float32), hit


def _state(gray0, K):
    kp = jorb.extract(jnp.asarray(gray0), num_features=NF, levels=LEVELS, scale=1.2,
                      threshold=20.0, height=H, width=W)
    xy = np.asarray(kp.xy)
    pts, hit = _ray_cast(xy, K)
    tracked = np.asarray(kp.valid) & hit
    return jfe.FrontendState(
        desc=kp.desc, xy=kp.xy, kp_valid=kp.valid,
        pts3d=jnp.asarray(np.where(tracked[:, None], pts, 0.0), jnp.float32),
        tracked=jnp.asarray(tracked), rvec=jnp.zeros(3, jnp.float32),
        tvec=jnp.zeros(3, jnp.float32))


def _run_both(gray, state_j, K, frame_idx, consistent):
    key = jax.random.fold_in(jax.random.PRNGKey(1), frame_idx)
    fn = jfe.build_track_fn(NF, LEVELS, 1.2, 20.0, H, W, 0.75, False, False, 128, 8.0,
                            3.0, consistent)
    a = fn(jnp.asarray(gray), state_j, jnp.asarray(K), key)
    u = torch.as_tensor(np.asarray(jax.random.uniform(key, tr.pnp_draw_shape(128))))
    state_t = convert.frontend_state(jax.tree.map(np.asarray, state_j), device="cpu")
    b = tfe.track_step(torch.as_tensor(gray), state_t, torch.as_tensor(K), u,
                       consistent=consistent, **TRACK_KW)
    return a, b


@pytest.mark.parametrize("frame,consistent", [(1, False), (3, False), (3, True)])
def test_track_step_matches_jax(scene, frame, consistent):
    grays, K = scene
    a, b = _run_both(grays[frame], _state(grays[0], K), K, frame, consistent)
    pa, pb = np.asarray(a.packed, np.float64), b.packed.numpy().astype(np.float64)
    assert pa.shape == pb.shape == (34,)
    ints = [0, 1, 2, 3, 4, 6, 9]
    np.testing.assert_array_equal(pb[ints], pa[ints])
    assert pa[2] == 1 and pa[3] > 50, "PnP must succeed on this state"
    np.testing.assert_allclose(pb[[7, 8]], pa[[7, 8]], rtol=1e-4, atol=0)
    np.testing.assert_allclose(pb[5], pa[5], rtol=0, atol=1e-4)
    np.testing.assert_allclose(pb[10:34], pa[10:34], rtol=0, atol=1e-4)

    ia, ib = np.asarray(a.insert_packed, np.float64), b.insert_packed.numpy().astype(np.float64)
    assert ia.shape == ib.shape == (NF, 10)
    for col in (1, 2, 6, 9):
        np.testing.assert_array_equal(ib[:, col], ia[:, col])
    m = ia[:, 1] > 0.5
    np.testing.assert_array_equal(ib[m, 0], ia[m, 0])
    np.testing.assert_allclose(ib[:, 7:9], ia[:, 7:9], rtol=0, atol=1e-4)
    tri = ia[:, 6] > 0.5
    np.testing.assert_allclose(ib[tri, 3:6], ia[tri, 3:6], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(b.match_mask.numpy(), np.asarray(a.match_mask))
    np.testing.assert_array_equal(b.match_dist.numpy(), np.asarray(a.match_dist))

    sa, sb = jfe.unpack_scalars(a.packed), tfe.unpack_scalars(b.packed)
    assert (sa.n_matches, sa.num_inliers, sa.pnp_ok) == (sb.n_matches, sb.num_inliers, sb.pnp_ok)


@pytest.mark.parametrize("frame", [2, 4, 5, 6])
def test_track_step_match_lanes_match_jax(scene, frame):
    """Matching, keypoints and the counts before PnP agree on every frame."""
    grays, K = scene
    a, b = _run_both(grays[frame], _state(grays[0], K), K, frame, False)
    pa, pb = np.asarray(a.packed, np.float64), b.packed.numpy().astype(np.float64)
    np.testing.assert_array_equal(pb[[0, 1, 9]], pa[[0, 1, 9]])
    ia, ib = np.asarray(a.insert_packed, np.float64), b.insert_packed.numpy().astype(np.float64)
    np.testing.assert_array_equal(ib[:, [1, 9]], ia[:, [1, 9]])
    np.testing.assert_allclose(ib[:, 7:9], ia[:, 7:9], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(b.match_dist.numpy(), np.asarray(a.match_dist))


def test_covis_step_matches_jax(scene):
    grays, K = scene
    banks = [_state(grays[0], K), _state(grays[1], K)]
    new = jorb.extract(jnp.asarray(grays[2]), num_features=NF, levels=LEVELS, scale=1.2,
                       threshold=20.0, height=H, width=W)
    R_new = np.asarray(jax.numpy.eye(3), np.float32)
    t_new = np.array([-0.05, 0.0, -0.01], np.float32)
    args_j = (jnp.stack([s.desc for s in banks]), jnp.stack([s.kp_valid for s in banks]),
              jnp.stack([s.pts3d for s in banks]), jnp.stack([s.tracked for s in banks]),
              new.desc, new.valid, new.xy, jnp.asarray(R_new), jnp.asarray(t_new),
              jnp.asarray(K))
    a = np.asarray(jfe.build_covis_fn(0.75, False, False, 30.0)(*args_j))
    args_t = [torch.as_tensor(np.asarray(x)) for x in args_j]
    args_t[0] = convert.descriptors(np.asarray(args_j[0]), "cpu")
    args_t[4] = convert.descriptors(np.asarray(args_j[4]), "cpu")
    b = tfe.covis_step(*args_t, ratio=0.75, cross_check=False, reproj_px=30.0).numpy()
    assert a.shape == b.shape == (2, NF, 2)
    np.testing.assert_array_equal(b[..., 1], a[..., 1])
    ok = a[..., 1] > 0.5
    assert ok.sum() > 20
    np.testing.assert_array_equal(b[..., 0][ok], a[..., 0][ok])


def test_make_state_matches_jax(scene):
    """make_state of the same host keyframe gives the same mirror."""
    grays, K = scene
    st = jax.tree.map(np.asarray, _state(grays[0], K))
    kp_to_mp = np.where(st.tracked, np.cumsum(st.tracked) - 1, -1)
    points = st.pts3d[st.tracked].astype(np.float64)

    class KF:
        desc, xy, kp_valid = st.desc, st.xy, st.kp_valid
        R, t = np.eye(3), np.zeros(3)

    KF.kp_to_mp = kp_to_mp
    a = jax.tree.map(np.asarray, jfe.make_state(KF, points, NF))
    KF.desc = convert.descriptors(st.desc, "cpu")
    b = tfe.make_state(KF, points, NF, device="cpu")
    np.testing.assert_array_equal(convert.descriptors_to_u32(b.desc), a.desc)
    for name in ("xy", "kp_valid", "pts3d", "tracked", "rvec", "tvec"):
        np.testing.assert_array_equal(getattr(b, name).numpy(), getattr(a, name))
