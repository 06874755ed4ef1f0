"""Parity of the port's geometry ops (lie, projection, triangulation,
five-point, RANSAC) with the JAX package, on numpy-made inputs.

Tolerances: float32 algebra within 1e-5 relative (plus an absolute floor
where a value passes near 0); RANSAC on identical uniforms: the same inlier
mask and R, t within 1e-4.  Null vectors (E, DLT) differ in sign between
LAPACK builds, so poses and points are compared, not raw E or P.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.ops import five_point as jfp
from bundle_adjustment_tpu.ops import lie as jlie
from bundle_adjustment_tpu.ops import projection as jproj
from bundle_adjustment_tpu.ops import ransac as jr
from bundle_adjustment_tpu.ops import triangulation as jtri
from bundle_adjustment_tpu_torch.ops import five_point as tfp
from bundle_adjustment_tpu_torch.ops import lie as tlie
from bundle_adjustment_tpu_torch.ops import projection as tproj
from bundle_adjustment_tpu_torch.ops import ransac as tr
from bundle_adjustment_tpu_torch.ops import triangulation as ttri

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)

K = np.array([[912.78, 0, 650.29], [0, 913.03, 362.72], [0, 0, 1.0]], np.float32)


def _proj(R, t, X):
    """The JAX package's pixel projection (uv only) as numpy."""
    return np.asarray(jproj.project(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t),
                                    jnp.asarray(X))[0])


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def _T(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _rvecs(rng, n=64):
    """Generic, tiny and near-pi rotation vectors."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0.01, 3.0, n - 16), rng.uniform(0, 1e-5, 8),
                          np.pi - rng.uniform(1e-4, 1e-2, 8)])
    return (axis * ang[:, None]).astype(np.float32)


def test_so3_exp_hat_and_jacobian_match():
    w = _rvecs(np.random.default_rng(0))
    _close(tlie.so3_hat(_T(w)), jlie.so3_hat(jnp.asarray(w)))
    _close(tlie.so3_exp(_T(w)), jlie.so3_exp(jnp.asarray(w)))
    Rt, dt = tlie.so3_exp_and_jac(_T(w))
    Rj, dj = jlie.so3_exp_and_jac(jnp.asarray(w))
    _close(Rt, Rj)
    _close(dt, dj, atol=1e-5)


def test_so3_log_roundtrip_and_near_pi():
    """so3_log agrees with the JAX one everywhere, near pi included, and
    stays finite; exp(log(R)) == R holds away from pi and near identity.
    Within 1e-2 of pi both packages read the axis off the diagonal of
    (R + I) / 2 in float32 and can lose the relative sign of its components,
    so the round trip is not asserted there (a property of the JAX package
    that the port keeps)."""
    w = _rvecs(np.random.default_rng(1))
    R = jlie.so3_exp(jnp.asarray(w))
    lt = tlie.so3_log(_T(R))
    assert torch.isfinite(lt).all()
    _close(lt, jlie.so3_log(R), rtol=1e-5, atol=1e-6)
    away = np.abs(np.linalg.norm(w, axis=1) - np.pi) > 1e-2
    _close(tlie.so3_exp(lt)[away], np.asarray(R)[away], atol=2e-5)
    _close(tlie.rotation_angle(_T(R)), jlie.rotation_angle(R), rtol=1e-5, atol=1e-6)


def test_pose_helpers_and_numpy_twins_match():
    rng = np.random.default_rng(2)
    R1, R2 = (np.asarray(jlie.so3_exp(jnp.asarray(x))) for x in _rvecs(rng, 32)[:2])
    t1, t2 = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    for a, b in zip(tlie.compose_pose_reference(_T(R1), _T(t1), _T(R2), _T(t2)),
                    jlie.compose_pose_reference(jnp.asarray(R1), jnp.asarray(t1),
                                                jnp.asarray(R2), jnp.asarray(t2))):
        _close(a, b)
    for a, b in zip(tlie.invert_rt(_T(R1), _T(t1)),
                    jlie.invert_rt(jnp.asarray(R1), jnp.asarray(t1))):
        _close(a, b)
    for w in _rvecs(rng, 24).astype(np.float64):
        np.testing.assert_allclose(tlie.so3_exp_np(w), jlie.so3_exp_np(w), atol=1e-12)
        Rw = jlie.so3_exp_np(w)
        np.testing.assert_allclose(tlie.so3_exp_np(tlie.so3_log_np(Rw)), Rw, atol=1e-9)


def _scene(rng, n=200, behind=0):
    X = rng.uniform([-3, -2, 4], [3, 2, 12], size=(n, 3)).astype(np.float32)
    if behind:
        X[:behind, 2] = -X[:behind, 2]
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.05, jnp.float32)))
    t = (rng.normal(size=3) * 0.3).astype(np.float32)
    return X, R, t


def test_projection_functions_match():
    rng = np.random.default_rng(3)
    X, R, t = _scene(rng)
    w = np.asarray(jlie.so3_log(jnp.asarray(R)))
    for a, b in zip(tproj.project(_T(K), _T(R), _T(t), _T(X)),
                    jproj.project(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t),
                                  jnp.asarray(X))):
        _close(a, b)
    for a, b in zip(tproj.project_rvec(_T(K), _T(w), _T(t), _T(X)),
                    jproj.project_rvec(jnp.asarray(K), jnp.asarray(w), jnp.asarray(t),
                                       jnp.asarray(X))):
        _close(a, b, rtol=1e-5, atol=1e-4)   # pixels and depths: 1e-4 absolute
    uv1 = _proj(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X)
    uv2 = _proj(R, t, X)
    uv2 = uv2 + rng.normal(size=uv2.shape).astype(np.float32)
    _close(tproj.pixel_to_normalized(_T(K), _T(uv1)),
           jproj.pixel_to_normalized(jnp.asarray(K), jnp.asarray(uv1)))
    E = np.asarray(jlie.so3_hat(jnp.asarray(t / np.linalg.norm(t)))) @ R
    x1 = np.asarray(jproj.pixel_to_normalized(jnp.asarray(K), jnp.asarray(uv1)))
    x2 = np.asarray(jproj.pixel_to_normalized(jnp.asarray(K), jnp.asarray(uv2)))
    _close(tproj.sampson_distance(_T(E), _T(x1), _T(x2)),
           jproj.sampson_distance(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2)),
           rtol=1e-4, atol=1e-12)
    _close(tproj.epipolar_errors_px(_T(E), _T(K), _T(uv1), _T(uv2)),
           jproj.epipolar_errors_px(jnp.asarray(E), jnp.asarray(K), jnp.asarray(uv1),
                                    jnp.asarray(uv2)), rtol=1e-4, atol=1e-6)


def test_triangulation_matches_and_masks_points_behind():
    rng = np.random.default_rng(4)
    X, R, t = _scene(rng, behind=20)
    uv1 = _proj(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X)
    uv2 = _proj(R, t, X)
    _close(ttri.camera_matrix(_T(K), _T(R), _T(t)),
           jtri.camera_matrix(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t)))
    Xt, vt = ttri.triangulate_pair(_T(K), _T(R), _T(t), _T(uv1), _T(uv2))
    Xj, vj = jtri.triangulate_pair(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t),
                                   jnp.asarray(uv1), jnp.asarray(uv2))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert not vt[:20].any() and vt[20:].all()
    _close(Xt, Xj, rtol=1e-4, atol=1e-4)
    _close(ttri.cheirality_mask(torch.eye(3), torch.zeros(3), _T(R), _T(t), _T(X)),
           jtri.cheirality_mask(jnp.eye(3), jnp.zeros(3), jnp.asarray(R), jnp.asarray(t),
                                jnp.asarray(X)))


def test_zero_baseline_triangulation_has_no_nan():
    rng = np.random.default_rng(5)
    X, _, _ = _scene(rng, n=50)
    uv = _proj(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X)
    Xt, _ = ttri.triangulate_pair(_T(K), torch.eye(3), torch.zeros(3), _T(uv), _T(uv))
    assert torch.isfinite(Xt).all()


def _matches(seed, n=240, n_out=50, noise=0.4):
    rng = np.random.default_rng(seed)
    X, R, t = _scene(rng, n=n)
    t = t / np.linalg.norm(t) * 0.5
    uv1 = _proj(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), X)
    uv2 = _proj(R, t, X)
    uv1 = (uv1 + rng.normal(size=uv1.shape) * noise).astype(np.float32)
    uv2 = (uv2 + rng.normal(size=uv2.shape) * noise).astype(np.float32)
    uv2[:n_out] = rng.uniform([0, 0], [1280, 720], size=(n_out, 2))
    valid = np.ones(n, bool)
    valid[-7:] = False
    quality = rng.integers(0, 60, n).astype(np.float32)
    return X, uv1, uv2, valid, quality, R, t


def test_five_point_candidates_contain_the_true_model():
    """On the same 5 exact correspondences both solvers return valid
    candidates, and each set holds the true E up to sign and scale."""
    X, uv1, uv2, _, _, R, t = _matches(6, n=60, n_out=0, noise=0.0)
    x1 = np.asarray(jproj.pixel_to_normalized(jnp.asarray(K), jnp.asarray(uv1)))[None, 10:15]
    x2 = np.asarray(jproj.pixel_to_normalized(jnp.asarray(K), jnp.asarray(uv2)))[None, 10:15]
    Ej, vj = (np.asarray(a)[0] for a in jfp.five_point_candidates(jnp.asarray(x1), jnp.asarray(x2)))
    Et, vt = (a.numpy()[0] for a in tfp.five_point_candidates(_T(x1), _T(x2)))
    E_true = np.asarray(jlie.so3_hat(jnp.asarray(t))) @ R

    def unit(E):
        E = E / np.linalg.norm(E)
        return E * np.sign(E.ravel()[np.argmax(np.abs(E.ravel()))])

    for Es, v in ((Ej, vj), (Et, vt)):
        assert v.any()
        assert min(np.abs(unit(e) - unit(E_true)).max() for e in Es[v]) < 1e-3


@pytest.mark.parametrize("use_quality", [False, True])
def test_essential_ransac_same_draws(use_quality):
    _, uv1, uv2, valid, quality, _, _ = _matches(7)
    key = jax.random.PRNGKey(3)
    num_hyp = 1024
    u = np.asarray(jax.random.uniform(key, tr.essential_draw_shape(num_hyp)))
    q = quality if use_quality else None
    a = jr.estimate_essential_pose(key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
                                   jnp.asarray(K), num_hyp=num_hyp,
                                   quality=None if q is None else jnp.asarray(q))
    b = tr.estimate_essential_pose(_T(u), _T(uv1), _T(uv2), torch.as_tensor(valid), _T(K),
                                   num_hyp=num_hyp, quality=None if q is None else _T(q))
    np.testing.assert_array_equal(b.inliers.numpy(), np.asarray(a.inliers))
    assert int(b.num_inliers) == int(a.num_inliers) and bool(b.ok) == bool(a.ok)
    _close(b.R, a.R, rtol=0, atol=1e-4)
    _close(b.t, a.t, rtol=0, atol=1e-4)


def test_sample_indices_same_draws():
    _, _, _, valid, quality, _, _ = _matches(8)
    key = jax.random.PRNGKey(9)
    u = np.asarray(jax.random.uniform(key, (64, 5)))
    for q in (None, quality):
        a = jr._sample_indices(key, jnp.asarray(valid), 64, 5,
                               None if q is None else jnp.asarray(q))
        b = tr._sample_indices(_T(u), torch.as_tensor(valid), 64, 5,
                               None if q is None else _T(q))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError):
        tr._sample_indices(_T(u[:, :4]), torch.as_tensor(valid), 64, 5)


def test_pnp_ransac_same_draws():
    rng = np.random.default_rng(10)
    X, R, t = _scene(rng, n=128)
    uv = _proj(R, t, X)
    uv = (uv + rng.normal(size=uv.shape)).astype(np.float32)
    uv[:25] = rng.uniform([0, 0], [1280, 720], size=(25, 2))
    valid = np.arange(128) < 120
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, tr.pnp_draw_shape(128)))
    a = jr.estimate_pnp_pose(key, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                             jnp.asarray(K), num_hyp=128)
    b = tr.estimate_pnp_pose(_T(u), _T(X), _T(uv), torch.as_tensor(valid), _T(K), num_hyp=128)
    np.testing.assert_array_equal(b.inliers.numpy(), np.asarray(a.inliers))
    assert int(b.num_inliers) == int(a.num_inliers) > 80
    _close(b.R, a.R, rtol=0, atol=1e-4)
    _close(b.t, a.t, rtol=0, atol=1e-4)
