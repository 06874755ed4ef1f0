"""Parity of the port's bundle adjustment (``ops.ba`` flat Schur-LM and
``ops.ba_grid`` window solver) with the JAX package on one synthetic window.

Tolerances, as the JAX package's own BA tests hold its solvers: the initial
cost within 1e-5 relative, the final cost within 1 %, the iteration count
within 1.  The grid layout built by ``from_flat`` is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.ops import ba as jba
from bundle_adjustment_tpu.ops import ba_grid as jbg
from bundle_adjustment_tpu.ops.lie import so3_exp_np
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.ops import ba as tba
from bundle_adjustment_tpu_torch.ops import ba_grid as tbg

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)

K = np.array([[300, 0, 160], [0, 300, 120], [0, 0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def window():
    """5 cameras, 120 points seen with probability 0.8, 0.5 px noise, a
    perturbed start; padded to 256 points and 1024 observations as the
    pipeline's gather_window pads."""
    rng = np.random.default_rng(0)
    C, P, Pp, O = 5, 120, 256, 1024
    pts = np.c_[rng.uniform(-2, 2, (P, 2)), rng.uniform(4, 8, P)]
    rv = np.c_[np.zeros(C), np.linspace(0, -0.1, C), np.zeros(C)]
    tv = np.stack([-so3_exp_np(rv[i]) @ np.array([0.3 * i, 0.05 * i, 0.1 * i]) for i in range(C)])
    ci, pi, uv = [], [], []
    for c in range(C):
        Xc = pts @ so3_exp_np(rv[c]).T + tv[c]
        proj = Xc[:, :2] / Xc[:, 2:] * 300 + [160, 120]
        for p in range(P):
            if rng.random() < 0.8:
                ci.append(c)
                pi.append(p)
                uv.append(proj[p] + rng.normal(0, 0.5, 2))
    n = len(ci)
    cia, pia = np.zeros(O, np.int32), np.zeros(O, np.int32)
    uva, om = np.zeros((O, 2), np.float32), np.zeros(O, np.float32)
    cia[:n], pia[:n], uva[:n], om[:n] = ci, pi, uv, 1
    ptsp = np.zeros((Pp, 3), np.float32)
    ptsp[:P] = pts + rng.normal(0, 0.05, (P, 3))
    pm = np.zeros(Pp, bool)
    pm[:P] = True
    rvn = (rv + rng.normal(0, 0.01, rv.shape)).astype(np.float32)
    tvn = (tv + rng.normal(0, 0.02, tv.shape)).astype(np.float32)
    return jba.BAProblem(*(jnp.asarray(x) for x in (rvn, tvn, ptsp, cia, pia, uva, om, pm, K)))


def _port(problem_j):
    return convert.ba_problem(jax.tree.map(np.asarray, problem_j), device="cpu")


def _same_result(a, b):
    sa, sb = a[3], b[3]
    np.testing.assert_allclose(float(sb.initial_cost), float(sa.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(sb.final_cost), float(sa.final_cost), rtol=1e-2)
    np.testing.assert_allclose(float(sb.final_sq), float(sa.final_sq), rtol=1e-2)
    assert abs(int(sb.iterations) - int(sa.iterations)) <= 1
    assert bool(sb.accepted) == bool(sa.accepted)
    assert float(sa.final_cost) < 0.9 * float(sa.initial_cost)


@pytest.mark.parametrize("motion_only", [False, True])
def test_flat_ba_solve_matches(window, motion_only):
    pj, pt = window, _port(window)
    n_fixed = 2
    if motion_only:            # the pipeline's pose refine: every point fixed
        pj = pj._replace(point_mask=jnp.zeros_like(pj.point_mask))
        pt = pt._replace(point_mask=torch.zeros_like(pt.point_mask))
        n_fixed = 0
    a = jba.ba_solve(pj, n_fixed=n_fixed, max_iterations=50)
    b = tba.ba_solve(pt, n_fixed=n_fixed, max_iterations=50)
    _same_result(a, b)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), atol=1e-3)
    np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), atol=1e-3)


def test_grid_ba_solve_matches(window):
    ga = jbg.from_flat(window)
    gb = tbg.from_flat(_port(window))
    for name in ("cam_slot", "mask", "uv", "point_mask"):
        np.testing.assert_array_equal(getattr(gb, name).numpy(), np.asarray(getattr(ga, name)))
    a = jbg.ba_solve_grid(ga, n_fixed=2)
    b = tbg.ba_solve_grid_impl(convert.ba_problem_grid(jax.tree.map(np.asarray, ga), "cpu"),
                               n_fixed=2)
    _same_result(a, b)
    np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), atol=1e-2)


def test_residuals_and_robust_cost_match(window):
    pj, pt = window, _port(window)
    rj = jba._residuals(pj.rvecs, pj.tvecs, pj.points, pj)
    rt = tba._residuals(pt.rvecs, pt.tvecs, pt.points, pt)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(tba.robust_cost(rt, 1.0)),
                               float(jba.robust_cost(rj, 1.0)), rtol=1e-5)
    np.testing.assert_allclose(tba._huber_weights(rt, 1.0).numpy(),
                               np.asarray(jba._huber_weights(rj, 1.0)), rtol=2e-5)
    M = np.random.default_rng(1).normal(size=(7, 3, 3)).astype(np.float32)
    M = M @ np.swapaxes(M, 1, 2) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tba._inv3(torch.as_tensor(M)).numpy(),
                               np.asarray(jba._inv3(jnp.asarray(M))), rtol=1e-5, atol=1e-6)


def test_inv3_of_an_overflowing_block_matches_the_jitted_solve():
    """A point a hair from a camera centre: its V block (~1e13) overflows the
    float32 determinant.  The JAX package's solve runs jitted and freezes the
    point (inverse 0); the port must not turn the block into NaNs."""
    V = np.array([[[2.6654e13, -5.0177e10, 4.2991e12],
                   [-5.0177e10, 2.5534e13, 5.0427e12],
                   [4.2991e12, 5.0427e12, 1.6925e12]]], np.float32)
    ref = np.asarray(jax.jit(jba._inv3)(jnp.asarray(V)))
    out = tba._inv3(torch.as_tensor(V)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, ref)


def test_unported_solver_options_raise(window):
    """The PCG camera solve (``cg_iters > 0``) is ported: it lands on the
    dense solve's optimum (final cost within 2 %, as the JAX package's
    ``test_pcg_matches_dense_window``).  So is the sharded solver's hook: a
    process group in place of ``axis_name`` (``parallel/dist_ba``,
    ``tests/test_torch_parallel.py``); with none the solve is the
    single-rank one, bit for bit, and ``axis_name`` is no argument of it."""
    pt = _port(window)
    dense = tba.ba_solve(pt, n_fixed=1, max_iterations=30)
    pcg = tba.ba_solve(pt, n_fixed=1, max_iterations=30, cg_iters=200, cg_tol=1e-8)
    assert float(pcg[3].final_cost) <= 1.02 * float(dense[3].final_cost)
    assert float(pcg[3].final_cost) < 0.9 * float(pcg[3].initial_cost)
    grid = tbg.from_flat(pt)
    pcg = tbg.ba_solve_grid(grid, n_fixed=1, max_iterations=30, cg_iters=200, cg_tol=1e-8,
                            cg_forcing=False)
    assert float(pcg[3].final_cost) <= 1.02 * float(dense[3].final_cost)
    grouped = tba.ba_solve(pt, n_fixed=1, max_iterations=30, group=None)
    for a, b in zip(dense[:3], grouped[:3]):
        assert torch.equal(a, b)
    assert float(grouped[3].final_cost) == float(dense[3].final_cost)
    with pytest.raises(TypeError, match="axis_name"):
        tba.ba_solve(pt, n_fixed=1, axis_name="x")


def _refine_problem(window, cam):
    """The pipeline's pose refine of camera ``cam`` of the window: that
    camera's observations alone, every point fixed, ``n_fixed`` 0."""
    p = jax.tree.map(np.asarray, window)
    keep = (p.cam_idx == cam) & (p.obs_mask > 0)
    O = p.uv.shape[0]
    ci, pi = np.zeros(O, np.int32), np.zeros(O, np.int32)
    uv, om = np.zeros((O, 2), np.float32), np.zeros(O, np.float32)
    n = int(keep.sum())
    pi[:n], uv[:n], om[:n] = p.pnt_idx[keep], p.uv[keep], 1.0
    return jba.BAProblem(*(jnp.asarray(x) for x in (
        p.rvecs[cam: cam + 1], p.tvecs[cam: cam + 1], p.points, ci, pi, uv, om,
        np.zeros_like(p.point_mask), p.K)))


# (camera, max_iterations, ftol = xtol, stops early): the refine's own cap
# of 10 with its tolerance, where camera 1 stops at 9 iterations, and a
# looser tolerance, where camera 3 stops at 4; a cap of 2, and tolerances of
# 0, where the loop runs to the cap
LOOP_CASES = [(1, 10, 1e-5, True), (3, 10, 1e-4, True), (3, 2, 1e-5, False),
              (3, 6, 0.0, False)]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("cam,max_iterations,tol,early", LOOP_CASES)
def test_masked_lm_loop_equals_the_loop_that_leaves(window, threads, cam, max_iterations, tol,
                                                    early):
    """The LM loop on the device (updates masked after the stop, no host
    read) gives the bits of the loop that leaves at the stop, and counts
    the live iterations alone, at one and at four torch threads."""
    pt = _port(_refine_problem(window, cam))
    kw = dict(n_fixed=0, max_iterations=max_iterations, huber_delta=1.0, ftol=tol, xtol=tol)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        a = tba.ba_solve(pt, **kw)
        b = tba.ba_solve(pt, **kw, masked=True)
    finally:
        torch.set_num_threads(before)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    for name, x, y in zip(a[3]._fields, a[3], b[3]):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), name
    its = int(b[3].iterations)
    assert (1 <= its < max_iterations) if early else (its == max_iterations)
    assert float(b[3].final_cost) < float(b[3].initial_cost)


def test_pipeline_refine_holds_to_jax(window):
    """The pipeline's pose refine (its cap of 10, the masked loop) against
    the JAX package's ``ba_solve`` on the same problem, to the bounds of
    ``_same_result``."""
    pj = _refine_problem(window, 4)
    a = jba.ba_solve(pj, n_fixed=0, max_iterations=10)
    b = tba.ba_solve(_port(pj), n_fixed=0, max_iterations=10, masked=True)
    _same_result(a, b)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), atol=1e-3)
    np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), atol=1e-3)
