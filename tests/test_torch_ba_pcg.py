"""Parity of the port's matrix-free PCG bundle adjustment (``ops.ba._pcg_blocked``,
the PCG branch of the flat solver, ``ops.ba_grid._solve_step_pcg`` and the
PCG arms of ``ba_solve_grid_impl``) with the JAX package, on one seeded
band-visibility chain: 12 cameras, 600 points, 4 observations per point.

Tolerances are the JAX package's own (``tests/test_ba_pcg.py``,
``tests/test_ba_global_pallas.py``): one step at the pipeline's PCG settings
(8 iterations, so that both run the same recurrences and only rounding
differs: a float32 CG run to stagnation wanders by more than that on a
12-camera chain), camera rotations 1e-5, translations and points 1e-4
absolute; whole solves, initial cost 1e-5
relative, final cost 1 %, rotations 5e-3, points 5e-2 absolute; PCG against
the dense solve on a window, final cost within 2 %, rotations 2e-4,
translations 2e-3.  With ``cg_bf16`` the reduced rows are rounded to three
decimal digits, and the two packages round at different places of the sum, so
the final cost is held to 2 % and the parameters to twice the bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.ops import ba as jba
from bundle_adjustment_tpu.ops import ba_grid as jbg
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.ops import ba as tba
from bundle_adjustment_tpu_torch.ops import ba_grid as tbg
from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_problem, synthetic_window

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)

FREE = dict(max_iterations=15, ftol=0.0, xtol=0.0, lambda_max=1e30)


@pytest.fixture(scope="module")
def chain():
    """(JAX flat problem, port flat problem, JAX grid, port grid)."""
    pr = synthetic_global_problem(3, C=12, P=600, centre_sigma=0.03, point_sigma=0.03,
                                  rot_sigma=0.01)
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in pr.items()})
    pt = convert.ba_problem(jax.tree.map(np.asarray, pj), device="cpu")
    gj = jbg.from_flat(pj)
    return pj, pt, gj, convert.ba_problem_grid(jax.tree.map(np.asarray, gj), "cpu")


def _spd_blocks(seed, n_blocks):
    rng = np.random.default_rng(seed)
    n = 6 * n_blocks
    M = rng.normal(size=(n, n)).astype(np.float32)
    A = M @ M.T / n + np.diag(rng.uniform(0.5, 50.0, n)).astype(np.float32)
    b = rng.normal(size=(n_blocks, 6)).astype(np.float32)
    blocks = np.stack([A[6 * i: 6 * i + 6, 6 * i: 6 * i + 6] for i in range(n_blocks)])
    return A, b, np.linalg.inv(blocks).astype(np.float32)


@pytest.mark.parametrize("precond", ["blocks", "callable"])
def test_pcg_blocked_matches_jax_and_stops_on_the_same_iteration(precond):
    """x after every iteration cap agrees (1e-5 of its scale: both run the
    same float32 recurrences, sums in another order), and the loop leaves on
    the relative residual at the same iteration."""
    A, b, Minv = _spd_blocks(0, 7)
    tol = 1e-4
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    Mj, Mt = jnp.asarray(Minv), torch.as_tensor(Minv)
    if precond == "callable":
        Mj_arg = lambda r: jnp.einsum("cij,cj->ci", Mj, r)       # noqa: E731
        Mt_arg = lambda r: torch.einsum("cij,cj->ci", Mt, r)     # noqa: E731
    else:
        Mj_arg, Mt_arg = Mj, Mt
    calls = []

    def mv_t(x):
        calls.append(1)
        return (At @ x.reshape(-1)).reshape(x.shape)

    xs_j, n_t = [], []
    for cap in range(1, 21):
        xj = np.asarray(jba._pcg_blocked(lambda x: (Aj @ x.reshape(-1)).reshape(x.shape),
                                         jnp.asarray(b), Mj_arg, cap, tol))
        calls.clear()
        xt = tba._pcg_blocked(mv_t, torch.as_tensor(b), Mt_arg, cap, tol).numpy()
        np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-5 * np.abs(xj).max())
        xs_j.append(xj)
        n_t.append(len(calls))
    stop_j = next(k for k in range(1, 20) if np.array_equal(xs_j[k - 1], xs_j[k]))
    assert n_t[-1] == stop_j < 20, (n_t[-1], stop_j)
    assert n_t[: stop_j] == list(range(1, stop_j + 1))
    exact = np.linalg.solve(A.astype(np.float64), b.reshape(-1).astype(np.float64))
    np.testing.assert_allclose(xs_j[-1].reshape(-1), exact, rtol=0, atol=1e-3 * np.abs(exact).max())


def test_pcg_blocked_of_a_zero_right_hand_side_is_zero():
    A, _, Minv = _spd_blocks(1, 3)
    x = tba._pcg_blocked(lambda v: (torch.as_tensor(A) @ v.reshape(-1)).reshape(v.shape),
                         torch.zeros(3, 6), torch.as_tensor(Minv), 8, 1e-6)
    assert torch.equal(x, torch.zeros(3, 6))


@pytest.mark.parametrize("n_fixed", [1, 2])
def test_flat_pcg_step_matches_jax(chain, n_fixed):
    pj, pt, _, _ = chain
    a = jba._solve_normal_equations(pj.rvecs, pj.tvecs, pj.points, pj, jnp.float32(1e-3), 1.0,
                                    n_fixed, cg_iters=8, cg_tol=1e-6)
    b = tba._solve_normal_equations(pt.rvecs, pt.tvecs, pt.points, pt, torch.tensor(1e-3), 1.0,
                                    n_fixed, cg_iters=8, cg_tol=1e-6)
    for x, y, atol in zip(a, b, (1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0, atol=atol)
    assert not b[0][:n_fixed].any() and not b[1][:n_fixed].any()


def _onehots(gj, gt, n_fixed):
    c_adj = gj.rvecs.shape[0] - n_fixed
    oj = (jnp.arange(c_adj)[:, None] == (gj.cam_slot.reshape(-1)[None, :] - n_fixed)
          ).astype(jnp.float32)
    return oj, torch.as_tensor(np.asarray(oj))


@pytest.mark.parametrize("n_fixed,group", [(1, 1), (2, 1), (1, 4)])
def test_grid_pcg_step_matches_jax(chain, n_fixed, group):
    _, _, gj, gt = chain
    oj, ot = _onehots(gj, gt, n_fixed)
    pj = gj._replace(mask=gj.mask.astype(jnp.float32))
    a = jbg._solve_step_pcg(pj.rvecs, pj.tvecs, pj.points, pj, jnp.float32(1e-3), 1.0, n_fixed,
                            oj, 8, 1e-6, pc_group=group)
    b = tbg._solve_step_pcg(gt.rvecs, gt.tvecs, gt.points, gt, torch.tensor(1e-3), 1.0, n_fixed,
                            ot, 8, 1e-6, pc_group=group)
    # the grouped preconditioner inverts 24x24 blocks by LU in both packages
    # (other pivots, other rounding, on blocks as badly conditioned as the
    # chain's gauge): five times the bounds
    scale = 5.0 if group > 1 else 1.0
    for x, y, atol in zip(a[:3], b[:3], (1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0, atol=atol * scale)
    np.testing.assert_allclose(float(b[3]), float(a[3]), rtol=1e-4)


def test_inv6_and_group_rows_match_jax():
    rng = np.random.default_rng(2)
    M = rng.normal(size=(9, 6, 6)).astype(np.float32)
    M = M @ np.swapaxes(M, 1, 2) + 2 * np.eye(6, dtype=np.float32)
    out = tbg._inv6(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(out, np.asarray(jbg._inv6(jnp.asarray(M))), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out, np.linalg.inv(M.astype(np.float64)), rtol=1e-3, atol=1e-5)
    Y = rng.normal(size=(20, 3, 6, 3)).astype(np.float32)
    YV = rng.normal(size=(20, 3, 6, 3)).astype(np.float32)
    slot = rng.integers(0, 9, (20, 3)).astype(np.int32)
    a = jbg._group_precond_rows(jnp.asarray(Y), jnp.asarray(YV), jnp.asarray(slot), 2, 4)
    b = tbg._group_precond_rows(torch.as_tensor(Y), torch.as_tensor(YV), torch.as_tensor(slot),
                                2, 4)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def _same_solve(a, b, scale=1.0):
    sa, sb = a[3], b[3]
    np.testing.assert_allclose(float(sb.initial_cost), float(sa.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(sb.final_cost), float(sa.final_cost), rtol=1e-2 * scale)
    np.testing.assert_allclose(float(sb.final_sq), float(sa.final_sq), rtol=1e-2 * scale)
    assert int(sb.iterations) == int(sa.iterations)
    assert float(sb.final_cost) < 0.5 * float(sb.initial_cost)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=0, atol=5e-3 * scale)
    np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), rtol=0, atol=5e-2 * scale)


@pytest.mark.parametrize("opts,scale", [
    (dict(n_fixed=1, cg_forcing=True), 1.0),
    (dict(n_fixed=2, cg_forcing=True), 1.0),
    (dict(n_fixed=1, cg_forcing=False), 1.0),
    (dict(n_fixed=1, cg_forcing=True, cg_precond_group=4), 1.0),
    (dict(n_fixed=1, cg_forcing=True, cg_bf16=True), 2.0),
], ids=["forcing", "forcing-n_fixed2", "fixed-tolerance", "grouped", "bf16"])
def test_grid_pcg_solve_matches_jax(chain, opts, scale):
    _, _, gj, gt = chain
    kw = dict(FREE, cg_iters=8, cg_tol=1e-6, **opts)
    _same_solve(jbg.ba_solve_grid(gj, **kw), tbg.ba_solve_grid(gt, **kw), scale)


def test_flat_pcg_solve_matches_jax(chain):
    pj, pt, _, _ = chain
    kw = dict(FREE, n_fixed=2, cg_iters=100, cg_tol=1e-6)
    _same_solve(jba.ba_solve(pj, **kw), tba.ba_solve(pt, **kw))


@pytest.mark.parametrize("solver", ["flat", "grid"])
def test_pcg_matches_dense_on_a_window(solver):
    """At window scale both camera solvers land on the same optimum."""
    w = synthetic_window(4, C=5, n_pts=80, P=96, noise=0.2)
    g = tbg.BAProblemGrid(**{k: torch.as_tensor(v) for k, v in w.items()})
    if solver == "grid":
        dense = tbg.ba_solve_grid(g, n_fixed=1, max_iterations=30)
        pcg = tbg.ba_solve_grid(g, n_fixed=1, max_iterations=30, cg_iters=200, cg_tol=1e-8,
                                cg_forcing=False)
    else:
        live = g.mask > 0
        pi, _ = torch.nonzero(live, as_tuple=True)
        prob = tba.BAProblem(g.rvecs, g.tvecs, g.points, g.cam_slot[live], pi.to(torch.int32),
                             g.uv[live], torch.ones(len(pi)), g.point_mask, g.K)
        dense = tba.ba_solve(prob, n_fixed=1, max_iterations=30)
        pcg = tba.ba_solve(prob, n_fixed=1, max_iterations=30, cg_iters=200, cg_tol=1e-8)
    assert float(pcg[3].final_cost) <= 1.02 * float(dense[3].final_cost)
    assert float(dense[3].final_cost) < 0.1 * float(dense[3].initial_cost)
    np.testing.assert_allclose(pcg[0].numpy(), dense[0].numpy(), rtol=0, atol=2e-4)
    np.testing.assert_allclose(pcg[1].numpy(), dense[1].numpy(), rtol=0, atol=2e-3)


@pytest.mark.parametrize("forcing", [True, False])
def test_lm_loop_hands_the_step_its_tolerance(forcing):
    """Eisenstat-Walker: 0.1 first, then clip(sqrt(|b_k-1| / |b_0|), cg_tol,
    0.1); without forcing every step gets cg_tol; a dense step gets none."""
    bnorms = [4.0, 1.0, 0.04, 1e-14, 9.0]
    seen = []

    def step(rv, tv, pt, lam, tol):
        seen.append(float(tol))
        z = torch.zeros_like(rv)
        return z, z, torch.zeros_like(pt), torch.tensor(bnorms[len(seen) - 1])

    def cost_at(rv, tv, pt):       # never improves: every step is rejected
        return torch.tensor(1.0)

    z = torch.zeros(2, 3)
    out = tba.lm_loop(step, cost_at, cost_at, z, z, torch.zeros(4, 3), max_iterations=5,
                      lambda_init=1e-3, lambda_up=4.0, lambda_down=0.5, lambda_min=1e-10,
                      lambda_max=1e8, ftol=1e-5, xtol=1e-5, cg_tol=1e-6, cg_forcing=forcing)
    assert int(out[3].iterations) == 5 and not bool(out[3].accepted)
    want = [0.1, 0.1, 0.1, 0.1, 1e-6] if forcing else [1e-6] * 5
    if forcing:
        want[1] = min(0.1, np.sqrt(4.0 / 4.0))
        want[2] = min(0.1, np.sqrt(1.0 / 4.0))
        want[3] = np.sqrt(0.04 / 4.0)
    np.testing.assert_allclose(seen, want, rtol=1e-6)
