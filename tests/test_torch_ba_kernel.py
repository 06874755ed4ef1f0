"""Parity of the window LM solve's plain version (``ops.ba_kernel``, the CPU
path of ``lm_solve`` and the twin of the CUDA kernel K3) with the JAX
package's ``ba_pallas``: its plain reference ``reference_lm`` and the Pallas
kernel in interpret mode, on windows made with numpy from a seed (``utils.synthetic.synthetic_window``).

Tolerances, each from what is compared:

* one LM iteration (same arithmetic, float32 sums in another order):
  rvecs and tvecs within 1e-5 absolute, points within 1e-4 absolute, the
  four costs within 1e-5 relative.  With one fixed camera the monocular
  scale is free and only the damping holds it, so the camera system is a
  thousand times worse conditioned along it: there tvecs and points get
  5e-5 and 5e-4 (measured: 1.4e-5 on tvecs of size 0.9, all of it along the
  translations' common scale);
* a full solve (up to 50 iterations, where one accept/reject decided by the
  last bits changes the path): final cost within 1 %, iterations within 1,
  ``accepted`` equal (at 9 cameras with the scale gauge free, seeds 5 and
  11 to 14 all give equal counts);
* the Pallas kernel in interpret mode after 10 iterations: final cost within
  1e-3 relative, rvecs and tvecs within 1e-4, points within 1e-3 (ten
  iterations of the drift allowed for one);
* the port's own grid solver ``ba_grid.ba_solve_grid_impl`` (LAPACK solve in
  place of Gauss-Jordan): final cost within 1 %, iterations within 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.ops import ba_grid as jbg
from bundle_adjustment_tpu.ops import ba_pallas as jbp
from bundle_adjustment_tpu.ops.lie import so3_exp_np
from bundle_adjustment_tpu_torch import convert, kernels
from bundle_adjustment_tpu_torch.ops import ba_grid as tbg
from bundle_adjustment_tpu_torch.ops import ba_kernel
from bundle_adjustment_tpu_torch.utils.synthetic import repeat_slots, synthetic_window

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)

def jax_grid(w):
    return jbg.BAProblemGrid(**{k: jnp.asarray(v) for k, v in w.items()})


def port_grid(w):
    return convert.ba_problem_grid(jbg.BAProblemGrid(**w), device="cpu")


def _costs(stats):
    return [float(stats.initial_cost), float(stats.final_cost),
            float(stats.initial_sq), float(stats.final_sq)]


@pytest.mark.parametrize("seed,C,n_fixed", [(0, 5, 2), (1, 4, 1), (2, 9, 1)])
def test_one_iteration_matches_reference_lm(seed, C, n_fixed):
    loose = 5.0 if n_fixed == 1 else 1.0       # the free scale gauge, see above
    w = synthetic_window(seed, C=C, D=min(C, 6))
    a = jbp.reference_lm(jax_grid(w), n_fixed=n_fixed, max_iterations=1)
    b = ba_kernel.lm_solve_plain(port_grid(w), n_fixed=n_fixed, max_iterations=1)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), rtol=0, atol=loose * 1e-5)
    np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), rtol=0, atol=loose * 1e-4)
    np.testing.assert_allclose(_costs(b[3]), _costs(a[3]), rtol=1e-5)
    assert int(b[3].iterations) == int(a[3].iterations) == 1
    assert bool(b[3].accepted) == bool(a[3].accepted) is True
    # the gauge cameras are untouched
    np.testing.assert_array_equal(b[0].numpy()[:n_fixed], w["rvecs"][:n_fixed])
    np.testing.assert_array_equal(b[1].numpy()[:n_fixed], w["tvecs"][:n_fixed])


@pytest.mark.parametrize("seed,C,n_fixed", [(3, 5, 2), (4, 5, 1), (12, 9, 1)])
def test_full_solve_matches_reference_lm(seed, C, n_fixed):
    w = synthetic_window(seed, C=C, D=min(C, 6))
    a = jbp.reference_lm(jax_grid(w), n_fixed=n_fixed)
    b = ba_kernel.lm_solve_plain(port_grid(w), n_fixed=n_fixed)
    np.testing.assert_allclose(float(b[3].initial_cost), float(a[3].initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(b[3].final_cost), float(a[3].final_cost), rtol=1e-2)
    np.testing.assert_allclose(float(b[3].final_sq), float(a[3].final_sq), rtol=1e-2)
    assert abs(int(b[3].iterations) - int(a[3].iterations)) <= 1
    assert bool(b[3].accepted) == bool(a[3].accepted) is True
    assert float(b[3].final_cost) < 0.9 * float(b[3].initial_cost)


def test_matches_the_pallas_kernel_in_interpret_mode():
    w = synthetic_window(6, C=3, n_pts=30, P=32)
    a = jbp.ba_solve_grid_pallas(jax_grid(w), max_iterations=10, interpret=True)
    b = ba_kernel.lm_solve_plain(port_grid(w), max_iterations=10)
    np.testing.assert_allclose(float(b[3].final_cost), float(a[3].final_cost), rtol=1e-3)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), rtol=0, atol=1e-3)
    assert int(b[3].iterations) == int(a[3].iterations)


def test_matches_the_ports_grid_solver():
    w = synthetic_window(7)
    a = tbg.ba_solve_grid_impl(port_grid(w), n_fixed=2)
    b = ba_kernel.lm_solve_plain(port_grid(w), n_fixed=2)
    np.testing.assert_allclose(float(b[3].initial_cost), float(a[3].initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(b[3].final_cost), float(a[3].final_cost), rtol=1e-2)
    assert abs(int(b[3].iterations) - int(a[3].iterations)) <= 1
    np.testing.assert_allclose(b[1].numpy(), a[1].numpy(), rtol=0, atol=1e-3)


def test_matches_the_jax_grid_solver_past_twelve_slots():
    """Each observation of a window in 3 slots (D = 15 over 5 cameras: a
    keyframe that sees a point through several keypoints, as the long
    drive's windows do): the window kernel's gate takes it, and its plain
    version lands where the JAX grid solver does, which the JAX pipeline
    runs on such a window (its Pallas gate stops at 12 slots)."""
    w = repeat_slots(synthetic_window(13, C=5, n_pts=96, P=128), 3, 13)
    assert w["cam_slot"].shape == (128, 15)
    assert ba_kernel.kernel_eligible(port_grid(w), 2)
    a = jbg.ba_solve_grid(jax_grid(w), n_fixed=2)
    b = ba_kernel.lm_solve_plain(port_grid(w), n_fixed=2)
    np.testing.assert_allclose(float(b[3].initial_cost), float(a[3].initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(b[3].final_cost), float(a[3].final_cost), rtol=1e-2)
    assert abs(int(b[3].iterations) - int(a[3].iterations)) <= 1
    np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), rtol=0, atol=1e-3)


def test_padding_points_and_dead_slots_are_inert():
    """The same live window with more padding points, more dead slots and
    junk in the dead slots' camera index and pixel gives the same solve."""
    w0 = synthetic_window(8, C=4, n_pts=60, P=64, D=4)
    w1 = synthetic_window(8, C=4, n_pts=60, P=256, D=7)
    dead = w1["mask"] == 0
    w1["cam_slot"][dead] = 3
    w1["uv"][dead] = 1e4
    for name in ("cam_slot", "uv", "mask"):
        np.testing.assert_array_equal(w1[name][:60, :4][~dead[:60, :4]],
                                      w0[name][:60][w0["mask"][:60] > 0])
    a = ba_kernel.lm_solve_plain(port_grid(w0), n_fixed=1, max_iterations=20)
    b = ba_kernel.lm_solve_plain(port_grid(w1), n_fixed=1, max_iterations=20)
    np.testing.assert_allclose(_costs(b[3]), _costs(a[3]), rtol=1e-4)
    np.testing.assert_allclose(b[0].numpy(), a[0].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b[2].numpy()[60:], 0.0)
    assert int(b[3].iterations) == int(a[3].iterations)


def test_a_point_on_a_camera_centre_stays_finite_and_agrees_with_jax():
    """A point a hair from an adjustable camera's centre: its V block
    overflows the float32 determinant.  The jitted JAX solve freezes the
    point for the step; the plain version must do the same, not turn the
    camera system into NaNs."""
    w = synthetic_window(9, C=5)
    c = 3
    centre = -so3_exp_np(w["rvecs"][c].astype(np.float64)).T @ w["tvecs"][c]
    w["points"][0] = (centre + [1e-7, -1e-7, 2e-7]).astype(np.float32)
    a = jbp.reference_lm(jax_grid(w), n_fixed=2, max_iterations=1)
    b = ba_kernel.lm_solve_plain(port_grid(w), n_fixed=2, max_iterations=1)
    for x in b[:3]:
        assert torch.isfinite(x).all()
    assert all(np.isfinite(_costs(b[3])))
    np.testing.assert_array_equal(b[2].numpy()[0], w["points"][0])
    np.testing.assert_allclose(b[2].numpy()[0], np.asarray(a[2])[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), rtol=0, atol=1e-4)
    full = ba_kernel.lm_solve_plain(port_grid(w), n_fixed=2)
    assert all(np.isfinite(_costs(full[3]))) and bool(full[3].accepted)


@pytest.mark.parametrize("C,P,D,n_fixed,ok", [
    (5, 8192, 5, 2, True),        # the default window
    (9, 8192, 12, 1, True),       # 6C' = 48, D = 12
    (10, 8192, 12, 2, True),      # the final BA's widest admitted window
    (10, 8192, 12, 1, False),     # 6C' = 54
    (9, 8192, 13, 1, True),       # D above 12: no bound on the slot loop
    (5, 8192, 262144, 2, False),  # ... but a slot index d*P + p stays an int32
    (17, 8192, 5, 9, False),      # more than 16 cameras in shared memory
    (2, 64, 2, 2, False),         # no adjustable camera
    (9, 53430, 12, 1, True),      # the scratch bound at C' = 8 ...
    (9, 53431, 12, 1, False),
    (5, 125203, 5, 2, True),      # ... and at C' = 3
    (5, 125204, 5, 2, False),
])
def test_eligible_shape_at_its_edges(C, P, D, n_fixed, ok):
    assert ba_kernel.eligible_shape(C, P, D, n_fixed) is ok
    if ok:
        assert 4 * ba_kernel.scratch_floats(C, P, n_fixed) <= ba_kernel.SCRATCH_LIMIT_BYTES


def test_lm_solve_takes_the_plain_path_on_the_cpu_and_counts_no_launch():
    w = synthetic_window(10, C=3, n_pts=30, P=32)
    kernels.reset_launches()
    a = ba_kernel.lm_solve(port_grid(w), n_fixed=1, max_iterations=3)
    b = ba_kernel.lm_solve_plain(port_grid(w), n_fixed=1, max_iterations=3)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert kernels.LAUNCHES[ba_kernel.NAME] == 0
    assert ba_kernel.kernel_eligible(port_grid(w), 1)
    with pytest.raises(ValueError, match="adjustable"):
        ba_kernel.lm_solve(port_grid(w), n_fixed=3)
