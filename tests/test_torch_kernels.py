"""The port's hand-written CUDA kernels against their plain PyTorch versions.

This file imports nothing of JAX, so it runs on the machine with the card,
which has no JAX:

    python -m pytest tests/test_torch_kernels.py -q

The tests marked ``cuda`` skip where there is no card.  On the card K1 and K2
are compared exactly: K1's distances are integers, K2 copies float32 pixels.
K3, the window LM solve, sums float32 in another order than its plain
version and contracts to FMA where eager PyTorch does not: after one LM
iteration rvecs and tvecs agree within 1e-5 and points within 1e-4 absolute,
the costs within 1e-5 relative; after a full solve the final cost within
1 %, the iteration count within 2, ``accepted`` equal.  Two launches on the
same input give equal bits.
"""

import re

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch import kernels
from bundle_adjustment_tpu_torch.ops import ba_kernel, hamming_kernel, orb, orb_kernel
from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid
from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np
from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_window

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, n):
    return torch.as_tensor(
        rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))


def _knn2_case(seed, n1, n2):
    """Random words with planted ties and invalid train slots."""
    rng = np.random.default_rng(seed)
    d1, d2 = _words(rng, n1), _words(rng, n2)
    if n2 > 1:
        d2[1::3] = d2[0::3][: len(d2[1::3])]
    d1[::4] = d2[torch.arange(0, n1, 4) % n2]
    d1[1::5] = d2[torch.arange(1, n1, 5) % n2] ^ (1 << 7)
    valid2 = torch.as_tensor(rng.random(n2) > 0.1)
    return d1, d2, valid2


def _gather_case(H, W, B, seed=3):
    rng = np.random.default_rng(seed)
    img = torch.as_tensor((rng.random((H, W)) * 255).astype(np.float32))
    sy = torch.as_tensor(rng.integers(0, H - 37 + 1, B).astype(np.int32))
    sx = torch.as_tensor(rng.integers(0, W - 37 + 1, B).astype(np.int32))
    sy[:20] = H - 37            # rows 37..39 of the window fall off the image
    sx[10:30] = W - 37
    sy[30:40] = 0
    sx[30:40] = 0
    return img, sy, sx


def _window(device, seed, **kw):
    w = synthetic_window(seed, **kw)
    return BAProblemGrid(**{k: torch.as_tensor(v, device=device) for k, v in w.items()})


def _costs(stats):
    return [float(stats.initial_cost), float(stats.final_cost),
            float(stats.initial_sq), float(stats.final_sq)]


def test_every_kernel_has_a_source_that_names_what_it_replaces():
    for name, (source, entry, argtypes) in kernels.KERNELS.items():
        text = (kernels.SOURCE_DIR / source).read_text()
        assert re.search(r"Replaces: bundle_adjustment_tpu/ops/\w+_pallas\.py", text), name
        assert f'extern "C" int {entry}(' in text, name
        assert "What bounds it on this card" in text, name
        assert len(argtypes) == text.split(f"int {entry}(")[1].split(")")[0].count(",") + 1


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    kernels.reset_launches()
    d1, d2, valid2 = _knn2_case(0, 33, 47)
    for a, b in zip(hamming_kernel.knn2_fused(d1, d2, valid2),
                    hamming_kernel.knn2_plain(d1, d2, valid2)):
        assert torch.equal(a, b)
    img, sy, sx = _gather_case(60, 90, 50)
    assert torch.equal(orb_kernel.gather_patches40(img, sy, sx),
                       orb_kernel.gather_patches40_plain(img, sy, sx))
    g = _window("cpu", 0, C=3, n_pts=30, P=32)
    for a, b in zip(ba_kernel.lm_solve(g, n_fixed=1, max_iterations=2)[:3],
                    ba_kernel.lm_solve_plain(g, n_fixed=1, max_iterations=2)[:3]):
        assert torch.equal(a, b)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_window_kernel_wrapper_checks_what_the_kernel_does_not_take():
    g = _window("cpu", 1, C=3, n_pts=30, P=32)
    opts = dict(max_iterations=1, huber_delta=1.0, lambda_init=1e-3, lambda_up=4.0,
                lambda_down=0.5, lambda_min=1e-10, lambda_max=1e8, ftol=1e-5, xtol=1e-5)
    with pytest.raises(ValueError, match="cam_slot"):
        ba_kernel.launch(g._replace(cam_slot=g.cam_slot.long()), 1, **opts)
    with pytest.raises(ValueError, match="uv"):
        ba_kernel.launch(g._replace(uv=g.uv[:, :2]), 1, **opts)
    with pytest.raises(ValueError, match="gate"):
        ba_kernel.launch(g, 3, **opts)


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(4000, 4000), (1237, 3001), (130, 200), (64, 1)])
def test_hamming_kernel_matches_plain_on_the_card(card, n1, n2):
    args = [x.to(card) for x in _knn2_case(n1 + n2, n1, n2)]
    before = kernels.LAUNCHES[hamming_kernel.NAME]
    out = hamming_kernel.knn2_fused(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[hamming_kernel.NAME] == before + 1
    for a, b in zip(out, hamming_kernel.knn2_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gather_kernel_matches_plain_on_the_card(card):
    """At the main path's shapes: eight pyramid levels of a 1280x720 frame
    with preset_video's per-level budgets, edge starts included."""
    budgets = orb.level_budgets(6400, 8, 1.2)
    H, W = 720, 1280
    for lvl, B in enumerate(budgets):
        s = 1.2 ** -lvl
        img, sy, sx = _gather_case(int(round(H * s)), int(round(W * s)), B, seed=lvl)
        args = [x.to(card) for x in (img, sy, sx)]
        out = orb_kernel.gather_patches40(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, orb_kernel.gather_patches40_plain(*args))


K3_SHAPES = [
    dict(C=5, n_fixed=2, n_pts=6000, P=8192, D=5),    # the main path's window
    dict(C=9, n_fixed=1, n_pts=1531, P=1777, D=6),    # 6C' = 48, ragged P
    dict(C=10, n_fixed=2, n_pts=900, P=1024, D=12),   # D = 12, 6C' = 48
    dict(C=3, n_fixed=1, n_pts=40, P=64, D=3),
]


def _split(shape):
    shape = dict(shape)
    return shape.pop("n_fixed"), shape


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_SHAPES, ids=lambda s: f"C{s['C']}P{s['P']}D{s['D']}")
def test_window_kernel_one_iteration_matches_plain_on_the_card(card, shape):
    n_fixed, kw = _split(shape)
    g = _window(card, 11, **kw)
    before = kernels.LAUNCHES[ba_kernel.NAME]
    a = ba_kernel.lm_solve(g, n_fixed=n_fixed, max_iterations=1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[ba_kernel.NAME] == before + 1
    b = ba_kernel.lm_solve_plain(g, n_fixed=n_fixed, max_iterations=1)
    assert float((a[0] - b[0]).abs().max()) <= 1e-5
    assert float((a[1] - b[1]).abs().max()) <= 1e-5
    assert float((a[2] - b[2]).abs().max()) <= 1e-4
    np.testing.assert_allclose(_costs(a[3]), _costs(b[3]), rtol=1e-5)
    assert int(a[3].iterations) == int(b[3].iterations) == 1
    assert bool(a[3].accepted) == bool(b[3].accepted)
    assert torch.equal(a[0][:n_fixed], g.rvecs[:n_fixed])
    assert torch.equal(a[2][kw["n_pts"]:], g.points[kw["n_pts"]:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_SHAPES, ids=lambda s: f"C{s['C']}P{s['P']}D{s['D']}")
def test_window_kernel_full_solve_matches_plain_on_the_card(card, shape):
    n_fixed, kw = _split(shape)
    g = _window(card, 12, **kw)
    a = ba_kernel.lm_solve(g, n_fixed=n_fixed)
    b = ba_kernel.lm_solve_plain(g, n_fixed=n_fixed)
    np.testing.assert_allclose(float(a[3].initial_cost), float(b[3].initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(a[3].final_cost), float(b[3].final_cost), rtol=1e-2)
    assert abs(int(a[3].iterations) - int(b[3].iterations)) <= 2
    assert bool(a[3].accepted) == bool(b[3].accepted) is True
    assert float(a[3].final_cost) < 0.9 * float(a[3].initial_cost)


@pytest.mark.cuda
def test_window_kernel_is_deterministic_and_fills_its_stats_lanes(card):
    g = _window(card, 13, C=5, n_pts=3000, P=4096, D=5)
    opts = dict(max_iterations=50, huber_delta=1.0, lambda_init=1e-3, lambda_up=4.0,
                lambda_down=0.5, lambda_min=1e-10, lambda_max=1e8, ftol=1e-5, xtol=1e-5)
    a = ba_kernel.launch(g, 2, **opts)
    b = ba_kernel.launch(g, 2, **opts)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    stats = a[3].cpu().numpy()
    assert np.isfinite(stats).all()
    assert stats[4] == np.floor(stats[4]) and 1 <= stats[4] <= 50
    assert stats[5] == 1.0 and 1e-10 <= stats[6] <= 1e8 and stats[7] == 0.0
    # the input window is not written to
    assert torch.equal(g.points, _window(card, 13, C=5, n_pts=3000, P=4096, D=5).points)


@pytest.mark.cuda
def test_window_kernel_freezes_a_point_on_a_camera_centre(card):
    w = synthetic_window(14, C=5, n_pts=500, P=512)
    centre = -so3_exp_np(w["rvecs"][3].astype(np.float64)).T @ w["tvecs"][3]
    w["points"][0] = (centre + [1e-7, -1e-7, 2e-7]).astype(np.float32)
    g = BAProblemGrid(**{k: torch.as_tensor(v, device=card) for k, v in w.items()})
    a = ba_kernel.lm_solve(g, n_fixed=2, max_iterations=1)
    b = ba_kernel.lm_solve_plain(g, n_fixed=2, max_iterations=1)
    for x in a[:3]:
        assert torch.isfinite(x).all()
    assert np.isfinite(_costs(a[3])).all()
    assert torch.equal(a[2][0], g.points[0])
    assert float((a[0] - b[0]).abs().max()) <= 1e-4
    assert float((a[1] - b[1]).abs().max()) <= 1e-4
    full = ba_kernel.lm_solve(g, n_fixed=2)
    assert np.isfinite(_costs(full[3])).all() and bool(full[3].accepted)


@pytest.mark.cuda
def test_window_kernel_ignores_junk_in_dead_slots_and_padding(card):
    g0 = _window(card, 15, C=4, n_pts=300, P=320, D=4)
    w1 = synthetic_window(15, C=4, n_pts=300, P=1024, D=7)
    dead = w1["mask"] == 0
    w1["cam_slot"][dead] = 3
    w1["uv"][dead] = 1e4
    g1 = BAProblemGrid(**{k: torch.as_tensor(v, device=card) for k, v in w1.items()})
    a = ba_kernel.lm_solve(g0, n_fixed=1, max_iterations=20)
    b = ba_kernel.lm_solve(g1, n_fixed=1, max_iterations=20)
    # same per-point arithmetic; the sums over points run in another order
    # (another stride over another P), hence not bit-equal
    np.testing.assert_allclose(_costs(a[3]), _costs(b[3]), rtol=1e-4)
    assert float((a[0] - b[0]).abs().max()) <= 1e-4
    assert torch.equal(b[2][300:], torch.zeros_like(b[2][300:]))
