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

K4, the four global-BA PCG roles (setup, matvec, backsub, cost), are held to
their plain versions norm-wise: the largest absolute difference over the
largest absolute value, because single entries of U or V^-1 cancel.  Outputs
whose lanes differ in scale are compared in groups of one scale as well (Y's
rotation and translation rows, the ten groups of
``ba_global_kernel.red_lane_groups``, the matvec's rotation and translation
lanes): a camera's rotation lanes are larger than its translation lanes by the
scene's depth, and one norm over all 54 lanes of the reduction would hide an
error as large as the small lanes.  The kernels contract to FMA and add each
camera's pairs over tiles of the pair list (``ba_global_kernel.
tiled_camera_sum`` is their order) where the plain versions add by
``index_put_``.
The widest gap is Y's: a pixel residual is the difference of two numbers near
600, so it carries about 1e-3 px of rounding, and the Huber weight 1/|r| of a
residual of a pixel or two carries that relatively.  Measured on one H100 at
the two shapes: Y 6.0e-4 (translation rows; rotation rows 3.5e-4), V^-1
1.4e-4, z_p 5.4e-5, the reduction's groups 3.9e-6 to 2.1e-5, matvec 9.4e-7,
backsub 8.5e-6, the costs 1.1e-7.  Bounds: Y 2e-3, V^-1 and z_p 1e-3, each
group of the reduction 1e-4, matvec 2e-5, backsub 2e-4, the two costs 1e-5
relative.  A whole solve: initial cost 1e-5, final cost 1 %, iterations within
2.  Repeat launches and repeat solves give equal bits, and junk in dead slots
changes no bit.  The plain grid PCG solver (the card's solver when
``cg_precond_group`` is above 1) gives equal bits on repeat as well.
"""

import os
import re

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch import kernels
from bundle_adjustment_tpu_torch.config import BAConfig, CameraModel, PipelineConfig
from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk
from bundle_adjustment_tpu_torch.ops import ba_kernel, hamming_kernel, orb, orb_kernel
from bundle_adjustment_tpu_torch.ops.ba import BAProblem
from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid, ba_solve_grid_impl, from_flat
from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np
from bundle_adjustment_tpu_torch.utils.event_log import EventLog
from bundle_adjustment_tpu_torch.utils.synthetic import (synthetic_global_map,
                                                         synthetic_global_problem,
                                                         synthetic_ring_problem,
                                                         synthetic_window)
from bundle_adjustment_tpu_torch.utils.synthetic import repeat_slots

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


def _global_grid(device, seed, C, n_pts, P, drop=0.0):
    """A band-visibility chain of C cameras and n_pts points padded to P, a
    share ``drop`` of its observations left out, in the grid layout."""
    pr = synthetic_global_problem(seed, C=C, P=n_pts, drop=drop, pad_to=P)
    return from_flat(BAProblem(**{k: torch.as_tensor(v, device=device)
                                  for k, v in pr.items()}))


def _rel(a, b):
    """The largest absolute difference over the largest absolute value."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


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
    gg = _global_grid("cpu", 0, C=6, n_pts=60, P=64)
    for a, b in zip(gk.solve(gg, n_fixed=1, max_iterations=2)[:3],
                    gk.solve_plain(gg, n_fixed=1, max_iterations=2)[:3]):
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


# K1 at the edges of the tiling: few train rows (fewer than the splits the
# query count alone would ask for, and one), shapes that are not multiples of
# the MMA tiles, all train rows tied, all train rows invalid
K1_EDGES = [(4000, 12, "random"), (4000, 1, "random"), (4001, 2999, "random"),
            (300, 700, "tied"), (300, 700, "invalid")]


def _knn2_edge(n1, n2, kind):
    d1, d2, valid2 = _knn2_case(n1 * 7 + n2, n1, n2)
    if kind == "tied":
        d2[:] = d2[0]
        valid2[:] = True
    elif kind == "invalid":
        valid2[:] = False
    return d1, d2, valid2


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2,kind", K1_EDGES, ids=[f"{a}x{b}{k}" for a, b, k in K1_EDGES])
def test_hamming_kernel_tiling_edges_on_the_card(card, n1, n2, kind):
    """Exact against the plain version at the tiling's edges."""
    args = [x.to(card) for x in _knn2_edge(n1, n2, kind)]
    out = hamming_kernel.launch(*args)
    torch.cuda.synchronize()
    plain = hamming_kernel.knn2_plain(*args)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    if kind == "tied":
        assert torch.equal(out[0], out[2]) and not out[1].any()
    if kind == "invalid":
        assert bool((out[0] == 1e9).all()) and not out[1].any()
    if n2 == 1:
        assert bool(torch.isinf(out[2]).all())


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


# K3 at the cluster's edges: fewer points than the cluster has threads (a
# single point; 300), and the widest window the gate admits (32 MiB of scratch)
K3_EDGES = [
    dict(C=5, n_fixed=2, n_pts=1, P=1, D=5),
    dict(C=5, n_fixed=2, n_pts=300, P=300, D=5),
    dict(C=10, n_fixed=2, n_pts=50000, P=53430, D=5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_EDGES, ids=lambda s: f"C{s['C']}P{s['P']}D{s['D']}")
def test_window_kernel_cluster_edges_match_plain_on_the_card(card, shape):
    """One iteration and a full solve within the tolerances of the tests
    above, and two launches bit-equal."""
    n_fixed, kw = _split(shape)
    assert ba_kernel.eligible_shape(kw["C"], kw["P"], kw["D"], n_fixed)
    g = _window(card, 16, **kw)
    opts = dict(max_iterations=50, huber_delta=1.0, lambda_init=1e-3, lambda_up=4.0,
                lambda_down=0.5, lambda_min=1e-10, lambda_max=1e8, ftol=1e-5, xtol=1e-5)
    one = ba_kernel.lm_solve_plain(g, n_fixed=n_fixed, max_iterations=1)
    full = ba_kernel.lm_solve_plain(g, n_fixed=n_fixed)
    a = ba_kernel.launch(g, n_fixed, **dict(opts, max_iterations=1))
    torch.cuda.synchronize()
    assert float((a[0] - one[0]).abs().max()) <= 1e-5
    assert float((a[1] - one[1]).abs().max()) <= 1e-5
    assert float((a[2] - one[2]).abs().max()) <= 1e-4
    np.testing.assert_allclose(a[3][:4].cpu().numpy(), _costs(one[3]), rtol=1e-5)
    assert int(a[3][4]) == 1 and bool(a[3][5] > 0.5) == bool(one[3].accepted)
    r1 = ba_kernel.launch(g, n_fixed, **opts)
    r2 = ba_kernel.launch(g, n_fixed, **opts)
    torch.cuda.synchronize()
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)
    np.testing.assert_allclose(float(r1[3][0]), float(full[3].initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(r1[3][1]), float(full[3].final_cost), rtol=1e-2)
    assert abs(int(r1[3][4]) - int(full[3].iterations)) <= 2
    assert bool(r1[3][5] > 0.5) == bool(full[3].accepted)
    assert all(bool(torch.isfinite(x).all()) for x in r1[:3])


@pytest.mark.cuda
def test_window_kernel_past_twelve_slots_matches_plain_on_the_card(card):
    """Each observation in 3 slots (D = 15 over 5 cameras, a keyframe seeing
    a point through several keypoints): one launch, the plain version's
    final cost within 1 %."""
    w = repeat_slots(synthetic_window(13, C=5, n_pts=6000, P=8192), 3, 13)
    g = BAProblemGrid(**{k: torch.as_tensor(v, device=card) for k, v in w.items()})
    assert g.cam_slot.shape == (8192, 15) and ba_kernel.kernel_eligible(g, 2)
    before = kernels.LAUNCHES[ba_kernel.NAME]
    a = ba_kernel.lm_solve(g, n_fixed=2)
    b = ba_kernel.lm_solve_plain(g, n_fixed=2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[ba_kernel.NAME] == before + 1
    np.testing.assert_allclose(_costs(a[3])[:2], _costs(b[3])[:2], rtol=1e-2)
    assert abs(int(a[3].iterations) - int(b[3].iterations)) <= 2
    assert all(bool(torch.isfinite(x).all()) for x in a[:3])


@pytest.mark.cuda
def test_window_kernel_holds_to_its_plain_version_along_its_path_on_the_card(card):
    """K3 along its own float32 LM path on the committed windows of the long
    drive (``tests/data/torch_wide_windows.npz``, live points only;
    ``stress.float32_path``), rule (a) of ``stress.window_rule``: from
    every state its plain version's one LM iteration ends within
    ``stress.FLOAT32_REL``, and over all their states K3 ends above (or
    below) it on no larger share than ``stress.share_p`` allows at
    ``stress.SIGN_LEVEL``; one launch per state (rule (a)'s walk alone: rule
    (d)'s witness launches K3 once more on a state to cost its trial)."""
    from bundle_adjustment_tpu_torch.tools import stress

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_wide_windows.npz")
    kw = dict(max_iterations=50, huber_delta=1.0, lambda_init=1e-3, lambda_up=4.0,
              lambda_down=0.5, lambda_min=1e-10, lambda_max=1e8, ftol=1e-5, xtol=1e-5)
    with np.load(path) as z:
        names = sorted({k.split("/")[0] for k in z.files})
        windows = [(BAProblemGrid(**{k: torch.as_tensor(z[f"{n}/{k}"], device=card)
                                     for k in BAProblemGrid._fields}),
                    int(z[f"{n}/n_fixed"])) for n in names]
    higher = lower = 0
    for name, (g, n_fixed) in zip(names, windows):
        before = kernels.LAUNCHES[ba_kernel.NAME]
        s = stress.float32_path(g, dict(kw, n_fixed=n_fixed), witness=False)
        print(name, s)
        assert kernels.LAUNCHES[ba_kernel.NAME] == before + s["states"]
        assert s["worst"] <= stress.FLOAT32_REL, (name, s)
        higher, lower = higher + s["higher"], lower + s["lower"]
    assert stress.share_p(higher, lower) >= stress.SIGN_LEVEL, (higher, lower)


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
    # lane 7: the ops/ba.STOP_TESTS code of the test that ended the loop
    # (0 the cap, 1 ftol, 2 xtol, 3 stuck)
    assert stats[5] == 1.0 and 1e-10 <= stats[6] <= 1e8
    assert stats[7] in ((1.0, 2.0, 3.0) if stats[4] < 50 else (0.0, 1.0, 2.0))
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


# K4: C, n_pts, P, n_fixed.  The first is the size the global path runs at
# (200 keyframes, 30,000 points, bucketed to 32,768); the second is ragged.
K4_SHAPES = [(200, 30000, 32768, 2), (37, 1531, 1777, 1)]
RED_GROUP_TOL = 1e-4      # each scale group of the setup reduction (module docstring)
_K4_IDS = [f"C{c}P{p}" for c, _, p, _ in K4_SHAPES]


def _k4_inputs(card, shape, seed=21):
    C, n_pts, P, n_fixed = shape
    g = _global_grid(card, seed, C, n_pts, P, drop=0.15 if P % 128 else 0.0)
    lay = gk.layout(g)
    index = gk.camera_index(lay.slotT, lay.maskT, C, n_fixed)
    ptT = g.points.T.contiguous()
    x = torch.as_tensor(np.random.default_rng(seed).normal(0, 1e-2, (C - n_fixed, 6))
                        .astype(np.float32), device=card)
    return g, lay, index, ptT, x, n_fixed


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K4_SHAPES, ids=_K4_IDS)
def test_global_roles_match_plain_on_the_card(card, shape):
    g, lay, index, ptT, x, n_fixed = _k4_inputs(card, shape)
    scal = gk.with_lambda(lay.scal, 1e-3)
    cam = gk.camera_rows(g.rvecs, g.tvecs, True)
    before = dict(kernels.LAUNCHES)
    k = gk.setup(cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask, scal, n_fixed, index)
    p = gk.setup_plain(cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask, scal, n_fixed)
    torch.cuda.synchronize()
    for name, a, b, tol in zip(("Y", "Vinv", "zp", "red"), k, p, (2e-3, 1e-3, 1e-3, 1e-4)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= tol, (name, _rel(a, b))
    # Y's rotation and translation rows, and the ten groups of the reduction
    # (blocks split into rotation and translation lanes), each on its own scale
    D = lay.slotT.shape[0]
    for rows in (slice(0, 3), slice(3, 6)):
        assert _rel(k[0].reshape(D, 6, 3, -1)[:, rows],
                    p[0].reshape(D, 6, 3, -1)[:, rows]) <= 2e-3, rows
    for name, lanes in gk.red_lane_groups().items():
        assert _rel(k[3][:, lanes], p[3][:, lanes]) <= RED_GROUP_TOL, \
            (name, _rel(k[3][:, lanes], p[3][:, lanes]))
    YT, VinvT, zpT, _ = p
    a = gk.matvec(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed, index)
    b = gk.matvec_plain(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed)
    assert _rel(a[:, :3], b[:, :3]) <= 2e-5 and _rel(a[:, 3:], b[:, 3:]) <= 2e-5
    a = gk.backsub(YT, VinvT, zpT, lay.slotT, lay.maskT, x, n_fixed, index)
    assert _rel(a, gk.backsub_plain(YT, VinvT, zpT, lay.slotT, lay.maskT, x, n_fixed)) <= 2e-4
    camc = gk.camera_rows(g.rvecs, g.tvecs, False)
    a = gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal, index)
    b = gk.cost_plain(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal)
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5)
    for name in (gk.SETUP, gk.MATVEC, gk.BACKSUB, gk.COST):
        assert kernels.LAUNCHES[name] == before[name] + 1, name
    # padding points: V^-1 and z_p are zero, so they cannot move
    n_pts = shape[1]
    assert not k[1][:, n_pts:].any() and not k[2][:, n_pts:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K4_SHAPES, ids=_K4_IDS)
def test_global_solve_matches_plain_on_the_card(card, shape):
    C, n_pts, P, n_fixed = shape
    g = _global_grid(card, 22, C, n_pts, P, drop=0.15 if P % 128 else 0.0)
    before = dict(kernels.LAUNCHES)
    a = gk.solve(g, n_fixed=n_fixed, max_iterations=12)
    b = gk.solve_plain(g, n_fixed=n_fixed, max_iterations=12)
    torch.cuda.synchronize()
    np.testing.assert_allclose(float(a[3].initial_cost), float(b[3].initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(a[3].final_cost), float(b[3].final_cost), rtol=1e-2)
    np.testing.assert_allclose(float(a[3].final_sq), float(b[3].final_sq), rtol=1e-2)
    assert abs(int(a[3].iterations) - int(b[3].iterations)) <= 2
    assert bool(a[3].accepted) and float(a[3].final_cost) < 0.5 * float(a[3].initial_cost)
    assert all(bool(torch.isfinite(x).all()) for x in a[:3])
    assert torch.equal(a[0][:n_fixed], g.rvecs[:n_fixed])
    assert torch.equal(a[2][n_pts:], g.points[n_pts:])
    # the launches of the graph's replays are counted: CG runs to its cap
    # of 8 with its updates masked after the stop
    its = int(a[3].iterations)
    assert kernels.LAUNCHES[gk.SETUP] == before[gk.SETUP] + its
    assert kernels.LAUNCHES[gk.BACKSUB] == before[gk.BACKSUB] + its
    assert kernels.LAUNCHES[gk.COST] == before[gk.COST] + its + 2
    assert kernels.LAUNCHES[gk.MATVEC] - before[gk.MATVEC] == 8 * its
    assert kernels.LAUNCHES[ba_kernel.NAME] == before[ba_kernel.NAME]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [14, 54, 91])
def test_global_solve_past_twelve_slots_matches_plain_on_the_card(card, D):
    """A ring of 96 cameras around 1000 points, each seen by D of them (the
    long drive's slot counts): the kernels' solve within 1 % of the plain
    versions' on the card, its launches counted, two solves bit-equal; the
    pipeline's global BA of the same map takes the kernels."""
    pr = synthetic_ring_problem(3, C=96, P=1000, D=D)
    g = from_flat(BAProblem(**{k: torch.as_tensor(v, device=card) for k, v in pr.items()}))
    assert g.cam_slot.shape == (1000, D)
    before = dict(kernels.LAUNCHES)
    a = gk.solve(g, n_fixed=1)
    a2 = gk.solve(g, n_fixed=1)
    b = gk.solve_plain(g, n_fixed=1)
    torch.cuda.synchronize()
    np.testing.assert_allclose(float(a[3].final_cost), float(b[3].final_cost), rtol=1e-2)
    assert abs(int(a[3].iterations) - int(b[3].iterations)) <= 2
    assert float(a[3].final_cost) < 0.1 * float(a[3].initial_cost)
    assert kernels.LAUNCHES[gk.SETUP] == before[gk.SETUP] + 2 * int(a[3].iterations)
    for x, y in zip(a[:3] + tuple(a[3]), a2[:3] + tuple(a2[3])):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_global_kernels_are_deterministic(card):
    g, lay, index, ptT, x, n_fixed = _k4_inputs(card, K4_SHAPES[0])
    scal = gk.with_lambda(lay.scal, 1e-3)
    cam = gk.camera_rows(g.rvecs, g.tvecs, True)
    runs = []
    for _ in range(2):     # every role's output is the index's: clone it
        s = gk.setup(cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask, scal, n_fixed, index)
        runs.append(tuple(t.clone() for t in s + (
            gk.matvec(s[0], s[1], lay.slotT, lay.maskT, x, n_fixed, index),
            gk.backsub(s[0], s[1], s[2], lay.slotT, lay.maskT, x, n_fixed, index),
            gk.cost(gk.camera_rows(g.rvecs, g.tvecs, False), ptT, lay.slotT, lay.maskT,
                    lay.uvT, lay.scal, index))))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    a = gk.solve(g, n_fixed=n_fixed, max_iterations=6)
    b = gk.solve(g, n_fixed=n_fixed, max_iterations=6)
    for x1, x2 in zip(a[:3] + tuple(a[3]), b[:3] + tuple(b[3])):
        assert torch.equal(x1, x2)


@pytest.mark.cuda
def test_grid_pcg_solver_is_deterministic_on_the_card(card):
    """The plain grid PCG solver, which the pipeline takes on the card when
    ``cg_precond_group`` is above 1: its camera sums are float32 one-hot
    products, so two solves give equal bits, and it agrees with its own run
    on the CPU (initial cost 1e-5, final cost 1 %, iterations within 2: the
    tolerances of the kernels' whole solve).  It launches no kernel."""
    g = _global_grid(card, 25, 37, 1531, 1777, drop=0.15)
    before = dict(kernels.LAUNCHES)
    opts = dict(n_fixed=2, max_iterations=12, cg_iters=8, cg_forcing=True, cg_precond_group=4)
    a = ba_solve_grid_impl(g, **opts)
    b = ba_solve_grid_impl(g, **opts)
    c = ba_solve_grid_impl(BAProblemGrid(*(t.cpu() for t in g)), **opts)
    torch.cuda.synchronize()
    for x1, x2 in zip(a[:3] + tuple(a[3]), b[:3] + tuple(b[3])):
        assert torch.equal(x1, x2)
    assert all(bool(torch.isfinite(x).all()) for x in a[:3])
    assert bool(a[3].accepted) and float(a[3].final_cost) < 0.5 * float(a[3].initial_cost)
    np.testing.assert_allclose(float(a[3].initial_cost), float(c[3].initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(a[3].final_cost), float(c[3].final_cost), rtol=1e-2)
    assert abs(int(a[3].iterations) - int(c[3].iterations)) <= 2
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4])
def test_pipeline_says_when_a_card_window_skips_the_global_kernels(card, group):
    """A window above ``pcg_min_cameras`` on the card goes through the four
    kernels and leaves no ``pcg_plain_solver`` event; with the grouped
    preconditioner it takes the plain grid PCG solver, says so in one event
    per solve, and launches none of them."""
    gmap, K = synthetic_global_map(0, C=31, P=800, device="cuda")
    cam = CameraModel(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                      cy=float(K[1, 2]), width=1280, height=720)
    cfg = PipelineConfig(camera=cam, ba=BAConfig(cg_precond_group=group, max_iterations=6))
    pipe = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device="cuda")
    gmap.log = pipe.log
    pipe.map = gmap
    before = dict(kernels.LAUNCHES)
    out = pipe.run_global_ba()
    assert out["n_cams"] == 30 and not out["diverged"]
    assert np.isfinite(out["final"]) and out["final"] < 0.5 * out["initial"]
    said = [e for e in pipe.log.events if e["event"] == "pcg_plain_solver"]
    if group == 1:
        assert not said and kernels.LAUNCHES[gk.SETUP] == before[gk.SETUP] + out["iterations"]
    else:
        assert len(said) == 1 and said[0]["why"] == "cg_precond_group=4"
        assert said[0]["solver"] == "grid PCG solver" and kernels.LAUNCHES == before


@pytest.mark.cuda
def test_global_kernels_ignore_junk_in_dead_slots(card):
    """Observations behind their camera are dead slots; junk in their camera
    index and pixels changes no bit, and no index is read out of range."""
    g = _global_grid(card, 23, 37, 1531, 1777, drop=0.15)
    dead = g.mask == 0
    assert int(dead[:1531].sum()) > 100
    junk = g._replace(cam_slot=torch.where(dead, torch.full_like(g.cam_slot, 10 ** 6), g.cam_slot),
                      uv=torch.where(dead[..., None], torch.full_like(g.uv, 1e4), g.uv))
    junk.cam_slot[1700:] = -7
    a = gk.solve(g, n_fixed=2, max_iterations=5)
    b = gk.solve(junk, n_fixed=2, max_iterations=5)
    for x1, x2 in zip(a[:3] + tuple(a[3]), b[:3] + tuple(b[3])):
        assert torch.equal(x1, x2)


@pytest.mark.cuda
def test_global_kernels_freeze_a_point_on_a_camera_centre(card):
    pr = synthetic_global_problem(24, C=12, P=600)
    centre = -so3_exp_np(pr["rvecs"][5].astype(np.float64)).T @ pr["tvecs"][5]
    first = int(np.flatnonzero(pr["cam_idx"] == 5)[0])
    pid = int(pr["pnt_idx"][first])
    pr["points"][pid] = (centre + [1e-7, -1e-7, 2e-7]).astype(np.float32)
    pr["obs_mask"][:] = 1.0
    g = from_flat(BAProblem(**{k: torch.as_tensor(v, device=card) for k, v in pr.items()}))
    for iters in (1, 30):
        a = gk.solve(g, n_fixed=1, max_iterations=iters)
        assert all(bool(torch.isfinite(x).all()) for x in a[:3])
        assert np.isfinite(_costs(a[3])).all()


@pytest.mark.cuda
def test_global_wrappers_check_what_the_kernels_do_not_take(card):
    g, lay, index, ptT, _, n_fixed = _k4_inputs(card, K4_SHAPES[1])
    cam = gk.camera_rows(g.rvecs, g.tvecs, True)
    args = (cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask, lay.scal, n_fixed)
    with pytest.raises(ValueError, match="index"):
        gk.setup(*args)
    with pytest.raises(ValueError, match="slotT"):
        gk.setup(cam, ptT, lay.slotT.long(), *args[3:], index)
    with pytest.raises(ValueError, match="ptT"):
        gk.setup(cam, g.points, *args[2:], index)
    with pytest.raises(ValueError, match="devices"):
        gk.setup(cam.cpu(), *args[1:], index)
    with pytest.raises(ValueError, match="gate"):
        gk.setup(*args[:7], 37, index)


# K4's tile plan at its edges: C, n_pts, P, n_fixed, a camera whose
# observations are all dead.  With C = 4 every camera sees every point, so at
# n_fixed = C - 1 the one adjustable camera spans all the tiles; the third has
# a camera without pairs in the middle and the last camera, which no point
# reaches; none has a pair count that is a multiple of the tile.
K4_EDGES = [(4, 20000, 20480, 1, None), (4, 20000, 20480, 3, None),
            (37, 1531, 1777, 1, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", K4_EDGES,
                         ids=[f"C{c}P{p}n_fixed{n}" for c, _, p, n, _ in K4_EDGES])
def test_global_tile_edges_match_plain_on_the_card(card, edge):
    C, n_pts, P, n_fixed, no_pairs = edge
    g = _global_grid(card, 26, C, n_pts, P, drop=0.15 if P % 128 else 0.0)
    if no_pairs is not None:
        g = g._replace(mask=torch.where(g.cam_slot == no_pairs, torch.zeros_like(g.mask), g.mask))
    lay = gk.layout(g)
    index = gk.camera_index(lay.slotT, lay.maskT, C, n_fixed)
    n_tiles = index.tile_seg.shape[0] - 1
    assert int(index.offsets[-1]) % gk.PAIR_TILE != 0
    if n_fixed == C - 1:
        assert index.cam_seg.tolist() == [0, n_tiles] and n_tiles > 1
    empty = [a for a in range(C - n_fixed) if index.cam_seg[a] == index.cam_seg[a + 1]]
    if no_pairs is not None:
        assert no_pairs - n_fixed in empty and C - 1 - n_fixed in empty
    ptT = g.points.T.contiguous()
    scal = gk.with_lambda(lay.scal, 1e-3)
    cam = gk.camera_rows(g.rvecs, g.tvecs, True)
    x = torch.as_tensor(np.random.default_rng(C).normal(0, 1e-2, (C - n_fixed, 6))
                        .astype(np.float32), device=card)
    k = tuple(t.clone() for t in gk.setup(cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask,
                                           scal, n_fixed, index))
    p = gk.setup_plain(cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask, scal, n_fixed)
    torch.cuda.synchronize()
    D = lay.slotT.shape[0]
    for rows in (slice(0, 3), slice(3, 6)):
        assert _rel(k[0].reshape(D, 6, 3, -1)[:, rows],
                    p[0].reshape(D, 6, 3, -1)[:, rows]) <= 2e-3, rows
    assert _rel(k[1], p[1]) <= 1e-3 and _rel(k[2], p[2]) <= 1e-3
    for name, lanes in gk.red_lane_groups().items():
        assert _rel(k[3][:, lanes], p[3][:, lanes]) <= RED_GROUP_TOL, \
            (name, _rel(k[3][:, lanes], p[3][:, lanes]))
    a = gk.matvec(p[0], p[1], lay.slotT, lay.maskT, x, n_fixed, index).clone()
    b = gk.matvec_plain(p[0], p[1], lay.slotT, lay.maskT, x, n_fixed)
    assert _rel(a[:, :3], b[:, :3]) <= 2e-5 and _rel(a[:, 3:], b[:, 3:]) <= 2e-5
    # a camera without pairs: exact zeros
    for e in empty:
        assert not k[3][e].any() and not a[e].any()
    # repeat launches: equal bits
    k2 = gk.setup(cam, ptT, lay.slotT, lay.maskT, lay.uvT, lay.pmask, scal, n_fixed, index)
    a2 = gk.matvec(p[0], p[1], lay.slotT, lay.maskT, x, n_fixed, index)
    torch.cuda.synchronize()
    for u, v in zip(k + (a,), k2 + (a2,)):
        assert torch.equal(u, v)
    assert not index.ticket.any()          # every counter is back at 0


@pytest.mark.cuda
def test_global_matvec_is_one_call_and_allocates_nothing(card):
    """A CG iteration's matvec: one launch counted, no allocation (the
    result is the index's scratch), and the kernels' tile CTA is the one
    ``tiled_camera_sum`` assumes."""
    g, lay, index, ptT, x, n_fixed = _k4_inputs(card, K4_SHAPES[0])
    YT, VinvT, _, _ = gk.setup(gk.camera_rows(g.rvecs, g.tvecs, True), ptT, lay.slotT, lay.maskT,
                               lay.uvT, lay.pmask, gk.with_lambda(lay.scal, 1e-3), n_fixed, index)
    gk.matvec(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed, index)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES[gk.MATVEC]
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = gk.matvec(YT, VinvT, lay.slotT, lay.maskT, x, n_fixed, index)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocated
    assert kernels.LAUNCHES[gk.MATVEC] == launches + 1
    assert out.data_ptr() == index.out.data_ptr()
    assert kernels.library_const(gk.SETUP, "ba_global_tile_threads") == gk.TILE_THREADS


def _cost_case(card, C, n_pts, P, drop, seed=27):
    g = _global_grid(card, seed, C, n_pts, P, drop=drop)
    lay = gk.layout(g)
    index = gk.camera_index(lay.slotT, lay.maskT, C, 1)
    camc = gk.camera_rows(g.rvecs, g.tvecs, False)
    return g, lay, index, camc, g.points.T.contiguous()


# the cost's shapes: the global path's; pair counts that are not a multiple of
# a CTA's 512 pairs, with dead slots, on 37 cameras and on a chain of 1,100
# (a camera table of 52.8 KB)
K4D_SHAPES = [(200, 30000, 32768, 0.0), (37, 1531, 1777, 0.15), (1100, 3000, 3001, 0.15)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K4D_SHAPES, ids=[f"C{c}P{p}" for c, _, p, _ in K4D_SHAPES])
def test_global_cost_matches_plain_and_repeats_its_bits(card, shape):
    """K4d: within 1e-5 of ``cost_plain`` (relative), equal bits on repeat,
    its counter back at 0; all slots dead: exact zeros."""
    g, lay, index, camc, ptT = _cost_case(card, *shape)
    assert (shape[2] * 4) % gk.COST_PAIRS_PER_BLOCK != 0 or shape[0] == 200
    a = gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal, index).clone()
    b = gk.cost_plain(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal)
    again = gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal, index).clone()
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5)
    assert torch.equal(a, again) and not index.cost_ticket.any()
    dead = gk.cost(camc, ptT, lay.slotT, torch.zeros_like(lay.maskT), lay.uvT, lay.scal, index)
    torch.cuda.synchronize()
    assert not dead.any()


@pytest.mark.cuda
def test_global_cost_is_one_launch_and_allocates_nothing(card):
    g, lay, index, camc, ptT = _cost_case(card, 200, 30000, 32768, 0.0)
    gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal, index)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES[gk.COST]
    stats = torch.cuda.memory_stats()
    out = gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal, index)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == stats["allocation.all.allocated"]
    assert torch.cuda.memory_allocated() == stats["allocated_bytes.all.current"]
    assert kernels.LAUNCHES[gk.COST] == launches + 1
    assert out.data_ptr() == index.cost_out.data_ptr()
    assert kernels.library_const(gk.COST, "ba_global_cost_pairs_per_block") \
        == gk.COST_PAIRS_PER_BLOCK
    with pytest.raises(ValueError, match="index"):
        gk.cost(camc, ptT, lay.slotT, lay.maskT, lay.uvT, lay.scal)


def _lm(card, max_iterations=12):
    g = _global_grid(card, 28, 200, 30000, 32768)
    return gk.GlobalLM(g, n_fixed=2, max_iterations=max_iterations)


@pytest.mark.cuda
def test_one_graph_replay_equals_one_eager_body_bit_for_bit(card):
    """From one state, an eager call of the LM body with the kernels and one
    replay of its captured graph give the same state, bit for bit; the
    replay makes setup, backsub and cost one launch each and matvec
    ``cg_iters``."""
    lm = _lm(card)
    lm.warm_up()                               # loads every kernel
    torch.cuda.synchronize()
    start = {k: v.clone() for k, v in lm.state.items()}
    lm.body()
    eager = {k: v.clone() for k, v in lm.state.items()}
    for k, v in start.items():
        lm.state[k].copy_(v)
    graph, per_replay = lm.capture()
    assert per_replay == {gk.SETUP: 1, gk.MATVEC: 8, gk.BACKSUB: 1, gk.COST: 1}
    for k, v in lm.state.items():             # capturing ran nothing
        assert torch.equal(v, start[k]), k
    graph.replay()
    torch.cuda.synchronize()
    for k, v in lm.state.items():
        assert torch.equal(v, eager[k]), k
    assert not torch.equal(eager["rv"], start["rv"])


@pytest.mark.cuda
def test_a_replayed_lm_iteration_allocates_nothing(card):
    lm = _lm(card)
    lm.warm_up()
    graph, _ = lm.capture()
    graph.replay()
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == stats["allocation.all.allocated"]
    assert torch.cuda.memory_allocated() == stats["allocated_bytes.all.current"]


@pytest.mark.cuda
def test_a_global_solve_reads_the_host_once_per_lm_iteration(card):
    """The solve's record: its host reads (``camera_index`` and the stop flag
    after each iteration), graph replays (every iteration after the first)
    and live CG iterations."""
    g = _global_grid(card, 28, 200, 30000, 32768)
    gk.SOLVES.clear()
    before = dict(kernels.LAUNCHES)
    out = gk.solve(g, n_fixed=2, max_iterations=12)
    rec = gk.SOLVES[-1]
    its = int(out[3].iterations)
    assert its > 2 and rec["lm_iterations"] == its
    assert rec["host_reads"] == its + gk.HOST_READS_OUTSIDE_LOOP
    assert rec["graph_replays"] == its - 1
    assert its <= int(rec["cg_iterations"]) <= 8 * its
    assert kernels.LAUNCHES[gk.SETUP] - before[gk.SETUP] == its


def _bit_equal(a, b):
    """Equal bits, NaNs included (the packed medians are NaN on an empty
    subset)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _track_pipeline(card):
    """A pipeline at 320x240 on the card, its first frame (the first
    keyframe) processed, and its frames."""
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_sequence

    frames, K, _, _ = synthetic_sequence(n_frames=12, width=320, height=240, fx=300.0, seed=3)
    cfg = PipelineConfig(camera=CameraModel(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                                            width=320, height=240),
                         num_features=500, pyramid_levels=3)
    pipe = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device=card)
    pipe.process_frame(frames[0])
    return pipe, frames


def _eager_step(pipe, shape):
    """``track_step`` eagerly on the step's static buffers, as they stand."""
    from bundle_adjustment_tpu_torch.models import frontend
    from bundle_adjustment_tpu_torch.ops import ransac

    t = pipe.track
    return frontend.track_step(t._images[shape], t.state, t._K,
                               t.u_buffer(ransac.pnp_draw_shape(pipe.cfg.pnp_iters)),
                               **pipe.track_args(*shape))


@pytest.mark.cuda
def test_track_step_replay_equals_eager_over_frames_and_a_state_change(card):
    """Three frames through the tracked-frame step's graph, the static state
    replaced by another keyframe's before the third: each replay's outputs
    equal, bit for bit, eager ``track_step`` on the same static inputs; one
    capture, one replay per frame, and the replay's K1 and K2 launches
    counted (one 2-NN, one gather per pyramid level; the first frame's
    eager warm-up before the capture launches them once more)."""
    from bundle_adjustment_tpu_torch.models import frontend
    from bundle_adjustment_tpu_torch.models.pipeline import bgr_to_gray

    pipe, frames = _track_pipeline(card)
    for i in (1, 2, 3):
        if i == 3:
            kp = pipe.track.state
            pipe.track.load_state(frontend.FrontendState(
                desc=res.kp_desc, xy=res.kp_xy, kp_valid=res.kp_valid,
                pts3d=kp.pts3d.flip(0) + 0.5, tracked=kp.tracked.flip(0),
                rvec=torch.full((3,), 0.01, device=card), tvec=torch.zeros(3, device=card)))
        gray = bgr_to_gray(frames[i])
        before = dict(kernels.LAUNCHES)
        res = pipe._fused_dispatch(gray, i)
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        eager = _eager_step(pipe, gray.shape)
        torch.cuda.synchronize()
        for name, a, b in zip(res._fields, res, eager):
            assert _bit_equal(a, b), (i, name)
        per_replay = {hamming_kernel.NAME: 1, orb_kernel.NAME: 3}
        assert pipe.track.captures[0]["launches_per_replay"] == per_replay
        for name, k in per_replay.items():
            assert launched[name] == (2 * k if i == 1 else k), (i, name)
    assert len(pipe.track.captures) == 1 and pipe.track.replays == 3


@pytest.mark.cuda
def test_track_step_outputs_outlive_the_next_replay(card):
    """What a replay returned is the caller's own: the next replay leaves it
    as it was, and a keyframe keeps the descriptors it was given while
    later frames replay the graph."""
    from bundle_adjustment_tpu_torch.models.pipeline import bgr_to_gray

    pipe, frames = _track_pipeline(card)
    first = pipe._fused_dispatch(bgr_to_gray(frames[1]), 1)
    kept = [t.clone() for t in first]
    second = pipe._fused_dispatch(bgr_to_gray(frames[2]), 2)
    torch.cuda.synchronize()
    for name, a, b in zip(first._fields, first, kept):
        assert _bit_equal(a, b), name
    assert not torch.equal(first.kp_desc, second.kp_desc)
    kf_desc = {k: (kf.desc, kf.desc.clone()) for k, kf in pipe.map.keyframes.items()}
    for f in frames[1:8]:
        pipe.process_frame(f)
    torch.cuda.synchronize()
    assert pipe.map.num_keyframes > 1 and pipe.track.replays >= 7
    for k, kf in pipe.map.keyframes.items():
        kf_desc.setdefault(k, (kf.desc, kf.desc.clone()))
    pipe._fused_dispatch(bgr_to_gray(frames[8]), 8)
    torch.cuda.synchronize()
    for k, (desc, copy) in kf_desc.items():
        assert torch.equal(desc, copy), k


def _small_batch(card, shape, seed):
    """A batch of the tracked-frame step's small matrices: the DLT's and the
    triangulation's normal matrices of random rows, the pose's 3x3 M; the
    first one exactly zero."""
    B, rows, n = {"dlt": (128, 12, 12), "triangulation": (4000, 4, 4),
                  "pose": (128, 3, 3)}[shape]
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, rows, n, generator=g)
    A[0] = 0.0
    return (A if shape == "pose" else A.transpose(-1, -2) @ A).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["dlt", "triangulation", "pose"])
def test_small_linalg_is_torch_linalg_on_the_card_and_replays(card, shape):
    """``small_linalg.eigh`` (DLT, triangulation) and ``small_linalg.svd``
    (pose) give ``torch.linalg``'s bits on the card, and a CUDA graph of
    them, replayed on new inputs, gives the eager call's."""
    from bundle_adjustment_tpu_torch.ops import small_linalg

    ours, theirs = ((small_linalg.svd, torch.linalg.svd) if shape == "pose"
                    else (small_linalg.eigh, torch.linalg.eigh))
    A = _small_batch(card, shape, 0)
    for a, b in zip(ours(A), theirs(A)):
        assert _bit_equal(a.contiguous(), b.contiguous())
    static = A.clone()
    kernels.on_side_stream(card, lambda: ours(static))
    graph, out, _ = kernels.capture(card, lambda: ours(static))
    for seed in (1, 2):
        static.copy_(_small_batch(card, shape, seed))
        graph.replay()
        eager = theirs(static)
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert _bit_equal(a.contiguous(), b.contiguous())


@pytest.mark.cuda
def test_the_null_vector_correction_on_the_card_reaches_lapacks_residual(card):
    """cuSOLVER's null vectors on the card, corrected by
    ``small_linalg.refine_null_vector``, on the committed samples of a long
    drive (``tests/data/torch_dlt_samples.npz``, ``test_torch_dlt``): their
    residuals on the exact normal matrices at the 50th, 90th and 99th
    percentiles at most twice LAPACK's float32 ones on the CPU (the JAX
    package's reference), and a CUDA graph of them replays the eager call's
    bits.  cuSOLVER's own (the "cuSOLVER eigh" routing, the card's before
    it took the SVD of A) miss this: 9.37e-8, 5.28e-7 and 9.01e-7 against
    LAPACK's 1.39e-8, 7.59e-8 and 1.49e-7 (NVIDIA H100 80GB HBM3, 700.00 W;
    PERF.md section 5).  A study route: the shipped vectors are held by
    ``test_dlt_null_vectors_on_the_card_are_as_accurate_as_lapacks``."""
    from bundle_adjustment_tpu_torch.ops import ransac, small_linalg

    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                             "torch_dlt_samples.npz"))
    X, x = torch.tensor(d["X"]), torch.tensor(d["x"])
    qs = (0.5, 0.9, 0.99)

    def quantiles(P):
        r = ransac.dlt_residual(X, x, P).double()
        return [float(torch.quantile(r, q)) for q in qs]

    N = ransac._dlt_normal(X.to(card), x.to(card))

    def corrected():
        return small_linalg.refine_null_vector(N, small_linalg.eigh(N)[1])

    got = quantiles(corrected())
    want = quantiles(ransac._dlt_projection(X, x))
    assert all(a <= 2 * b for a, b in zip(got, want)), (got, want)
    eager = corrected()
    kernels.on_side_stream(card, corrected)
    graph, out, _ = kernels.capture(card, corrected)
    graph.replay()
    torch.cuda.synchronize()
    assert _bit_equal(out, eager)


@pytest.mark.cuda
def test_dlt_null_vectors_on_the_card_are_as_accurate_as_lapacks(card):
    """The card's shipped PnP DLT null vectors (``ransac._dlt_projection`` on
    CUDA tensors: the SVD of A, cuSOLVER's gesvdj) on the committed samples
    of a long drive (``tests/data/torch_dlt_samples.npz``): their residuals
    |N p| / |N| on the exact normal matrices at most twice LAPACK's float32
    eigh's on the CPU (the JAX package's reference) at the 50th, 90th and
    99th percentiles, and the sine of their angle to the float64 null
    vector of the same float32 system at most 1e-4 in the median; a CUDA
    graph of them replays the eager call's bits.  cuSOLVER's eigh of A^T A,
    which the card took before, fails both: 6.73, 6.96 and 6.05 times
    LAPACK's residuals, a median sine of 0.293 (NVIDIA H100 80GB HBM3,
    700.00 W; PERF.md section 5)."""
    from bundle_adjustment_tpu_torch.ops import ransac

    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                             "torch_dlt_samples.npz"))
    X, x = torch.tensor(d["X"]), torch.tensor(d["x"])
    Xc, xc = X.to(card), x.to(card)
    qs = (0.5, 0.9, 0.99)

    def residuals(P):
        r = ransac.dlt_residual(X, x, P).double()
        return [float(torch.quantile(r, q)) for q in qs]

    def shipped():
        return ransac._dlt_projection(Xc, xc)

    eager = shipped()
    got, want = residuals(eager), residuals(ransac._dlt_projection(X, x))
    assert all(a <= 2 * b for a, b in zip(got, want)), (got, want)
    exact = torch.linalg.svd(ransac._dlt_rows(X, x).double())[2][..., -1, :]
    p = eager.double().cpu().reshape(exact.shape)
    cos = torch.abs(torch.sum(p * exact, -1)) / torch.linalg.norm(p, dim=-1)
    sine = torch.sqrt(torch.clamp(1 - cos * cos, min=0))
    assert float(torch.quantile(sine, 0.5)) <= 1e-4, float(torch.quantile(sine, 0.5))
    kernels.on_side_stream(card, shipped)
    graph, out, _ = kernels.capture(card, shipped)
    graph.replay()
    torch.cuda.synchronize()
    assert _bit_equal(out, eager)


@pytest.mark.cuda
def test_ann_bank_search_on_the_card_equals_the_cpu(card):
    """The coarse-to-fine bank search (plain PyTorch, ``ops/ann.py``) on the
    card at a relocalization bank's shape (4000 queries, 32,000
    descriptors, coarse ties in 50 groups): indices and distances equal to
    the CPU's exactly, in one block and in chunks of queries."""
    from bundle_adjustment_tpu_torch.ops import ann

    rng = np.random.default_rng(11)
    bank = rng.integers(0, 2 ** 32, size=(32000, 8), dtype=np.uint64).astype(np.uint32)
    bank[:, :2] = bank[rng.integers(0, 50, len(bank))][:, :2]
    q = bank[rng.integers(0, len(bank), 4000)].copy()
    q[:, 5] ^= rng.integers(0, 2 ** 32, len(q), dtype=np.uint64).astype(np.uint32)
    valid = torch.as_tensor(rng.random(len(bank)) > 0.2)
    qt, bt = torch.as_tensor(q.view(np.int32)), torch.as_tensor(bank.view(np.int32))
    want = ann.knn2_coarse_fine(qt, bt, valid)
    default = ann.MAX_BLOCK
    try:
        for block in (default, 32000 * 300):
            ann.MAX_BLOCK = block
            got = ann.knn2_coarse_fine(qt.to(card), bt.to(card), valid.to(card))
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
    finally:
        ann.MAX_BLOCK = default


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [16384, 0], ids=["k1", "ann"])
def test_relocalization_on_the_card(card, threshold):
    """A pipeline on the card over 6 frames, then a forced relocalization of
    the view of the keyframe with the most map points (as ``chip_smoke.py``
    phase 11 (c) picks its targets): it succeeds; the bank search launches
    K1 once when the bank is at most ``reloc_ann_threshold`` descriptors and
    not at all through the coarse-to-fine search.  Which of frames 1-5
    become keyframes follows the PnP's DLT solver (the JAX package
    discards frame 4, the port on the CPU frames 3 and 4), so the view is
    read from the map, not named."""
    import dataclasses

    from bundle_adjustment_tpu_torch.models.pipeline import bgr_to_gray
    from bundle_adjustment_tpu_torch.models.relocalize import try_relocalize

    pipe, frames = _track_pipeline(card)
    for f in frames[1:6]:
        pipe.process_frame(f)
    assert pipe.map.num_keyframes >= 3
    best = max(pipe.map.sorted_kf_ids(),
               key=lambda k: int((pipe.map.keyframes[k].kp_to_mp >= 0).sum()))
    target = pipe.map.keyframes[best].frame_idx
    pipe.cfg = dataclasses.replace(pipe.cfg, reloc_enabled=True, reloc_ann_threshold=threshold)
    pipe.frame_idx += 1
    kp = pipe._extract(bgr_to_gray(frames[target]))
    n_kf = pipe.map.num_keyframes
    before = kernels.LAUNCHES[hamming_kernel.NAME]
    r = try_relocalize(pipe, frames[target], kp)
    assert r is not None and r["status"] == "relocalized" and r["inliers"] > 15
    assert kernels.LAUNCHES[hamming_kernel.NAME] - before == (1 if threshold else 0)
    assert pipe.map.num_keyframes == n_kf + 1
    kf = pipe.map.keyframes[r["kf_id"]]
    assert np.isfinite(kf.R).all() and np.isfinite(kf.t).all() and kf.desc.is_cuda


@pytest.mark.cuda
def test_the_native_mirror_on_a_card_map(card):
    """The C++ mirror of the observation table (the default ``Map``) gives
    the numpy table's windows, problems on the card included, on a map of
    60 keyframes and 6000 points."""
    m, K = synthetic_global_map(1, C=60, P=6000, device="cuda")
    assert m._native is not None
    ids = m.sorted_kf_ids()
    windows = [ids[i: i + 6] for i in range(0, 55, 5)] + [[k] for k in ids[::7]] + [ids]
    for w in windows:
        got = m.gather_window(w, K, 8192, 32768)
        mirror, m._native = m._native, None
        try:
            want = m.gather_window(w, K, 8192, 32768)
        finally:
            m._native = mirror
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[1], want[1])
        for k in want[0]._fields:
            assert getattr(got[0], k).device.type == "cuda"
            assert torch.equal(getattr(got[0], k), getattr(want[0], k)), k


@pytest.mark.cuda
def test_gloo_collectives_of_cuda_tensors_in_two_ranks(card):
    """Two ranks on one card take gloo (NCCL refuses two ranks on a device);
    gloo reduces and broadcasts CUDA tensors, and the exchange of parts
    gives their bits, a -0.0 included."""
    import torch_ranks
    from bundle_adjustment_tpu_torch.parallel.launch import run_ranks
    from bundle_adjustment_tpu_torch.parallel.mesh import backend_for

    if torch.cuda.device_count() == 1:
        assert backend_for("cuda", 2) == "gloo"
    res = run_ranks(torch_ranks.collectives_on_the_card, 2, device_type="cuda", timeout=120.0)
    want_z = np.array([[-0.0, 1.5, -2.25], [-0.0, 3.0, -4.5]], np.float32)
    for r in res:
        assert r["backend"] == backend_for("cuda", 2) and r["device"].startswith("cuda")
        np.testing.assert_array_equal(r["x"], 2 * np.arange(6) + 1)
        np.testing.assert_array_equal(r["y"], [2.0, 2.0, 2.0])
        assert r["z"].tobytes() == want_z.tobytes()
