"""The global-BA PCG kernels' plain versions and the LM solve around them
(``ops.ba_global_kernel``) against the JAX package, on the CPU: against the
XLA grid PCG solver's intermediates (``ba_grid._solve_step_pcg``), against
the Pallas setup kernel in interpret mode (run as the JAX package's own
``tests/test_ba_global_pallas.py`` runs it), and whole solves against
``ba_solve_global_pallas(interpret=True)`` and ``ba_grid.ba_solve_grid``.

Seeded band-visibility chains: 12 cameras, 600 points, 4 observations per
point; for the per-role tests a tenth of them dropped, so that live points
have dead slots.

Tolerances.  The JAX package holds its Pallas setup to its XLA step with
rtol 1e-2 and atol 1e-3 to 1e-2 and whole solves to 1 % of the final cost,
rotations 5e-3 and points 5e-2.  Here the per-role outputs are float32 sums
of the same terms in another order, held norm-wise (largest absolute
difference over largest absolute value) to 1e-4, V^-1 to 1e-3 (the
determinant cancels); whole solves are held to the JAX package's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.ops import ba as jba
from bundle_adjustment_tpu.ops import ba_global_pallas as jgp
from bundle_adjustment_tpu.ops import ba_grid as jbg
from bundle_adjustment_tpu_torch import convert, kernels
from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk
from bundle_adjustment_tpu_torch.ops import ba_grid as tbg
from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np
from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_problem

from test_ba_global_pallas import _setup_outputs_interp

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)

LAM, DELTA = 1e-3, 1.0
FREE = dict(max_iterations=15, ftol=0.0, xtol=0.0, lambda_max=1e30, cg_iters=8, cg_tol=1e-6,
            cg_forcing=True)


def _problem(seed=3, drop=0.1):
    return synthetic_global_problem(seed, C=12, P=600, centre_sigma=0.03, point_sigma=0.03,
                                    rot_sigma=0.01, drop=drop)


def _grids(pr):
    gj = jbg.from_flat(jba.BAProblem(**{k: jnp.asarray(v) for k, v in pr.items()}))
    return gj, convert.ba_problem_grid(jax.tree.map(np.asarray, gj), "cpu")


@pytest.fixture(scope="module")
def chain():
    return _grids(_problem())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _xla_step_pieces(gj, n_fixed):
    """V^-1, z_p, Y and the four camera reductions as ``_solve_step_pcg``
    computes them (the way ``tests/test_ba_global_pallas.py`` does)."""
    f32 = jnp.float32
    C_adj = gj.rvecs.shape[0] - n_fixed
    r, Jc, Jp = jbg._grid_terms(gj.rvecs.astype(f32), gj.tvecs.astype(f32),
                                gj.points.astype(f32), gj)
    a = jnp.abs(r)
    w = jnp.where(a <= DELTA, 1.0, DELTA / jnp.maximum(a, 1e-12)) * gj.mask.astype(f32)[..., None]
    Jc = Jc * (gj.cam_slot >= n_fixed).astype(f32)[..., None, None]
    V = jnp.sum(jbg._jtj(Jp, Jp, w), axis=1)
    V = V + LAM * (jnp.abs(jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(V))) + 1e-6 * jnp.eye(3))
    Vinv = jnp.where(gj.point_mask[:, None, None], jba._inv3(V), 0.0)
    g_p = jnp.sum(Jp * w[..., None] * r[..., None], axis=(1, 2))
    z_p = jnp.einsum("pij,pj->pi", Vinv, g_p)
    Y = jbg._jtj(Jc, Jp, w)
    onehot_T = (jnp.arange(C_adj)[:, None] == (gj.cam_slot.reshape(-1)[None, :] - n_fixed)
                ).astype(f32)
    YV = jbg._mm(Y, Vinv[:, None])
    return dict(
        r=r, Vinv=Vinv, z_p=z_p, Y=Y, onehot_T=onehot_T,
        U=(onehot_T @ jbg._jtj(Jc, Jc, w).reshape(-1, 36)).reshape(C_adj, 6, 6),
        g_c=onehot_T @ jnp.sum(Jc * w[..., None] * r[..., None], axis=-2).reshape(-1, 6),
        Wz=onehot_T @ jnp.sum(Y * z_p[:, None, None, :], axis=-1).reshape(-1, 6),
        Do=(onehot_T @ jnp.sum(YV[..., :, None, :] * Y[..., None, :, :], axis=-1)
            .reshape(-1, 36)).reshape(C_adj, 6, 6))


def _plain_setup(gt, n_fixed):
    lay = gk.layout(gt, DELTA)
    return lay, gk.setup_plain(gk.camera_rows(gt.rvecs, gt.tvecs, True),
                               gt.points.T.contiguous(), lay.slotT, lay.maskT, lay.uvT,
                               lay.pmask, gk.with_lambda(lay.scal, LAM), n_fixed)


@pytest.mark.parametrize("n_fixed", [1, 2])
def test_setup_plain_matches_the_xla_step(chain, n_fixed):
    gj, gt = chain
    D = gt.cam_slot.shape[1]
    ref = _xla_step_pieces(gj, n_fixed)
    _, (YT, VinvT, zpT, red) = _plain_setup(gt, n_fixed)
    assert _rel(gk._y_blocks(YT, D).permute(1, 0, 2, 3).numpy(), ref["Y"]) <= 1e-4
    assert _rel(gk._vinv_matrix(VinvT).numpy(), ref["Vinv"]) <= 1e-3
    assert _rel(zpT.T.numpy(), ref["z_p"]) <= 1e-4
    assert _rel(gk._unpack_sym6(red[:, gk._RED_U]).numpy(), ref["U"]) <= 1e-4
    assert _rel(red[:, gk._RED_GC].numpy(), ref["g_c"]) <= 1e-4
    assert _rel(red[:, gk._RED_WZ].numpy(), ref["Wz"]) <= 1e-4
    assert _rel(gk._unpack_sym6(red[:, gk._RED_DO]).numpy(), ref["Do"]) <= 1e-4
    assert red.shape == (12 - n_fixed, 54)


@pytest.mark.parametrize("pregather", [False, True], ids=["gather", "split"])
def test_setup_plain_matches_the_pallas_setup_in_interpret_mode(chain, pregather):
    gj, gt = chain
    (YT_j, VinvT_j, zpT_j, red_j), P = _setup_outputs_interp(gj, LAM, 1, pregather=pregather)
    _, (YT, VinvT, zpT, red) = _plain_setup(gt, 1)
    assert _rel(YT.numpy(), np.asarray(YT_j)[:, :P]) <= 1e-4
    assert _rel(VinvT.numpy(), np.asarray(VinvT_j)[:, :P]) <= 1e-3
    assert _rel(zpT.numpy(), np.asarray(zpT_j)[:, :P]) <= 1e-4
    for sl in (gk._RED_U, gk._RED_GC, gk._RED_WZ, gk._RED_DO):
        assert _rel(red[:, sl].numpy(), np.asarray(red_j)[:, sl]) <= 1e-4
    np.testing.assert_array_equal(
        gk._unpack_sym6(red[:, gk._RED_U]).numpy(),
        np.asarray(jgp._unpack_sym6(jnp.asarray(red[:, gk._RED_U].numpy()))))


@pytest.mark.parametrize("n_fixed", [1, 2])
def test_matvec_backsub_and_cost_plain_match_the_xla_step(chain, n_fixed):
    gj, gt = chain
    ref = _xla_step_pieces(gj, n_fixed)
    lay, (YT, VinvT, zpT, _) = _plain_setup(gt, n_fixed)
    x = np.random.default_rng(1).normal(0, 1e-2, (12 - n_fixed, 6)).astype(np.float32)
    # the XLA step's matvec coupling term and back-substitution
    xs = jnp.concatenate([jnp.zeros((n_fixed, 6)), jnp.asarray(x)])[gj.cam_slot]
    q = jnp.sum(jnp.sum(ref["Y"] * xs[..., None], axis=-2), axis=1)
    z = jnp.einsum("pij,pj->pi", ref["Vinv"], q)
    WVWx = ref["onehot_T"] @ jnp.sum(ref["Y"] * z[:, None, None, :], axis=-1).reshape(-1, 6)
    xt = torch.as_tensor(x)
    assert _rel(gk.matvec_plain(YT, VinvT, lay.slotT, lay.maskT, xt, n_fixed).numpy(),
                WVWx) <= 1e-4
    assert _rel(gk.backsub_plain(YT, VinvT, zpT, lay.slotT, lay.maskT, xt, n_fixed).numpy().T,
                -(ref["z_p"] + z)) <= 1e-4
    out = gk.cost_plain(gk.camera_rows(gt.rvecs, gt.tvecs, False), gt.points.T.contiguous(),
                        lay.slotT, lay.maskT, lay.uvT, lay.scal).numpy()
    np.testing.assert_allclose(out[0], float(jba.robust_cost(ref["r"], DELTA)), rtol=1e-5)
    np.testing.assert_allclose(out[1], float(jnp.sum(ref["r"] ** 2)), rtol=1e-5)
    assert out.shape == (2,)


def _same_solve(a, b):
    """The JAX package's whole-solve bounds (``tests/test_ba_global_pallas.py``)."""
    np.testing.assert_allclose(float(b[3].initial_cost), float(a[3].initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(b[3].final_cost), float(a[3].final_cost), rtol=1e-2)
    np.testing.assert_allclose(float(b[3].final_sq), float(a[3].final_sq), rtol=1e-2)
    assert int(b[3].iterations) == int(a[3].iterations)
    assert float(b[3].final_cost) < 0.5 * float(b[3].initial_cost)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=0, atol=5e-3)
    np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), rtol=0, atol=5e-2)


@pytest.fixture(scope="module")
def full_chain():
    """Every point keeps its 4 observations, as in the JAX package's
    whole-solve tests: a point left with one or two wanders along its ray by
    more than the bound on the points."""
    return _grids(_problem(seed=5, drop=0.0))


@pytest.mark.parametrize("n_fixed", [1, 2])
def test_solve_plain_matches_the_pallas_solve_and_the_grid_solver(full_chain, n_fixed):
    gj, gt = full_chain
    b = gk.solve_plain(gt, n_fixed=n_fixed, **FREE)
    _same_solve(jgp.ba_solve_global_pallas(gj, n_fixed=n_fixed, interpret=True, **FREE), b)
    _same_solve(jbg.ba_solve_grid(gj, n_fixed=n_fixed, **FREE), b)
    # the port's own grid PCG solver, and the default stopping rule
    c = tbg.ba_solve_grid(gt, n_fixed=n_fixed, **FREE)
    np.testing.assert_allclose(float(b[3].final_cost), float(c[3].final_cost), rtol=1e-2)
    d = gk.solve_plain(gt, n_fixed=n_fixed)
    e = jbg.ba_solve_grid(gj, n_fixed=n_fixed, cg_iters=8, cg_tol=1e-6, cg_forcing=True)
    np.testing.assert_allclose(float(d[3].final_cost), float(e[3].final_cost), rtol=1e-2)
    assert abs(int(d[3].iterations) - int(e[3].iterations)) <= 2
    assert torch.equal(b[0][:n_fixed], gt.rvecs[:n_fixed])


def test_cpu_tensors_take_the_plain_path_and_count_no_launch(chain):
    _, gt = chain
    kernels.reset_launches()
    a = gk.solve(gt, n_fixed=2, max_iterations=3)
    b = gk.solve_plain(gt, n_fixed=2, max_iterations=3)
    for x, y in zip(a[:3] + tuple(a[3]), b[:3] + tuple(b[3])):
        assert torch.equal(x, y)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    lay = gk.layout(gt)
    meta = [t.to("meta") for t in (gt.points.T, lay.slotT, lay.maskT, lay.uvT, lay.scal)]
    with pytest.raises(ValueError, match="device"):
        gk.cost(gk.camera_rows(gt.rvecs, gt.tvecs, False).to("meta"), *meta)
    with pytest.raises(ValueError, match="devices"):
        gk.cost(gk.camera_rows(gt.rvecs, gt.tvecs, False), *meta)


def test_padding_points_and_dead_slots_are_inert():
    """More padding points, more (dead) slots per point, junk in the dead
    slots' camera index and pixels: the same solve up to the order of the
    float32 sums (1e-5 on the costs, 1e-4 on the cameras), and padding points
    do not move."""
    pr = _problem(seed=5)
    _, g0 = _grids(pr)
    P, D = g0.cam_slot.shape
    P2, D2 = P + 72, D + 3
    cam_slot = torch.full((P2, D2), 10 ** 6, dtype=torch.int32)
    cam_slot[P:] = -3
    cam_slot[:P, :D] = torch.where(g0.mask > 0, g0.cam_slot, cam_slot[:P, :D])
    uv = torch.full((P2, D2, 2), 1e4)
    uv[:P, :D] = torch.where(g0.mask[..., None] > 0, g0.uv, uv[:P, :D])
    mask = torch.zeros((P2, D2))
    mask[:P, :D] = g0.mask
    pts = torch.cat([g0.points, torch.full((P2 - P, 3), 7.0)])
    g1 = g0._replace(cam_slot=cam_slot, uv=uv, mask=mask, points=pts,
                     point_mask=torch.cat([g0.point_mask, torch.zeros(P2 - P, dtype=torch.bool)]))
    a = gk.solve_plain(g0, n_fixed=1, max_iterations=8)
    b = gk.solve_plain(g1, n_fixed=1, max_iterations=8)
    np.testing.assert_allclose([float(x) for x in b[3][:4]], [float(x) for x in a[3][:4]],
                               rtol=1e-5)
    assert int(a[3].iterations) == int(b[3].iterations)
    np.testing.assert_allclose(b[0].numpy(), a[0].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(b[2][:P].numpy(), a[2].numpy(), rtol=0, atol=1e-3)
    assert torch.equal(b[2][P:], pts[P:])


def test_a_point_on_a_camera_centre_stays_finite():
    """Its V block overflows the float32 determinant; the inverse becomes 0
    and the point is frozen for the step, as in ``ba._inv3`` and K3."""
    pr = _problem(seed=6, drop=0.0)
    centre = -so3_exp_np(pr["rvecs"][5].astype(np.float64)).T @ pr["tvecs"][5]
    pid = int(pr["pnt_idx"][np.flatnonzero(pr["cam_idx"] == 5)[0]])
    pr["points"][pid] = (centre + [1e-7, -1e-7, 2e-7]).astype(np.float32)
    pr["obs_mask"][:] = 1.0
    _, gt = _grids(pr)
    _, (YT, VinvT, zpT, red) = _plain_setup(gt, 1)
    assert all(bool(torch.isfinite(t).all()) for t in (YT, VinvT, zpT, red))
    assert not VinvT[:, pid].any()
    for iters in (1, 20):
        out = gk.solve_plain(gt, n_fixed=1, max_iterations=iters)
        assert all(bool(torch.isfinite(t).all()) for t in out[:3])
        assert np.isfinite([float(x) for x in out[3][:4]]).all()
    one = gk.solve_plain(gt, n_fixed=1, max_iterations=1)
    if bool(one[3].accepted):
        assert torch.equal(one[2][pid], gt.points[pid])


def test_the_gate_at_its_edges(chain):
    _, gt = chain
    assert gk.kernel_eligible_global(gt, 1) and gk.kernel_eligible_global(gt, 11)
    assert not gk.kernel_eligible_global(gt, 12)        # no adjustable camera
    assert not gk.kernel_eligible_global(gt, -1)
    assert gk.eligible_shape_global(200, 32768, 4, 2)
    assert gk.eligible_shape_global(20000, 131072, 12, 1)   # no C <= 8192 bound
    assert gk.eligible_shape_global(5, 8192, 12) and not gk.eligible_shape_global(5, 8192, 13)
    assert not gk.eligible_shape_global(5, 8192, 0) and not gk.eligible_shape_global(5, 0, 4)
    # per point at D = 4: Y and the pair list (4 * 19 floats), V^-1, z_p and
    # the matvec's z (12); per segment of the tile plan 54 floats, at most
    # one per tile and one per camera
    per_point = 4 * (4 * 19 + 12)

    def scratch(P, C):
        return P * per_point + 4 * 54 * (-(-4 * P // gk.PAIR_TILE) + C)

    edge = gk.SCRATCH_LIMIT_BYTES // per_point
    while scratch(edge, 200) > gk.SCRATCH_LIMIT_BYTES:
        edge -= 1
    assert gk.eligible_shape_global(200, edge, 4) and not gk.eligible_shape_global(200, edge + 1, 4)
    assert gk.scratch_bytes(32768, 4, 200) == scratch(32768, 200)
    assert 4 * edge < 2 ** 31                   # a pair index d*P + p stays an int32
    with pytest.raises(ValueError, match="gate"):
        gk.solve(gt, n_fixed=12)
    with pytest.raises(ValueError, match="gate"):
        gk.solve_plain(gt, n_fixed=1, cg_iters=0)


def test_camera_index_lists_each_cameras_live_pairs_in_order(chain):
    _, gt = chain
    lay = gk.layout(gt)
    for n_fixed in (1, 2):
        index = gk.camera_index(lay.slotT, lay.maskT, 12, n_fixed)
        pairs, offsets = index.pairs, index.offsets
        assert offsets[0] == 0 and pairs.dtype == offsets.dtype == torch.int32
        flat_slot, flat_mask = lay.slotT.reshape(-1), lay.maskT.reshape(-1)
        for a in range(12 - n_fixed):
            mine = pairs[offsets[a]: offsets[a + 1]].long()
            want = torch.nonzero((flat_slot == a + n_fixed) & (flat_mask > 0)).reshape(-1)
            assert torch.equal(mine, want)          # ascending: a stable sort
        assert int(offsets[-1]) == int(((flat_slot >= n_fixed) & (flat_mask > 0)).sum())


def _plan_problem():
    """The chain with padding points, dead slots, a camera in the middle whose
    observations are all dead (6) and the last one, which no point reaches."""
    pr = synthetic_global_problem(7, C=12, P=600, centre_sigma=0.03, point_sigma=0.03,
                                  rot_sigma=0.01, drop=0.1, pad_to=680)
    pr["obs_mask"][pr["cam_idx"] == 6] = 0.0
    return _grids(pr)


# tiles of at most 16 pairs: each camera (about 190 live pairs) spans many;
# of 150: two each; of 4096: one tile holds every camera
PLAN_TILES = [16, 150, 4096]


@pytest.mark.parametrize("tile", PLAN_TILES)
@pytest.mark.parametrize("n_fixed", [1, 2])
def test_tile_plan_covers_each_live_pair_once_in_camera_major_order(tile, n_fixed):
    _, gt = _plan_problem()
    lay = gk.layout(gt)
    index = gk.camera_index(lay.slotT, lay.maskT, 12, n_fixed, tile=tile)
    c_adj = 12 - n_fixed
    offsets = index.offsets.tolist()
    n = offsets[-1]
    start, seg_cam = index.seg_start.tolist(), index.seg_cam.tolist()
    tile_seg, cam_seg = index.tile_seg.tolist(), index.cam_seg.tolist()
    assert start[0] == 0 and start[-1] == n and n % tile != 0
    assert all(a < b for a, b in zip(start, start[1:]))     # no empty segment
    # each segment lies in one camera's run of the pair list: the pairs list
    # every live pair of an adjustable camera once, camera-major
    flat_slot, flat_mask = lay.slotT.reshape(-1).long(), lay.maskT.reshape(-1)
    covered = torch.cat([index.pairs[start[k]:start[k + 1]].long() for k in range(len(seg_cam))])
    want = torch.nonzero((flat_slot >= n_fixed) & (flat_mask > 0)).reshape(-1)
    assert torch.equal(torch.sort(covered).values, want) and covered.numel() == n
    for k, a in enumerate(seg_cam):
        assert offsets[a] <= start[k] and start[k + 1] <= offsets[a + 1]
        assert bool((flat_slot[index.pairs[start[k]:start[k + 1]].long()] == a + n_fixed).all())
    # each camera's segments, in order; the two without live pairs have none
    assert cam_seg[0] == 0 and cam_seg[-1] == len(seg_cam) and len(cam_seg) == c_adj + 1
    for a in range(c_adj):
        mine = range(cam_seg[a], cam_seg[a + 1])
        assert all(seg_cam[k] == a for k in mine)
        count = offsets[a + 1] - offsets[a]
        # a camera is cut only when it has more than `tile` pairs, into as
        # few near-equal segments as fit
        assert len(mine) == (-(-count // tile) if count > tile else int(count > 0))
        if len(mine) > 1:
            sizes = [start[k + 1] - start[k] for k in mine]
            assert max(sizes) - min(sizes) <= 1
    assert cam_seg[6 - n_fixed] == cam_seg[7 - n_fixed] and cam_seg[-2] == cam_seg[-1]
    # tiles of at most `tile` pairs, each made of consecutive segments; a
    # segment of a cut camera is a tile of its own
    assert tile_seg[0] == 0 and tile_seg[-1] == len(seg_cam)
    for t in range(len(tile_seg) - 1):
        k0, k1 = tile_seg[t], tile_seg[t + 1]
        assert k0 < k1 and start[k1] - start[k0] <= tile
        if k1 - k0 > 1:
            assert all(cam_seg[seg_cam[k] + 1] - cam_seg[seg_cam[k]] == 1 for k in range(k0, k1))
    spans = [b - a for a, b in zip(cam_seg, cam_seg[1:])]
    assert {16: max(spans) > 8, 150: max(spans) == 2, 4096: len(tile_seg) == 2}[tile]
    # the scratch of one solve
    assert index.carry.shape == (len(seg_cam), 54) and not index.ticket.any()
    assert index.z.shape == (3, 680) and index.out.shape == (c_adj, 6)


@pytest.fixture(scope="module")
def pallas_setup():
    gj, gt = _plan_problem()
    return gt, _setup_outputs_interp(gj, LAM, 1, pregather=False)


@pytest.mark.parametrize("tile", PLAN_TILES)
def test_tiled_camera_sum_matches_camera_sum_and_the_pallas_setup(pallas_setup, tile):
    """The kernels' order of the per-camera sums, on the plain version's
    per-slot rows: within float32 rounding of ``_camera_sum`` (norm-wise per
    scale group; zeros exactly where a camera has no live pair), and against
    the Pallas setup in interpret mode within the bound of
    ``test_setup_plain_matches_the_pallas_setup_in_interpret_mode``."""
    gt, ((_, _, _, red_j), _) = pallas_setup
    lay = gk.layout(gt, DELTA)
    index = gk.camera_index(lay.slotT, lay.maskT, 12, 1, tile=tile)
    YT, VinvT, _, rows, live = gk._setup_rows(
        gk.camera_rows(gt.rvecs, gt.tvecs, True), gt.points.T.contiguous(), lay.slotT, lay.maskT,
        lay.uvT, lay.pmask, gk.with_lambda(lay.scal, LAM), 1)
    tiled = gk.tiled_camera_sum(rows, index)
    plain = gk._camera_sum(rows, lay.slotT, live, 1, 11)
    for name, lanes in gk.red_lane_groups().items():
        assert _rel(tiled[:, lanes].numpy(), plain[:, lanes].numpy()) <= 1e-6, name
    for a in (5, 10):                      # cameras 6 and 11: no live pair
        assert not tiled[a].any() and not plain[a].any()
    for sl in (gk._RED_U, gk._RED_GC, gk._RED_WZ, gk._RED_DO):
        assert _rel(tiled[:, sl].numpy(), np.asarray(red_j)[:, sl]) <= 1e-4
    # the matvec's 6 lanes in the same order
    x = torch.as_tensor(np.random.default_rng(2).normal(0, 1e-2, (11, 6)).astype(np.float32))
    w2, _ = gk._matvec_rows(YT, VinvT, lay.slotT, lay.maskT, x, 1)
    out = gk.tiled_camera_sum(w2, index)
    want = gk.matvec_plain(YT, VinvT, lay.slotT, lay.maskT, x, 1)
    assert _rel(out[:, :3].numpy(), want[:, :3].numpy()) <= 1e-6
    assert _rel(out[:, 3:].numpy(), want[:, 3:].numpy()) <= 1e-6
