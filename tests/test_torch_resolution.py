"""Where float32 resolves a BA state, the window and global solvers held to
a float64 witness (``tools/stress.py``: rule (d) of ``window_rule`` for
K3, ``k4_path`` for K4).

The slot test (``stress.slot_test``) names the live slots whose float32
residual lies further than ``stress.SLOT_REL`` of its projection from the
float64 residual; on the committed windows of the long drive (a2)
(``tests/data/torch_wide_windows.npz``) it names the same slots when the
float32 residuals come from the JAX package's ``ba_grid._grid_terms`` as
from the port's formulas, and every slot it names sees a point near its
camera's centre in the map's scale (the camera-frame point a small
difference of large terms), not a point near the camera's plane.

The state test (``stress.state_resolution``) calls a state resolved where
the float32 start costs lie within ``stress.START_REL`` of float64's and the
float64 cost change of the step passes ``stress.RESOLVE_MARGIN`` times the
float32 spread of the start and the trial.  Rule (d) holds K3 on those
states to K3's function in float64 one LM iteration from the same state and
damping; on the CPU K3's wrapper is its plain version, so the tests put the
stand-ins of rule (a)'s tests (``tests/test_torch_stress_windows.py``) in
its place over the first ``RULE_D_STATES`` states of each window: the plain
version in another float order holds, and with either planted defect it
fails.

K4's rule per state (``stress.k4_rule``) holds the step and the end cost of
K4's one LM iteration to the grid PCG solver's in float64 with CG to
convergence, on a ring of 8 cameras built from a numpy seed: K4's roles as
they ship (their plain versions on the CPU) hold, and the two planted
defects of its setup role (``stress.defective_setup``: the Huber threshold
times 1.5, a gradient lane times 1.5) fail.

As a script it prints the CPU calibration of ``stress.SLOT_REL`` and
``stress.RESOLVE_MARGIN`` on the committed windows (``calibrate``), or
with ``--windows DIR [k3|grid|lu|scaled]`` rule (d) on every window a
``chip_smoke.py`` run saved in DIR with K3's plain version under that
point-block inverse in K3's place (``hold_saved``, about 25 min for 63):

    JAX_PLATFORMS=cpu python tests/test_torch_resolution.py
    JAX_PLATFORMS=cpu python tests/test_torch_resolution.py --windows DIR lu
"""

import json
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bundle_adjustment_tpu.ops import ba_grid as jbg  # noqa: E402
from bundle_adjustment_tpu_torch.ops import ba_kernel  # noqa: E402
from bundle_adjustment_tpu_torch.ops.ba import BAProblem  # noqa: E402
from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid, from_flat  # noqa: E402
from bundle_adjustment_tpu_torch.tools import stress  # noqa: E402
from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_ring_problem  # noqa: E402
from test_torch_stress_windows import (OPTS, RULE_A_WINDOWS, WIDE_THREADS,  # noqa: E402
                                       WIDE_WINDOWS, _first_slot_only, _grid_inverse,
                                       _k3_as, _short_of)

#: the states of K3's path that rule (d)'s tests walk on each committed
#: window: the resolved ones lie at its start (large steps at large damping)
RULE_D_STATES = 12


def _window(name) -> BAProblemGrid:
    w = WIDE_WINDOWS[name]
    return BAProblemGrid(**{k: torch.as_tensor(w[k]) for k in BAProblemGrid._fields})


def _jax_terms(g):
    """The float32 residuals of the JAX package's ``ba_grid._grid_terms``."""
    p = jbg.BAProblemGrid(**{k: jnp.asarray(getattr(g, k).numpy())
                             for k in BAProblemGrid._fields})
    return torch.from_numpy(np.array(jbg._grid_terms(p.rvecs, p.tvecs, p.points, p)[0]))


def _named(g, terms32, terms64=None, factor=1.0) -> set:
    test = stress.slot_test(g, terms32, terms64, bound=factor * stress.SLOT_REL, most=0)
    return set(test["keys"])


@pytest.mark.parametrize("name", RULE_A_WINDOWS)
def test_the_slot_test_names_the_jax_packages_slots(name):
    """On a committed window, the slots the slot test names from the port's
    float32 residuals (K3's formula and the grid solver's) are those it
    names from the JAX package's, within a factor of 2 of the bound: a slot
    past twice the bound in one is past the bound in the other."""
    g = _window(name)
    torch.set_num_threads(WIDE_THREADS)
    r = _jax_terms(g)
    for port in (stress.k3_terms, stress.grid_terms):
        jax_ = (lambda _: r, port)
        assert _named(g, port, factor=2) <= _named(g, *jax_), name
        assert _named(g, *jax_, factor=2) <= _named(g, port), name
        assert _named(g, port) == _named(g, *jax_), name


def test_the_unresolved_slots_are_points_near_a_camera_centre():
    """Every slot the slot test names on the committed windows sees a point
    whose camera-frame coordinates are a difference of terms at least 10
    times larger ((|R X| + |t|) / |X_c|; the worst slot of each window at
    least 90 times), with |z| at least half of |X_c|: near the camera's
    centre in the map's scale, not near its plane.  Window 57 (the one
    whose start costs float32 does not resolve) has the most of them."""
    counts = {}
    for name in RULE_A_WINDOWS:
        test = stress.slot_test(_window(name), most=1000)
        counts[name] = len(test["keys"])
        assert len(test["slots"]) == len(test["keys"]) > 0, name
        assert test["slots"][0]["cancel"] >= 90, (name, test["slots"][0])
        for s in test["slots"]:
            assert s["cancel"] >= 10 and s["z_over_norm"] >= 0.5, (name, s)
    assert max(counts, key=counts.get) == "a2_w0057", counts


def test_the_witness_is_the_plain_versions_iteration_in_float64():
    """``stress.k3_witness``'s float64 step and decision are
    ``lm_solve_plain``'s one LM iteration on the float64 state from the
    same damping, bit for bit."""
    g = _window("a2_w0062")
    one = dict(OPTS, n_fixed=int(WIDE_WINDOWS["a2_w0062"]["n_fixed"]), max_iterations=1,
               lambda_init=1e-3)
    st = stress.stats_summary(ba_kernel.lm_solve_plain(stress.as_float64(g), **one)[3])
    a = ba_kernel.lm_solve_plain(g, **one)[3]
    rec = dict(start=float(a.initial_cost), start_b=float(a.initial_cost),
               a=float(a.final_cost))
    w = stress.k3_witness(g, one, rec)
    assert w["accepted64"] == (st["final_cost"] < st["initial_cost"])
    assert w["end64"] == st["final_cost"]


@pytest.mark.parametrize("case, resolved", [
    ("change past the margin", True), ("start costs apart", False),
    ("change inside the margin", False), ("a float32 step overflows", False)])
def test_state_resolution(case, resolved):
    """The state test's arithmetic: start costs within ``START_REL`` of each
    other and a float64 change past ``RESOLVE_MARGIN`` times the float32
    spread (here 2e-3, the trial's); a float32 step whose cost is not
    finite resolves nothing."""
    apart = 1e-2 if case == "start costs apart" else 1e-4
    trial = 99.9 if case == "change inside the margin" else 90.0
    nan = float("nan") if case == "a float32 step overflows" else trial
    r = stress.state_resolution((100.0, 100.0 + apart), 100.0,
                                (trial + 1e-3, trial - 2e-3, nan), trial)
    assert r["resolved"] == resolved, r
    assert r["band"] == (math.inf if nan != nan else pytest.approx(max(2e-3, apart)))


@pytest.mark.parametrize("k3, holds", [("in another float order", True),
                                       ("a camera counted once per point", False),
                                       ("0.9 of the step", False)])
def test_rule_d_holds_k3_to_float64_where_float32_resolves(monkeypatch, k3, holds):
    """Rule (d) (``stress.float32_path``'s witness, ``stress.resolved_rule``)
    over the first ``RULE_D_STATES`` states of the committed windows, with a
    stand-in for K3: its plain version with the grid solver's point-block
    inverse decides as float64 on every resolved state and ends above its
    plain version on no more of them than chance allows; with a camera
    repeated on a point counted once, or 0.9 of the right step, K3 ends
    above its plain version on nearly every resolved state and the rule
    fails.  Window 57's states do not resolve (its float32 start costs lie
    3.5e-4 from float64's)."""
    step_of = {"in another float order": _grid_inverse,
               "a camera counted once per point": _first_slot_only,
               "0.9 of the step": _short_of}[k3]
    monkeypatch.setattr(ba_kernel, "lm_solve", _k3_as(step_of))
    torch.set_num_threads(WIDE_THREADS)
    recs = []
    for name in RULE_A_WINDOWS:
        w = WIDE_WINDOWS[name]
        recs.append(dict(index=name, path32=stress.float32_path(
            _window(name), dict(OPTS, n_fixed=int(w["n_fixed"]), max_iterations=RULE_D_STATES))))
    d = stress.resolved_rule(recs)
    assert d["resolved"] > 0 and d["passed"] == holds, d
    assert recs[0]["path32"]["resolution"]["resolved"] == 0     # window 57
    if holds:
        assert d["k3_otherwise"] == 0 and d["worst64"] <= stress.FLOAT32_REL


#: the ring of K4's tests: few cameras, so that K4's CG cap of 8 nearly
#: converges and the witness resolves most states
RING = dict(C=8, P=2000, D=4, drift=0.2)
RING_STATES = 8


@pytest.fixture(scope="module")
def ring():
    pr = synthetic_ring_problem(0, **RING)
    return from_flat(BAProblem(**{k: torch.as_tensor(v) for k, v in pr.items()}))


@pytest.mark.parametrize("route, holds", [("as shipped", True),
                                          ("K4 setup Huber x1.5", False),
                                          ("K4 setup gradient lane x1.5", False)])
def test_k4_rule_holds_k4_to_float64_with_cg_to_convergence(ring, route, holds):
    """``stress.k4_path`` over the first ``RING_STATES`` states of K4's path
    on the ring (K4's plain roles on the CPU): as they ship, every resolved
    state holds (K4 decides as float64 and its step and end cost lie within
    ``K4_STEP_REL`` of the witness's or twice the float32 plain steps'
    gap); with the Huber threshold or a gradient lane of the setup role
    times 1.5 resolved states fail."""
    torch.set_num_threads(2)
    with stress.routed("lehman_indoor", **stress.routing(route)):
        path = stress.k4_path(ring, dict(n_fixed=1, max_iterations=RING_STATES,
                                         huber_delta=1.0, cg_iters=8, cg_tol=0.0,
                                         cg_forcing=False))
    assert path["states"] == RING_STATES and path["resolved"] >= 3, path["resolved"]
    assert (not path["failures"]) == holds, path["failures"]
    assert all(r["cg"]["residual"] <= stress.CG_TOL64 for r in path["records"] if "cg" in r)


def _inverse(name):
    """A point-block inverse in ``ba_kernel._inv3_damped``'s signature: the
    TPU kernel's adjugate (K3's), the grid solver's, an LU inverse
    (``torch.linalg.inv``) or the adjugate of the Jacobi-scaled block."""
    from bundle_adjustment_tpu_torch.ops import ba

    def lu(V, lam, pm):
        inv = torch.linalg.inv_ex(ba._damp(V, lam))[0]
        ok = torch.isfinite(inv).all(dim=-1).all(dim=-1) & pm
        return torch.where(ok[:, None, None], inv, torch.zeros_like(inv))

    def scaled(V, lam, pm):
        Vd = ba._damp(V, lam)
        d = 1.0 / torch.sqrt(torch.diagonal(Vd, dim1=-2, dim2=-1).abs().clamp(min=1e-30))
        inv = ba._inv3(Vd * d[:, :, None] * d[:, None, :]) * d[:, :, None] * d[:, None, :]
        return torch.where(pm[:, None, None], inv, torch.zeros_like(inv))

    return dict(k3=ba_kernel._inv3_damped, grid=stress.grid_point_inverse, lu=lu,
                scaled=scaled)[name]


def _with_inverse(name):
    """K3's plain step with the point-block inverse ``name``."""
    def step_of(solve_step):
        def step(*a):
            own = ba_kernel._inv3_damped
            ba_kernel._inv3_damped = _inverse(name)
            try:
                return solve_step(*a)
            finally:
                ba_kernel._inv3_damped = own
        return step
    return step_of


def calibrate(margins=(10, 30, 50, 100, 300)):
    """The CPU calibration of ``SLOT_REL`` and ``RESOLVE_MARGIN`` on the
    committed windows (one JSON line each): per window the live slots'
    relative residual gaps (median, 99.99 %, largest), the slots named at
    ``SLOT_REL`` and the float32 start cost's gap to float64; then along
    the plain version's path on each window, at each state whose start
    costs resolve, where the plain version's float32 step lands with each
    of four point-block inverses (``_inverse``): with the spread of K3's
    and the grid solver's, the states at each margin where the LU or the
    Jacobi-scaled one decides otherwise than float64."""
    torch.set_num_threads(WIDE_THREADS)
    flips = {m: {"lu": [], "scaled": []} for m in margins}
    counts = {m: 0 for m in margins}
    for name in RULE_A_WINDOWS:
        g = _window(name)
        g64 = stress.as_float64(g)
        r64 = stress.k3_terms(g64)
        gap = torch.linalg.vector_norm(stress.k3_terms(g).double() - r64, dim=-1)
        rel = (gap / torch.linalg.vector_norm(r64 + g64.uv, dim=-1))[g64.mask > 0]
        _, _, c64, _ = ba_kernel.plain_parts(g64, int(WIDE_WINDOWS[name]["n_fixed"]))
        _, _, c32, _ = ba_kernel.plain_parts(g, int(WIDE_WINDOWS[name]["n_fixed"]))
        x = (g.rvecs, g.tvecs, g.points)
        print(json.dumps(dict(
            window=name, live=int(rel.numel()), median=float(rel.median()),
            q9999=float(torch.quantile(rel, 0.9999)), largest=float(rel.max()),
            named=int((rel > stress.SLOT_REL).sum()),
            start_gap=float(c32(*x)) / float(c64(*(t.double() for t in x))) - 1)))
        kw = dict(OPTS, n_fixed=int(WIDE_WINDOWS[name]["n_fixed"]))
        for rec, state, one in stress.lm_path(ba_kernel.lm_solve, ba_kernel.lm_solve_plain,
                                              g, kw):
            w = stress.k3_witness(state, one, rec)
            if w["start_spread"] > stress.START_REL:
                continue
            p64, step64, cost64, _ = ba_kernel.plain_parts(stress.as_float64(state),
                                                           kw["n_fixed"])
            _, step32, _, _ = ba_kernel.plain_parts(state, kw["n_fixed"])
            xs = (state.rvecs, state.tvecs, state.points)
            c0 = float(cost64(p64.rvecs, p64.tvecs, p64.points))
            c1 = c0 - w["change"] if w["accepted64"] else c0 + w["change"]
            lam = torch.tensor(one["lambda_init"])
            lands = {}
            for f in ("lu", "scaled"):
                d = _with_inverse(f)(step32)(*xs, lam)
                lands[f] = float(cost64(*(a.double() + b.double()
                                          for a, b in zip(xs, d)))) < c0
            for m in margins:
                if w["change"] > m * w["band"]:
                    counts[m] += 1
                    for f, accepted in lands.items():
                        if accepted != w["accepted64"]:
                            flips[m][f].append((name, rec["iteration"]))
    print(json.dumps(dict(resolved=counts, otherwise=flips)))


def hold_saved(src: str, k3: str = "grid"):
    """Rule (d) on every window ``chip_smoke.py`` saved in ``src``
    (``w####.npz``, ``windows.json``) with a stand-in for K3, its plain
    version with the point-block inverse ``k3`` (``_inverse``): one JSON
    line per window, then ``stress.resolved_rule``'s verdict."""
    with open(os.path.join(src, "windows.json")) as f:
        held = {r["index"]: r for r in json.load(f)["windows"]}
    ba_kernel.lm_solve = _k3_as(_with_inverse(k3))
    torch.set_num_threads(WIDE_THREADS)
    recs = []
    for i, r in sorted(held.items()):
        with np.load(os.path.join(src, f"w{i:04d}.npz")) as z:
            g = BAProblemGrid(**{k: torch.as_tensor(z[k]) for k in BAProblemGrid._fields})
            n_fixed = int(z["n_fixed"])
        path = stress.float32_path(g, dict(r["opts"], n_fixed=n_fixed))
        recs.append(dict(index=i, path32=path))
        print(json.dumps(dict(window=i, **{k: v for k, v in path["resolution"].items()
                                           if k != "slots"})), flush=True)
    print(json.dumps(stress.resolved_rule(recs)))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--windows"]:
        hold_saved(*sys.argv[2:4])
    else:
        calibrate()
