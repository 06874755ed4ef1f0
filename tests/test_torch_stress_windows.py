"""The window solvers held to the JAX package on windows of the long drive.

``tests/data/torch_stress_windows.npz`` holds windows that K3 solved in the
port's stress drive on the card (``tools/stress --hold-windows``, the JAX
stress cells' own videos of seeds 2 and 3, 640 x 480, 1500 features): those
where K3 and the grid solver parted on the card (final costs more than 1 %
apart, another stop test, or one diverged) and the last ones solved before
each drive's first Rotation keyframe, their live points only.
``tests/data/torch_wide_windows.npz`` holds windows of ``chip_smoke.py``
phase 11's run (a2) (``preset_lehman_indoor`` on the 600-frame room at
1280 x 720, ``--consistent-convention``; ``hold_wide_windows``): the one
that diverged in the drive, the one past 12 slots per point where K3 and
the grid solver parted the most on the card, and one whose whole float64
solves part (``stress.wide_window_choice`` orders them; ``--record``).
Key ``{window}/{field}``: the ``BAProblemGrid`` fields and ``n_fixed``;
``{window}/card`` is the card's record of the window (K3's, the grid
solver's and K3's plain version's final cost, iterations and stop; for the
wide windows also the float64 pair where the card ran it).

Each window runs through the port's ``ba_kernel.lm_solve_plain`` (K3's
function) and through the two packages' grid solvers
(``ba_grid.ba_solve_grid_impl``), in float32 on the CPU, each window padded
to its file's shape with dead points and slots (so each JAX solver compiles
once per file).  K3's function is held to JAX ``ba_pallas.reference_lm``
(the TPU kernel's twin) on windows the TPU kernel takes (at most 12 slots
per point, its gate); past 12 slots the JAX package runs its grid solver
(on the CPU; on the TPU the global-BA kernels' route), so there K3's
function is held to JAX's grid solver.  Held: the final cost within 1 %,
the iterations within one, the same stop ("cap", "stuck" or "converged":
the JAX solvers report no stop test, so it is read from the iterations and
the last lambda, and the port's ``ftol`` and ``xtol`` both count as
converged; JAX's grid solver keeps no lambda, so there the stop is the cap
or an earlier end).  Where the two float32 packages part, the float64
witness decides (the port's solver in float64 on the same window): the port
passes where its final cost is within 1 % of float64's or at most twice as
far from it as JAX's.  These windows are the long drive's hard ones: half
of them run to the 50-iteration cap, and float32 order alone moves a final
cost by several percent (the same solver on the same window with its points
in another order).  So where the witness does not clear one ordering, it is
taken over ``ORDERINGS`` orderings of the window's points, both packages
on the same ones: the port's mean gap to float64 within 1 % of it or at
most twice JAX's.  The iterations say whether JAX stops earlier than the
port (ROADMAP Queue 3 item 6).

On the wide windows K3's function and the port's grid solver are held to
each other in float64 too, by rule (b) of ``tools/stress.window_rule``
(``stress.hold_float64``): from each state of K3's function's float64 path
(every state where the whole float64 solves part, the first eight where
they agree) one LM iteration of each ends within 1e-4, the point blocks
inverted by one formula, and K3's point-block inverse is the grid solver's
within 1e-9 on the blocks float64 resolves.  Whole float64 solves are not
held to each other: float order parts them on these windows, the same
solver with its points in another order as far.  A planted defect (K3's
plain version adding only the first of a camera's slots on a point) must
fail the rule on every window past 12 slots.

Rule (a) holds K3 to its plain version per state of K3's float32 path
(``stress.float32_path``); on the CPU K3's wrapper is its plain version,
so its tests put a stand-in for K3 in its place: the plain version in
another float order holds, and K3 with either of two planted defects
fails.
"""

import contextlib
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bundle_adjustment_tpu.ops import ba_grid as jbg  # noqa: E402
from bundle_adjustment_tpu.ops import ba_pallas as jbp  # noqa: E402
from bundle_adjustment_tpu_torch.ops import ba_grid as tbg  # noqa: E402
from bundle_adjustment_tpu_torch.ops import ba_kernel  # noqa: E402
from bundle_adjustment_tpu_torch.ops.ba import STOP_TESTS  # noqa: E402
from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid  # noqa: E402
from bundle_adjustment_tpu_torch.tools import stress  # noqa: E402

torch.set_num_threads(1)

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DATA = os.path.join(HERE, "torch_stress_windows.npz")
WIDE = os.path.join(HERE, "torch_wide_windows.npz")
FIELDS = BAProblemGrid._fields
OPTS = dict(max_iterations=50, huber_delta=1.0, lambda_init=1e-3, lambda_up=4.0,
            lambda_down=0.5, lambda_min=1e-10, lambda_max=1e8, ftol=1e-5, xtol=1e-5)


#: every window of a file padded to one shape, so that each JAX solver
#: compiles once per file: padding points and slots are dead (mask 0, point
#: mask off) and add nothing to any sum.  The stress windows' shape, and the
#: wide windows' (D up to 18: (a2) puts up to 18 slots on a point; P the
#: most live points of a wide window, to 256)
PAD_P, PAD_D = 2048, 10
WIDE_PAD_D = 18
#: the slots per point past which K3's windows were the grid solver's
#: before K3's gate lost the TPU kernel's D <= 12 (``ba_pallas.eligible_shape``)
TPU_MAX_SLOTS = 12
#: torch's threads for the wide windows' solves (4,000-4,500 live points
#: each), so that their cases stay within 90 s in one process
WIDE_THREADS = 4
#: the orderings of a window's points the JAX package's own float32
#: spread is read over (``_jax_spread``)
ORDERINGS = 4


def _pad(w: dict, shape=(PAD_P, PAD_D)) -> dict:
    P, D = w["cam_slot"].shape
    out = dict(w)
    for k, fill in (("points", 0.0), ("cam_slot", 0), ("uv", 0.0), ("mask", 0.0),
                    ("point_mask", False)):
        a = w[k]
        width = [(0, shape[0] - P)] + (
            [(0, shape[1] - D)] if k in ("cam_slot", "uv", "mask") else [])
        out[k] = np.pad(a, width + [(0, 0)] * (a.ndim - len(width)), constant_values=fill)
    return out


def _reordered(w: dict, seed: int) -> dict:
    """``w`` with its live points in another order (seed 0: as captured)."""
    if not seed:
        return w
    n, P = int(w["point_mask"].sum()), w["point_mask"].shape[0]
    perm = np.r_[np.random.default_rng(seed).permutation(n), np.arange(n, P)]
    return dict(w, **{k: w[k][perm] for k in ("points", "cam_slot", "uv", "mask", "point_mask")})


def _windows(path: str, prefix: str = "") -> dict:
    if not os.path.exists(path):        # before ``record`` writes it
        return {}
    with np.load(path) as z:
        names = sorted({k.split("/")[0] for k in z.files})
        return {prefix + n: {k.split("/")[1]: z[k] for k in z.files if k.startswith(n + "/")}
                for n in names}


WINDOWS = _windows(DATA)
WIDE_WINDOWS = _windows(WIDE, "a2_")
WIDE_PAD_P = -(-max([w["cam_slot"].shape[0] for w in WIDE_WINDOWS.values()] or [1]) // 256) * 256
assert all(w["cam_slot"].shape[0] <= PAD_P and w["cam_slot"].shape[1] <= PAD_D
           for w in WINDOWS.values())
assert all(w["cam_slot"].shape[0] <= WIDE_PAD_P and w["cam_slot"].shape[1] <= WIDE_PAD_D
           for w in WIDE_WINDOWS.values())


@functools.lru_cache(maxsize=None)
def _padded(name: str, seed: int = 0) -> dict:
    """Window ``name`` padded to its file's shape, its points in ordering
    ``seed``; one object per (name, seed), so the solves on it are kept
    (``_kept``)."""
    if name in WIDE_WINDOWS:
        return _reordered(_pad(WIDE_WINDOWS[name], (WIDE_PAD_P, WIDE_PAD_D)), seed)
    return _reordered(_pad(WINDOWS[name]), seed)


def _slots(name: str) -> int:
    """The slots per point of window ``name`` as the drive built it."""
    return (WIDE_WINDOWS.get(name) or WINDOWS[name])["cam_slot"].shape[1]


_SOLVES = {}


def _kept(key: str, fn):
    """``fn`` (window -> result) with each result kept per window, so that
    the tests of one window share its solves."""
    def call(w, n_fixed):
        if (key, id(w)) not in _SOLVES:
            _SOLVES[key, id(w)] = fn(w, n_fixed)
        return _SOLVES[key, id(w)]
    return call



def _classify(iterations: int, stop: str) -> str:
    """The stop both packages can report: the cap, stuck, or converged."""
    if iterations >= OPTS["max_iterations"]:
        return "cap"
    return "stuck" if stop == "stuck" else "converged"


@functools.partial(jax.jit, static_argnames=("n_fixed",))
def _jax_lm_stats(g, n_fixed):
    """``ba_pallas.reference_lm``'s body, returning its eight stats lanes
    (lane 6 the last lambda, which ``reference_lm`` drops)."""
    ptT, onehot, maskT, uvT, pmaskT, params, P, P_pad, D, C = jbp._prep_inputs(g, n_fixed)
    cfg = dict(C=C, D=D, n_fixed=n_fixed, **OPTS)
    return jbp._lm_solve_values(g.rvecs.astype(jnp.float32), g.tvecs.astype(jnp.float32),
                                ptT, onehot, maskT, uvT, pmaskT, params, cfg)[3]


def _jax_k3(w, n_fixed):
    """(final cost, iterations, stop) of the TPU kernel's twin; a stuck loop
    ends at ``lambda_max``."""
    g = jbg.BAProblemGrid(**{k: jnp.asarray(w[k]) for k in FIELDS})
    s = np.asarray(_jax_lm_stats(g, n_fixed))[0]
    its = int(s[4])
    return float(s[1]), its, _classify(its, "stuck" if s[6] >= OPTS["lambda_max"] else "")


def _jax_grid_stats(w, n_fixed):
    """JAX's grid solver on window ``w``: its ``BAStats``."""
    g = jbg.BAProblemGrid(**{k: jnp.asarray(w[k]) for k in FIELDS})
    return jbg.ba_solve_grid(g, n_fixed=n_fixed, **OPTS)[3]


JAX_GRID_STATS = _kept("jax grid stats", _jax_grid_stats)


def _jax_grid(w, n_fixed):
    """(final cost, iterations, stop) of JAX's grid solver, which keeps no
    lambda: its stop is the cap or an earlier end."""
    st = JAX_GRID_STATS(w, n_fixed)
    its = int(st.iterations)
    return float(st.final_cost), its, _classify(its, "")


def _port_stats(fn, w, n_fixed, dtype=torch.float32, keep=True) -> dict:
    """The port's solver ``fn`` on window ``w`` in ``dtype``: its
    ``stress.stats_summary``, kept per window with ``keep``."""
    key = (fn.__name__, str(dtype), id(w))
    if keep and key in _SOLVES:
        return _SOLVES[key]
    g = BAProblemGrid(**{k: torch.as_tensor(w[k]).to(dtype) if w[k].dtype.kind == "f"
                         else torch.as_tensor(w[k]) for k in FIELDS})
    out = stress.stats_summary(fn(g, n_fixed=n_fixed, **OPTS)[3])
    if keep:
        _SOLVES[key] = out
    return out


def _port(fn, w, n_fixed, dtype=torch.float32):
    st = _port_stats(fn, w, n_fixed, dtype)
    return st["final_cost"], st["iterations"], _classify(st["iterations"], st["stop"])


def near_float64(port: float, jax_: float, f64: float) -> bool:
    """The float64 witness (``chip_smoke.near_float64``'s rule): the port's
    final cost within 1 % of float64's, or at most twice as far from it as
    the JAX package's."""
    gap = abs(port - f64)
    return gap <= 0.01 * abs(f64) or gap <= 2 * abs(jax_ - f64)


def _hold(name, port_fn, jax_fn, f64_fn):
    """The rule of the module docstring on window ``name`` for the port's
    solver ``port_fn`` and the JAX one ``jax_fn`` (each window -> (final
    cost, iterations, stop)), with ``f64_fn`` the port's solver in float64.
    Returns how it held: "agree", "float64", or "orderings" (the witness
    over the mean gaps of ``ORDERINGS`` orderings of the window's
    points)."""
    w = _padded(name)
    n_fixed = int(w["n_fixed"])
    port, jax_ = port_fn(w, n_fixed), jax_fn(w, n_fixed)
    if (abs(port[0] - jax_[0]) <= 0.01 * abs(jax_[0]) and abs(port[1] - jax_[1]) <= 1
            and port[2] == jax_[2]):
        return "agree"
    f64 = f64_fn(w, n_fixed)[0]
    if near_float64(port[0], jax_[0], f64):
        return "float64"
    runs = [(port, jax_)] + [(port_fn(v, n_fixed), jax_fn(v, n_fixed))
                             for v in (_padded(name, k) for k in range(1, ORDERINGS))]
    mean_port = float(np.mean([p[0] for p, _ in runs]))
    mean_jax = float(np.mean([abs(j[0] - f64) for _, j in runs]))
    gap_port = float(np.mean([abs(p[0] - f64) for p, _ in runs]))
    assert gap_port <= 0.01 * abs(f64) or gap_port <= 2 * mean_jax, (
        f"{name}: port {port}, JAX {jax_}, float64 {f64:.6g}; over {ORDERINGS} orderings "
        f"of the points the port's mean gap to float64 {gap_port:.6g} (mean cost "
        f"{mean_port:.6g}) against JAX's {mean_jax:.6g}: "
        f"{[(round(p[0], 2), round(j[0], 2)) for p, j in runs]}")
    return "orderings"


def _port_fn(fn, dtype=torch.float32, coarse=False):
    """``_port`` of ``fn`` as a window -> (cost, iterations, stop) function;
    ``coarse``: the stop as the cap or an earlier end."""
    def call(w, n_fixed):
        r = _port(fn, w, n_fixed, dtype)
        return r[:2] + (_classify(r[1], ""),) if coarse else r
    return call


PORT_K3 = _port_fn(ba_kernel.lm_solve_plain)
PORT_K3_COARSE = _port_fn(ba_kernel.lm_solve_plain, coarse=True)
PORT_K3_64 = _port_fn(ba_kernel.lm_solve_plain, torch.float64)
PORT_GRID = _port_fn(tbg.ba_solve_grid_impl, coarse=True)
PORT_GRID_64 = _port_fn(tbg.ba_solve_grid_impl, torch.float64)
JAX_K3 = _kept("jax k3", _jax_k3)
JAX_GRID = _kept("jax grid", _jax_grid)


def _k3_against(name):
    """K3's function and the JAX solver it is held to on window ``name``:
    the TPU kernel's twin where the JAX package's TPU kernel takes the
    window (``ba_pallas.eligible_shape``), else JAX's grid solver (the stops
    then compared as the cap or an earlier end)."""
    w = WIDE_WINDOWS.get(name) or WINDOWS[name]
    P, D = w["cam_slot"].shape
    if jbp.eligible_shape(w["rvecs"].shape[0], P, D, int(w["n_fixed"])):
        return PORT_K3, JAX_K3
    return PORT_K3_COARSE, JAX_GRID


@contextlib.contextmanager
def _threads(name):
    """torch's threads for window ``name``'s solves: ``WIDE_THREADS`` for a
    wide window, one for the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(WIDE_THREADS if name in WIDE_WINDOWS else 1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


ALL = sorted(WINDOWS) + sorted(WIDE_WINDOWS)


@pytest.mark.parametrize("name", ALL)
def test_k3_function_holds_to_reference_lm(name):
    """K3's plain version (the kernel's function) against the TPU kernel's
    JAX twin on one captured window; past the TPU kernel's 12 slots,
    against the JAX package's grid solver, which runs those windows."""
    port, jax_ = _k3_against(name)
    with _threads(name):
        _hold(name, port, jax_, PORT_K3_64)


@pytest.mark.parametrize("name", ALL)
def test_grid_solver_holds_to_jax_grid_solver(name):
    """The port's grid solver against JAX's on one captured window; the
    stops compared as the cap or an earlier end (JAX's keeps no lambda)."""
    with _threads(name):
        _hold(name, PORT_GRID, JAX_GRID, PORT_GRID_64)


def _float64_record(name) -> dict:
    """Rule (b)'s record of window ``name`` (``stress.hold_float64``): K3's
    function and the port's grid solver, both in float64, their point-block
    inverses, and K3's function's float64 path held to the grid solver per
    state."""
    w = _padded(name)
    n_fixed = int(w["n_fixed"])
    key = ("rule b", id(w))
    if key not in _SOLVES:
        rec = dict(index=name,
                   plain64=_port_stats(ba_kernel.lm_solve_plain, w, n_fixed, torch.float64),
                   grid64=_port_stats(tbg.ba_solve_grid_impl, w, n_fixed, torch.float64))
        rec.update(stress.hold_float64(rec, _grid(w), dict(OPTS, n_fixed=n_fixed)))
        _SOLVES[key] = rec
    return _SOLVES[key]


def _grid(w) -> BAProblemGrid:
    return BAProblemGrid(**{k: torch.as_tensor(w[k]) for k in FIELDS})


@pytest.mark.parametrize("name", sorted(WIDE_WINDOWS))
def test_k3_function_and_grid_solver_agree_in_float64(name):
    """Rule (b) on a window of the long drive: from every state of K3's
    function's float64 path compared (all where the whole float64 solves
    part, the first eight where they agree), one LM iteration of it and of
    the grid solver ends within 1e-4, the point blocks inverted by one
    formula, and K3's point-block inverse is the grid solver's within 1e-9
    on blocks float64 resolves; for a window that diverged in the drive,
    whether the JAX grid solver diverges on it too is printed."""
    with _threads(name):
        rec = _float64_record(name)
        card = json.loads(str(WIDE_WINDOWS[name]["card"]))
        if card.get("drive_diverged"):
            print(f"{name} diverged in the drive; on the CPU: {_diverges(name)}")
    assert stress.float64_holds(rec), rec


def _diverges(name) -> dict:
    """Which solves diverge on window ``name`` on the CPU (the squared cost
    does not fall, as the pipeline rejects a window): JAX's grid solver,
    the port's K3 function and grid solver, and both in float64."""
    w = _padded(name)
    n_fixed = int(w["n_fixed"])
    st = JAX_GRID_STATS(w, n_fixed)
    out = {"JAX grid": float(st.final_sq) >= float(st.initial_sq)}
    for solver, fn in (("K3 function", ba_kernel.lm_solve_plain),
                       ("grid", tbg.ba_solve_grid_impl)):
        out[solver] = _port_stats(fn, w, n_fixed)["diverged"]
    rec = _float64_record(name)
    out.update({k: rec[k]["diverged"] for k in ("plain64", "grid64")})
    return out


def _first_slot_only(solve_step):
    """K3's plain step with a planted defect: a camera that sees a point
    through several slots adds only the first of them to its coupling block,
    its U block and its gradient."""
    def step(rv, tv, pts, p, live, onehot, *a):
        first = (torch.cumsum(onehot, dim=1) == 1).to(onehot.dtype)
        return solve_step(rv, tv, pts, p, live, onehot * first, *a)
    return step


def _short_of(solve_step, share=0.9):
    """K3's plain step with a planted defect: ``share`` of the right step."""
    def step(*a):
        return tuple(share * d for d in solve_step(*a))
    return step


def test_rule_b_fails_with_a_camera_counted_once_per_point(monkeypatch):
    """Rule (b) has teeth: with K3's plain version adding only the first
    slot of a camera repeated on a point, K3's function's float64 path
    parts from the grid solver's past ``stress.FLOAT64_REL`` within its
    first ``stress.PATH_STATES`` states on every committed window past 12
    slots (the shipped function passes,
    ``test_k3_function_and_grid_solver_agree_in_float64``), where the whole
    float64 solves may still agree: a step of the wrong curvature still
    converges to the same minimum."""
    monkeypatch.setattr(ba_kernel, "_solve_step", _first_slot_only(ba_kernel._solve_step))
    wide = [n for n in sorted(WIDE_WINDOWS) if _slots(n) > TPU_MAX_SLOTS]
    assert wide
    for name in wide:
        w = _padded(name)
        with _threads(name):
            path = stress.float64_path(_grid(w), dict(OPTS, n_fixed=int(w["n_fixed"]),
                                                      max_iterations=stress.PATH_STATES))
        assert path["worst"] > stress.FLOAT64_REL, (name, path)


def _k3_as(step_of):
    """A stand-in for K3 (``ba_kernel.lm_solve``) on the CPU: its plain
    version with the step ``step_of(ba_kernel._solve_step)``."""
    plain, own = ba_kernel.lm_solve_plain, ba_kernel._solve_step

    def solve(grid, **kw):
        ba_kernel._solve_step = step_of(own)
        try:
            return plain(grid, **kw)
        finally:
            ba_kernel._solve_step = own
    return solve


def _grid_inverse(solve_step):
    """K3's plain step with the grid solver's point-block inverse: the same
    function in another float order."""
    def step(*a):
        with stress.one_point_inverse():
            return solve_step(*a)
    return step


#: the committed windows rule (a)'s tests walk: the one where the float32
#: solves part the most on the card, the diverged one, and one whose whole
#: float64 solves part
RULE_A_WINDOWS = ("a2_w0057", "a2_w0062", "a2_w0014")


@pytest.mark.parametrize("k3, holds", [("in another float order", True),
                                       ("a camera counted once per point", False),
                                       ("0.9 of the step", False)])
def test_rule_a_holds_k3_to_its_plain_version_per_state(monkeypatch, k3, holds):
    """Rule (a) (``stress.float32_path``, ``stress.window_rule``) on the
    committed windows with a stand-in for K3: its plain version with the
    grid solver's point-block inverse (another float order of one function)
    holds; with a camera repeated on a point counted once, or with 0.9 of
    the right step, K3 ends above its plain version on too many of the
    states (or one state past ``stress.FLOAT32_REL``) and the rule fails."""
    step_of = {"in another float order": _grid_inverse,
               "a camera counted once per point": _first_slot_only,
               "0.9 of the step": _short_of}[k3]
    monkeypatch.setattr(ba_kernel, "lm_solve", _k3_as(step_of))
    recs = []
    for name in RULE_A_WINDOWS:
        w = _padded(name)
        with _threads(name):
            recs.append(dict(index=name, path32=stress.float32_path(
                _grid(w), dict(OPTS, n_fixed=int(w["n_fixed"])), witness=False)))
    a = stress.window_rule([dict(r, **_made_up(100.0, 100.0)) for r in recs])["a"]
    assert a["passed"] == holds, a


def _made_up(k3, grid, stop="ftol"):
    """A made-up window's whole solves: K3's, its plain version's (K3's) and
    the grid solver's final costs."""
    def s(cost, its=20):
        return dict(final_cost=cost, iterations=its, stop=stop, diverged=False)
    return dict(k3=s(k3), grid=s(grid), plain=s(k3))


def _record(index, k3, grid, path=None, state=(1e-4, 5, 5)):
    """A made-up held window: K3's, its plain version's (K3's) and the grid
    solver's final costs; rule (a)'s float32 path, its worst gap and the
    states where K3 ends above and below its plain version (``state``);
    with ``path``, rule (b)'s float64 tests, the path's worst gap
    ``path``."""
    worst, higher, lower = state
    rec = dict(index=index, **_made_up(k3, grid),
               path32=dict(states=higher + lower, worst=worst, at=0, decide_otherwise=0,
                           higher=higher, lower=lower))
    if path is not None:
        rec.update(plain64=rec["k3"], grid64=rec["k3"], whole_agree=True,
                   path64=dict(states=8, worst=path, at=0, decide_otherwise=0),
                   inverse=dict(worst=1e-13, sound=100, ill=0))
    return rec


@pytest.mark.parametrize("case", ["sign test passes", "sign test fails", "float64 disagrees",
                                  "a state past the float32 bound",
                                  "K3 the lower on one window's states",
                                  "K3 the higher on too many states"])
def test_window_rule(case):
    """``stress.window_rule`` on made-up records: ten windows that part
    with K3 the higher on five (p = 0.62) pass; K3 the higher on all ten
    (p = 2 ** -10) fails rule (c); a window whose float64 path parts by
    1e-3 at a state fails rule (b) by name, another at 1e-5 holding; a
    window whose float32 path parts by 0.2 at a state fails rule (a) by
    name; one window where K3 ends below its plain version on all 60
    states is listed and fails rule (a) over all (115 of 170 below), and
    so does K3 the higher on 9 of 12 states on every window (99 of 132),
    no window listed."""
    state = (1e-4, 9, 3) if case == "K3 the higher on too many states" else (1e-4, 5, 5)
    recs = [_record(i, 100.0 + (5 if (i < 5 or case == "sign test fails") else -5), 100.0,
                    state=state) for i in range(10)]
    recs.append(_record(10, 50.0, 50.0, path=1e-5, state=state))
    if case == "float64 disagrees":
        recs.append(_record(11, 40.0, 40.0, path=1e-3))
    if case == "a state past the float32 bound":
        recs.append(_record(11, 40.0, 40.0, state=(0.2, 5, 5)))
    if case == "K3 the lower on one window's states":
        recs.append(_record(11, 40.0, 40.0, state=(1e-3, 0, 60)))
    rule = stress.window_rule(recs)
    assert rule["c"]["n"] == 10
    if case == "sign test passes":
        assert rule["passed"] and rule["c"]["k"] == 5 and rule["c"]["p"] > 0.5
        assert rule["c"]["mean_gap"] == pytest.approx(0.0)
        assert rule["a"]["k"] == 55 and rule["a"]["n"] == 110 and rule["a"]["p"] > 0.5
    elif case == "sign test fails":
        assert not rule["passed"] and not rule["c"]["passed"] and rule["b"]["passed"]
        assert rule["c"]["k"] == 10 and rule["c"]["p"] == pytest.approx(2.0 ** -10)
        assert rule["c"]["mean_gap"] == pytest.approx(0.05) and rule["c"]["stderr"] == 0.0
    elif case == "float64 disagrees":
        assert not rule["passed"] and rule["c"]["passed"] and rule["a"]["passed"]
        assert rule["b"]["failures"] == [11] and rule["b"]["windows"] == 2
    elif case == "a state past the float32 bound":
        assert not rule["passed"] and rule["b"]["passed"] and rule["c"]["passed"]
        assert rule["a"]["failures"] == [11] and rule["a"]["worst_window"] == 11
    elif case == "K3 the lower on one window's states":
        assert not rule["passed"] and rule["a"]["failures"] == [] and rule["a"]["split"] == [11]
        assert rule["a"]["k"] == 55 and rule["a"]["n"] == 170
        assert rule["a"]["least_window"] == 11 and rule["a"]["p"] < stress.SIGN_LEVEL
    else:
        assert not rule["passed"] and rule["a"]["failures"] == [] and rule["a"]["split"] == []
        assert rule["a"]["k"] == 99 and rule["a"]["n"] == 132
        assert rule["a"]["p"] < stress.SIGN_LEVEL < rule["a"]["least_p"]


def test_the_captured_windows_are_the_cards():
    """The file holds what the card recorded of each window, and at most
    1 MB; the windows are small (at most 8 cameras and 4096 points)."""
    assert os.path.getsize(DATA) <= 1 << 20
    for name, w in WINDOWS.items():
        rec = json.loads(str(w["card"]))
        P, D = w["cam_slot"].shape
        assert w["rvecs"].shape[0] <= 8 and P <= 4096, name
        assert rec["P_live"] == P and rec["D"] == D and rec["C"] == w["rvecs"].shape[0]
        assert {"k3", "grid", "plain"} <= set(rec)


def test_the_wide_windows_are_the_cards():
    """The wide file holds at most 12 windows in at most 6 MB, each what the
    card recorded of it: past 12 slots per point, or diverged in the drive."""
    assert os.path.getsize(WIDE) <= 6 << 20 and 0 < len(WIDE_WINDOWS) <= 12
    for name, w in WIDE_WINDOWS.items():
        rec = json.loads(str(w["card"]))
        P, D = w["cam_slot"].shape
        assert rec["P_live"] == P and rec["D"] == D and rec["C"] == w["rvecs"].shape[0]
        assert {"k3", "grid", "plain"} <= set(rec) and (D > 12 or rec["drive_diverged"])


def record(src: str, chosen: str = None, out: str = WIDE) -> None:
    """Write ``out`` from a directory of ``chip_smoke.py``'s held windows
    (``hold_wide_windows``: ``w####.npz`` and ``windows.json``): the
    windows ``chosen`` (their indices, joined by commas; by default all it
    chose to commit), each with the card's record of it."""
    with open(os.path.join(src, "windows.json")) as f:
        held = json.load(f)
    recs = {r["index"]: r for r in held["windows"]}
    which = [int(i) for i in chosen.split(",")] if chosen else held["chosen"]
    arrays = {}
    for i in which:
        with np.load(os.path.join(src, f"w{i:04d}.npz")) as z:
            arrays.update({f"w{i:04d}/{k}": z[k] for k in z.files})
        arrays[f"w{i:04d}/card"] = np.array(json.dumps(recs[i]))
    np.savez_compressed(out, **arrays)
    print(f"{out}: {len(which)} windows, {os.path.getsize(out)} bytes")


def main():
    """Each window's final costs, iterations and stops: the port's and the
    JAX package's solvers, float64, the card's record, and how the test
    holds it (one JSON line per window and solver)."""
    for name in ALL:
        w = _padded(name)
        n_fixed = int(w["n_fixed"])
        card = json.loads(str((WIDE_WINDOWS.get(name) or WINDOWS[name])["card"]))
        if card.get("drive_diverged"):
            print(json.dumps(dict(window=name, diverged_in_the_drive=_diverges(name))))
        port3, jax3 = _k3_against(name)
        for solver, port_fn, jax_fn, f64_fn in (
                ("k3", port3, jax3, PORT_K3_64),
                ("grid", PORT_GRID, JAX_GRID, PORT_GRID_64)):
            try:
                how = _hold(name, port_fn, jax_fn, f64_fn)
            except AssertionError as e:
                how = f"fails: {e}"
            print(json.dumps(dict(
                window=name, solver=solver, port=port_fn(w, n_fixed), jax=jax_fn(w, n_fixed),
                float64=f64_fn(w, n_fixed), card=card["k3" if solver == "k3" else "grid"],
                how=how)), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--record"]:
        record(*sys.argv[2:4])
    else:
        main()
