"""Long-sequence stress harness: the counterpart of the JAX package's
``tools/stress.py``, with its flags and its JSON keys.

Drives ``preset_lehman_indoor`` (culling, relocalization, loop closure)
end to end through the port's CLI, ``bundle_adjustment_tpu_torch.run``, flag
for flag as the JAX harness drives its own (``--preset lehman_indoor --size
640x480 --consistent-convention --features 1500``, the camera of the
render), on a 600-frame render of the closed textured room, and scores the
run: keyframes, culled points, pruned observations, divergences,
relocalizations, capacity drops, closures, ATE against the ground truth over
the path length, frames/s.  Two keys more than the JAX harness's:
``ate_pct_of_extent`` (ATE over the extent of the keyframes' ground-truth
centres, the denominator PERF.md uses) and ``device`` (the card's name and
power limit as ``nvidia-smi`` gives them, or "cpu").

    python -m bundle_adjustment_tpu_torch.tools.stress --out OUT
    python -m bundle_adjustment_tpu_torch.tools.stress --video \\
        .dedup_study/s2_d3_cpu/sequence.mp4 --seed 2 --out OUT

The input is the port's render (``utils/synthetic.synthetic_sequence``),
written as ``OUT/sequence.mp4`` through cv2 as the JAX harness writes it, or
with ``--png`` as a folder of PNG files that needs no cv2; or, with
``--video``, a sequence written earlier (a JAX cell's ``sequence.mp4``, read
as it is through cv2, which is then needed: without it the harness stops
and names it), scored against the ground truth of ``--seed`` and
``--frames``.  ``--device cpu`` runs the pipeline on the CPU (for the
tests); by default it runs on the card.

``--route NAME`` runs the drive under one of ``ROUTES``: the window
solver or the frontend swapped for another function or path, to tell which
layer moves the drive (``chip_smoke.py --routes``, ``dedup_study
--route``).  ``--hold-windows DIR`` solves every window that K3 takes once
more through the grid solver and K3's plain version on the same input,
records the three beside each other (``DIR/windows.json``) and keeps the
windows where they part and those just before the run's first Rotation
keyframe (``DIR/w*.npz``, the live points only), for the CPU tests to hold
to the JAX package.  The result carries ``breakdowns``: each Rotation
trigger, each discarded frame and the map's maintenance counts, read from
the run's events (``breakdowns``).  ``hold_window`` and ``window_rule``
(rules (a)-(d)) hold the long drive's windows past 12 slots and those that
diverge to K3's plain version, the grid solver and, on the states float32
resolves (``slot_test``, ``state_resolution``), to K3's function in
float64 (``chip_smoke.py`` phase 11, ``tests/test_torch_stress_windows.py``,
``tests/test_torch_resolution.py``), per LM state along a path where whole
solves cannot be held (``lm_path``; ``chip_smoke.py`` phase 9 walks K4's
so); ``k4_path`` walks K4's against the grid solver's step in float64 with
CG to convergence (phase 11's ``hold_to_grid``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import time
import types

import numpy as np

#: the render's camera: ``synthetic_sequence``'s defaults, 640 x 480
WIDTH, HEIGHT, FX = 640, 480, 450.0


def device_name(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or "cpu"."""
    if device == "cpu":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        import torch

        return f"{torch.cuda.get_device_name(0)} (nvidia-smi not read)"


#: the lane of K4's setup reduction (``red``, 54 lanes per camera: 21 of
#: the camera block, then the camera gradient's six) that the "K4 setup
#: gradient lane" routing scales: the gradient's rotation x
GRADIENT_LANE = 21


#: the routings of ``--route``: each the keywords of ``routed``.  "as
#: shipped": nothing switched (the step's null vectors from the SVD of A on
#: the card, ``small_linalg.null_vector``); "grid windows": every window on
#: the grid solver (``use_pallas_ba=False``, as the JAX package solves them
#: on the CPU); "K3 plain": K3's function without the kernel on every window
#: K3 takes; "no graph replay": the staged frontend (``fused_frontend=
#: False``); "eager step": the fused step run eagerly on the card, not
#: replayed as a CUDA graph; "CPU eigh": that, with the step's null vectors
#: (the PnP DLT's and the triangulation's, as an eigh of A^T A) and SVDs
#: (the pose's nearest rotation) solved on the CPU by LAPACK, as the JAX
#: package solves them there ("only": the one or the other); "float64 ...":
#: those solved on the card in float64 by ``torch.linalg`` (the inputs cast
#: up, the results down); "cuSOLVER eigh": the null vectors from cuSOLVER's
#: batched float32 eigh of A^T A on the card (``small_linalg.eigh``), as the
#: port took them before it took the SVD of A ("in the PnP DLT", "in
#: triangulation": at that call site only); "corrected eigh": those with
#: ``small_linalg.refine_null_vector``'s correction; "K4 setup ...":
#: planted defects of K4's setup role (``defective_setup``) for phase 11's
#: holds of ``chip_smoke.py``: the Huber threshold times 1e6 (least-squares
#: weights) or times 1.5, or one lane of the camera gradient (rotation x)
#: times 1.5; the rest hold K3's or K4's gate to
#: the TPU's 12 slots per point, or send K3's windows past 12 slots to its
#: plain version.  Names joined by "+" run together (``routing``).
ROUTES = {
    "as shipped": {},
    "grid windows": dict(grid_windows=True),
    "K3 plain": dict(k3_plain_past=0),
    "no graph replay": dict(staged=True),
    "eager step": dict(eager_step=True),
    "CPU eigh": dict(eager_step=True, host_linalg=("eigh", "svd")),
    "CPU eigh only": dict(eager_step=True, host_linalg=("eigh",)),
    "CPU svd only": dict(eager_step=True, host_linalg=("svd",)),
    "float64 eigh": dict(eager_step=True, linalg64=("eigh",)),
    "float64 eigh and svd": dict(eager_step=True, linalg64=("eigh", "svd")),
    "cuSOLVER eigh": dict(null="eigh"),
    "cuSOLVER eigh in the PnP DLT": dict(null="eigh", null_at="pnp"),
    "cuSOLVER eigh in triangulation": dict(null="eigh", null_at="triangulation"),
    "corrected eigh": dict(null="corrected"),
    "K4 setup defect": dict(k4_defect=dict(huber=1e6)),
    "K4 setup Huber x1.5": dict(k4_defect=dict(huber=1.5)),
    "K4 setup gradient lane x1.5": dict(k4_defect=dict(lane=GRADIENT_LANE, scale=1.5)),
    "K3 at D <= 12": dict(k3_max_slots=12),
    "K4 at D <= 12": dict(k4_max_slots=12),
    "both at D <= 12": dict(k3_max_slots=12, k4_max_slots=12),
    "K3 plain past 12": dict(k3_plain_past=12),
}

def routing(name: str) -> dict:
    """The keywords of ``routed`` for a routing of ``ROUTES``, or for
    several joined by "+" (e.g. "cuSOLVER eigh+K4 setup defect")."""
    kw = {}
    for part in name.split("+"):
        if part not in ROUTES:
            raise KeyError(f"{part!r} is not a routing; one of {sorted(ROUTES)}")
        kw.update(ROUTES[part])
    return kw


def defective_setup(setup, huber: float = 1.0, lane: int = None, scale: float = 1.0):
    """K4's setup role ``setup`` with a planted defect: its Huber weights
    taken at ``huber`` times the threshold (lane 5 of ``scal``), and lane
    ``lane`` of its camera reduction times ``scale``; the other roles as
    they are.  A uniform scale of the weights would not be a defect that
    any hold could see: the LM's damping is a multiple of the normal
    matrix's diagonal (``ba._damp``), so the step would not change."""
    import torch

    def call(cam, ptT, slotT, maskT, uvT, pmask, scal, n_fixed, index=None):
        scal = torch.cat([scal[:5], scal[5:6] * huber, scal[6:]])
        out = setup(cam, ptT, slotT, maskT, uvT, pmask, scal, n_fixed, index)
        if lane is not None:
            out[3][:, lane].mul_(scale)      # in place: the kernel's buffer
        return out
    return call


@contextlib.contextmanager
def routed(preset: str, grid_windows: bool = False, staged: bool = False,
           eager_step: bool = False, host_linalg: tuple = (), linalg64: tuple = (),
           null: str = None, null_at: str = None, k3_plain_past: int = None,
           k3_max_slots: int = None, k4_max_slots: int = None, k4_defect: dict = None):
    """The CLI's preset ``preset`` and the solvers' modules switched to a
    routing of ``ROUTES`` for the duration of the block, then put back."""
    import torch

    from bundle_adjustment_tpu_torch import run as run_mod
    from bundle_adjustment_tpu_torch.models import frontend
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk
    from bundle_adjustment_tpu_torch.ops import ba_kernel, ransac, small_linalg, triangulation

    orig_preset = run_mod.PRESETS[preset]
    linalg = small_linalg.null_vector, small_linalg.svd
    k3, k4, solve3 = ba_kernel.eligible_shape, gk.eligible_shape_global, ba_kernel.lm_solve
    solve4 = gk.solve
    replay = frontend.TrackStep._replay

    def preset_fn():
        cfg = orig_preset()
        if grid_windows:
            cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, use_pallas_ba=False))
        return dataclasses.replace(cfg, fused_frontend=False) if staged else cfg

    def k3_gate(C, P, D, n_fixed=1):
        return D <= k3_max_slots and k3(C, P, D, n_fixed)

    def k4_gate(C, P, D, n_fixed=1):
        return D <= k4_max_slots and k4(C, P, D, n_fixed)

    def plain_past(g, **kw):
        return (ba_kernel.lm_solve_plain if g.cam_slot.shape[1] > k3_plain_past
                else solve3)(g, **kw)

    def eager(self, args, static):
        return frontend.track_step(*args, **static)

    def moved(fn, cast):
        """``fn`` on ``cast(A)``, its results back in A's dtype on A's device."""
        def call(A):
            out = fn(cast(A))
            return out.to(A) if torch.is_tensor(out) else tuple(t.to(A) for t in out)
        return call

    # by the name of the routing: the function it replaces, and LAPACK's or
    # PyTorch's own solver in its place
    def normal(A):
        return torch.matmul(A.transpose(-1, -2), A)

    solvers = dict(eigh=("null_vector", lambda A: torch.linalg.eigh(normal(A))[1][..., :, 0]),
                   svd=("svd", torch.linalg.svd))
    run_mod.PRESETS[preset] = preset_fn
    if k3_max_slots is not None:
        ba_kernel.eligible_shape = k3_gate
    if k4_max_slots is not None:
        gk.eligible_shape_global = k4_gate
    if k3_plain_past is not None:
        ba_kernel.lm_solve = plain_past
    if eager_step:
        frontend.TrackStep._replay = eager
    for name in host_linalg:
        setattr(small_linalg, solvers[name][0], moved(solvers[name][1], lambda A: A.cpu()))
    for name in linalg64:
        setattr(small_linalg, solvers[name][0], moved(solvers[name][1], lambda A: A.double()))
    def corrected(A):
        N = normal(A)
        return small_linalg.refine_null_vector(N, small_linalg.eigh(N)[1])

    nulls = dict(corrected=corrected,
                 eigh=lambda A: small_linalg.eigh(normal(A))[1][..., :, 0])
    # a call site alone: its module reads small_linalg through a namespace
    # whose null_vector is the routing's
    site = dict(pnp=ransac, triangulation=triangulation).get(null_at)
    if null and site is not None:
        names = {k: getattr(small_linalg, k) for k in dir(small_linalg) if not k.startswith("__")}
        site.small_linalg = types.SimpleNamespace(**dict(names, null_vector=nulls[null]))
    elif null:
        small_linalg.null_vector = nulls[null]
    if k4_defect:
        roles = gk._KERNELS._replace(setup=defective_setup(gk._KERNELS.setup, **k4_defect))
        gk.solve = functools.partial(solve4, roles=roles)
    try:
        yield
    finally:
        small_linalg.null_vector, small_linalg.svd = linalg
        ransac.small_linalg = triangulation.small_linalg = small_linalg
        run_mod.PRESETS[preset] = orig_preset
        ba_kernel.eligible_shape, gk.eligible_shape_global, ba_kernel.lm_solve = k3, k4, solve3
        gk.solve = solve4
        frontend.TrackStep._replay = replay


def breakdowns(events: list) -> dict:
    """The run's tracking breakdowns and map maintenance from its events:
    each "Rotation" keyframe trigger (frame, ``rotation_rad``, ``tracked``,
    ``num_inliers``), each discarded frame, and the pruned observations,
    culled points, failed relocalizations and divergences."""
    rot = [[e["frame_idx"], e.get("rotation_rad"), e.get("tracked"), e.get("num_inliers")]
           for e in events
           if e["event"] == "keyframe_trigger" and e.get("reason") == "Rotation"]
    return {
        "rotation_triggers": rot,
        "discarded_frames": [e["frame_idx"] for e in events
                             if e["event"] == "frame_discarded"],
        "pruned_obs": int(sum(e.get("pruned", 0) for e in events if e["event"] == "prune")),
        "culled_points": int(sum(e.get("culled", 0) for e in events if e["event"] == "cull")),
        "reloc_fail": sum(1 for e in events
                          if e["event"] == "relocalization" and not e.get("success")),
        "divergences": sum(1 for e in events if e["event"] == "ba_diverged"),
    }


def tally(events: list, keyframes: int) -> dict:
    """A drive's decisions from its events, in the form that both packages'
    event logs give: the keyframes, the statuses, the keyframe triggers by
    reason and the "Rotation" ones, the discarded frames (``frame_discarded``
    events, as ``breakdowns`` counts them: a frame whose relocalization then
    succeeds counts too) by ``why`` and the first of them, relocalizations
    (successes/attempts) and failed ones, ``loop_reject`` stages and
    closures."""
    def count(event, key):
        out = {}
        for e in events:
            if e["event"] == event:
                out[e[key]] = out.get(e[key], 0) + 1
        return out

    relocs = [e for e in events if e["event"] == "relocalization"]
    discarded = [e["frame_idx"] for e in events if e["event"] == "frame_discarded"]
    triggers = count("keyframe_trigger", "reason")
    return dict(keyframes=keyframes, statuses=count("frame_timing", "status"),
                triggers=triggers, rotation=triggers.get("Rotation", 0),
                discarded=len(discarded), discarded_why=count("frame_discarded", "why"),
                first_discarded=discarded[0] if discarded else None,
                relocalizations=f"{sum(bool(e['success']) for e in relocs)}/{len(relocs)}",
                reloc_fail=sum(not e["success"] for e in relocs),
                loop_reject=count("loop_reject", "stage"),
                closures=sum(e["event"] == "loop_closure" for e in events))


def stats_summary(stats) -> dict:
    """A solve's ``BAStats`` as numbers: its initial and final cost and
    squared cost, LM iterations, the stop test (``ba.STOP_TESTS``; "cap"
    for a solver that records none), and whether it diverged as the
    pipeline rejects a window (its squared cost did not fall)."""
    from bundle_adjustment_tpu_torch.ops.ba import STOP_TESTS

    return dict(initial_cost=float(stats.initial_cost), final_cost=float(stats.final_cost),
                initial_sq=float(stats.initial_sq), final_sq=float(stats.final_sq),
                iterations=int(stats.iterations),
                stop=STOP_TESTS[int(stats.stop)] if stats.stop is not None else "cap",
                diverged=float(stats.final_sq) >= float(stats.initial_sq))


def save_window(out_dir: str, index: int, grid, n_fixed: int) -> str:
    """Save a window's problem as ``out_dir/w{index:04d}.npz``, its live
    points only (the fields of ``BAProblemGrid`` and ``n_fixed``); returns
    the path."""
    keep = grid.point_mask.bool().nonzero().flatten()
    path = os.path.join(out_dir, f"w{index:04d}.npz")
    np.savez_compressed(
        path, n_fixed=n_fixed,
        **{k: getattr(grid, k).index_select(0, keep).cpu().numpy()
           if k in ("points", "cam_slot", "uv", "mask", "point_mask")
           else getattr(grid, k).cpu().numpy() for k in grid._fields})
    return path


def hold_window(grid, kw: dict, solvers=("k3", "plain", "grid")) -> dict:
    """One window (``grid``, the solver's keyword arguments ``kw``, its
    ``n_fixed`` among them) solved on its device by each of ``solvers``:
    "k3" (``ba_kernel.lm_solve``: the kernel on the card, its plain version
    on the CPU), "plain" (K3's plain version), "grid" (the grid dense
    solver), "plain64" and "grid64" (the last two in float64).  Returns
    each solve's ``stats_summary`` and its seconds (to a device
    synchronise), keyed by solver."""
    import torch

    from bundle_adjustment_tpu_torch.ops import ba_grid, ba_kernel

    g64 = as_float64(grid) if any(name.endswith("64") for name in solvers) else None
    runs = dict(k3=(ba_kernel.lm_solve, grid), plain=(ba_kernel.lm_solve_plain, grid),
                grid=(ba_grid.ba_solve_grid_impl, grid),
                plain64=(ba_kernel.lm_solve_plain, g64),
                grid64=(ba_grid.ba_solve_grid_impl, g64))
    out = {}
    for name in solvers:
        fn, g = runs[name]
        t0 = time.perf_counter()
        out[name] = stats_summary(fn(g, **kw)[3])
        if g.rvecs.is_cuda:
            torch.cuda.synchronize()
        out[name]["seconds"] = time.perf_counter() - t0
    return out


@contextlib.contextmanager
def hold_windows(out_dir: str):
    """Every window K3 takes inside the block solved once more through the
    grid solver and K3's plain version on the same input (on its device):
    their final costs, iterations and stop tests (``ba.STOP_TESTS``) beside
    K3's in ``records`` (yielded; one dict per window, with the frame whose
    local BA made it), each window saved as ``out_dir/w{index}.npz``
    (``save_window``; ``select_windows`` keeps a few)."""
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.ops import ba_grid, ba_kernel

    os.makedirs(out_dir, exist_ok=True)
    records, frame = [], {"idx": -1}
    solve3 = ba_kernel.lm_solve
    orig_lba = VisualOdometryPipeline.run_local_ba

    def run_local_ba(self, *a, **kw):
        frame["idx"] = self.frame_idx
        return orig_lba(self, *a, **kw)

    def held(grid, n_fixed=1, **kw):
        res = solve3(grid, n_fixed=n_fixed, **kw)
        P, D = grid.cam_slot.shape
        rec = dict(index=len(records), frame=frame["idx"], C=int(grid.rvecs.shape[0]),
                   n_fixed=int(n_fixed), P=int(P), P_live=int(grid.point_mask.sum()),
                   D=int(D), opts=dict(kw), k3=stats_summary(res[3]))
        for name, fn in (("grid", ba_grid.ba_solve_grid_impl),
                         ("plain", ba_kernel.lm_solve_plain)):
            rec[name] = stats_summary(fn(grid, n_fixed=n_fixed, **kw)[3])
        records.append(rec)
        save_window(out_dir, rec["index"], grid, n_fixed)
        return res

    ba_kernel.lm_solve = held
    VisualOdometryPipeline.run_local_ba = run_local_ba
    try:
        yield records
    finally:
        ba_kernel.lm_solve = solve3
        VisualOdometryPipeline.run_local_ba = orig_lba


def parted(rec: dict, a: str = "k3", b: str = "grid") -> bool:
    """Whether two solves of a held window part (by default K3 and the grid
    solver): final costs more than 1 % apart, another stop, or one diverges
    and not the other."""
    a, b = rec[a], rec[b]
    return (abs(a["final_cost"] - b["final_cost"]) > 0.01 * max(abs(b["final_cost"]), 1e-12)
            or a["stop"] != b["stop"] or a["diverged"] != b["diverged"])


def lm_path(solve_a, solve_b, grid, kw: dict):
    """``solve_a``'s LM path on ``grid``, one iteration at a time: its
    one-iteration solve (``max_iterations=1``) chained from the start, each
    from the state and damping the previous one left (``solve_a``'s
    accept/reject and ``ba.next_lambda``), and at each state ``solve_b``'s
    one LM iteration from the same state and damping.  Both start each
    state from the same inputs, so no rounding is carried from one state to
    the next.  Yields per state its record (``iteration``, ``lam``, each
    solve's start cost (``start``, ``start_b``) and end cost and whether it
    accepted, and ``gap``,
    |a - b| / |b|), the state and the one-iteration arguments; stops after
    ``kw``'s ``max_iterations`` states or where ``solve_a``'s step meets a
    stop test."""
    import torch

    from bundle_adjustment_tpu_torch.ops import ba

    lam, state = kw.get("lambda_init", 1e-3), grid
    for n in range(kw.get("max_iterations", 50)):
        one = dict(kw, max_iterations=1, lambda_init=lam)
        rv, tv, pt, a = solve_a(state, **one)
        b = solve_b(state, **one)[3]
        ca, cb = float(a.final_cost), float(b.final_cost)
        rec = dict(iteration=n, lam=lam, start=float(a.initial_cost),
                   start_b=float(b.initial_cost), a=ca, b=cb,
                   a_accepted=bool(a.accepted), b_accepted=bool(b.accepted),
                   gap=abs(ca - cb) / max(abs(cb), 1e-30))
        yield rec, state, one
        state = state._replace(rvecs=rv, tvecs=tv, points=pt)
        lam = float(ba.next_lambda(
            torch.tensor(lam, dtype=torch.float64), torch.tensor(rec["a_accepted"]),
            kw.get("lambda_up", 4.0), kw.get("lambda_down", 0.5),
            kw.get("lambda_min", 1e-10), kw.get("lambda_max", 1e8)))
        if int(a.stop) != 0:
            break


def path_summary(states: list) -> dict:
    """``lm_path``'s records of one path: the states compared, the worst
    gap and its iteration, the states where the two solves decide otherwise
    (accept or reject), and those where the first ends above and below the
    second."""
    worst = max(states, key=lambda r: r["gap"])
    return dict(states=len(states), worst=worst["gap"], at=worst["iteration"],
                decide_otherwise=sum(r["a_accepted"] != r["b_accepted"] for r in states),
                higher=sum(r["a"] > r["b"] for r in states),
                lower=sum(r["a"] < r["b"] for r in states))


def as_float64(grid):
    """``grid`` with its floating fields in float64."""
    return type(grid)(*(t.double() if t.is_floating_point() else t for t in grid))


def k3_terms(g):
    """The residuals (P, D, 2) of K3's formula (``ba_kernel._slot_terms``)
    on the window ``g``, in its float type."""
    from bundle_adjustment_tpu_torch.ops import ba_kernel

    live = (g.mask > 0).to(g.uv.dtype)
    return ba_kernel._slot_terms(g.rvecs, g.tvecs, g.points, g, live, False)[0]


def grid_terms(g):
    """The residuals (P, D, 2) of the grid solver's formula
    (``ba_grid._grid_terms``, K4's and the grid solver's) on ``g``."""
    from bundle_adjustment_tpu_torch.ops import ba_grid

    return ba_grid._grid_terms(g.rvecs, g.tvecs, g.points,
                               g._replace(mask=g.mask.to(g.uv.dtype)), with_jac=False)[0]


#: the slot test (``slot_test``): a live slot's float32 residual is
#: unresolved where it lies further than this from its float64 residual,
#: relative to the norm of its projection in pixels.  From the CPU, on the
#: three committed windows of (a2) (``tests/test_torch_resolution.py`` as a
#: script; PERF.md section 6): 99.99 % of the live slots of windows
#: 14 and 62, whose float32 start costs resolve (within 2.6e-6 of
#: float64), lie below 9.6e-6, and the bulk of every window a few float32
#: roundings of the projection (median 0.5-3.1e-7)
SLOT_REL = 1e-5
#: the state test (``state_resolution``): the float32 start costs (the
#: solver's under test and its plain version's) and the float64 one within
#: this relative spread (ROADMAP Queue 3 item 23's proposal)
START_REL = 1e-5
#: and the float64 cost change of the step past this many times the float32
#: spread of the start and of the trial.  The float32 step on these windows
#: is heavy-tailed: a point-block inverse formula outside the spread's two
#: can land far outside it.  From the CPU, on the three committed windows
#: (``tests/test_torch_resolution.py`` as a script; PERF.md section 6):
#: with the spread of K3's formula and the grid solver's, the plain
#: version with an LU inverse or a Jacobi-scaled adjugate decides as
#: float64 on all 21 states resolved at 100, the LU one not at 50
RESOLVE_MARGIN = 100.0


def slot_test(grid, terms32=k3_terms, terms64=None, bound: float = SLOT_REL,
              most: int = 8) -> dict:
    """The slot test of one state ``grid``: each live slot's float32
    residual as ``terms32`` evaluates it (K3's formula, ``k3_terms``, or the
    grid solver's, ``grid_terms``) against the float64 residual from the
    same inputs (``terms64``, by default the same formula).  A slot is
    unresolved where the two lie further apart than ``bound`` times its
    float64 projection's norm.
    Returns the live slots, the worst relative gap, every unresolved slot
    (``keys``: (point, slot)) and the ``most`` worst of them, each (point,
    slot, camera, gap in pixels, relative gap, depth z in its camera,
    |z| / |X_c|, and (|R X| + |t|) / |X_c|: how far the camera-frame point
    cancels)."""
    import torch

    from bundle_adjustment_tpu_torch.ops.lie import so3_exp

    g32 = type(grid)(*(t.float() if t.is_floating_point() else t for t in grid))
    g64 = as_float64(grid)
    r64 = (terms64 or terms32)(g64)
    gap = torch.linalg.vector_norm(terms32(g32).double() - r64, dim=-1)
    proj = torch.linalg.vector_norm(r64 + g64.uv, dim=-1)
    live = g64.mask > 0
    rel = torch.where(live, gap / proj.clamp(min=1e-30), torch.zeros_like(gap))
    bad = (rel > bound).nonzero()
    worst = bad[torch.argsort(rel[bad[:, 0], bad[:, 1]], descending=True)[:most]]
    slots = []
    if len(worst):
        p, d = worst[:, 0], worst[:, 1]
        cam = g64.cam_slot[p, d].long()
        RX = torch.einsum("sij,sj->si", so3_exp(g64.rvecs)[cam], g64.points[p])
        Xc = RX + g64.tvecs[cam]
        n = torch.linalg.vector_norm(Xc, dim=-1)
        cancel = (torch.linalg.vector_norm(RX, dim=-1)
                  + torch.linalg.vector_norm(g64.tvecs[cam], dim=-1)) / n
        slots = [dict(point=int(a), slot=int(b), camera=int(c), px=float(gap[a, b]),
                      rel=float(rel[a, b]), z=float(z), z_over_norm=float(abs(z) / m),
                      cancel=float(q))
                 for a, b, c, z, m, q in zip(p, d, cam, Xc[:, 2], n, cancel)]
    return dict(live=int(live.sum()), worst=float(rel.max()),
                keys=[tuple(k) for k in bad.tolist()], slots=slots)


def state_resolution(start32: tuple, start64: float, trial32: tuple, trial64: float) -> dict:
    """The state test of one LM state and the decision taken from it:
    ``start32``, the float32 costs of the start (the solver under test's,
    its plain version's), ``start64`` its float64 cost; ``trial32``, the
    float32 spread of the float64 witness's trial (its cost evaluated in
    float32, and where the plain version's own float32 steps land,
    ``own_trial``), ``trial64`` the trial's float64 cost.  Resolved where the start
    costs lie within ``START_REL`` of each other and the float64 cost change
    of the step is larger than ``RESOLVE_MARGIN`` times the float32 spread of
    the start and that of the trial (``band``)."""
    costs = (*start32, start64)
    band = max([abs(c - start64) for c in start32] + [abs(c - trial64) for c in trial32])
    if not all(map(math.isfinite, (*costs, *trial32))):    # a float32 step that overflows
        band = math.inf
    change = abs(trial64 - start64)
    start_ok = max(costs) - min(costs) <= START_REL * abs(start64)
    return dict(resolved=bool(start_ok and change > RESOLVE_MARGIN * band),
                start_spread=(max(costs) - min(costs)) / max(abs(start64), 1e-30),
                change=change, band=band)


def own_trial(cost32, cost64, x32, d, trial64: float) -> tuple:
    """A float32 plain step ``d`` from ``x32`` as the float32 spread of the
    witness's trial sees it: the float64 cost of its trial as float32 holds
    it (``x32 + d`` rounded to float32), and the float64 trial cost
    ``trial64`` moved by the float32 evaluation's error there (the float32
    cost less the float64 one)."""
    trial = tuple(a + b for a, b in zip(x32, d))
    c64 = float(cost64(*(t.double() for t in trial)))
    return c64, trial64 + float(cost32(*trial)) - c64


def k3_witness(state, one: dict, rec: dict) -> dict:
    """The float64 decision witness of one state of K3's path (``lm_path``'s
    ``state``, one-iteration arguments ``one`` and record ``rec``): K3's
    function in float64 (``ba_kernel.plain_parts``, ``lm_solve_plain``'s
    iteration) one LM iteration from the same state and damping, and
    ``state_resolution`` of the state from K3's and its plain version's
    start costs and the float32 spread of the trial: the witness's trial
    costed by K3 (a launch of no LM iteration) and by the plain version in
    float32, and the trials of the plain version's float32 step with each
    of two point-block inverses, K3's (the TPU kernel's formula) and the
    grid solver's (``one_point_inverse``), each costed in float64 and in
    float32 (``own_trial``); where the start costs already lie past
    ``START_REL``, the state does not resolve and the spread is not taken.
    Returns the witness's decision and end cost, K3's gap to it, and the
    resolution."""
    import torch

    from bundle_adjustment_tpu_torch.ops import ba_kernel

    n_fixed, delta = one.get("n_fixed", 1), one.get("huber_delta", 1.0)
    lam = one["lambda_init"]
    p64, step64, cost64, _ = ba_kernel.plain_parts(as_float64(state), n_fixed, delta)
    x64 = (p64.rvecs, p64.tvecs, p64.points)
    trial = tuple(a + d for a, d in zip(x64, step64(*x64, torch.tensor(
        lam, dtype=torch.float64, device=p64.uv.device))))
    c0, c1 = float(cost64(*x64)), float(cost64(*trial))
    starts = (rec["start"], rec["start_b"], c0)
    res = dict(resolved=False, change=abs(c1 - c0), band=math.inf,
               start_spread=(max(starts) - min(starts)) / max(abs(c0), 1e-30))
    if res["start_spread"] <= START_REL:
        _, step32, cost32, _ = ba_kernel.plain_parts(state, n_fixed, delta)
        x32 = (state.rvecs, state.tvecs, state.points)
        lam32 = torch.tensor(lam, dtype=torch.float32, device=state.uv.device)
        own = [step32(*x32, lam32)]
        with one_point_inverse():
            own.append(step32(*x32, lam32))
        t32 = tuple(t.float() for t in trial)
        k3_trial = ba_kernel.lm_solve(state._replace(rvecs=t32[0], tvecs=t32[1], points=t32[2]),
                                      **dict(one, max_iterations=0))[3].initial_cost
        res = state_resolution((rec["start"], rec["start_b"]), c0, (
            float(k3_trial), float(cost32(*t32)),
            *(c for d in own for c in own_trial(cost32, cost64, x32, d, c1))), c1)
    end = c1 if c1 < c0 else c0
    return dict(res, accepted64=c1 < c0, end64=end,
                gap64=abs(rec["a"] - end) / max(abs(end), 1e-30))


def resolved_summary(states: list) -> dict:
    """The witness's records of one path (``k3_witness`` merged into
    ``lm_path``'s): the states resolved and not; in each group those where
    K3 decides otherwise than float64 (and, beside them, where its plain
    version does); on the resolved ones K3's worst gap to float64's end
    cost and the states where K3 ends above and below its plain version."""
    res = [r for r in states if r["resolved"]]
    un = [r for r in states if not r["resolved"]]

    def otherwise(group, key):
        return sum(r[key] != r["accepted64"] for r in group)

    return dict(resolved=len(res), unresolved=len(un),
                k3_otherwise=otherwise(res, "a_accepted"),
                k3_otherwise_unresolved=otherwise(un, "a_accepted"),
                plain_otherwise=otherwise(res, "b_accepted"),
                plain_otherwise_unresolved=otherwise(un, "b_accepted"),
                worst64=max([r["gap64"] for r in res] or [0.0]),
                higher=sum(r["a"] > r["b"] for r in res),
                lower=sum(r["a"] < r["b"] for r in res),
                decided=[r["iteration"] for r in res if r["a_accepted"] != r["accepted64"]])


def float32_path(grid, kw: dict, witness: bool = True) -> dict:
    """Rule (a)'s test of one window: K3's path on ``grid`` as it runs it
    (``ba_kernel.lm_solve``: the kernel on the card, its plain version on
    the CPU), one LM iteration at a time, and at each state its plain
    version's one LM iteration from the same state and damping, both in
    float32 (``lm_path``); ``path_summary`` of the states.  Rule (d)'s test
    beside it (``resolution``): at each state the float64 decision witness
    and the state test (``k3_witness``, ``resolved_summary``), and the slot
    test of every state (``slot_test``): the distinct unresolved slots over
    the path (``n_slots``) and the worst of them (``slots``); without
    ``witness``, rule (a)'s test alone."""
    from bundle_adjustment_tpu_torch.ops import ba_kernel

    states, keys, worst = [], set(), {}
    for r, state, one in lm_path(ba_kernel.lm_solve, ba_kernel.lm_solve_plain, grid, kw):
        if not witness:
            states.append(r)
            continue
        states.append(dict(r, **k3_witness(state, one, r)))
        st = slot_test(state)
        keys.update(st["keys"])
        for s in st["slots"]:
            if s["rel"] > worst.get((s["point"], s["slot"]), {"rel": 0.0})["rel"]:
                worst[s["point"], s["slot"]] = s
    if not witness:
        return path_summary(states)
    return dict(path_summary(states), resolution=dict(
        resolved_summary(states), n_slots=len(keys),
        slots=sorted(worst.values(), key=lambda s: -s["rel"])[:8]))


def grid_point_inverse(V, lam, point_mask):
    """The grid solver's inverse of the damped point blocks
    (``ba._inv3(ba._damp(V, lam))``, dead points 0), in the signature of K3's
    plain version's ``ba_kernel._inv3_damped`` (the TPU kernel's formula):
    the same algebra, its products associated otherwise."""
    import torch

    from bundle_adjustment_tpu_torch.ops import ba

    inv = ba._inv3(ba._damp(V, lam))
    return torch.where(point_mask[:, None, None], inv, torch.zeros_like(inv))


@contextlib.contextmanager
def one_point_inverse():
    """K3's plain version with the grid solver's point-block inverse
    (``grid_point_inverse``) inside the block."""
    from bundle_adjustment_tpu_torch.ops import ba_kernel

    own = ba_kernel._inv3_damped
    ba_kernel._inv3_damped = grid_point_inverse
    try:
        yield
    finally:
        ba_kernel._inv3_damped = own


def float64_path(grid, kw: dict) -> dict:
    """Rule (b)'s path test of one window: K3's function's path on ``grid``
    in float64 (``lm_solve_plain``), one LM iteration at a time, and at
    each state the grid dense solver's one LM iteration from the same state
    and damping, the point blocks inverted by one formula in both
    (``one_point_inverse``, ``lm_path``); ``path_summary`` of the
    states."""
    from bundle_adjustment_tpu_torch.ops import ba_grid, ba_kernel

    g64 = as_float64(grid)
    with one_point_inverse():
        return path_summary([r for r, _, _ in lm_path(
            ba_kernel.lm_solve_plain, ba_grid.ba_solve_grid_impl, g64, kw)])


#: rule (b)'s test of the point-block inverse: blocks of a condition number
#: below this, where float64 resolves the inverse to about 1e-16 times it
INVERSE_COND = 1e8
#: and the relative gap the two formulas may show there
INVERSE_REL = 1e-9


def point_inverse_gap(grid, kw: dict) -> dict:
    """K3's plain version's point-block inverse (``ba_kernel._inv3_damped``)
    against the grid solver's (``grid_point_inverse``) in float64 on every
    live point block of ``grid`` at its start state, damped by
    ``lambda_init``: the worst relative gap over the blocks of a condition
    number below ``INVERSE_COND``, their number and that of the others
    (which the two formulas round apart, each as well as the other)."""
    import torch

    from bundle_adjustment_tpu_torch.ops import ba, ba_kernel

    g = as_float64(grid)
    live = (g.mask > 0).double()
    r, _, Jp = ba_kernel._slot_terms(g.rvecs, g.tvecs, g.points, g, live, with_jac=True)
    delta, lam = kw.get("huber_delta", 1.0), kw.get("lambda_init", 1e-3)
    a = torch.abs(r)
    w = torch.where(a <= delta, torch.ones_like(a), delta / torch.clamp(a, min=1e-12)) \
        * g.mask[..., None]
    V = torch.einsum("pdki,pdkj->pij", Jp * w[..., None], Jp)
    k3 = ba_kernel._inv3_damped(V, lam, g.point_mask)
    ref = grid_point_inverse(V, lam, g.point_mask)
    gap = torch.linalg.matrix_norm(k3 - ref) / torch.linalg.matrix_norm(ref).clamp(min=1e-300)
    sound = g.point_mask & (torch.linalg.cond(ba._damp(V, lam)) < INVERSE_COND)
    return dict(worst=float(gap[sound].max()) if bool(sound.any()) else 0.0,
                sound=int(sound.sum()), ill=int(g.point_mask.sum() - sound.sum()))


#: the K4 witness's CG (``converged_cg``): to this relative residual, in
#: float64, or to ``CG_UNKNOWNS`` iterations per camera unknown
CG_TOL64 = 1e-10
CG_UNKNOWNS = 4
#: K4's step and end cost per resolved state (``k4_rule``): within this
#: relative gap of the float64 witness's, or at most twice as far from it
#: as the farther of the two float32 plain steps with K4's CG cap (the
#: capped CG's truncation), as ``chip_smoke.near_float64`` holds the roles
K4_STEP_REL = 1e-2


def _pcg_to_tolerance(matvec, b, Minv, iters, tol, live=None):
    """``ba._pcg_blocked``'s iteration run until its relative residual falls
    to ``CG_TOL64`` (read on the host each iteration) or for
    ``CG_UNKNOWNS`` times the unknowns (``iters`` and ``tol`` are the
    caller's cap and are not read); the iterations taken and the residual
    reached go to ``_pcg_to_tolerance.last``."""
    import torch

    if callable(Minv):
        precond = Minv
    else:
        def precond(r):
            return torch.sum(Minv * r[:, None, :], dim=-1)
    bnorm = float(torch.linalg.vector_norm(b))
    x, r = torch.zeros_like(b), b
    z = precond(r)
    p, rz = z, torch.sum(r * z)
    n = 0
    for n in range(CG_UNKNOWNS * b.numel()):
        if float(torch.linalg.vector_norm(r)) <= CG_TOL64 * bnorm:
            break
        Ap = matvec(p)
        alpha = rz / torch.sum(p * Ap)
        x, r = x + alpha * p, r - alpha * Ap
        z = precond(r)
        rz, rz_old = torch.sum(r * z), rz
        p = z + (rz / rz_old) * p
    _pcg_to_tolerance.last = dict(iterations=n, residual=float(
        torch.linalg.vector_norm(r)) / max(bnorm, 1e-300))
    return x


@contextlib.contextmanager
def converged_cg():
    """The grid PCG solver's camera solve to convergence inside the block:
    ``ba._pcg_blocked`` replaced by ``_pcg_to_tolerance``."""
    from bundle_adjustment_tpu_torch.ops import ba

    own = ba._pcg_blocked
    ba._pcg_blocked = _pcg_to_tolerance
    try:
        yield
    finally:
        ba._pcg_blocked = own


def k4_roles():
    """The roles ``ba_global_kernel.solve`` runs under the routing in
    effect (``routed``: a planted defect of the setup role), else K4's."""
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk

    return getattr(gk.solve, "keywords", {}).get("roles", gk._KERNELS)


def k4_trial(grid, kw: dict, roles):
    """One LM iteration of ``ba_global_kernel.GlobalLM`` with ``roles`` on
    ``grid`` (``kw``: the one-iteration arguments, CG to its cap), its
    trial kept whatever the decision (the start cost set above every trial
    for the body, the decision taken after against the start cost).
    Returns (the solve, its start cost, the trial cost, the trial (rvecs,
    tvecs, points), the step (d_rvecs, d_tvecs, d_points))."""
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk

    n_fixed = kw.get("n_fixed", 1)
    opts = {k: v for k, v in kw.items() if k not in ("n_fixed", "cg_precond_group")}
    lm = gk.GlobalLM(grid, n_fixed, **dict(opts, roles=roles))
    st = lm.state
    x0 = tuple(st[k].clone() for k in ("rv", "tv", "ptT"))
    start = float(lm.initial[0])
    st["cost"].fill_(float("inf"))
    lm.body()
    trial = (st["rv"], st["tv"], st["ptT"].T)
    step = tuple(a - b for a, b in zip((st["rv"], st["tv"], st["ptT"]), x0))
    return lm, start, float(st["cost"]), trial, (step[0], step[1], step[2].T)


def _grid_step(grid, kw: dict, lam: float):
    """The grid PCG solver's step (``ba_grid._solve_step_pcg``, block-Jacobi,
    CG as ``kw`` caps it) on ``grid`` in its float type at damping ``lam``."""
    import torch

    from bundle_adjustment_tpu_torch.ops import ba_grid

    n_fixed = kw.get("n_fixed", 1)
    p = grid._replace(mask=grid.mask.to(grid.uv.dtype))
    cams = torch.arange(p.rvecs.shape[0] - n_fixed, device=p.uv.device)
    onehot_T = (cams[:, None] == (p.cam_slot.long().reshape(-1)[None, :] - n_fixed)
                ).to(p.uv.dtype)
    out = ba_grid._solve_step_pcg(p.rvecs, p.tvecs, p.points, p, torch.tensor(
        lam, dtype=p.uv.dtype, device=p.uv.device), kw.get("huber_delta", 1.0), n_fixed,
        onehot_T, kw["cg_iters"], kw.get("cg_tol", 0.0))
    return out[:3]


def _grid_cost(grid, x, delta: float) -> float:
    """The Huber cost of the grid solver's formula (``grid_terms``) at
    ``x`` = (rvecs, tvecs, points) on ``grid``'s observations, in ``x``'s
    float type."""
    from bundle_adjustment_tpu_torch.ops import ba

    g = grid._replace(rvecs=x[0], tvecs=x[1], points=x[2])
    return float(ba.robust_cost(grid_terms(g._replace(uv=g.uv.to(x[0].dtype),
                                                      K=g.K.to(x[0].dtype))), delta))


def step_gaps(step, ref) -> dict:
    """The relative gaps of a step (d_rvecs, d_tvecs, d_points) to ``ref``
    per lane group: rotations, translations, points."""
    import torch

    return {k: float(torch.linalg.vector_norm(a.double() - b.double())
                     / torch.linalg.vector_norm(b.double()).clamp(min=1e-300))
            for k, a, b in zip(("rotation", "translation", "points"), step, ref)}


def k4_witness(state, kw: dict, lam: float, k4: tuple) -> dict:
    """The float64 witness of one state of K4's path (``state``, the
    one-iteration arguments ``kw`` at damping ``lam``, ``k4`` = ``k4_trial``'s
    result): the grid PCG solver's step in float64 with CG to convergence
    (``converged_cg``), its decision and end cost; ``state_resolution``
    from K4's start cost and the grid solver's in float32, and the float32
    spread of the trial: the witness's trial costed by K4's cost role and
    by the grid solver's formula in float32, and the trials of the two
    float32 plain steps with K4's CG cap (the grid solver's and K4's plain
    roles', ``ba_global_kernel._PLAIN``), each costed in float64 and in
    float32 (``own_trial``).  Returns the resolution, both decisions, K4's
    end-cost gap and the step gaps (``step_gaps``) of K4 and of the two float32 steps to the witness's."""
    from bundle_adjustment_tpu_torch.ops import ba_global_kernel as gk

    lm, k4_start, k4_cost, _, k4_step = k4
    delta = kw.get("huber_delta", 1.0)
    g64 = as_float64(state)
    x64 = (g64.rvecs, g64.tvecs, g64.points)
    with converged_cg():
        d64 = _grid_step(g64, kw, lam)
    cg = dict(_pcg_to_tolerance.last)
    trial64 = tuple(a + d for a, d in zip(x64, d64))
    c0, c1 = _grid_cost(g64, x64, delta), _grid_cost(g64, trial64, delta)
    x32 = (state.rvecs, state.tvecs, state.points)
    steps32 = dict(grid=_grid_step(state, kw, lam),
                   plain=k4_trial(state, dict(kw, lambda_init=lam), gk._PLAIN)[4])
    t32 = tuple(t.float() for t in trial64)
    k4_eval = float(lm._cost(t32[0], t32[1], t32[2].T.contiguous())[0])
    res = state_resolution((k4_start, _grid_cost(state, x32, delta)), c0, (
        k4_eval, _grid_cost(state, t32, delta),
        *(c for d in steps32.values() for c in own_trial(
            lambda *x: _grid_cost(state, x, delta), lambda *x: _grid_cost(g64, x, delta),
            x32, d, c1))), c1)
    accepted64, k4_accepted = c1 < c0, k4_cost < k4_start
    end64 = c1 if accepted64 else c0
    k4_end = k4_cost if k4_accepted else k4_start
    plain_end = []
    for d in steps32.values():
        c = _grid_cost(g64, tuple(a + b.double() for a, b in zip(x64, d)), delta)
        plain_end.append(abs(min(c, c0) - end64) / max(abs(end64), 1e-30))
    del g64, x64, trial64
    return dict(res, accepted64=accepted64, k4_accepted=k4_accepted, end64=end64, k4_end=k4_end,
                end_gap=abs(k4_end - end64) / max(abs(end64), 1e-30), plain_end_gap=max(plain_end),
                k4_gaps=step_gaps(k4_step, d64),
                plain_gaps={k: max(step_gaps(d, d64)[k] for d in steps32.values())
                            for k in ("rotation", "translation", "points")},
                cg=cg, lam=lam)


def k4_rule(rec: dict) -> list:
    """What fails ``k4_path``'s rule on one resolved state ``rec``
    (``k4_witness``): K4 deciding otherwise than the float64 witness, its
    end cost, or a lane group of its step, each farther from the witness's
    than ``K4_STEP_REL`` and than twice the float32 plain steps' gap."""
    out = []
    if rec["k4_accepted"] != rec["accepted64"]:
        out.append("decision")
    if not (rec["end_gap"] <= K4_STEP_REL or rec["end_gap"] <= 2 * rec["plain_end_gap"]):
        out.append("end cost")
    out += [k for k, v in rec["k4_gaps"].items()
            if not (v <= K4_STEP_REL or v <= 2 * rec["plain_gaps"][k])]
    return out


def k4_path(grid, kw: dict) -> dict:
    """K4's path per LM state against the float64 witness: K4 (the roles
    in effect, ``k4_roles``) one LM iteration at a time from the start
    (``kw``: the one-iteration arguments, CG to its cap), each from the
    state and damping the previous one left, over ``kw``'s LM cap or its
    first ``PATH_STATES`` (over the 20 of (a2)'s polish the walk took
    63.6 s of ``chip_smoke.py``'s time limit on an NVIDIA H100 80GB HBM3,
    and none resolved); at each
    state whose float32 start costs (K4's and the grid solver's) lie within
    ``START_REL`` of float64's, ``k4_witness`` and, on a resolved state,
    ``k4_rule`` (the others cannot resolve: no witness).  Returns the
    states, those witnessed and resolved, the failures, the resolved
    states' worst gaps, the witness's CG iterations, the slot test of the
    start (``slot_test`` of the grid solver's formula) and the seconds."""
    import torch

    from bundle_adjustment_tpu_torch.ops import ba

    t0 = time.perf_counter()
    roles, lam, state = k4_roles(), kw.get("lambda_init", 1e-3), grid
    delta = kw.get("huber_delta", 1.0)
    recs = []
    for n in range(min(kw.get("max_iterations", 50), PATH_STATES)):
        k4 = k4_trial(state, dict(kw, lambda_init=lam, max_iterations=1), roles)
        g64 = as_float64(state)
        costs = (k4[1], _grid_cost(state, (state.rvecs, state.tvecs, state.points), delta),
                 _grid_cost(g64, (g64.rvecs, g64.tvecs, g64.points), delta))
        del g64
        rec = dict(iteration=n, lam=lam, resolved=False, k4_accepted=k4[2] < k4[1],
                   start_spread=(max(costs) - min(costs)) / max(abs(costs[2]), 1e-30))
        if rec["start_spread"] <= START_REL:
            rec.update(k4_witness(state, kw, lam, k4))
        rec["fails"] = k4_rule(rec) if rec["resolved"] else []
        recs.append(rec)
        if rec["k4_accepted"]:
            state = state._replace(rvecs=k4[3][0].clone(), tvecs=k4[3][1].clone(),
                                   points=k4[3][2].contiguous())
        lam = float(ba.next_lambda(torch.tensor(lam, dtype=torch.float64),
                                   torch.tensor(rec["k4_accepted"]), kw.get("lambda_up", 4.0),
                                   kw.get("lambda_down", 0.5), kw.get("lambda_min", 1e-10),
                                   kw.get("lambda_max", 1e8)))
        del k4
    seen = [r for r in recs if "accepted64" in r]
    res = [r for r in seen if r["resolved"]]
    slots = slot_test(grid, grid_terms)
    return dict(states=len(recs), witnessed=len(seen), resolved=len(res), slots=dict(
                    live=slots["live"], unresolved=len(slots["keys"]), worst=slots["slots"][:3]),
                failures=[(r["iteration"], r["fails"]) for r in res if r["fails"]],
                otherwise_unresolved=sum(r["k4_accepted"] != r["accepted64"]
                                         for r in seen if not r["resolved"]),
                worst_end=max([r["end_gap"] for r in res] or [0.0]),
                worst_step={k: max([r["k4_gaps"][k] for r in res] or [0.0])
                            for k in ("rotation", "translation", "points")},
                worst_start=max(r["start_spread"] for r in recs),
                cg=max([r["cg"]["iterations"] for r in seen] or [0]),
                records=recs, seconds=time.perf_counter() - t0)


def sign_test_p(k: int, n: int, share: float = 0.5) -> float:
    """The one-sided binomial p-value of ``k`` or more of ``n`` at
    ``share`` (1/2: the sign test)."""
    if share == 0.5:
        return sum(math.comb(n, i) for i in range(k, n + 1)) / (1 << n)
    return math.fsum(math.exp(math.log(math.comb(n, i)) + i * math.log(share)
                              + (n - i) * math.log1p(-share)) for i in range(k, n + 1))


#: rule (a): at every state of K3's float32 path its plain version's one LM
#: iteration from it ends within this relative cost of K3's
#: (``float32_path``)
FLOAT32_REL = 0.1
#: and over the states where they end apart, K3 ends above (or below) its
#: plain version on a share of them that a one-sided binomial test at this
#: share does not place above it at ``SIGN_LEVEL``.  Both bounds from the
#: CPU: over the 2,629 states of (a2)'s 63 windows, the plain version with
#: the grid solver's point-block inverse or with its points in another
#: order ends up to 2.9e-2 from the plain version and the higher on
#: 50.1-52.1 % of the states; with a camera counted once per point or a
#: step of 0.9 times the right one, the higher on 79-83 %
STATE_SHARE = 0.55
#: the share test of one window, read beside rule (a) and not gated: K3
#: built as it ships (FMA contraction) reaches 9.0e-11 on one of (a2)'s
#: windows and built without it 1.4e-5 on another drive's, where the plain
#: version in another float order reaches 1.3e-2 at its least over the 63
#: windows (CPU): float32 evaluates the cost of these windows' states apart
#: (K3's and its plain version's costs of one start state up to 2.8e-3
#: apart, 25 % without contraction), and a path selects the states its own
#: solver's rounding favours (ROADMAP Queue 3)
WINDOW_LEVEL = 1e-6


def share_p(higher: int, lower: int) -> float:
    """The one-sided binomial p-value at ``STATE_SHARE`` of the larger of
    ``higher`` and ``lower`` among the states where two solves end apart."""
    return sign_test_p(max(higher, lower), higher + lower, STATE_SHARE)
#: rule (b): at every state of K3's function's float64 path the grid
#: solver's one LM iteration from it ends within this relative cost of K3's
#: function's (``float64_path``); and the whole float64 solves' agreement
#: (``float64_agree``) is read at this tolerance
FLOAT64_REL = 1e-4
#: the states of K3's function's float64 path that rule (b) compares on a
#: window whose whole float64 solves agree (all of them where they part)
PATH_STATES = 8
#: rules (a) and (c): the one-sided sign tests' level
SIGN_LEVEL = 0.01


def float64_agree(rec: dict) -> bool:
    """Whether the whole float64 solves of K3's function and the grid solver
    agree on one window: final costs within ``FLOAT64_REL``, LM iterations
    within 1, the same stop test.  Read, not a rule: float order parts
    whole float64 solves on the drive's ill-conditioned windows (the same
    solver with the points in another order parts as far), and a step with
    the wrong curvature still converges to the same minimum."""
    a, b = rec["plain64"], rec["grid64"]
    return (abs(a["final_cost"] - b["final_cost"])
            <= FLOAT64_REL * max(abs(b["final_cost"]), 1e-30)
            and abs(a["iterations"] - b["iterations"]) <= 1 and a["stop"] == b["stop"])


def float64_holds(rec: dict) -> bool:
    """Rule (b) on one window: every state of K3's function's float64 path
    compared (``path64``, ``float64_path``) within ``FLOAT64_REL`` of the
    grid solver's one LM iteration from it, and the point-block inverses
    within ``INVERSE_REL`` (``inverse``, ``point_inverse_gap``)."""
    return (rec["path64"]["worst"] <= FLOAT64_REL
            and rec["inverse"]["worst"] <= INVERSE_REL)


def hold_float64(rec: dict, grid, kw: dict) -> dict:
    """Rule (b)'s tests on one window whose float64 pair ``rec`` holds
    (``plain64``, ``grid64``): its point-block inverses
    (``point_inverse_gap``) and K3's function's float64 path
    (``float64_path``), over every state where the whole float64 solves
    part and over its first ``PATH_STATES`` where they agree.  Returns the
    two, to be added to ``rec``."""
    agree = float64_agree(rec)
    return dict(inverse=point_inverse_gap(grid, kw), whole_agree=agree,
                path64=float64_path(grid, kw if not agree else dict(
                    kw, max_iterations=min(PATH_STATES, kw.get("max_iterations", 50)))))


def near_plain(rec: dict) -> bool:
    """The whole float32 solves of one window, read beside rule (a): K3's
    final cost within 1 % of its plain version's, or within 1 % of the
    float64 plain version's or at most twice as far from it as the float32
    plain version (the float64 witness)."""
    k, p = rec["k3"]["final_cost"], rec["plain"]["final_cost"]
    w = rec.get("plain64", {}).get("final_cost")
    return abs(k - p) <= 0.01 * abs(p) or w is not None and (
        abs(k - w) <= 0.01 * abs(w) or abs(k - w) <= 2 * abs(p - w))


def window_rule(records: list) -> dict:
    """The holds of the long drive's windows (``hold_window``'s solves, one
    record per window with its ``index``) by three rules:

    (a) K3 against its plain version per state (``path32``,
        ``float32_path``): from every state of K3's float32 path the two
        one-iteration solves end within ``FLOAT32_REL`` of each other, and
        over all states of all windows where they end apart, K3 ends above
        (or below) its plain version on no larger share than a binomial
        test at ``STATE_SHARE`` allows at ``SIGN_LEVEL`` (``share_p``; K3
        the higher on k of n).  The windows whose own states fail that test
        at ``WINDOW_LEVEL`` are listed (``split``), not gated.  Each state starts both from the same inputs, so
        the float32 rounding of far points that parts whole float32 solves
        by up to 24 % (any float32 solver, drawn anew by a relative 1e-6
        move of the points) is not carried along a path; the windows whose
        whole K3 and plain solves part (``near_plain`` fails) are listed;
    (b) K3's function and the grid solver's are one algorithm in float64 on
        every window held so (``hold_float64``, ``float64_holds``): from
        each state of K3's function's float64 path one LM iteration of each
        ends within ``FLOAT64_REL``, the point blocks inverted by one
        formula, and K3's point-block inverse is the grid solver's within
        ``INVERSE_REL`` on blocks float64 resolves; past that a window is an
        algorithmic difference (the windows whose whole float64 solves part,
        ``float64_agree``, are listed);
    (c) over the n windows where the float32 K3 and grid solves part
        (``parted``), K3 ends higher on k: the one-sided binomial p-value
        of k of n at 1/2 must not fall below ``SIGN_LEVEL``; the mean of
        (K3 - grid) / grid over them and its standard error beside it.

    (d) K3 against the float64 decision witness on the states of its float32
        path that float32 resolves (``path32``'s ``resolution``,
        ``float32_path``, ``state_resolution``): on every such state K3
        accepts or rejects as K3's function does in float64 from the same
        state and damping and ends within ``FLOAT32_REL`` of it; on each
        window the share test of K3 against its plain version over those
        states does not fall below ``WINDOW_LEVEL``; and over those of all
        windows K3 ends above its plain version on no larger share than a
        one-sided binomial test at ``STATE_SHARE`` allows at
        ``SIGN_LEVEL``.  One-sided: the state test selects states where the
        plain version's own step lands near float64's, so another float32
        step ends below it more often than above (an LU point-block inverse
        on 15 of 18 on the CPU), and a step short of the right one above.

    Returns each rule's verdict with the windows that fail it, and
    ``passed``."""
    fail_a = [r["index"] for r in records if r["path32"]["worst"] > FLOAT32_REL]
    n_a = sum(r["path32"]["higher"] + r["path32"]["lower"] for r in records)
    k_a = sum(r["path32"]["higher"] for r in records)
    p_a = share_p(k_a, n_a - k_a)
    least = min(records, key=lambda r: share_p(r["path32"]["higher"], r["path32"]["lower"]))
    worst_a = max(records, key=lambda r: r["path32"]["worst"])
    with64 = [r for r in records if "path64" in r]
    fail_b = [r["index"] for r in with64 if not float64_holds(r)]
    parted64 = [r["index"] for r in with64 if not r["whole_agree"]]
    part = [r for r in records if parted(r)]
    gaps = np.array([(r["k3"]["final_cost"] - r["grid"]["final_cost"])
                     / max(abs(r["grid"]["final_cost"]), 1e-30) for r in part])
    k = sum(r["k3"]["final_cost"] > r["grid"]["final_cost"] for r in part)
    p = sign_test_p(k, len(part))
    c = dict(n=len(part), k=k, p=p, passed=p >= SIGN_LEVEL,
             mean_gap=float(gaps.mean()) if len(gaps) else 0.0,
             stderr=float(gaps.std(ddof=1) / math.sqrt(len(gaps))) if len(gaps) > 1 else 0.0,
             windows=[r["index"] for r in part])
    a = dict(passed=not fail_a and p_a >= SIGN_LEVEL, failures=fail_a,
             states=sum(r["path32"]["states"] for r in records), n=n_a, k=k_a, p=p_a,
             worst=worst_a["path32"]["worst"], worst_window=worst_a["index"],
             least_p=share_p(least["path32"]["higher"], least["path32"]["lower"]),
             least_window=least["index"],
             split=[r["index"] for r in records
                    if share_p(r["path32"]["higher"], r["path32"]["lower"]) < WINDOW_LEVEL],
             decide_otherwise=sum(r["path32"]["decide_otherwise"] for r in records),
             whole_parted=[r["index"] for r in records if not near_plain(r)])
    d = resolved_rule(records)
    return dict(a=a, b=dict(passed=not fail_b, failures=fail_b, whole_parted=parted64,
                            windows=len(with64),
                            worst_path=max([r["path64"]["worst"] for r in with64] or [0.0]),
                            worst_inverse=max([r["inverse"]["worst"] for r in with64] or [0.0])),
                c=c, d=d, passed=a["passed"] and not fail_b and c["passed"] and d["passed"])


def resolved_rule(records: list) -> dict:
    """Rule (d) of ``window_rule`` over the windows' ``path32`` records that
    carry the witness (``float32_path``'s ``resolution``): the windows where
    K3 decides otherwise than float64 on a resolved state, ends past
    ``FLOAT32_REL`` from it there, or whose resolved states fail the share
    test at ``WINDOW_LEVEL``; the counts over all windows and the one-sided
    test of K3 above its plain version beside them."""
    res = [(r["index"], r["path32"]["resolution"]) for r in records
           if "resolution" in r["path32"]]
    if not res:
        return dict(passed=True, failures={}, resolved=0)

    def p(q):
        return share_p(q["higher"], q["lower"])

    fails = dict(decide=[i for i, q in res if q["k3_otherwise"]],
                 end=[i for i, q in res if q["worst64"] > FLOAT32_REL],
                 split=[i for i, q in res if p(q) < WINDOW_LEVEL])
    least = min(res, key=lambda iq: p(iq[1]))

    def total(key):
        return sum(q[key] for _, q in res)

    high = total("higher")
    p_high = sign_test_p(high, high + total("lower"), STATE_SHARE)
    return dict(passed=not any(fails.values()) and p_high >= SIGN_LEVEL, failures=fails,
                **{k: total(k) for k in ("resolved", "unresolved", "k3_otherwise",
                                         "k3_otherwise_unresolved", "plain_otherwise",
                                         "plain_otherwise_unresolved", "higher", "lower",
                                         "n_slots")},
                p=p_high, worst64=max(q["worst64"] for _, q in res), least_p=p(least[1]),
                least_window=least[0])


def hold_one(grid, kw: dict, float64: bool) -> dict:
    """One window's holds: without ``float64``, K3, its plain version and
    the grid solver in float32 (``hold_window``) and rule (a)'s float32
    path (``path32``, ``float32_path``); with it, the float64 pair
    (``plain64``, ``grid64``) and rule (b)'s tests (``hold_float64``)."""
    if not float64:
        return dict(hold_window(grid, kw), path32=float32_path(grid, kw))
    out = hold_window(grid, kw, ("plain64", "grid64"))
    return dict(out, **hold_float64(out, grid, kw))


def _worker_start():
    """A hold worker's process: one torch thread, and the card's float32
    numerics as the drive ran them (``device.set_float32_numerics``)."""
    import torch

    from bundle_adjustment_tpu_torch import device

    torch.set_num_threads(1)
    device.set_float32_numerics()


def _hold_saved(job) -> dict:
    """``hold_one`` on a window saved by ``window_holds`` (a worker's job:
    its path and ``float64``)."""
    import torch

    from bundle_adjustment_tpu_torch.ops.ba_grid import BAProblemGrid

    path, float64 = job
    saved = torch.load(path, weights_only=False)
    return hold_one(BAProblemGrid(*saved["grid"]), saved["kw"], float64)


@contextlib.contextmanager
def window_holds(windows: list, workers: int):
    """A function ``hold(indices, float64)`` that runs ``hold_one`` on the
    windows of ``windows`` ((grid, solver arguments) pairs) at ``indices``
    and returns their records in that order: in this process with
    ``workers`` 0, else in ``workers`` processes started for the block (the
    windows saved whole for them, each solve on the windows' device; the
    solves are launch-bound on the host) and stopped at its end."""
    if not workers:
        yield lambda indices, float64: [hold_one(*windows[i], float64) for i in indices]
        return
    import multiprocessing
    import shutil
    import tempfile

    import torch

    tmp = tempfile.mkdtemp(prefix="window_holds_")
    paths = []
    for i, (grid, kw) in enumerate(windows):
        paths.append(os.path.join(tmp, f"{i}.pt"))
        torch.save(dict(grid=list(grid), kw=kw), paths[-1])
    pool = multiprocessing.get_context("spawn").Pool(workers, initializer=_worker_start)
    try:
        yield lambda indices, float64: pool.map(
            _hold_saved, [(paths[i], float64) for i in indices], chunksize=1)
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(tmp, ignore_errors=True)


def float64_choice(records: list, spread: int = 16) -> list:
    """The positions in ``records`` of the windows whose float64 pair
    ``hold_window`` runs: every one where the float32 solves part (K3 and
    the grid solver, or K3 and its plain version) or that diverged in the
    drive (``drive_diverged``), and ``spread`` of the others at even steps
    through the drive."""
    odd = {i for i, r in enumerate(records)
           if parted(r) or parted(r, "k3", "plain") or r.get("drive_diverged")}
    rest = [i for i in range(len(records)) if i not in odd]
    step = max(len(rest) / spread, 1.0) if spread else 1.0
    return sorted(odd | {rest[int(j * step)] for j in range(min(spread, len(rest)))})


def wide_window_choice(records: list, rule: dict, most: int = 12) -> list:
    """The indices of the windows to commit for the CPU tests, at most
    ``most``, in the order of their claim: every one that diverged in the
    drive, those that fail rule (a) or (b), then those where the float32 K3
    and grid solves part the most."""
    first = [r["index"] for r in records if r.get("drive_diverged")]
    first += [i for i in rule["a"]["failures"] + rule["b"]["failures"] if i not in first]

    def gap(r):
        return abs(r["k3"]["final_cost"] - r["grid"]["final_cost"]) \
            / max(abs(r["grid"]["final_cost"]), 1e-30)

    rest = sorted((r for r in records if parted(r) and r["index"] not in first),
                  key=gap, reverse=True)
    return (first + [r["index"] for r in rest])[:most]


def select_windows(out_dir: str, records: list, events: list, before: int = 3,
                   most: int = 8, max_c: int = 8, max_p: int = 4096) -> list:
    """Keep in ``out_dir`` the saved windows (at most ``max_c`` cameras and
    ``max_p`` live points) where K3 and the grid solver part, up to
    ``most``, and the last ``before`` solved before the first Rotation
    keyframe; delete the others.  Writes ``windows.json`` (every record,
    each with ``kept``) and returns the kept records."""
    rot = [e["frame_idx"] for e in events
           if e["event"] == "keyframe_trigger" and e.get("reason") == "Rotation"]
    small = [r for r in records if r["C"] <= max_c and r["P_live"] <= max_p]
    keep = {r["index"] for r in [r for r in small if parted(r)][:most]}
    if rot:
        keep |= {r["index"] for r in [r for r in small if r["frame"] < rot[0]][-before:]}
    for r in records:
        r["kept"] = r["index"] in keep
        r["parted"] = parted(r)
        r["before_first_rotation"] = bool(rot) and r["frame"] < rot[0]
        if not r["kept"]:
            os.remove(os.path.join(out_dir, f"w{r['index']:04d}.npz"))
    with open(os.path.join(out_dir, "windows.json"), "w") as f:
        json.dump({"first_rotation_frame": rot[0] if rot else None, "windows": records}, f,
                  indent=1)
    return [r for r in records if r["kept"]]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--motion", default="room", choices=["room", "strafe", "orbit"])
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--out", default="stress_out")
    ap.add_argument("--preset", default="lehman_indoor")
    ap.add_argument("--features", type=int, default=1500)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--staged", action="store_true",
                    help="disable the fused frontend (for A/B comparison)")
    ap.add_argument("--dedup-px", type=float, default=None,
                    help="override ops.orb._DEDUP_CELL_PX for this run")
    ap.add_argument("--video", default=None,
                    help="a sequence written earlier (e.g. a JAX cell's sequence.mp4), read "
                         "as it is through cv2, in place of a render")
    ap.add_argument("--png", action="store_true",
                    help="write the render as a folder of PNG files (no cv2 needed) in "
                         "place of sequence.mp4")
    ap.add_argument("--route", default="as shipped",
                    help="the routing of the run's solvers and frontend (ROUTES; several "
                         "joined by '+')")
    ap.add_argument("--hold-windows", default=None, metavar="DIR",
                    help="solve every K3 window also through the grid solver and K3's "
                         "plain version; records and the kept windows in DIR")
    return ap


def score(run_out: str, summary: dict, gt_C: np.ndarray) -> dict:
    """The JAX harness's score of a run (``tools/stress.py``), and the ATE
    over the extent of the keyframes' ground-truth centres."""
    from bundle_adjustment_tpu_torch.utils.event_log import read_events
    from bundle_adjustment_tpu_torch.utils.metrics import ate_rmse

    events = read_events(os.path.join(run_out, "events.jsonl"))
    tally = breakdowns(events)

    def count(ev):
        return sum(1 for e in events if e["event"] == ev)

    closures = [e for e in events if e["event"] == "loop_closure"]
    est, gt = [], []
    with open(os.path.join(run_out, "trajectory.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            v = line.split()
            fi = int(v[0])
            if 0 <= fi < len(gt_C):
                est.append([float(v[2]), float(v[3]), float(v[4])])
                gt.append(gt_C[fi])
    est, gt = np.asarray(est), np.asarray(gt)
    ate = ate_rmse(est, gt) if len(est) >= 3 else float("nan")
    path_len = float(np.sum(np.linalg.norm(np.diff(gt_C, axis=0), axis=1)))
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0))) if len(gt) else float("nan")
    return {
        "keyframes": summary["num_keyframes"],
        "map_points": summary["num_points"],
        "observations": summary["num_observations"],
        "culled_points": int(sum(e.get("culled", 0) for e in events if e["event"] == "cull")),
        "pruned_obs": int(sum(e.get("pruned", 0) for e in events if e["event"] == "prune")),
        "capacity_drops": int(sum(e.get("dropped_obs", 0) + e.get("dropped_points", 0)
                                  for e in events if e["event"] == "capacity_drop")),
        "divergences": count("ba_diverged"),
        "reloc_success": sum(1 for e in events
                             if e["event"] == "relocalization" and e.get("success")),
        "reloc_fail": sum(1 for e in events
                          if e["event"] == "relocalization" and not e.get("success")),
        "loop_closures": len(closures),
        "loop_fused_points": int(sum(e.get("fused", 0) for e in closures)),
        "frames_discarded": count("frame_discarded"),
        "ate_rmse": round(float(ate), 4),
        "ate_pct_of_path": round(100.0 * float(ate) / max(path_len, 1e-9), 3),
        "ate_pct_of_extent": round(100.0 * float(ate) / max(extent, 1e-9), 3),
        "gt_path_len": round(path_len, 3),
        "breakdowns": tally,
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from bundle_adjustment_tpu_torch import device as device_mod
    from bundle_adjustment_tpu_torch import run as run_mod
    from bundle_adjustment_tpu_torch.ops import orb as orb_mod
    from bundle_adjustment_tpu_torch.utils.io import _cv2, write_png
    from bundle_adjustment_tpu_torch.utils.synthetic import camera_path, synthetic_sequence, \
        write_video

    dev = device_mod.resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    gt_C = np.stack([C for _, _, C in camera_path(args.frames, args.motion)])
    if args.video:
        _cv2(f"--video {args.video} (a sequence written earlier is read as it is, "
             "never rendered again)")
        source = ["--video", args.video]
    else:
        print(f"rendering {args.frames}-frame '{args.motion}' sequence...", flush=True)
        frames, K, gt_C, _ = synthetic_sequence(
            n_frames=args.frames, width=WIDTH, height=HEIGHT, fx=FX, motion=args.motion,
            seed=args.seed, device=dev)
        if args.png:
            folder = os.path.join(args.out, "sequence")
            os.makedirs(folder, exist_ok=True)
            for i, f in enumerate(frames):
                write_png(os.path.join(folder, f"{i:05d}.png"), f)
            source = ["--images", folder]
        else:
            video = os.path.join(args.out, "sequence.mp4")
            write_video(frames, video)
            source = ["--video", video]
        del frames

    run_out = os.path.join(args.out, "run")
    cli = ["--preset", args.preset, *source, "--out", run_out, "--fx", str(FX),
           "--size", f"{WIDTH}x{HEIGHT}", "--consistent-convention",
           "--features", str(args.features), "--device", dev.type]

    route = routing(args.route)
    if args.staged:
        route["staged"] = True
    orig_dedup = orb_mod._DEDUP_CELL_PX
    if args.dedup_px is not None:
        orb_mod._DEDUP_CELL_PX = float(args.dedup_px)
    try:
        with routed(args.preset, **route), (
                hold_windows(args.hold_windows) if args.hold_windows
                else contextlib.nullcontext()) as held:
            t0 = time.perf_counter()
            summary = run_mod.main(cli)
            elapsed = time.perf_counter() - t0
    finally:
        orb_mod._DEDUP_CELL_PX = orig_dedup
    if summary["frames"] != args.frames:
        raise ValueError(f"{summary['frames']} frames ran, the ground truth is of "
                         f"--frames {args.frames}")

    result = {"frames": args.frames, "seed": args.seed, "dedup_px": args.dedup_px,
              "motion": args.motion, "fused_frontend": not route.get("staged", False)}
    result.update(score(run_out, summary, gt_C))
    result["route"] = args.route
    if args.hold_windows:
        from bundle_adjustment_tpu_torch.utils.event_log import read_events

        kept = select_windows(args.hold_windows, held,
                              read_events(os.path.join(run_out, "events.jsonl")))
        result["held_windows"] = dict(solved=len(held), parted=sum(map(parted, held)),
                                      kept=[r["index"] for r in kept])
    result.update(frames_per_s=summary["frames_per_s"], elapsed_s=round(elapsed, 1),
                  backend=dev.type, device=device_name(dev.type))
    with open(os.path.join(args.out, "stress_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
