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
the run's events (``breakdowns``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
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
        gk.solve = lambda grid, n_fixed=1, **opts: solve4(grid, n_fixed, **dict(opts, roles=roles))
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


@contextlib.contextmanager
def hold_windows(out_dir: str):
    """Every window K3 takes inside the block solved once more through the
    grid solver and K3's plain version on the same input (on its device):
    their final costs, iterations and stop tests (``ba.STOP_TESTS``) beside
    K3's in ``records`` (yielded; one dict per window, with the frame whose
    local BA made it), each window saved as ``out_dir/w{index}.npz`` (its live points only;
    ``select_windows`` keeps a few)."""
    import numpy as np

    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.ops import ba_grid, ba_kernel
    from bundle_adjustment_tpu_torch.ops.ba import STOP_TESTS

    os.makedirs(out_dir, exist_ok=True)
    records, frame = [], {"idx": -1}
    solve3 = ba_kernel.lm_solve
    orig_lba = VisualOdometryPipeline.run_local_ba

    def run_local_ba(self, *a, **kw):
        frame["idx"] = self.frame_idx
        return orig_lba(self, *a, **kw)

    def summary(stats):
        return dict(initial_sq=float(stats.initial_sq), final_sq=float(stats.final_sq),
                    final_cost=float(stats.final_cost), iterations=int(stats.iterations),
                    stop=STOP_TESTS[int(stats.stop)],
                    diverged=float(stats.final_sq) >= float(stats.initial_sq))

    def held(grid, n_fixed=1, **kw):
        res = solve3(grid, n_fixed=n_fixed, **kw)
        live = grid.point_mask.bool()
        P, D = grid.cam_slot.shape
        rec = dict(index=len(records), frame=frame["idx"], C=int(grid.rvecs.shape[0]),
                   n_fixed=int(n_fixed), P=int(P), P_live=int(live.sum()), D=int(D),
                   opts=dict(kw), k3=summary(res[3]))
        for name, fn in (("grid", ba_grid.ba_solve_grid_impl),
                         ("plain", ba_kernel.lm_solve_plain)):
            rec[name] = summary(fn(grid, n_fixed=n_fixed, **kw)[3])
        records.append(rec)
        keep = live.nonzero().flatten()
        np.savez_compressed(
            os.path.join(out_dir, f"w{rec['index']:04d}.npz"), n_fixed=n_fixed,
            **{k: getattr(grid, k).index_select(0, keep).cpu().numpy()
               if k in ("points", "cam_slot", "uv", "mask", "point_mask")
               else getattr(grid, k).cpu().numpy() for k in grid._fields})
        return res

    ba_kernel.lm_solve = held
    VisualOdometryPipeline.run_local_ba = run_local_ba
    try:
        yield records
    finally:
        ba_kernel.lm_solve = solve3
        VisualOdometryPipeline.run_local_ba = orig_lba


def parted(rec: dict) -> bool:
    """Whether K3 and the grid solver part on a held window: final costs
    more than 1 % apart, another stop, or one diverges and not the other."""
    a, b = rec["k3"], rec["grid"]
    return (abs(a["final_cost"] - b["final_cost"]) > 0.01 * max(abs(b["final_cost"]), 1e-12)
            or a["stop"] != b["stop"] or a["diverged"] != b["diverged"])


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
