"""What each rank runs in the port's multi-process CPU tests
(``tests/test_torch_parallel.py``, ``test_torch_native.py``,
``test_torch_rules.py``, ``test_torch_run.py``).

``bundle_adjustment_tpu_torch.parallel.launch.run_ranks`` starts the ranks as
fresh spawned processes, which import this module by name (the test
directory is on the path they inherit), joined by gloo over TCP on
localhost.  It imports torch, numpy and the port only, so a rank starts
without JAX.  Every function takes numpy inputs and returns numpy values.
"""

from __future__ import annotations

import numpy as np
import torch

from bundle_adjustment_tpu_torch.ops import ba
from bundle_adjustment_tpu_torch.parallel import dist_ba, dist_match, mesh as mesh_mod


def problem(arrays: dict) -> ba.BAProblem:
    """A port ``BAProblem`` on the CPU from a dict of numpy arrays."""
    return ba.BAProblem(**{k: torch.as_tensor(np.asarray(arrays[k])) for k in ba.BAProblem._fields})


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def solve_and_match(prob: dict, d1, d2, v1, v2, ratio: float, windows=None):
    """On a (1, world) mesh: the sharded BA of ``prob`` (30 LM iterations,
    n_fixed 1), ``match_sharded`` of the queries over "pt" and ``match_ring``
    with this rank's block of the bank.  With ``windows`` (two window
    problems and their keyframe ids) also ``solve_windows_consensus`` on a
    (2, world / 2) mesh, the problems sharded over "pt"."""
    world = torch.distributed.get_world_size()
    m = mesh_mod.make_mesh(1, world, "cpu")
    sh = dist_ba.shard_problem(problem(prob), world)
    rv, tv, pts, stats = dist_ba.ba_solve_sharded(sh, m, "pt", n_fixed=1, max_iterations=30)
    out = dict(rv=_np(rv), tv=_np(tv), pts=_np(pts), cost=float(stats.final_cost),
               shape=mesh_mod.shape(m))
    t = [torch.as_tensor(a) for a in (d1, d2, v1, v2)]
    idx, mask, best = dist_match.match_sharded(t[0], t[1], t[2], t[3], m, axis="pt",
                                               ratio=ratio)
    out.update(sharded=(_np(idx), _np(mask), _np(best)))
    s, block = mesh_mod.axis_index(m, "pt"), t[1].shape[0] // world
    mine = slice(s * block, (s + 1) * block)
    idx, mask, best = dist_match.match_ring(t[0], t[1][mine], t[3][mine], m, axis="pt",
                                            ratio=ratio)
    out.update(ring=(_np(idx), _np(mask), _np(best)))
    if windows is not None:
        probs, ids = windows
        m2 = mesh_mod.make_mesh(2, world // 2, "cpu")
        n_pt = mesh_mod.shape(m2)["pt"]
        ps = [dist_ba.shard_problem(problem(p), n_pt) if n_pt > 1 else problem(p)
              for p in probs]
        poses, sim3s, (rvs, tvs, ptss, st) = dist_ba.solve_windows_consensus(
            ps, ids, m2, n_fixed=1, max_iterations=25)
        out.update(consensus=(poses, sim3s, rvs, tvs, ptss, dict(st._asdict())))
    return out


def _pipeline(cfg, map_args):
    """A CPU pipeline of ``cfg`` on ``synthetic_global_map(*map_args)``."""
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog
    from bundle_adjustment_tpu_torch.utils.synthetic import synthetic_global_map

    pipe = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device="cpu")
    seed, C, P = map_args
    pipe.map, pipe.K = synthetic_global_map(seed, C=C, P=P, device="cpu")
    pipe.map.log = pipe.log
    return pipe


def map_state(pipe):
    """(keyframe ids, (K, 12) R|t rows, points)."""
    ids = pipe.map.sorted_kf_ids()
    poses = np.stack([np.concatenate([pipe.map.keyframes[k].R.ravel(), pipe.map.keyframes[k].t])
                      for k in ids])
    return ids, poses, pipe.map.points().copy()


_MAP_ARRAYS = ("_pts", "_colors", "_pt_alive", "_obs_kf", "_obs_mp", "_obs_kp", "_obs_uv",
               "_obs_alive")


def map_arrays(m) -> dict:
    """A port ``Map``'s table and keyframes as numpy, to rebuild it in the
    JAX package's ``Map`` (descriptors left out: BA does not read them)."""
    return dict(
        table={name: np.array(getattr(m, name)) for name in _MAP_ARRAYS},
        counts=(m._n_pts, m._n_obs, m.next_keyframe_id, m.next_map_point_id),
        keyframes=[dict(kf_id=kf.kf_id, R=kf.R.copy(), t=kf.t.copy(), xy=kf.xy.copy(),
                        kp_valid=kf.kp_valid.copy(), frame_idx=kf.frame_idx,
                        kp_to_mp=kf.kp_to_mp.copy())
                   for kf in (m.keyframes[k] for k in m.sorted_kf_ids())])


def sharded_window_solves(cfg, map_args):
    """``run_local_ba`` (a dense window) then ``run_global_ba`` (above
    ``pcg_min_cameras``: the flat PCG) of a pipeline with ``cfg.mesh_shape``
    on a synthetic map; the map after each and the BA events."""
    pipe = _pipeline(cfg, map_args)
    local = pipe.run_local_ba()
    after_local = map_state(pipe)
    glob = pipe.run_global_ba()
    return dict(local=local, after_local=after_local, glob=glob, after_global=map_state(pipe),
                mesh=mesh_mod.shape(pipe._mesh),
                events=[e for e in pipe.log.events if e["event"] in ("ba_complete",
                                                                     "ba_diverged")])


def frames_then_partitioned(cfg, frames):
    """The pipeline of ``cfg`` over ``frames``, then
    ``run_partitioned_global_ba`` over a (2, world / 2) mesh, and, on this
    rank alone, the reference it must equal: each window solved by
    ``ba_solve_impl`` and ``reconcile_windows_sim3`` from the same map."""
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline
    from bundle_adjustment_tpu_torch.utils.event_log import EventLog

    pipe = VisualOdometryPipeline(cfg, log=EventLog(echo=False), device="cpu")
    statuses = [pipe.process_frame(f)["status"] for f in frames]
    before, table = map_state(pipe), map_arrays(pipe.map)
    world = torch.distributed.get_world_size()
    m = mesh_mod.make_mesh(2, world // 2, "cpu")
    n_pt = mesh_mod.shape(m)["pt"]
    ref = None
    if n_pt == 1:
        all_ids = pipe.map.sorted_kf_ids()
        parts = dist_ba.partition_windows(len(all_ids), 2, 2)
        window_kf_ids = [np.asarray(all_ids)[w] for w in parts]
        problems, _ = pipe.partition_problems(window_kf_ids, 1)
        n_fixed = max(1, min(cfg.ba.n_fixed, len(window_kf_ids[0]) - 1))
        sols = [ba.ba_solve_impl(p, n_fixed=n_fixed, max_iterations=cfg.ba.max_iterations,
                                 huber_delta=cfg.ba.huber_delta) for p in problems]
        ref = dist_ba.reconcile_windows_sim3(
            window_kf_ids, np.stack([_np(s[0]) for s in sols]),
            np.stack([_np(s[1]) for s in sols]))
    result = pipe.run_partitioned_global_ba(n_windows=2, mesh=m, overlap=2)
    return dict(statuses=statuses, before=before, table=table, after=map_state(pipe),
                result=result, ref=ref)


def partitioned_on_a_synthetic_map(cfg, map_args):
    """``run_partitioned_global_ba`` over (2, world / 2) on a synthetic map:
    the result, the window problems' shapes and the map after it."""
    pipe = _pipeline(cfg, map_args)
    world = torch.distributed.get_world_size()
    m = mesh_mod.make_mesh(2, world // 2, "cpu")
    all_ids = pipe.map.sorted_kf_ids()
    parts = dist_ba.partition_windows(len(all_ids), 2, 2)
    problems, _ = pipe.partition_problems([np.asarray(all_ids)[w] for w in parts], world // 2)
    result = pipe.run_partitioned_global_ba(n_windows=2, mesh=m, overlap=2)
    return dict(result=result, after=map_state(pipe),
                obs_slots=[p.uv.shape[0] for p in problems])


def build_pipeline(cfg):
    """Whether a pipeline of ``cfg`` builds here (the world's size
    against ``mesh_shape``): "built" or the error's text."""
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline

    try:
        VisualOdometryPipeline(cfg, device="cpu")
    except ValueError as e:
        return str(e)
    return "built"


def cli(argv):
    """``run.main(argv)`` (with ``--multihost`` it joins the group itself);
    this rank's summary and its keyframe poses."""
    from bundle_adjustment_tpu_torch import run
    from bundle_adjustment_tpu_torch.models.pipeline import VisualOdometryPipeline

    kept = []
    orig = VisualOdometryPipeline.finalize

    def finalize(self, *a, **kw):
        kept.append(self)
        return orig(self, *a, **kw)

    VisualOdometryPipeline.finalize = finalize
    try:
        summary = run.main(argv)
    finally:
        VisualOdometryPipeline.finalize = orig
    return dict(summary=summary, state=map_state(kept[0]))



def collectives_on_the_card():
    """``all_reduce``, ``broadcast`` and ``dist_ba.exchange`` of CUDA tensors
    (two ranks on one card: gloo, which stages them through the host)."""
    rank = torch.distributed.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.arange(6, dtype=torch.float32, device=dev) + rank
    torch.distributed.all_reduce(x)
    y = torch.full((3,), float(rank + 1), device=dev)
    torch.distributed.broadcast(y, src=1)
    part = torch.zeros((2, 3), dtype=torch.float32, device=dev)
    part[rank] = torch.tensor([-0.0, 1.5, -2.25], device=dev) * (rank + 1)
    z = dist_ba.exchange(part)
    return dict(backend=torch.distributed.get_backend(), device=str(x.device),
                x=_np(x), y=_np(y), z=_np(z))
