"""Distributed bundle adjustment on ``torch.distributed`` (port of
``bundle_adjustment_tpu.parallel.dist_ba``): the point-sharded Schur solve
and window-partitioned solves with sim(3) pose consensus, on a ("win",
"pt") mesh of ranks (``parallel/mesh``).

1. **Point sharding ("pt").**  ``shard_problem`` lays the points and their
   observations out in equal contiguous blocks, one per shard; each rank of
   the axis solves its block with the cameras replicated
   (``ops/ba.ba_solve_impl(group=...)``): the point blocks stay local and
   only the camera system and the scalar costs are summed over the group.
2. **Window partitioning ("win").**  The keyframe chain is split into
   overlapping windows (``partition_windows``), each row of the mesh solves
   one, and every rank then runs the same host consensus
   (``reconcile_windows_sim3``: chain alignment by sim(3) fits on the
   shared keyframes, chordal rotation averaging), in float64 numpy.

Results cross ranks by ``all_reduce`` of zero-filled buffers in which each
rank has written only its own part: the floats travel as their int32 bit
patterns, and an integer sum of one value and zeros is that value, bit for
bit.  ``problem_specs`` and ``globalize`` of the JAX package are
``shard_map`` plumbing and have no counterpart.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from bundle_adjustment_tpu_torch.ops import ba
from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np, so3_log_np
from bundle_adjustment_tpu_torch.parallel import mesh as mesh_mod


def shard_problem(problem: ba.BAProblem, n_shards: int,
                  min_obs_capacity: int = 0) -> ba.BAProblem:
    """``problem`` re-laid so that its points and observations fall into
    ``n_shards`` equal contiguous blocks (concatenated along the leading
    dim), on the problem's device.

    Host-side numpy.  Shard s holds points [s * P_s, (s + 1) * P_s) with
    P_s = ceil(P / n_shards); each live observation goes to the shard of its
    point, with its point index made shard-local, and every shard is padded
    to the largest shard's observation count (at least
    ``min_obs_capacity``), so all shards have one shape."""
    P_tot = problem.points.shape[0]

    def host(t):
        return t.detach().cpu().numpy()

    pnt_idx, cam_idx = host(problem.pnt_idx), host(problem.cam_idx)
    uv, obs_mask = host(problem.uv), host(problem.obs_mask)
    points, point_mask = host(problem.points), host(problem.point_mask)

    P_s = -(-P_tot // n_shards)
    shard_of_point = np.minimum(np.arange(P_tot) // P_s, n_shards - 1)
    obs_shard = shard_of_point[pnt_idx]
    live = obs_mask > 0
    O_s = max([int((live & (obs_shard == s)).sum()) for s in range(n_shards)]
              + [min_obs_capacity, 1])

    pts_out = np.zeros((n_shards * P_s, 3), points.dtype)
    pmask_out = np.zeros(n_shards * P_s, bool)
    ci = np.zeros(n_shards * O_s, np.int32)
    pi = np.zeros(n_shards * O_s, np.int32)
    uv_out = np.zeros((n_shards * O_s, 2), uv.dtype)
    om = np.zeros(n_shards * O_s, obs_mask.dtype)
    for s in range(n_shards):
        p0 = s * P_s
        n_p = max(min(p0 + P_s, P_tot) - p0, 0)
        pts_out[p0: p0 + n_p] = points[p0: p0 + n_p]
        pmask_out[p0: p0 + n_p] = point_mask[p0: p0 + n_p]
        sel = np.flatnonzero(live & (obs_shard == s))
        o0, n_o = s * O_s, len(sel)
        ci[o0: o0 + n_o] = cam_idx[sel]
        pi[o0: o0 + n_o] = pnt_idx[sel] - p0
        uv_out[o0: o0 + n_o] = uv[sel]
        om[o0: o0 + n_o] = obs_mask[sel]

    dev = problem.points.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    return problem._replace(points=t(pts_out), cam_idx=t(ci), pnt_idx=t(pi), uv=t(uv_out),
                            obs_mask=t(om), point_mask=t(pmask_out))


def shard_of(problem: ba.BAProblem, n_shards: int, s: int) -> ba.BAProblem:
    """Shard ``s`` of a ``shard_problem`` layout: its blocks of points and
    observations, the cameras and K whole."""
    P_s = problem.points.shape[0] // n_shards
    O_s = problem.uv.shape[0] // n_shards
    ps, os_ = slice(s * P_s, (s + 1) * P_s), slice(s * O_s, (s + 1) * O_s)
    return problem._replace(points=problem.points[ps], point_mask=problem.point_mask[ps],
                            cam_idx=problem.cam_idx[os_], pnt_idx=problem.pnt_idx[os_],
                            uv=problem.uv[os_], obs_mask=problem.obs_mask[os_])


def exchange(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over ``group`` of float32 or int32 buffers in which each rank has
    written its own part and zeros elsewhere: the sum of the int32 bit
    patterns, so every rank gets every part's bits exactly (for floats a
    float sum would turn a -0.0 into +0.0).  Returns a new tensor."""
    bits = buf.contiguous().view(torch.int32).clone()
    dist.all_reduce(bits, op=dist.ReduceOp.SUM, group=group)
    return bits.view(buf.dtype)


def ba_solve_sharded(problem: ba.BAProblem, mesh, axis: str = "pt", n_fixed: int = 1,
                     **solver_kwargs):
    """Solve a ``shard_problem`` layout over the mesh axis ``axis``: each rank
    of the axis solves its shard with the cameras replicated, every sum of
    the camera system and of the costs reduced over the axis's group.
    Returns (rvecs, tvecs, points, BAStats) on every rank, the points in the
    shard layout (every shard's block, reassembled by ``exchange``)."""
    n = mesh_mod.shape(mesh)[axis]
    s = mesh_mod.axis_index(mesh, axis)
    group = mesh_mod.axis_group(mesh, axis) if n > 1 else None
    local = shard_of(problem, n, s)
    rv, tv, pts, stats = ba.ba_solve_impl(local, n_fixed=n_fixed, group=group,
                                          **solver_kwargs)
    if group is None:
        return rv, tv, pts, stats
    P_s = local.points.shape[0]
    full = torch.zeros((n * P_s, 3), dtype=pts.dtype, device=pts.device)
    full[s * P_s: (s + 1) * P_s] = pts
    return rv, tv, exchange(full, group), stats


# ---------------------------------------------------------------------------
# Window partitioning with overlap consensus (the "win" axis), float64 numpy
# ---------------------------------------------------------------------------


def _project_so3(M: np.ndarray) -> np.ndarray:
    """Nearest rotation matrix (Frobenius) via SVD."""
    U, _, Vt = np.linalg.svd(M)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    return R


def chordal_mean(Rs) -> np.ndarray:
    """Chordal L2 rotation average: the Euclidean mean projected onto SO(3)."""
    return _project_so3(np.mean(np.asarray(Rs, np.float64), axis=0))


def fit_sim3(centers_dst: np.ndarray, centers_src: np.ndarray, R_rel: list) -> tuple:
    """(s, R_g, t_g) with c_dst ~ s R_g c_src + t_g: the rotation from the
    chordal mean of the per-keyframe ``R_rel``, the scale from the ratio of
    the centres' RMS spreads (1 with one shared keyframe), the translation
    from the centroids."""
    R_g = chordal_mean(R_rel)
    mu_d = centers_dst.mean(axis=0)
    mu_s = centers_src.mean(axis=0)
    s = 1.0
    if len(centers_dst) >= 2:
        spread_d = np.sqrt(np.sum((centers_dst - mu_d) ** 2))
        spread_s = np.sqrt(np.sum((centers_src - mu_s) ** 2))
        if spread_s > 1e-12 and spread_d > 1e-12:
            s = float(spread_d / spread_s)
    t_g = mu_d - s * (R_g @ mu_s)
    return s, R_g, t_g


def reconcile_windows_sim3(window_kf_ids: Sequence[np.ndarray], rvs, tvs):
    """Pose-graph consensus over independently solved windows, each in its
    own sim(3) gauge: window w is mapped into the frame of window 0 by a
    sim(3) fit on the keyframes it shares with the windows aligned before
    it, then the poses of shared keyframes are fused (chordal rotation mean,
    translation mean).  Returns (poses: kf_id -> (rvec, tvec), sim3s: per
    window (s, R_g, t_g), which maps its points as X' = s R_g X + t_g)."""
    W = len(window_kf_ids)
    rvs = np.asarray(rvs, np.float64)
    tvs = np.asarray(tvs, np.float64)

    # the first slot of each keyframe (windows are repeat-padded)
    slots: list[dict] = []
    for ids in window_kf_ids:
        d: dict = {}
        for i, kf in enumerate(ids):
            d.setdefault(int(kf), i)
        slots.append(d)

    def pose(w, i):
        return so3_exp_np(rvs[w, i]), tvs[w, i]

    identity = (1.0, np.eye(3), np.zeros(3))
    sim3s = [identity]
    aligned: list[dict] = [{kf: pose(0, i) for kf, i in slots[0].items()}]
    for w in range(1, W):
        prefix: dict = {}
        for a in aligned:
            prefix.update(a)
        shared = [kf for kf in slots[w] if kf in prefix]
        if shared:
            c_dst, c_src, R_rel = [], [], []
            for kf in shared:
                R_d, t_d = prefix[kf]
                R_s, t_s = pose(w, slots[w][kf])
                c_dst.append(-R_d.T @ t_d)
                c_src.append(-R_s.T @ t_s)
                R_rel.append(R_d.T @ R_s)
            s, R_g, t_g = fit_sim3(np.asarray(c_dst), np.asarray(c_src), R_rel)
        else:
            s, R_g, t_g = identity
        sim3s.append((s, R_g, t_g))
        cur = {}
        for kf, i in slots[w].items():
            R_s, t_s = pose(w, i)
            # the extrinsic under the world sim(3): R' = R R_g^T, t' = s t - R' t_g
            R_n = R_s @ R_g.T
            cur[kf] = (R_n, s * t_s - R_n @ t_g)
        aligned.append(cur)

    acc: dict[int, list] = {}
    for a in aligned:
        for kf, Rt in a.items():
            acc.setdefault(kf, []).append(Rt)
    poses = {}
    for kf, lst in acc.items():
        R = chordal_mean([Rt[0] for Rt in lst])
        t = np.mean([Rt[1] for Rt in lst], axis=0)
        poses[kf] = (so3_log_np(R), t)
    return poses, sim3s


def partition_windows(n_keyframes: int, n_windows: int, overlap: int = 1):
    """[0, n_keyframes) split into ``n_windows`` contiguous windows whose
    neighbours share ``overlap`` keyframes, each padded to the longest by
    repeating its last index."""
    if n_windows == 1:
        return [np.arange(n_keyframes)]
    base = -(-(n_keyframes + (n_windows - 1) * overlap) // n_windows)
    windows = []
    start = 0
    for _ in range(n_windows):
        end = min(start + base, n_keyframes)
        windows.append(np.arange(start, end))
        start = end - overlap
    L = max(len(w) for w in windows)
    return [np.pad(w, (0, L - len(w)), mode="edge") for w in windows]


def solve_windows_consensus(problems: Sequence[ba.BAProblem],
                            window_kf_ids: Sequence[np.ndarray], mesh, n_fixed: int = 1,
                            **solver_kwargs):
    """Solve W window problems of one shape, row w of the mesh solving
    window w (point-sharded over the row's "pt" ranks when that axis has
    more than one: the problems must then be ``shard_problem`` layouts for
    it), exchange the results over the world, and reconcile them with
    ``reconcile_windows_sim3`` on every rank.  Every rank of the world calls
    it; a rank outside the mesh solves nothing.  Returns (poses, sim3s, (rvs
    (W, C, 3), tvs, ptss (W, P, 3), BAStats of (W,) arrays)), numpy."""
    shp = mesh_mod.shape(mesh)
    W, n_pt = len(problems), shp["pt"]
    if W != shp["win"]:
        raise ValueError(f"{W} windows on a mesh of {shp}")
    C = problems[0].rvecs.shape[0]
    P = problems[0].points.shape[0]
    n_stats = len(ba.BAStats._fields)
    layout = np.cumsum([0, 3 * C, 3 * C, n_stats, 3 * P])
    dev = problems[0].points.device
    rows = torch.zeros((W, int(layout[-1])), dtype=torch.float32, device=dev)
    coord = mesh.get_coordinate()
    if coord is not None:
        w, s = coord
        if n_pt > 1:
            rv, tv, pts, stats = ba_solve_sharded(problems[w], mesh, "pt", n_fixed=n_fixed,
                                                  **solver_kwargs)
        else:
            rv, tv, pts, stats = ba.ba_solve_impl(problems[w], n_fixed=n_fixed,
                                                  **solver_kwargs)
        if s == 0:
            sv = torch.stack([torch.as_tensor(x, device=dev).to(torch.float32)
                              for x in stats])
            rows[w] = torch.cat([rv.reshape(-1).float(), tv.reshape(-1).float(), sv,
                                 pts.reshape(-1).float()])
    rows = exchange(rows).cpu().numpy()
    rvs = rows[:, layout[0]: layout[1]].reshape(W, C, 3)
    tvs = rows[:, layout[1]: layout[2]].reshape(W, C, 3)
    sv = rows[:, layout[2]: layout[3]]
    ptss = rows[:, layout[3]: layout[4]].reshape(W, P, 3)
    stats = ba.BAStats(initial_cost=sv[:, 0], final_cost=sv[:, 1], initial_sq=sv[:, 2],
                       final_sq=sv[:, 3], iterations=sv[:, 4].astype(np.int32),
                       accepted=sv[:, 5] > 0.5, stop=sv[:, 6].astype(np.int32))
    poses, sim3s = reconcile_windows_sim3(window_kf_ids, rvs, tvs)
    return poses, sim3s, (rvs, tvs, ptss, stats)
