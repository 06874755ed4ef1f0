"""Structure-of-arrays world model: keyframes, map points, observations
(port of ``bundle_adjustment_tpu.models.map_store``).

The numpy observation table is the source of truth.  With ``use_native``
(the default, as in the JAX package) a C++ mirror of it
(``native.NativeObsTable``) holds a per-keyframe row index, and
``gather_window`` reads a window's rows from it instead of scanning the
whole table.  Every method that changes the table updates the mirror;
``refill_native`` rebuilds it from the arrays after they were set directly
(a checkpoint restore, ``convert.map_store``).

Points die by culling (``cull_points``) and by loop-closure fusion
(``merge_points``); their observations die with them, and every reader of
the table (``gather_window``, the per-point queries, ``get_pcd``) skips dead
rows and dead points.

The flat observation table — (kf_id, mp_id, kp_idx, u, v) rows — is at once
the per-point and per-keyframe observation list and the BA sparsity
pattern.  ``gather_window`` compacts a keyframe window into a padded
BAProblem on the map's device; ``apply_ba_result`` writes optimized poses
and points back.  Keyframe descriptor banks stay on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bundle_adjustment_tpu_torch import device as device_mod
from bundle_adjustment_tpu_torch import native
from bundle_adjustment_tpu_torch.ops import ba
from bundle_adjustment_tpu_torch.ops.lie import so3_exp_np, so3_log_np

_GROW = 1.5


def _bucket(n: int, buckets=(256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))


@dataclasses.dataclass
class Keyframe:
    """Host view of one keyframe (the reference's R, t convention)."""

    kf_id: int
    R: np.ndarray             # (3, 3)
    t: np.ndarray             # (3,)
    xy: np.ndarray            # (N, 2) keypoint pixels (fixed capacity, masked)
    desc: torch.Tensor        # (N, 8) int32 descriptor words, on the device
    kp_valid: np.ndarray      # (N,) bool
    frame_idx: int = -1
    kp_to_mp: np.ndarray = None   # kp_idx -> mp_id (-1 = none)

    def __post_init__(self):
        if self.kp_to_mp is None:
            self.kp_to_mp = np.full(self.xy.shape[0], -1, np.int64)


class Map:
    """The world model: host numpy arrays, descriptor banks on ``device``;
    with ``use_native`` the C++ mirror of the observation table (its build
    failing raises)."""

    def __init__(self, device="cuda", use_native: bool = True):
        self.device = device_mod.resolve(device)
        self._native = native.NativeObsTable() if use_native else None
        self.keyframes: dict[int, Keyframe] = {}
        self.next_keyframe_id = 0
        self.next_map_point_id = 0
        self.log = None   # optional EventLog for capacity_drop events

        cap = 1024
        self._pts = np.zeros((cap, 3), np.float64)
        self._colors = np.zeros((cap, 3), np.float64)
        self._pt_alive = np.zeros(cap, bool)
        self._n_pts = 0

        ocap = 4096
        self._obs_kf = np.zeros(ocap, np.int64)
        self._obs_mp = np.zeros(ocap, np.int64)
        self._obs_kp = np.zeros(ocap, np.int64)
        self._obs_uv = np.zeros((ocap, 2), np.float64)
        self._obs_alive = np.zeros(ocap, bool)
        self._n_obs = 0

    # -- keyframes ---------------------------------------------------------

    def add_keyframe(self, kf: Keyframe) -> int:
        if kf.kf_id in self.keyframes:
            raise ValueError(f"keyframe id {kf.kf_id} already exists")
        self.keyframes[kf.kf_id] = kf
        self.next_keyframe_id = max(self.next_keyframe_id, kf.kf_id + 1)
        return kf.kf_id

    def new_keyframe_id(self) -> int:
        return self.next_keyframe_id

    @property
    def num_keyframes(self) -> int:
        return len(self.keyframes)

    def sorted_kf_ids(self) -> list[int]:
        return sorted(self.keyframes)

    # -- map points --------------------------------------------------------

    def _ensure_pts(self, extra: int):
        need = self._n_pts + extra
        if need > len(self._pts):
            cap = max(int(len(self._pts) * _GROW), need)
            for name in ("_pts", "_colors"):
                a = getattr(self, name)
                b = np.zeros((cap, a.shape[1]), a.dtype)
                b[: self._n_pts] = a[: self._n_pts]
                setattr(self, name, b)
            alive = np.zeros(cap, bool)
            alive[: self._n_pts] = self._pt_alive[: self._n_pts]
            self._pt_alive = alive

    def add_map_points(self, pts: np.ndarray, colors: Optional[np.ndarray] = None) -> np.ndarray:
        """Append a batch of points; returns their dense new ids."""
        n = len(pts)
        self._ensure_pts(n)
        ids = np.arange(self._n_pts, self._n_pts + n)
        self._pts[ids] = pts
        self._colors[ids] = colors if colors is not None else 0.5
        self._pt_alive[ids] = True
        self._n_pts += n
        self.next_map_point_id = self._n_pts
        return ids

    @property
    def num_points(self) -> int:
        return int(self._pt_alive[: self._n_pts].sum())

    def points(self) -> np.ndarray:
        return self._pts[: self._n_pts]

    def colors(self) -> np.ndarray:
        return self._colors[: self._n_pts]

    def point_alive(self) -> np.ndarray:
        return self._pt_alive[: self._n_pts]

    def cull_points(self, mp_ids: np.ndarray):
        """Remove map points; their observations and the keypoint
        back-pointers to them die with them."""
        self._pt_alive[mp_ids] = False
        dead = np.zeros(self._n_pts, bool)
        dead[mp_ids] = True
        self._obs_alive[: self._n_obs][dead[self._obs_mp[: self._n_obs]]] = False
        if self._native is not None:
            self._native.kill_mps(np.flatnonzero(dead))
        for kf in self.keyframes.values():
            kf.kp_to_mp[dead[kf.kp_to_mp] & (kf.kp_to_mp >= 0)] = -1

    # -- observations ------------------------------------------------------

    def _ensure_obs(self, extra: int):
        need = self._n_obs + extra
        if need > len(self._obs_kf):
            cap = max(int(len(self._obs_kf) * _GROW), need)
            for name in ("_obs_kf", "_obs_mp", "_obs_kp"):
                a = getattr(self, name)
                b = np.zeros(cap, a.dtype)
                b[: self._n_obs] = a[: self._n_obs]
                setattr(self, name, b)
            uv = np.zeros((cap, 2), np.float64)
            uv[: self._n_obs] = self._obs_uv[: self._n_obs]
            self._obs_uv = uv
            alive = np.zeros(cap, bool)
            alive[: self._n_obs] = self._obs_alive[: self._n_obs]
            self._obs_alive = alive

    def add_observations(self, kf_id: int, mp_ids: np.ndarray, kp_idxs: np.ndarray,
                         uvs: np.ndarray):
        """Register observations (one table serves both directions)."""
        n = len(mp_ids)
        if n == 0:
            return
        self._ensure_obs(n)
        sl = slice(self._n_obs, self._n_obs + n)
        self._obs_kf[sl] = kf_id
        self._obs_mp[sl] = mp_ids
        self._obs_kp[sl] = kp_idxs
        self._obs_uv[sl] = uvs
        self._obs_alive[sl] = True
        self._n_obs += n
        self.keyframes[kf_id].kp_to_mp[kp_idxs] = mp_ids
        if self._native is not None:
            self._native.append(np.full(n, kf_id, np.int64), mp_ids, kp_idxs, uvs)

    def refill_native(self):
        """Rebuild the C++ mirror from the numpy table (after its arrays were
        set directly, as a checkpoint restore does)."""
        if self._native is None:
            return
        n = self._n_obs
        self._native = native.NativeObsTable()
        self._native.append(self._obs_kf[:n], self._obs_mp[:n], self._obs_kp[:n],
                            self._obs_uv[:n])
        dead = np.flatnonzero(~self._obs_alive[:n])
        if len(dead):
            self._native.kill_rows(dead)

    @property
    def num_observations(self) -> int:
        return int(self._obs_alive[: self._n_obs].sum())

    def observations_of_point(self, mp_id: int):
        """(kf_ids, kp_idxs) of the live observations of one point."""
        m = (self._obs_mp[: self._n_obs] == mp_id) & self._obs_alive[: self._n_obs]
        return self._obs_kf[: self._n_obs][m], self._obs_kp[: self._n_obs][m]

    def first_observer_per_point(self) -> np.ndarray:
        """Per point, the id of its first observing keyframe (int64; the
        largest int64 for a point with no live observation)."""
        first = np.full(self._n_pts, np.iinfo(np.int64).max, np.int64)
        alive = self._obs_alive[: self._n_obs]
        np.minimum.at(first, self._obs_mp[: self._n_obs][alive],
                      self._obs_kf[: self._n_obs][alive])
        return first

    def anchor_observations(self, max_first_kf: int):
        """(mp_ids, kf_ids, kp_idxs) of each live point's first observation,
        for the points first observed at or before ``max_first_kf``: the
        loop-closure bank, one descriptor per map point (a bank of every
        view would hold near-equal descriptors of one point, and the ratio
        test rejects every match among such duplicates)."""
        first = self.first_observer_per_point()
        alive_rows = self._obs_alive[: self._n_obs]
        okf = self._obs_kf[: self._n_obs][alive_rows]
        omp = self._obs_mp[: self._n_obs][alive_rows]
        okp = self._obs_kp[: self._n_obs][alive_rows]
        sel = (first[omp] == okf) & (okf <= max_first_kf) & self._pt_alive[omp]
        mp, kf, kp = omp[sel], okf[sel], okp[sel]
        _, f = np.unique(mp, return_index=True)
        return mp[f], kf[f], kp[f]

    def merge_points(self, dst_mp: int, src_mp: int) -> int:
        """Fuse two map points found to be one (loop closure): the
        observations of ``src_mp`` move to ``dst_mp`` and ``src_mp`` dies.  A
        keyframe that already observes ``dst_mp`` keeps its own observation
        (one observation per keyframe and point).  Kill and re-add, as the
        JAX package does.  Returns the number of observations moved."""
        rows = np.flatnonzero(self._obs_mp[: self._n_obs] == src_mp)
        live = rows[self._obs_alive[rows]]
        kfs, kps, uvs = self._obs_kf[live], self._obs_kp[live], self._obs_uv[live]
        drows = np.flatnonzero(self._obs_mp[: self._n_obs] == dst_mp)
        dst_kfs = set(self._obs_kf[drows[self._obs_alive[drows]]].tolist())
        # cull_points([src_mp]) over the rows of src_mp only: a keypoint's
        # back-pointer is set by add_observations, which adds a row, so only
        # keyframes with a row of src_mp (live or dead) can point at it
        self._pt_alive[src_mp] = False
        self._obs_alive[rows] = False
        if self._native is not None:
            self._native.kill_rows(rows)
        for k in np.unique(self._obs_kf[rows]):
            kp_to_mp = self.keyframes[int(k)].kp_to_mp
            kp_to_mp[kp_to_mp == src_mp] = -1
        n = 0
        for kf, kp, uv in zip(kfs, kps, uvs):
            if int(kf) in dst_kfs:
                continue
            self.add_observations(int(kf), np.asarray([dst_mp]), np.asarray([kp]), uv[None])
            dst_kfs.add(int(kf))
            n += 1
        return n

    def observation_count_per_point(self) -> np.ndarray:
        counts = np.zeros(self._n_pts, np.int64)
        alive = self._obs_alive[: self._n_obs]
        np.add.at(counts, self._obs_mp[: self._n_obs][alive], 1)
        return counts

    # -- BA window extraction / writeback ---------------------------------

    def gather_window(self, window_kf_ids: list[int], K: np.ndarray,
                      max_points: int, max_obs: int, dtype=np.float32,
                      pad_to_max: bool = False):
        """Padded BAProblem for a keyframe window, on the map's device:
        points observed by window keyframes and only the observations those
        keyframes made.  Returns (problem, mp_ids, obs_rows) or None."""
        window_kf_ids = list(window_kf_ids)
        kf_pos: dict = {}
        for i, k in enumerate(window_kf_ids):
            kf_pos.setdefault(k, i)

        if self._native is not None:
            # each keyframe once: the mirror returns a keyframe's rows as many
            # times as it is named, and a repeat-padded window names its last
            # keyframe again (the JAX package passes the window as it is, and
            # its gather repeats those rows when the table has room for them)
            obs_rows = np.sort(self._native.gather_window(np.unique(window_kf_ids)))
        else:
            alive = self._obs_alive[: self._n_obs]
            in_win = np.isin(self._obs_kf[: self._n_obs], window_kf_ids) & alive
            obs_rows = np.flatnonzero(in_win)
        okf = self._obs_kf[obs_rows]
        omp = self._obs_mp[obs_rows]
        ouv = self._obs_uv[obs_rows]
        if len(omp) == 0:
            return None

        mp_ids, pnt_idx = np.unique(omp, return_inverse=True)
        if len(mp_ids) > max_points or len(omp) > max_obs:
            n_pts_before, n_obs_before = len(mp_ids), len(omp)
            counts = np.bincount(pnt_idx)
            keep_p = np.argsort(-counts)[:max_points]
            keep_mask = np.isin(pnt_idx, keep_p)
            okf, omp, ouv = okf[keep_mask], omp[keep_mask], ouv[keep_mask]
            obs_rows = obs_rows[keep_mask][:max_obs]
            okf, omp, ouv = okf[:max_obs], omp[:max_obs], ouv[:max_obs]
            mp_ids, pnt_idx = np.unique(omp, return_inverse=True)
            if self.log is not None:
                self.log.emit(
                    "capacity_drop",
                    f"    -> BA window over capacity: dropped "
                    f"{n_pts_before - len(mp_ids)} points / "
                    f"{n_obs_before - len(omp)} observations "
                    f"(max_points={max_points}, max_obs={max_obs})",
                    dropped_points=int(n_pts_before - len(mp_ids)),
                    dropped_obs=int(n_obs_before - len(omp)),
                    max_points=int(max_points), max_obs=int(max_obs),
                )

        cam_idx = np.array([kf_pos[k] for k in okf], np.int32)
        if pad_to_max:
            P, O = max_points, max_obs
        else:
            P = _bucket(len(mp_ids))
            O = _bucket(len(omp))

        rvecs = np.stack([so3_log_np(self.keyframes[k].R) for k in window_kf_ids]).astype(dtype)
        tvecs = np.stack([self.keyframes[k].t for k in window_kf_ids]).astype(dtype)
        pts = np.zeros((P, 3), dtype)
        pts[: len(mp_ids)] = self._pts[mp_ids]
        point_mask = np.zeros(P, bool)
        point_mask[: len(mp_ids)] = True
        ci = np.zeros(O, np.int32)
        pi = np.zeros(O, np.int32)
        uv = np.zeros((O, 2), dtype)
        om = np.zeros(O, dtype)
        ci[: len(omp)] = cam_idx
        pi[: len(omp)] = pnt_idx
        uv[: len(omp)] = ouv
        om[: len(omp)] = 1.0

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        problem = ba.BAProblem(
            rvecs=dev(rvecs), tvecs=dev(tvecs), points=dev(pts),
            cam_idx=dev(ci), pnt_idx=dev(pi), uv=dev(uv), obs_mask=dev(om),
            point_mask=dev(point_mask), K=dev(np.asarray(K, dtype)),
        )
        return problem, mp_ids, obs_rows

    def kill_observations(self, obs_rows: np.ndarray):
        """Remove observation-table rows (post-BA outlier pruning) and clear
        the kp->mp back-pointers they set."""
        self._obs_alive[obs_rows] = False
        if self._native is not None:
            self._native.kill_rows(obs_rows)
        for r in obs_rows:
            kf = self.keyframes[self._obs_kf[r]]
            if kf.kp_to_mp[self._obs_kp[r]] == self._obs_mp[r]:
                kf.kp_to_mp[self._obs_kp[r]] = -1

    def apply_ba_result(self, window_kf_ids: list[int], mp_ids: np.ndarray,
                        rvecs, tvecs, points, n_fixed: int = 1):
        """Write optimized poses/points back; gauge-fixed poses untouched."""
        rvecs = np.asarray(rvecs, np.float64)
        tvecs = np.asarray(tvecs, np.float64)
        points = np.asarray(points, np.float64)
        for i, k in enumerate(window_kf_ids):
            if i < n_fixed:
                continue
            kf = self.keyframes[k]
            kf.R = so3_exp_np(rvecs[i])
            kf.t = tvecs[i]
        self._pts[mp_ids] = points[: len(mp_ids)]

    # -- export ------------------------------------------------------------

    def get_pcd(self):
        """(points, colors) of alive map points."""
        alive = self._pt_alive[: self._n_pts]
        return self._pts[: self._n_pts][alive], self._colors[: self._n_pts][alive]

    def trajectory(self, consistent: bool = False):
        """(K, 3) camera positions in keyframe order: t (the reference's
        convention) or, with ``consistent``, the optical centre -R^T t."""
        ids = self.sorted_kf_ids()
        if not ids:
            return np.zeros((0, 3))
        if consistent:
            return np.stack([-self.keyframes[k].R.T @ self.keyframes[k].t for k in ids])
        return np.stack([self.keyframes[k].t for k in ids])
