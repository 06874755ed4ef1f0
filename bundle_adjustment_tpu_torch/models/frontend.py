"""Fused per-frame frontend (port of ``bundle_adjustment_tpu.models.frontend``).

``track_step`` runs the whole tracked-frame path on the device:

    ORB extract -> Hamming 2-NN + ratio -> PnP RANSAC against the tracked
    map points -> relative model -> Sampson epipolar inliers -> keyframe
    METRICS (median parallax / displacement / rotation magnitude)

and returns the same packed (34,) scalar vector and (N, 10) insertion
matrix as the JAX package, so the host reads one small vector per tracked
frame and one matrix per keyframe.  The PnP sample uniforms ``u`` are an
input (see ``ops/ransac.py``).

``TrackStep`` runs it behind static input buffers, as the JAX package runs
it as one jitted dispatch: on the card the step is captured once per shape
key as a CUDA graph and each tracked frame is one replay; on the CPU the
same step runs eagerly on the same buffers.

Medians follow ``jnp.nanmedian``: the midpoint of the two middle values of
the sorted valid subset (``torch.nanmedian`` would return the lower one).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from bundle_adjustment_tpu_torch import device as device_mod
from bundle_adjustment_tpu_torch import kernels
from bundle_adjustment_tpu_torch.ops import hamming, orb, ransac, triangulation
from bundle_adjustment_tpu_torch.ops.lie import rotation_angle, so3_exp, so3_hat, so3_log_np
from bundle_adjustment_tpu_torch.ops.projection import epipolar_errors_px
from bundle_adjustment_tpu_torch.utils.stages import stage


class FrontendState(NamedTuple):
    """Device mirror of the last keyframe (what matching/PnP need)."""

    desc: torch.Tensor      # (N, 8) int32 descriptor words
    xy: torch.Tensor        # (N, 2) f32 keypoint pixels
    kp_valid: torch.Tensor  # (N,) bool
    pts3d: torch.Tensor     # (N, 3) f32 map-point position per slot (0 if none)
    tracked: torch.Tensor   # (N,) bool — slot has a map point
    rvec: torch.Tensor      # (3,) f32
    tvec: torch.Tensor      # (3,) f32


class TrackResult(NamedTuple):
    """Packed per-frame outputs (layouts as in the JAX package):

    packed (34,) f32:
      0 n_matches | 1 tracked_n | 2 pnp_ok | 3 pnp_inliers | 4 num_inliers
      5 rot_mag | 6 n_parallax | 7 med_parallax_deg | 8 med_disp_px
      9 n_kp_valid | 10:19 R_pnp | 19:22 t_pnp | 22:31 R_rel | 31:34 t_rel
    insert_packed (N, 10) f32:
      0 match_idx | 1 match_mask | 2 inliers | 3:6 speculative DLT point in
      the last KF's frame | 6 tri_valid | 7:9 kp_xy | 9 kp_valid
    """

    packed: torch.Tensor
    kp_xy: torch.Tensor
    kp_desc: torch.Tensor
    kp_valid: torch.Tensor
    match_idx: torch.Tensor
    match_mask: torch.Tensor
    match_dist: torch.Tensor
    inliers: torch.Tensor
    insert_packed: torch.Tensor


class TrackScalars(NamedTuple):
    """Host-side unpacked view of TrackResult.packed."""

    n_matches: int
    tracked_n: int
    pnp_ok: bool
    pnp_inliers: int
    num_inliers: int
    rot_mag: float
    n_parallax: int
    med_parallax_deg: float
    med_disp_px: float
    n_kp_valid: int
    R_pnp: "np.ndarray"
    t_pnp: "np.ndarray"
    R_rel: "np.ndarray"
    t_rel: "np.ndarray"


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def unpack_scalars(packed) -> TrackScalars:
    v = _to_numpy(packed)
    return TrackScalars(
        n_matches=int(v[0]), tracked_n=int(v[1]), pnp_ok=bool(v[2] > 0.5),
        pnp_inliers=int(v[3]), num_inliers=int(v[4]), rot_mag=float(v[5]),
        n_parallax=int(v[6]), med_parallax_deg=float(v[7]),
        med_disp_px=float(v[8]), n_kp_valid=int(v[9]),
        R_pnp=v[10:19].reshape(3, 3), t_pnp=v[19:22],
        R_rel=v[22:31].reshape(3, 3), t_rel=v[31:34],
    )


class InsertArrays(NamedTuple):
    """Host-side unpacked view of TrackResult.insert_packed (numpy)."""

    match_idx: "np.ndarray"
    match_mask: "np.ndarray"
    inliers: "np.ndarray"
    tri_X: "np.ndarray"
    tri_valid: "np.ndarray"
    kp_xy: "np.ndarray"
    kp_valid: "np.ndarray"


def unpack_insert(insert_packed) -> InsertArrays:
    v = _to_numpy(insert_packed)
    return InsertArrays(
        match_idx=v[:, 0].astype(np.int64),
        match_mask=v[:, 1] > 0.5,
        inliers=v[:, 2] > 0.5,
        tri_X=v[:, 3:6],
        tri_valid=v[:, 6] > 0.5,
        kp_xy=v[:, 7:9],
        kp_valid=v[:, 9] > 0.5,
    )


def _masked_median(values, mask):
    """jnp.nanmedian over the masked subset: midpoint of the two middle
    sorted values; nan when the subset is empty."""
    v = torch.where(mask, values, torch.nan)
    s = torch.sort(v).values
    n = torch.sum(mask).to(torch.float32)
    q = 0.5 * (n - 1.0)
    hi = s.shape[0] - 1
    low = torch.clamp(torch.minimum(torch.floor(q), n - 1), min=0).long().clamp(max=hi)
    high = torch.clamp(torch.minimum(torch.ceil(q), n - 1), min=0).long().clamp(max=hi)
    # index_select: indexing with a 0-d tensor would read it on the host
    return (s.index_select(0, low.reshape(1))[0] + s.index_select(0, high.reshape(1))[0]) * 0.5


def track_step(
    image_u8: torch.Tensor,
    state: FrontendState,
    K: torch.Tensor,
    u: torch.Tensor,
    *,
    num_features: int,
    levels: int,
    pyramid_scale: float,
    fast_threshold: float,
    height: int,
    width: int,
    ratio: float,
    cross_check: bool,
    pnp_iters: int,
    pnp_reproj_px: float,
    sampson_thr_px: float,
    consistent: bool,
) -> TrackResult:
    """The fused tracked-frame step.  ``u``: PnP sample uniforms of shape
    ``ransac.pnp_draw_shape(pnp_iters)``.  Each stage runs inside
    ``utils/stages.stage`` (a no-op outside a profile by stage)."""
    f32 = torch.float32
    kp = orb.extract(
        image_u8, num_features=num_features, levels=levels,
        scale=pyramid_scale, threshold=fast_threshold,
        height=height, width=width,
    )
    with stage("K1 match"):
        idx, mask, dist = hamming.match(
            state.desc, kp.desc, state.kp_valid, kp.valid,
            ratio=ratio, cross_check=cross_check,
        )
        uv1 = state.xy
        uv2 = kp.xy[idx.long()]
        tracked = mask & state.tracked
        tracked_n = torch.sum(tracked)

    with stage("pnp ransac"):
        res = ransac.estimate_pnp_pose(
            u, state.pts3d, uv2, tracked, K,
            reproj_threshold_px=pnp_reproj_px, num_hyp=pnp_iters,
        )
    with stage("relative model"):
        R_last = so3_exp(state.rvec)
        t_last = state.tvec
        R_pnp, t_pnp = res.R, res.t
        R_rel = torch.matmul(R_pnp, R_last.T)
        t_rel = t_pnp - R_rel @ t_last
        finite = torch.isfinite(R_pnp).all() & torch.isfinite(t_pnp).all()

    with stage("sampson"):
        t_u = t_rel / torch.linalg.norm(t_rel).clamp(min=1e-12)
        E = torch.matmul(so3_hat(t_u), R_rel)
        errs = epipolar_errors_px(E, K, uv1, uv2)
        inl = (errs < sampson_thr_px ** 2) & mask
        num_inliers = torch.sum(inl)

    with stage("keyframe metrics"):
        rot_mag = rotation_angle(R_rel)
        if consistent:
            c_last = -(R_last.T @ t_last)
            c_new = -(R_pnp.T @ t_pnp)
        else:
            c_last = t_last
            c_new = t_last + R_last @ t_rel
        par_mask = inl & state.tracked
        r1 = state.pts3d - c_last
        r2 = state.pts3d - c_new
        n1 = torch.linalg.norm(r1, dim=1)
        n2 = torch.linalg.norm(r2, dim=1)
        good = par_mask & (n1 > 1e-9) & (n2 > 1e-9)
        cosang = torch.sum(r1 * r2, dim=1) / (n1 * n2).clamp(min=1e-18)
        ang_deg = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
        med_par = _masked_median(ang_deg, good)
        med_disp = _masked_median(torch.linalg.norm(uv2 - uv1, dim=1), inl)

    with stage("speculative DLT"):
        tri_X, tri_ok = triangulation.triangulate_pair(
            K.to(f32), R_rel.to(f32), t_rel.to(f32), uv1, uv2)
        tri_ok = tri_ok & inl

    with stage("pack"):
        packed = torch.cat([
            torch.stack([
                torch.sum(mask).to(f32), tracked_n.to(f32),
                (res.ok & finite).to(f32), res.num_inliers.to(f32),
                num_inliers.to(f32), rot_mag.to(f32), torch.sum(par_mask).to(f32),
                med_par.to(f32), med_disp.to(f32), torch.sum(kp.valid).to(f32),
            ]),
            R_pnp.reshape(-1).to(f32), t_pnp.to(f32),
            R_rel.reshape(-1).to(f32), t_rel.to(f32),
        ])
        insert_packed = torch.cat([
            idx[:, None].to(f32), mask[:, None].to(f32), inl[:, None].to(f32),
            tri_X.to(f32), tri_ok[:, None].to(f32), kp.xy.to(f32),
            kp.valid[:, None].to(f32),
        ], dim=1)
    return TrackResult(
        packed=packed, kp_xy=kp.xy, kp_desc=kp.desc, kp_valid=kp.valid,
        match_idx=idx, match_mask=mask, match_dist=dist, inliers=inl,
        insert_packed=insert_packed,
    )


class TrackStep:
    """``track_step`` behind static input buffers: the gray image, the
    ``FrontendState`` tensors, ``K`` and the PnP uniforms ``u``.

    The caller copies a keyframe's state in with ``load_state`` when it
    changes (a new keyframe, or the map moved under BA), draws each frame's
    ``u`` into ``u_buffer(shape)`` and calls ``run``, which copies the image
    and ``K`` in and runs the step.  On the card the step is a CUDA graph,
    one per shape key (the image's H and W, the state's capacity, the shape
    of ``u`` and ``track_step``'s static arguments): the first ``run`` of a
    key warms the step up eagerly on the side stream and captures it
    (``kernels.capture``); every ``run`` replays it and adds the replay's K1
    and K2 launches to ``kernels.LAUNCHES``.  A capture that fails raises:
    no eager step stands behind it.  A replay writes its outputs into the
    graph's own buffers, which the next replay overwrites, so ``run``
    returns copies of its own, issued before any later replay: no tensor the
    caller keeps aliases the graph.  On the CPU ``run`` calls ``track_step``
    eagerly on the same buffers.

    ``captures`` lists each capture (key, seconds of warm-up and capture,
    launches per replay); ``replays`` counts the replays."""

    def __init__(self, device="cuda"):
        self.device = device_mod.resolve(device)
        self.state: FrontendState | None = None
        self._states: dict = {}      # capacity N -> static FrontendState
        self._images: dict = {}      # (H, W) -> static uint8 image
        self._u: dict = {}           # shape -> static uniforms
        self._K = torch.zeros((3, 3), dtype=torch.float32, device=self.device)
        self._graphs: dict = {}      # key -> (graph, outputs, launches per replay)
        self.captures: list = []
        self.replays = 0

    def load_state(self, state: FrontendState) -> FrontendState:
        """Copy ``state`` into the static state of its capacity; returns it."""
        n = state.desc.shape[0]
        if n not in self._states:
            self._states[n] = FrontendState(*(torch.empty_like(t, device=self.device)
                                              for t in state))
        self.state = self._states[n]
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        return self.state

    def u_buffer(self, shape) -> torch.Tensor:
        """The static PnP uniforms of ``shape``, for the caller to draw into."""
        shape = tuple(shape)
        if shape not in self._u:
            self._u[shape] = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return self._u[shape]

    def run(self, image_u8, K: torch.Tensor, u: torch.Tensor, **static) -> TrackResult:
        """``track_step(image_u8, state, K, u, **static)`` on the static
        buffers and the state loaded last.  ``image_u8``: (H, W) uint8,
        numpy or tensor; ``u``: ``u_buffer``'s tensor, drawn."""
        if self.state is None:
            raise RuntimeError("TrackStep.run before load_state")
        if u is not self._u.get(tuple(u.shape)):
            raise ValueError("u: draw into u_buffer(shape), the step's static uniforms")
        hw = tuple(image_u8.shape)
        if hw not in self._images:
            self._images[hw] = torch.zeros(hw, dtype=torch.uint8, device=self.device)
        image = self._images[hw]
        image.copy_(torch.as_tensor(image_u8))
        self._K.copy_(K)
        args = (image, self.state, self._K, u)
        if self.device.type != "cuda":
            return track_step(*args, **static)
        return self._replay(args, static)

    def _replay(self, args: tuple, static: dict) -> TrackResult:
        """``track_step(*args, **static)`` as a replay of its graph, captured
        at the first call with these shapes and arguments."""
        hw, u = tuple(args[0].shape), args[3]
        key = (hw, self.state.desc.shape[0], tuple(u.shape), tuple(sorted(static.items())))
        entry = self._graphs.get(key)
        if entry is None:
            t0 = time.perf_counter()
            kernels.on_side_stream(self.device, lambda: track_step(*args, **static))
            entry = self._graphs[key] = kernels.capture(
                self.device, lambda: track_step(*args, **static))
            self.captures.append(dict(key=key, seconds=time.perf_counter() - t0,
                                      launches_per_replay=entry[2]))
            print(f"TrackStep: captured the tracked-frame step for a {hw[1]}x{hw[0]} image, "
                  f"{key[1]} features (capture {len(self.captures)}, "
                  f"{self.captures[-1]['seconds']:.2f} s with its warm-up)", flush=True)
        graph, out, per_replay = entry
        kernels.replay(graph, per_replay)
        self.replays += 1
        return TrackResult(*(t.clone() for t in out))


def covis_step(
    bank_desc: torch.Tensor,     # (B, N, 8) int32
    bank_valid: torch.Tensor,    # (B, N) bool
    bank_pts: torch.Tensor,      # (B, N, 3) f32
    bank_tracked: torch.Tensor,  # (B, N) bool
    new_desc: torch.Tensor,      # (N, 8) int32
    new_valid: torch.Tensor,     # (N,) bool
    new_xy: torch.Tensor,        # (N, 2) f32
    R_new: torch.Tensor,         # (3, 3) f32
    t_new: torch.Tensor,         # (3,) f32
    K: torch.Tensor,             # (3, 3) f32
    *,
    ratio: float,
    cross_check: bool,
    reproj_px: float,
) -> torch.Tensor:
    """Covisibility re-observation for the recent-keyframe bank: Hamming
    2-NN of each bank keyframe against the new keyframe, then reprojection
    verification of its map points under the new extrinsic.  Returns
    (B, N, 2) f32 packed [match_idx, ok]."""
    outs = []
    fxy = torch.stack([K[0, 0], K[1, 1]])
    cxy = torch.stack([K[0, 2], K[1, 2]])
    for b in range(bank_desc.shape[0]):
        idx, mask, _ = hamming.match(
            bank_desc[b], new_desc, bank_valid[b], new_valid,
            ratio=ratio, cross_check=cross_check,
        )
        Xc = bank_pts[b] @ R_new.T + t_new
        z = Xc[:, 2]
        z_safe = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
        uv_hat = (Xc[:, :2] / z_safe[:, None]) * fxy + cxy
        err = torch.linalg.norm(uv_hat - new_xy[idx.long()], dim=1)
        ok = (mask & bank_tracked[b] & (z > 1e-6)
              & torch.isfinite(err) & (err < reproj_px))
        outs.append(torch.stack([idx.to(torch.float32), ok.to(torch.float32)], dim=1))
    return torch.stack(outs)


def make_state(kf, points: np.ndarray, capacity: int, device="cuda") -> FrontendState:
    """Build the device mirror from a host Keyframe + the map's point array
    (``capacity`` = num_features)."""
    dev = device_mod.resolve(device)
    kp_to_mp = kf.kp_to_mp
    tracked = kp_to_mp >= 0
    pts = np.zeros((capacity, 3), np.float32)
    if tracked.any():
        pts[tracked] = points[kp_to_mp[tracked]]
    desc = kf.desc if isinstance(kf.desc, torch.Tensor) else torch.as_tensor(kf.desc)
    return FrontendState(
        desc=desc.to(dev),
        xy=torch.as_tensor(np.asarray(kf.xy, np.float32), device=dev),
        kp_valid=torch.as_tensor(np.asarray(kf.kp_valid, bool), device=dev),
        pts3d=torch.as_tensor(pts, device=dev),
        tracked=torch.as_tensor(tracked, device=dev),
        rvec=torch.as_tensor(so3_log_np(kf.R), dtype=torch.float32, device=dev),
        tvec=torch.as_tensor(np.asarray(kf.t), dtype=torch.float32, device=dev),
    )
