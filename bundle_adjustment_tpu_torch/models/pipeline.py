"""The frame-pipeline orchestrator (port of
``bundle_adjustment_tpu.models.pipeline``).

Per frame: grayscale -> (first frame: initialize the map) -> the fused
tracked-frame step on the device (ORB extract, Hamming 2-NN, PnP, Sampson
inliers, keyframe metrics; on the card one replay of its CUDA graph,
``frontend.TrackStep``) -> one host read of its packed scalars -> host
gates and keyframe decision -> keyframe insertion with covisibility
re-observation (and, with ``cull_enabled``, map-point culling) -> windowed
local BA with the newest keyframe's motion-only refine (its LM loop on the
device) -> with ``loop_closure``, a loop-closure attempt
(``models/loop_closure``).  A frame lost twice in a row, with
``reloc_enabled``, tries relocalization (``models/relocalize``).
``finalize`` runs the global and full BA and writes the outputs.
``process_stream`` issues frame N+1's step before frame N's read, so the
device works on one frame while the host finishes the last;
``host_reads`` counts every read of a device tensor made here.

The port runs the branches the default configuration and
``preset_lehman_indoor`` reach, plus the staged (unfused) path.  A window
of at most ``pcg_min_cameras`` cameras: with ``BAConfig.use_pallas_ba``
(the default) and a shape the window LM kernel admits
(``ops/ba_kernel.kernel_eligible``) it is solved in one kernel launch;
any other such window, and every one with the switch off, goes to the grid
solver.  A window above ``pcg_min_cameras`` cameras (global and full BA over
a long chain) takes the matrix-free PCG camera solve: on the card the
global-BA kernels (``ops/ba_global_kernel``), elsewhere the grid PCG solver
(``_solve_pcg``).  The shape is the only gate: a kernel that fails to build
or launch raises.  With ``mesh_shape`` over more than one rank every BA
window is point-sharded over the ranks of torch.distributed
(``_solve_sharded``, ``parallel/dist_ba``) before K3 and K4 are considered,
as in the JAX package; a world with fewer ranks than ``mesh_shape`` asks
for raises.  ``run_partitioned_global_ba`` solves overlapping windows on a
("win", "pt") mesh with sim(3) consensus.  ``features_source="cv2"`` takes
OpenCV's ORB on the host through the staged path (the constructor raises
naming cv2 where it is not installed).  ``debug`` draws the JAX package's
debug artifacts with ``utils/viz`` on the pipeline's device (trajectory
plots, match, keypoint and depth overlays per keyframe, the sparsity spy of
every BA window, the map after each window BA) and, where cv2 is installed,
the three overlay videos; it changes no decision.  ``finalize`` always
writes the final trajectory plots.

Random draws: the JAX pipeline draws RANSAC sample uniforms from
``PRNGKey(0)`` (split once per essential or PnP RANSAC call) and from
``fold_in(PRNGKey(1), frame_idx)`` (the fused step's PnP).  Here they come
from a ``draws`` object with the same two methods; ``Draws`` is the default,
seeded ``torch.Generator``s.  A test can replay the JAX schedule through it.
"""

from __future__ import annotations

import glob
import json
import os
import time
import types
from typing import Optional

import numpy as np
import torch

from bundle_adjustment_tpu_torch import device as device_mod
from bundle_adjustment_tpu_torch.config import PipelineConfig
from bundle_adjustment_tpu_torch.models import frontend, loop_closure, relocalize
from bundle_adjustment_tpu_torch.models.keyframe import decide_from_metrics, decide_keyframe
from bundle_adjustment_tpu_torch.models.map_store import Keyframe, Map
from bundle_adjustment_tpu_torch.native import voxel_downsample_native
from bundle_adjustment_tpu_torch.ops import (ba, ba_global_kernel, ba_grid, ba_kernel, hamming, orb,
                                             ransac,
                                             triangulation)
from bundle_adjustment_tpu_torch.ops.lie import rotation_angle, so3_exp_np, so3_hat, so3_log_np
from bundle_adjustment_tpu_torch.ops.projection import epipolar_errors_px
from bundle_adjustment_tpu_torch.parallel import dist_ba, mesh as mesh_mod
from bundle_adjustment_tpu_torch.utils import viz
from bundle_adjustment_tpu_torch.utils.event_log import EventLog
from bundle_adjustment_tpu_torch.utils.io import _cv2, read_png, write_pcd

#: the debug overlay videos: (folder of per-keyframe PNGs, video file)
DEBUG_VIDEOS = (("debug_keyframes", "keypoint_video.mp4"), ("debug_matches", "match_video.mp4"),
                ("debug_depth", "depth_video.mp4"))


def bgr_to_gray(frame_bgr: np.ndarray) -> np.ndarray:
    """uint8 BGR -> uint8 gray with cv2's integer BT.601 rounding, byte-equal
    to cv2.cvtColor(COLOR_BGR2GRAY): (3735 B + 19235 G + 9798 R + 2^14) >> 15."""
    f = frame_bgr.astype(np.int32)
    y = f[..., 0] * 3735 + f[..., 1] * 19235 + f[..., 2] * 9798 + (1 << 14)
    return (y >> 15).astype(np.uint8)


class Draws:
    """Seeded uniform draws for the RANSAC stages.  ``next(shape)`` serves
    the sequential draws (essential RANSAC, staged PnP); ``for_frame`` the
    fused step's PnP of one frame, derived from the frame index so the draw
    does not depend on what ran before."""

    def __init__(self, seed: int = 0, device="cuda"):
        self.device = device_mod.resolve(device)
        self.seed = seed
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    def next(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self._gen, device=self.device)

    def for_frame(self, frame_idx: int, shape, out=None) -> torch.Tensor:
        """The frame's draw, into ``out`` when given (the tracked-frame
        step's static uniforms)."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed + 1) * 1_000_003 + int(frame_idx))
        return torch.rand(shape, generator=g, device=self.device, out=out)


def _build_lba_refine_fn(use_kernel: bool, n_fixed: int, opts: tuple,
                         has_refine: bool, refine_iters: int, refine_huber: float,
                         prune_thr: float):
    """Window LBA (the window LM kernel with ``use_kernel``, else the grid
    solver) + optional motion-only refine of the newest keyframe + post-BA
    outlier classification, returning one flat f32 vector (one device pull):
      [rv (C*3) | tv (C*3) | window stats (6) | refine rvec+tvec+stats (12) |
       bad-observation mask (O) | points (P*3)]"""
    optd = dict(opts)

    def impl(grid, problem, *maybe_refine):
        if use_kernel:
            rv, tv, pts, stats = ba_kernel.lm_solve(grid, n_fixed=n_fixed, **optd)
        else:
            rv, tv, pts, stats = ba_grid.ba_solve_grid_impl(grid, n_fixed=n_fixed, **optd)
        f32 = torch.float32
        dev = rv.device

        def vec(*xs):
            return torch.stack([torch.as_tensor(x, device=dev).to(f32) for x in xs])

        stats_v = vec(stats.initial_cost, stats.final_cost, stats.initial_sq,
                      stats.final_sq, stats.iterations, stats.accepted)
        if has_refine:
            rp = maybe_refine[0]
            rp = rp._replace(point_mask=torch.zeros_like(rp.point_mask))
            rrv, rtv, _, rstats = ba.ba_solve_impl(
                rp, n_fixed=0, max_iterations=refine_iters, huber_delta=refine_huber,
                masked=True)
            refine_v = torch.cat([
                rrv[0].to(f32), rtv[0].to(f32),
                vec(rstats.initial_sq, rstats.final_sq, rstats.iterations,
                    rstats.accepted), torch.zeros(2, dtype=f32, device=dev)])
        else:
            refine_v = torch.zeros(12, dtype=f32, device=dev)
        if prune_thr > 0:
            r = ba._residuals(rv, tv, pts, problem)
            bad = (problem.obs_mask > 0) & (torch.linalg.norm(r, dim=1) > prune_thr)
        else:
            bad = torch.zeros(problem.uv.shape[0], dtype=torch.bool, device=dev)
        return torch.cat([rv.reshape(-1).to(f32), tv.reshape(-1).to(f32), stats_v,
                          refine_v, bad.to(f32), pts.reshape(-1).to(f32)])

    return impl


class VisualOdometryPipeline:
    def __init__(self, config: PipelineConfig, log: Optional[EventLog] = None,
                 device="cuda", draws=None):
        self.device = device_mod.resolve(device)
        if config.features_source not in ("orb_tpu", "cv2"):
            raise ValueError(f"features_source={config.features_source!r}: 'orb_tpu' or 'cv2'")
        if config.features_source == "cv2":
            self._cv2_orb = _cv2("features_source='cv2' (OpenCV's ORB)").ORB_create(
                nfeatures=config.num_features)
        n_ranks = int(np.prod(config.mesh_shape))
        if n_ranks > mesh_mod.world_size():
            # the JAX package takes the single-device solve when it has too
            # few devices; that would hide that the sharded path never ran
            raise ValueError(f"mesh_shape={tuple(config.mesh_shape)} asks for {n_ranks} ranks; "
                             f"the world has {mesh_mod.world_size()} (torch.distributed "
                             f"{'is' if torch.distributed.is_initialized() else 'is not'} "
                             "initialized)")
        if self.device.type == "cuda":
            device_mod.set_float32_numerics()
        self.cfg = config
        self.map = Map(device=self.device)
        self.log = log or EventLog(echo=False)
        self.map.log = self.log
        self.frame_idx = -1
        self.K = config.camera.K
        self.K_t = torch.as_tensor(self.K, dtype=torch.float32, device=self.device)
        self.draws = draws if draws is not None else Draws(0, self.device)
        self._lost_frames = 0
        self._last_loop_kf = -(10 ** 9)   # the loop-closure cooldown's last closure
        self._last_debug_frame = None     # the last keyframe's frame, with ``debug``
        self.track = frontend.TrackStep(self.device)
        self._front_state = None
        self._front_state_kf = -1
        self._front_dirty = False
        #: the ("win", "pt") mesh of the point-sharded window solves, made
        #: at the first one when ``mesh_shape`` asks for more than one rank
        self._mesh = None
        #: reads of device tensors on the host made by this object
        self.host_reads = 0

    # -- pipeline ----------------------------------------------------------

    def _extract(self, gray: np.ndarray) -> orb.Keypoints:
        if self.cfg.features_source == "cv2":
            return self._extract_cv2(gray)
        return orb.extract(
            torch.as_tensor(gray, device=self.device),
            num_features=self.cfg.num_features,
            levels=self.cfg.pyramid_levels,
            scale=self.cfg.pyramid_scale,
            threshold=float(self.cfg.fast_threshold),
            height=gray.shape[0],
            width=gray.shape[1],
        )

    def _extract_cv2(self, gray: np.ndarray) -> orb.Keypoints:
        """OpenCV's ORB keypoints and descriptors on the host (the JAX
        package's feature injection), padded to the static capacity and
        uploaded: the reference's detector in front of the port's matcher,
        pose and BA."""
        kps, des = self._cv2_orb.detectAndCompute(gray, None)
        N = self.cfg.num_features
        xy = np.zeros((N, 2), np.float32)
        d8 = np.zeros((N, 32), np.uint8)
        valid = np.zeros(N, bool)
        resp = np.zeros(N, np.float32)
        ang = np.zeros(N, np.float32)
        size = np.zeros(N, np.float32)
        lvl = np.zeros(N, np.int32)
        if kps:
            n = min(len(kps), N)
            xy[:n] = [k.pt for k in kps[:n]]
            d8[:n] = des[:n]
            valid[:n] = True
            resp[:n] = [k.response for k in kps[:n]]
            ang[:n] = np.radians([k.angle for k in kps[:n]])
            size[:n] = [k.size for k in kps[:n]]
            lvl[:n] = [k.octave for k in kps[:n]]
        dev = self.device
        return orb.Keypoints(
            xy=torch.as_tensor(xy, device=dev), response=torch.as_tensor(resp, device=dev),
            angle=torch.as_tensor(ang, device=dev), size=torch.as_tensor(size, device=dev),
            level=torch.as_tensor(lvl, device=dev),
            desc=hamming.pack_u8_to_u32(torch.as_tensor(d8, device=dev)),
            valid=torch.as_tensor(valid, device=dev))

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """``t`` on the host as numpy: one host read, counted."""
        self.host_reads += 1
        return t.detach().cpu().numpy()

    def process_frame(self, frame_bgr: np.ndarray, gray=None, res=None) -> dict:
        """Process one BGR frame; returns a dict with the decision chain.
        ``gray``, ``res``: the frame's gray image and the tracked-frame
        step that ``process_stream`` issued for it ahead of time."""
        t_start = time.perf_counter()
        reads = self.host_reads
        result = self._process_frame_inner(frame_bgr, gray, res)
        self.log.emit("frame_timing", None, frame_idx=self.frame_idx,
                      status=result.get("status"), pose=result.get("pose"),
                      total_ms=round((time.perf_counter() - t_start) * 1e3, 2),
                      host_reads=self.host_reads - reads)
        return result

    def _fusable(self) -> bool:
        return (self.cfg.fused_frontend and self.cfg.pnp_first
                and self.cfg.pnp_scale and self.map.num_keyframes > 0
                and self.cfg.features_source == "orb_tpu")

    def _ensure_front_state(self) -> int:
        """Refresh the device mirror of the last keyframe if stale: copied
        into the tracked-frame step's static state."""
        last_id = self.map.sorted_kf_ids()[-1]
        if (self._front_state is None or self._front_state_kf != last_id
                or self._front_dirty):
            self._front_state = self.track.load_state(frontend.make_state(
                self.map.keyframes[last_id], self.map.points(),
                self.cfg.num_features, device=self.device))
            self._front_state_kf = last_id
            self._front_dirty = False
        return last_id

    def _fused_dispatch(self, gray: np.ndarray, frame_idx: int = None):
        """Issue the fused tracked-frame step against the current front
        state (nothing is read back here).  The PnP draw comes from the
        target frame's index, so a speculative dispatch from
        ``process_stream`` and a sequential one for the same frame are
        bit-equal."""
        if frame_idx is None:
            frame_idx = self.frame_idx
        self._ensure_front_state()
        u = self.track.u_buffer(ransac.pnp_draw_shape(self.cfg.pnp_iters))
        self.draws.for_frame(frame_idx, u.shape, out=u)
        return self.track.run(gray, self.K_t, u, **self.track_args(*gray.shape))

    def track_args(self, height: int, width: int) -> dict:
        """``frontend.track_step``'s static arguments for frames of this size."""
        return dict(
            num_features=self.cfg.num_features, levels=self.cfg.pyramid_levels,
            pyramid_scale=self.cfg.pyramid_scale,
            fast_threshold=float(self.cfg.fast_threshold), height=height, width=width,
            ratio=self.cfg.ratio_test, cross_check=self.cfg.cross_check,
            pnp_iters=self.cfg.pnp_iters, pnp_reproj_px=self.cfg.pnp_reproj_err_px,
            sampson_thr_px=self.cfg.ransac_threshold_px,
            consistent=self.cfg.consistent_convention)

    def _essential(self, uv1, uv2, match_mask, quality):
        u = self.draws.next(ransac.essential_draw_shape(self.cfg.ransac_iters))
        return ransac.estimate_essential_pose(
            u,
            torch.as_tensor(uv1, dtype=torch.float32, device=self.device),
            torch.as_tensor(uv2, dtype=torch.float32, device=self.device),
            torch.as_tensor(match_mask, device=self.device),
            self.K_t,
            threshold_px=self.cfg.ransac_threshold_px,
            num_hyp=self.cfg.ransac_iters,
            quality=quality,
        )

    def process_stream(self, frames):
        """Generator over the per-frame results of ``frames``, in frame
        order and with ``process_frame``'s results, with the frames
        overlapped: frame N+1's tracked-frame step is issued before frame
        N's host read, so the device runs N+1 while the host finishes N.
        The speculation is against the current last-keyframe state; when
        frame N moves it (a keyframe or a relocalization, which change the
        keyframe count; BA or a loop closure, which mark the state dirty)
        the speculative step is dropped and frame N+1 issues its own."""
        pending = None  # (frame_bgr, gray, speculative TrackResult or None)
        for frame_bgr in frames:
            if pending is None:
                pending = (frame_bgr, None, None)
                continue
            spec = gray = token = None
            if self._fusable():
                gray = bgr_to_gray(frame_bgr)
                # pending is frame_idx + 1; this frame is frame_idx + 2
                spec = self._fused_dispatch(gray, self.frame_idx + 2)
                token = (self._front_state_kf, self.map.num_keyframes)
            yield self.process_frame(*pending)
            if spec is not None and (
                    self._front_dirty
                    or (self._front_state_kf, self.map.num_keyframes) != token):
                spec = None  # the map or the last keyframe moved: reissue
            pending = (frame_bgr, gray, spec)
        if pending is not None:
            yield self.process_frame(*pending)

    def _process_frame_inner(self, frame_bgr: np.ndarray, gray=None, res=None) -> dict:
        self.frame_idx += 1
        self.log.frame(self.frame_idx)
        if gray is None:
            gray = bgr_to_gray(frame_bgr)

        if self._fusable():
            return self._process_frame_fused(gray, frame_bgr, res=res)

        kp = self._extract(gray)
        if self.map.num_keyframes == 0:
            self._initialize_map(frame_bgr, kp)
            return {"status": "initialized", "kf_id": 0}

        # staged path (fused_frontend / pnp_first / pnp_scale off)
        last_id = self.map.sorted_kf_ids()[-1]
        last_kf = self.map.keyframes[last_id]
        idx, mask, dist = hamming.match(
            last_kf.desc, kp.desc,
            torch.as_tensor(last_kf.kp_valid, device=self.device), kp.valid,
            ratio=self.cfg.ratio_test, cross_check=self.cfg.cross_check)
        match_idx = self._host(idx).astype(np.int64)
        match_mask = self._host(mask)
        n_matches = int(match_mask.sum())
        if n_matches < self.cfg.min_tracked_features:
            self.log.frame_discarded(self.frame_idx, "Not enough matches to track.")
            return self._tracking_lost(frame_bgr, kp, "matches")

        kp_xy = self._host(kp.xy)
        uv1 = last_kf.xy
        uv2 = kp_xy[match_idx]

        world_pose_override = None
        R_rel = t_rel = inl = None
        tracked_n = int((match_mask & (last_kf.kp_to_mp >= 0)).sum())
        if (self.cfg.pnp_scale and self.cfg.pnp_first
                and tracked_n >= self.cfg.pnp_scale_min_tracked):
            pnp = self._pnp_pose(last_kf, kp_xy, match_idx, match_mask)
            if pnp is not None:
                R_pnp, t_pnp = pnp
                R_rel = R_pnp @ last_kf.R.T
                t_rel = t_pnp - R_rel @ last_kf.t
                inl = self._epipolar_inliers(R_rel, t_rel, uv1, uv2, match_mask)
                if self.cfg.consistent_convention:
                    world_pose_override = (R_pnp, t_pnp)

        if R_rel is None:
            pose = self._essential(uv1, uv2, match_mask, quality=dist)
            if not self._host(pose.ok):
                self.log.pose(self.frame_idx, 0, n_matches, 0.0)
                self.log.frame_discarded(self.frame_idx, "Could not estimate pose.")
                return self._tracking_lost(frame_bgr, kp, "pose")
            R_rel = self._host(pose.R).astype(np.float64)
            t_rel = self._host(pose.t).astype(np.float64)
            inl = self._host(pose.inliers)
            if self.cfg.pnp_scale and tracked_n >= self.cfg.pnp_scale_min_tracked:
                pnp = self._pnp_pose(last_kf, kp_xy, match_idx, match_mask)
                if pnp is not None:
                    R_pnp, t_pnp = pnp
                    R_rel_pnp = R_pnp @ last_kf.R.T
                    t_rel_pnp = t_pnp - R_rel_pnp @ last_kf.t
                    if self.cfg.consistent_convention:
                        world_pose_override = (R_pnp, t_pnp)
                        R_rel, t_rel = R_rel_pnp, t_rel_pnp
                    else:
                        s = float(np.clip(np.linalg.norm(t_rel_pnp), 1e-3, 1e3))
                        t_rel = t_rel * s

        num_inliers = int(inl.sum())
        inlier_ratio = num_inliers / max(n_matches, 1)
        self.log.pose(self.frame_idx, num_inliers, n_matches, inlier_ratio)
        if not (inlier_ratio > self.cfg.pose_inlier_ratio
                and num_inliers > self.cfg.pose_inlier_numbers):
            self.log.frame_discarded(
                self.frame_idx, "Low inlier ratio or insufficient inliers.")
            return self._tracking_lost(frame_bgr, kp, "unreliable")
        self._lost_frames = 0

        rot_mag = float(rotation_angle(torch.as_tensor(R_rel, dtype=torch.float32)))
        decision = self._host_decision(last_kf, inl, R_rel, t_rel, uv1[inl],
                                       uv2[inl], rot_mag, num_inliers)
        if not decision.is_keyframe:
            return {"status": "tracked", "inliers": num_inliers,
                    "inlier_ratio": inlier_ratio}

        kf_id = self.map.new_keyframe_id()
        self.log.keyframe_trigger(self.frame_idx, kf_id, decision.reason,
                                  decision.metrics)
        kp_host = types.SimpleNamespace(xy=kp_xy, desc=kp.desc,
                                        valid=self._host(kp.valid))
        self._add_new_keyframe(frame_bgr, kp_host, last_kf, match_idx, inl,
                               R_rel, t_rel, world_pose=world_pose_override)
        ba_result = self.run_local_ba(
            refine_kf_id=kf_id if self.cfg.pose_refine else None)
        return {"status": "keyframe", "kf_id": kf_id, "reason": decision.reason,
                "inliers": num_inliers, "inlier_ratio": inlier_ratio,
                "ba": ba_result, "loop": self._maybe_close_loop(kf_id)}

    def _host_decision(self, last_kf, inl, R_rel, t_rel, uv_last, uv_new,
                       rot_mag, num_inliers):
        """Keyframe cascade with the metrics computed host-side."""
        tracked_mp = last_kf.kp_to_mp[inl & (last_kf.kp_to_mp >= 0)]
        if self.cfg.consistent_convention:
            R_new, t_new = self._compose(last_kf.R, last_kf.t, R_rel, t_rel)
            last_center = -last_kf.R.T @ last_kf.t
            new_center = -R_new.T @ t_new
        else:
            last_center = last_kf.t
            new_center = last_kf.t + last_kf.R @ t_rel
        return decide_keyframe(
            self.cfg.keyframe,
            tracked_points=self.map.points()[tracked_mp],
            last_cam_center=last_center,
            new_cam_center=new_center,
            uv_last=uv_last,
            uv_new=uv_new,
            rotation_rad=rot_mag,
            num_inliers=num_inliers,
            num_last_features=int(last_kf.kp_valid.sum()),
        )

    def _process_frame_fused(self, gray: np.ndarray, frame_bgr: np.ndarray,
                             res=None) -> dict:
        """Tracked frame as one fused device step plus one scalar readback;
        big arrays cross to the host only on keyframe insertion or the
        essential-RANSAC fallback.  ``res``: the step ``process_stream``
        already issued for this frame."""
        last_id = self._ensure_front_state()
        last_kf = self.map.keyframes[last_id]
        if res is None:
            res = self._fused_dispatch(gray)

        sc = frontend.unpack_scalars(self._host(res.packed))
        n_matches = sc.n_matches
        num_inliers = sc.num_inliers
        kp = types.SimpleNamespace(xy=res.kp_xy, desc=res.kp_desc, valid=res.kp_valid)

        if n_matches < self.cfg.min_tracked_features:
            self.log.frame_discarded(self.frame_idx, "Not enough matches to track.")
            return self._tracking_lost(frame_bgr, kp, "matches")

        world_pose_override = None
        pnp_good = (sc.pnp_ok
                    and sc.tracked_n >= self.cfg.pnp_scale_min_tracked
                    and sc.pnp_inliers >= self.cfg.pnp_scale_min_tracked)
        if pnp_good:
            R_rel, t_rel = sc.R_rel, sc.t_rel
            inl = None
            if self.cfg.consistent_convention:
                world_pose_override = (sc.R_pnp, sc.t_pnp)
            metrics_from_device = True
        else:
            # essential-RANSAC fallback (initialization chains, thin maps)
            match_idx = self._host(res.match_idx).astype(np.int64)
            kp_xy = self._host(res.kp_xy)
            pose = self._essential(last_kf.xy, kp_xy[match_idx], res.match_mask,
                                   quality=res.match_dist)
            if not self._host(pose.ok):
                self.log.pose(self.frame_idx, 0, n_matches, 0.0)
                self.log.frame_discarded(self.frame_idx, "Could not estimate pose.")
                return self._tracking_lost(frame_bgr, kp, "pose")
            R_rel = self._host(pose.R).astype(np.float64)
            t_rel = self._host(pose.t).astype(np.float64)
            inl = self._host(pose.inliers)
            num_inliers = int(inl.sum())
            metrics_from_device = False

        inlier_ratio = num_inliers / max(n_matches, 1)
        self.log.pose(self.frame_idx, num_inliers, n_matches, inlier_ratio)
        if not (inlier_ratio > self.cfg.pose_inlier_ratio
                and num_inliers > self.cfg.pose_inlier_numbers):
            self.log.frame_discarded(
                self.frame_idx, "Low inlier ratio or insufficient inliers.")
            return self._tracking_lost(frame_bgr, kp, "unreliable")
        self._lost_frames = 0

        if metrics_from_device:
            decision = decide_from_metrics(
                self.cfg.keyframe,
                n_tracked=sc.n_parallax,
                median_parallax_deg=sc.med_parallax_deg,
                median_displacement_px=sc.med_disp_px,
                rotation_rad=sc.rot_mag,
                num_inliers=num_inliers,
                num_last_features=int(last_kf.kp_valid.sum()),
            )
        else:
            decision = self._host_decision(
                last_kf, inl, R_rel, t_rel, last_kf.xy[inl],
                kp_xy[match_idx[inl]], sc.rot_mag, num_inliers)

        # which model gave the pose: the fused step's PnP (the one host read
        # of the packed scalars), or the eager essential-RANSAC fallback
        pose_from = "pnp" if metrics_from_device else "essential"
        if not decision.is_keyframe:
            return {"status": "tracked", "inliers": num_inliers,
                    "inlier_ratio": inlier_ratio, "pose": pose_from}

        kf_id = self.map.new_keyframe_id()
        self.log.keyframe_trigger(self.frame_idx, kf_id, decision.reason,
                                  decision.metrics)
        ins = frontend.unpack_insert(self._host(res.insert_packed))
        if inl is None:
            inl = ins.inliers
        kp_host = types.SimpleNamespace(xy=ins.kp_xy, desc=res.kp_desc,
                                        valid=ins.kp_valid)
        # the speculative triangulation used the PnP relative model; on the
        # essential-RANSAC fallback the model differs, so re-triangulate
        tri = (ins.tri_X, ins.tri_valid) if metrics_from_device else None
        self._add_new_keyframe(frame_bgr, kp_host, last_kf, ins.match_idx, inl,
                               R_rel, t_rel, world_pose=world_pose_override, tri=tri)
        ba_result = self.run_local_ba(
            refine_kf_id=kf_id if self.cfg.pose_refine else None)
        return {"status": "keyframe", "kf_id": kf_id, "reason": decision.reason,
                "inliers": num_inliers, "inlier_ratio": inlier_ratio,
                "ba": ba_result, "loop": self._maybe_close_loop(kf_id), "pose": pose_from}

    def _maybe_close_loop(self, kf_id: int):
        """A loop-closure attempt for a keyframe just inserted (after its
        windowed BA), at most one closure per ``loop_cooldown`` keyframes."""
        if not self.cfg.loop_closure or kf_id - self._last_loop_kf < self.cfg.loop_cooldown:
            return None
        info = loop_closure.try_close_loop(self, self.map.keyframes[kf_id])
        if info is not None:
            self._last_loop_kf = kf_id
        return info

    def _epipolar_inliers(self, R_rel, t_rel, uv1, uv2, match_mask):
        """Sampson inlier classification against a known relative model."""
        f32 = torch.float32
        t = t_rel / max(np.linalg.norm(t_rel), 1e-12)
        E = (so3_hat(torch.as_tensor(t, dtype=f32))
             @ torch.as_tensor(R_rel, dtype=f32)).to(self.device)
        errs = self._host(epipolar_errors_px(
            E, self.K_t, torch.as_tensor(uv1, dtype=f32, device=self.device),
            torch.as_tensor(uv2, dtype=f32, device=self.device)))
        return (errs < self.cfg.ransac_threshold_px ** 2) & match_mask

    def _pnp_pose(self, last_kf: Keyframe, kp_xy, match_idx, match_mask):
        """World extrinsic (R, t) of the current frame from PnP against the
        tracked map points, or None when tracking is thin or PnP fails."""
        tracked = match_mask & (last_kf.kp_to_mp >= 0)
        slots = np.flatnonzero(tracked)
        if len(slots) < self.cfg.pnp_scale_min_tracked:
            return None
        X = self.map.points()[last_kf.kp_to_mp[slots]]
        uv = kp_xy[match_idx[slots]]
        cap = max(64, 1 << int(np.ceil(np.log2(len(slots)))))
        Xp = np.zeros((cap, 3), np.float32)
        uvp = np.zeros((cap, 2), np.float32)
        Xp[: len(slots)] = X
        uvp[: len(slots)] = uv
        valid = np.arange(cap) < len(slots)
        u = self.draws.next(ransac.pnp_draw_shape(self.cfg.pnp_iters))
        res = ransac.estimate_pnp_pose(
            u, torch.as_tensor(Xp, device=self.device),
            torch.as_tensor(uvp, device=self.device),
            torch.as_tensor(valid, device=self.device), self.K_t,
            reproj_threshold_px=self.cfg.pnp_reproj_err_px,
            num_hyp=self.cfg.pnp_iters,
        )
        ok = self._host(torch.stack([res.ok.to(torch.int32), res.num_inliers]))
        if not ok[0] or int(ok[1]) < self.cfg.pnp_scale_min_tracked:
            return None
        R_pnp = self._host(res.R).astype(np.float64)
        t_pnp = self._host(res.t).astype(np.float64)
        if not (np.isfinite(R_pnp).all() and np.isfinite(t_pnp).all()):
            return None
        return R_pnp, t_pnp

    def _tracking_lost(self, frame_bgr, kp, why: str) -> dict:
        """A discarded frame; from the second in a row, with
        ``reloc_enabled``, a relocalization attempt on its keypoints ``kp``
        (device tensors; on the fused path the copies of the step's
        outputs)."""
        self._lost_frames += 1
        if self.cfg.reloc_enabled and self._lost_frames >= 2:
            result = relocalize.try_relocalize(self, frame_bgr, kp)
            if result is not None:
                self._lost_frames = 0
                return result
        return {"status": "discarded", "why": why}

    def _initialize_map(self, frame_bgr, kp: orb.Keypoints):
        self.log.emit("init", "Initializing with first keyframe...", frame_idx=self.frame_idx)
        kf = Keyframe(
            kf_id=self.map.new_keyframe_id(), R=np.eye(3), t=np.zeros(3),
            xy=self._host(kp.xy).astype(np.float64), desc=kp.desc,
            kp_valid=self._host(kp.valid), frame_idx=self.frame_idx,
        )
        self.map.add_keyframe(kf)
        self.log.keyframe_trigger(self.frame_idx, kf.kf_id, "Initialization", {})

    def _compose(self, last_R, last_t, R_rel, t_rel):
        """Pose composition under the configured convention."""
        if self.cfg.consistent_convention:
            return R_rel @ last_R, R_rel @ last_t + t_rel
        return last_R @ R_rel, last_t + last_R @ t_rel

    def _cam_to_world(self, last_kf: Keyframe, X_rel: np.ndarray) -> np.ndarray:
        if self.cfg.consistent_convention:
            return (X_rel - last_kf.t) @ last_kf.R
        return (last_kf.R @ X_rel.T).T + last_kf.t

    def _add_new_keyframe(self, frame_bgr, kp, last_kf: Keyframe, match_idx,
                          inl, R_rel, t_rel, world_pose=None, tri=None):
        """Keyframe insertion: re-observations of existing points, DLT
        triangulation of the rest (``tri`` = the fused step's speculative
        per-slot triangulation), covisibility re-observation."""
        if world_pose is not None:
            world_R, world_t = world_pose
        else:
            world_R, world_t = self._compose(last_kf.R, last_kf.t, R_rel, t_rel)

        kp_xy = np.asarray(kp.xy, np.float64)
        new_kf = Keyframe(
            kf_id=self.map.new_keyframe_id(), R=world_R, t=world_t, xy=kp_xy,
            desc=kp.desc, kp_valid=np.asarray(kp.valid), frame_idx=self.frame_idx,
        )
        self.map.add_keyframe(new_kf)

        slots = np.flatnonzero(inl)
        # one map point per new keypoint: keep the first slot per train index
        _, first = np.unique(match_idx[slots], return_index=True)
        slots = slots[np.sort(first)]
        mp_of_slot = last_kf.kp_to_mp[slots]
        reobs = mp_of_slot >= 0

        r_slots = slots[reobs]
        self.map.add_observations(new_kf.kf_id, mp_of_slot[reobs],
                                  match_idx[r_slots], kp_xy[match_idx[r_slots]])

        n_slots = slots[~reobs]
        if len(n_slots):
            if tri is not None:
                X_rel = tri[0][n_slots]
                valid = tri[1][n_slots]
            else:
                f32 = torch.float32
                X_rel, valid = triangulation.triangulate_pair(
                    self.K_t,
                    torch.as_tensor(R_rel, dtype=f32, device=self.device),
                    torch.as_tensor(t_rel, dtype=f32, device=self.device),
                    torch.as_tensor(last_kf.xy[n_slots], dtype=f32, device=self.device),
                    torch.as_tensor(kp_xy[match_idx[n_slots]], dtype=f32,
                                    device=self.device))
                X_rel = self._host(X_rel).astype(np.float64)
                valid = self._host(valid)
            self.log.triangulated(self.frame_idx, int(valid.sum()), len(n_slots))
            if valid.any():
                keep = n_slots[valid]
                X_w = self._cam_to_world(last_kf, X_rel[valid])
                uv2k = kp_xy[match_idx[keep]]
                cc = np.clip(np.round(uv2k).astype(int), 0,
                             [frame_bgr.shape[1] - 1, frame_bgr.shape[0] - 1])
                bgr = frame_bgr[cc[:, 1], cc[:, 0]].astype(np.float64)
                mp_ids = self.map.add_map_points(X_w, bgr[:, ::-1] / 255.0)
                self.map.add_observations(last_kf.kf_id, mp_ids, keep, last_kf.xy[keep])
                self.map.add_observations(new_kf.kf_id, mp_ids, match_idx[keep],
                                          kp_xy[match_idx[keep]])

        if self.cfg.covis_keyframes > 0:
            self._covisibility_reobserve(new_kf, exclude_id=last_kf.kf_id)

        if self.cfg.cull_enabled:
            self._cull_points()

        if self.cfg.debug:
            self._debug_keyframe(frame_bgr, last_kf, new_kf, kp_xy, np.asarray(kp.valid),
                                 match_idx, slots)
        self._last_debug_frame = frame_bgr.copy() if self.cfg.debug else None

        if self.cfg.export_pcd_series:
            pts_w, colors = self.map.get_pcd()
            if len(pts_w):
                write_pcd(os.path.join(self.cfg.output_dir, "pcd_series",
                                       f"frame_{new_kf.kf_id:05d}.pcd"), pts_w, colors)

    def _debug_keyframe(self, frame_bgr, last_kf: Keyframe, new_kf: Keyframe, kp_xy,
                        kp_valid, match_idx, slots):
        """The JAX package's per-keyframe debug artifacts, drawn on the
        pipeline's device: the 2-D and 3-D trajectory plots, the matches
        against the last keyframe's frame, the keypoints, and the tracked
        keypoints coloured by depth.  Each drawing reads its image back
        once (counted in ``host_reads``)."""
        out, dev, kf = self.cfg.output_dir, self.device, new_kf.kf_id
        traj = self.map.trajectory(self.cfg.consistent_convention)
        viz.plot_and_save_trajectory_2d(traj, os.path.join(out, "trajectory_2d"),
                                        f"kf{kf:04d}", device=dev)
        rots = [self.map.keyframes[k].R for k in self.map.sorted_kf_ids()]
        viz.plot_and_save_trajectory_3d(traj, rots, os.path.join(out, "trajectory_3d"),
                                        f"kf{kf:04d}", device=dev)
        viz.draw_matches(
            self._last_debug_frame if self._last_debug_frame is not None else frame_bgr,
            last_kf.xy[slots], frame_bgr, kp_xy[match_idx[slots]],
            os.path.join(out, "debug_matches", f"matches_{kf:04d}.png"), device=dev)
        viz.draw_keypoints(frame_bgr, kp_xy[kp_valid],
                           os.path.join(out, "debug_keyframes", f"keyframe_{kf:04d}.png"),
                           device=dev)
        drawn = 4
        tracked_now = np.flatnonzero(new_kf.kp_to_mp >= 0)
        if len(tracked_now):
            X = self.map.points()[new_kf.kp_to_mp[tracked_now]]
            depths = X @ new_kf.R[2] + new_kf.t[2]
            viz.draw_depth_overlay(frame_bgr, new_kf.xy[tracked_now], depths,
                                   os.path.join(out, "debug_depth", f"depth_{kf:04d}.png"),
                                   device=dev)
            drawn += 1
        self.host_reads += drawn

    def _covisibility_reobserve(self, new_kf: Keyframe, exclude_id: int):
        """Reprojection-verified re-observations of map points seen by recent
        keyframes beyond the last one: the whole bank in one device step,
        the one-point-per-keypoint bookkeeping on the host."""
        recent = [k for k in self.map.sorted_kf_ids()
                  if k not in (new_kf.kf_id, exclude_id)][-self.cfg.covis_keyframes:]
        if not recent:
            return
        pts_all = self.map.points()
        N = new_kf.xy.shape[0]
        B = len(recent)
        bank_valid = np.zeros((B, N), bool)
        bank_pts = np.zeros((B, N, 3), np.float32)
        bank_tracked = np.zeros((B, N), bool)
        for b, k in enumerate(recent):
            kf = self.map.keyframes[k]
            bank_valid[b] = kf.kp_valid
            tr = kf.kp_to_mp >= 0
            bank_tracked[b] = tr
            if tr.any():
                bank_pts[b, tr] = pts_all[kf.kp_to_mp[tr]]

        dev = self.device
        f32 = torch.float32
        out = self._host(frontend.covis_step(
            torch.stack([self.map.keyframes[k].desc for k in recent]),
            torch.as_tensor(bank_valid, device=dev),
            torch.as_tensor(bank_pts, device=dev),
            torch.as_tensor(bank_tracked, device=dev),
            new_kf.desc, torch.as_tensor(new_kf.kp_valid, device=dev),
            torch.as_tensor(new_kf.xy, dtype=f32, device=dev),
            torch.as_tensor(new_kf.R, dtype=f32, device=dev),
            torch.as_tensor(new_kf.t, dtype=f32, device=dev),
            self.K_t, ratio=self.cfg.ratio_test, cross_check=self.cfg.cross_check,
            reproj_px=float(self.cfg.covis_reproj_px),
        ))

        for b, kf_id in enumerate(recent):
            kf = self.map.keyframes[kf_id]
            idx = out[b, :, 0].astype(np.int64)
            slots = np.flatnonzero(out[b, :, 1] > 0.5)
            if not len(slots):
                continue
            new_slots = idx[slots]
            _, first = np.unique(new_slots, return_index=True)
            keep = np.sort(first)
            slots, new_slots = slots[keep], new_slots[keep]
            free = new_kf.kp_to_mp[new_slots] < 0
            slots, new_slots = slots[free], new_slots[free]
            if not len(slots):
                continue
            mp = kf.kp_to_mp[slots]
            live = mp >= 0
            slots, new_slots, mp = slots[live], new_slots[live], mp[live]
            if len(slots):
                self.map.add_observations(new_kf.kf_id, mp, new_slots,
                                          new_kf.xy[new_slots])
                self.log.emit(
                    "covis",
                    f"    -> Covisibility: +{len(slots)} re-observations vs KF {kf_id}",
                    kf_id=new_kf.kf_id, anchor_kf=kf_id, added=len(slots),
                )

    def _refine_pose_only(self, kf_id: int):
        """Motion-only BA of one keyframe over its observations, map fixed
        (every point masked out of the parameter set)."""
        gathered = self.map.gather_window([kf_id], self.K, self.cfg.ba.max_points,
                                          self.cfg.ba.max_obs)
        if gathered is None:
            return
        problem, mp_ids, obs_rows = gathered
        if len(obs_rows) < 10:
            return
        problem = problem._replace(point_mask=torch.zeros_like(problem.point_mask))
        rv, tv, _, stats = ba.ba_solve(problem, n_fixed=0, max_iterations=10,
                                       huber_delta=self.cfg.ba.huber_delta, masked=True)
        # the pose and whether to take it in one read
        take = stats.accepted & (stats.final_sq < stats.initial_sq)
        v = self._host(torch.cat([rv[0], tv[0], take[None].to(rv.dtype)])).astype(np.float64)
        if v[6] > 0.5:
            kf = self.map.keyframes[kf_id]
            kf.R = so3_exp_np(v[0:3])
            kf.t = v[3:6].copy()

    def _cull_points(self):
        """Drop weakly observed points (fewer than ``cull_min_observations``
        live observations) once no keyframe of the active window observes
        them.  A cull rewrites keyframes' ``kp_to_mp``, which the tracked-frame
        step's state mirrors for the last keyframe: the state is marked
        dirty."""
        w_ids = self.map.sorted_kf_ids()[-(self.cfg.ba.window_size + 1):]
        counts = self.map.observation_count_per_point()
        alive = self.map.point_alive()
        n = self.map._n_obs
        obs_alive = self.map._obs_alive[:n]
        obs_kf = self.map._obs_kf[:n]
        obs_mp = self.map._obs_mp[:n]
        in_window = np.zeros(len(counts), bool)
        for k in w_ids:
            in_window[obs_mp[obs_alive & (obs_kf == k)]] = True
        weak = alive & ~in_window & (counts < self.cfg.cull_min_observations)
        if weak.any():
            self.map.cull_points(np.flatnonzero(weak))
            self._front_dirty = True
            self.log.emit("cull", f"    -> Culled {int(weak.sum())} weak map points.",
                          culled=int(weak.sum()))

    # -- bundle adjustment glue -------------------------------------------

    def run_local_ba(self, window_size: Optional[int] = None,
                     global_ba: bool = False,
                     refine_kf_id: Optional[int] = None) -> Optional[dict]:
        """Windowed LBA (the oldest keyframes gauge-fixed, the newest
        excluded); global BA is LBA over every keyframe but the newest."""
        w = window_size or self.cfg.ba.window_size
        all_ids = self.map.sorted_kf_ids()
        if len(all_ids) < w:
            self.log.lba_skipped("Not enough keyframes.")
            if refine_kf_id is not None:
                self._refine_pose_only(refine_kf_id)
            return None
        window = all_ids[-(w + 1):-1]
        if len(window) < 2:
            self.log.lba_skipped("No adjustable keyframes.")
            if refine_kf_id is not None:
                self._refine_pose_only(refine_kf_id)
            return None
        return self._solve_window(window, all_ids, global_ba=global_ba,
                                  refine_kf_id=refine_kf_id)

    def partition_problems(self, window_kf_ids, n_pt: int):
        """The window problems of ``run_partitioned_global_ba``: each window
        repeat-padded and gathered at the full capacities, in the shard
        layout for ``n_pt`` point shards when that is more than one, all of
        one shape (every shard padded to the fullest shard of any window,
        where the JAX package gives up on the partition and runs the full
        BA).  Returns (problems, mp_ids per window), or None when a window
        has nothing to solve."""
        problems, mp_lists = [], []
        for ids in window_kf_ids:
            uniq = list(dict.fromkeys(int(k) for k in ids))
            gathered = self.map.gather_window(
                uniq + [uniq[-1]] * (len(ids) - len(uniq)), self.K, self.cfg.ba.max_points,
                self.cfg.ba.max_obs, pad_to_max=True)
            if gathered is None:
                return None
            problems.append(gathered[0])
            mp_lists.append(gathered[1])
        if n_pt > 1:
            cap = -(-self.cfg.ba.max_obs // n_pt)
            for _ in range(2):   # the second pass pads every window to the fullest shard
                sharded = [dist_ba.shard_problem(p, n_pt, min_obs_capacity=cap)
                           for p in problems]
                cap = max(p.uv.shape[0] // n_pt for p in sharded)
            problems = sharded
        return problems, mp_lists

    def run_partitioned_global_ba(self, n_windows: int, mesh=None, overlap: int = 2,
                                  consensus_rounds: int = 1) -> Optional[dict]:
        """Global BA as ``n_windows`` overlapping keyframe windows solved at
        once over a ("win", "pt") mesh of ranks, then reconciled by the sim(3)
        pose-graph consensus (``parallel/dist_ba.solve_windows_consensus``);
        every rank of the world calls it and ends with the same map.  The
        default mesh puts ``world // n_windows`` ranks on "pt".  Each window's
        points are mapped by its sim(3) into the global frame and written
        back, the first window that holds a point winning.
        ``consensus_rounds`` > 1 solves again from the reconciled poses."""
        all_ids = self.map.sorted_kf_ids()
        if len(all_ids) < n_windows * 2:
            self.log.lba_skipped("Not enough keyframes for partitioned BA.")
            return None
        if mesh is None:
            mesh = mesh_mod.make_mesh(n_windows, max(mesh_mod.world_size() // n_windows, 1),
                                      self.device.type)
        shape = mesh_mod.shape(mesh)
        parts = dist_ba.partition_windows(len(all_ids), n_windows, overlap)
        window_kf_ids = [np.asarray(all_ids)[w] for w in parts]

        t0 = time.perf_counter()
        result = None
        for rnd in range(max(1, consensus_rounds)):
            gathered = self.partition_problems(window_kf_ids, shape["pt"])
            if gathered is None:
                self.log.lba_skipped("Empty window in partitioned BA.")
                return None
            problems, mp_lists = gathered
            poses, sim3s, (rvs, tvs, ptss, stats) = dist_ba.solve_windows_consensus(
                problems, window_kf_ids, mesh,
                n_fixed=max(1, min(self.cfg.ba.n_fixed, len(window_kf_ids[0]) - 1)),
                max_iterations=self.cfg.ba.max_iterations,
                huber_delta=self.cfg.ba.huber_delta)

            for kf_id, (rv, tv) in poses.items():
                kf = self.map.keyframes[int(kf_id)]
                kf.R = so3_exp_np(np.asarray(rv, np.float64))
                kf.t = np.asarray(tv, np.float64)
            written = set()
            for w, mp_ids in enumerate(mp_lists):
                s, Rg, tg = sim3s[w]
                pts_w = ptss[w].reshape(-1, 3)[: len(mp_ids)]
                pts_w = (s * pts_w) @ np.asarray(Rg).T + np.asarray(tg)
                fresh = [i for i, mp in enumerate(mp_ids) if mp not in written]
                if fresh:
                    self.map._pts[mp_ids[fresh]] = pts_w[fresh]
                    written.update(int(mp_ids[i]) for i in fresh)

            self._front_dirty = True
            init = float(np.sum(stats.initial_sq))
            final = float(np.sum(stats.final_sq))
            result = {"diverged": False, "initial": init, "final": final,
                      "windows": n_windows, "mesh": shape, "rounds": rnd + 1}

        elapsed = time.perf_counter() - t0
        result["elapsed_s"] = elapsed
        self.log.lba(all_ids[-1], result["initial"], result["final"],
                     int(np.max(stats.iterations)), result["final"] >= result["initial"],
                     elapsed, global_ba=True)
        return result

    def run_full_ba(self, max_iterations: Optional[int] = None) -> Optional[dict]:
        """Full BA over all keyframes, the newest included."""
        all_ids = self.map.sorted_kf_ids()
        if len(all_ids) < 3:
            return None
        return self._solve_window(all_ids, all_ids, global_ba=True,
                                  max_iterations=max_iterations)

    def _grid(self, problem):
        """The grid layout of ``problem``, its capacity drops logged."""
        return ba_grid.from_flat(problem, on_drop=lambda n: self.log.emit(
            "capacity_drop",
            f"    -> Grid layout dropped {n} observations (max_slots cap)",
            dropped_obs=int(n)))

    def _solve_window(self, window, all_ids, global_ba: bool = False,
                      refine_kf_id: Optional[int] = None,
                      max_iterations: Optional[int] = None) -> Optional[dict]:
        n_fixed = max(1, min(self.cfg.ba.n_fixed, len(window) - 1))
        max_points, max_obs = self.cfg.ba.max_points, self.cfg.ba.max_obs
        if global_ba:
            max_points = max(max_points, self.map.num_points)
            max_obs = max(max_obs, self.map.num_observations)
        gathered = self.map.gather_window(window, self.K, max_points, max_obs)
        if gathered is None:
            self.log.lba_skipped("No points in the local window.")
            return None
        problem, mp_ids, obs_rows = gathered
        if self.cfg.debug:
            viz.plot_and_save_sparsity(
                problem.cam_idx, problem.pnt_idx, len(window), len(mp_ids),
                os.path.join(self.cfg.output_dir, "debug_sparsity"),
                f"kf{window[0]:04d}_{window[-1]:04d}", device=self.device)
            self.host_reads += 1

        last_opt = self.map.keyframes[window[-1]]
        E_before = (last_opt.R.copy(), last_opt.t.copy())
        solver_kwargs = dict(
            max_iterations=(max_iterations if max_iterations is not None
                            else self.cfg.ba.max_iterations),
            huber_delta=self.cfg.ba.huber_delta,
            lambda_init=self.cfg.ba.lambda_init,
            lambda_up=self.cfg.ba.lambda_up,
            lambda_down=self.cfg.ba.lambda_down,
            lambda_min=self.cfg.ba.lambda_min,
            lambda_max=self.cfg.ba.lambda_max,
            ftol=self.cfg.ba.ftol,
            xtol=self.cfg.ba.xtol,
        )
        t0 = time.perf_counter()
        n_pt = int(np.prod(self.cfg.mesh_shape))
        if n_pt > 1:
            rv, tv, pts, stats, bad_mask = self._solve_sharded(
                problem, n_fixed, n_pt, len(window), solver_kwargs)
            if refine_kf_id is not None:
                self._refine_pose_only(refine_kf_id)
        elif len(window) > self.cfg.ba.pcg_min_cameras:
            rv, tv, pts, stats, bad_mask = self._solve_pcg(
                self._grid(problem), problem, n_fixed, len(window), solver_kwargs)
            if refine_kf_id is not None:
                self._refine_pose_only(refine_kf_id)
        else:
            grid = self._grid(problem)
            refine_problem = None
            if refine_kf_id is not None:
                g2 = self.map.gather_window([refine_kf_id], self.K,
                                            self.cfg.ba.max_points, self.cfg.ba.max_obs)
                if g2 is not None and len(g2[2]) >= 10:
                    refine_problem = g2[0]
            opts = tuple(sorted(
                (k, int(v) if k == "max_iterations" else float(v))
                for k, v in solver_kwargs.items()))
            use_kernel = (self.cfg.ba.use_pallas_ba
                          and ba_kernel.kernel_eligible(grid, n_fixed))
            fn = _build_lba_refine_fn(use_kernel, n_fixed, opts, refine_problem is not None,
                                      10, float(self.cfg.ba.huber_delta),
                                      float(self.cfg.prune_obs_reproj_px))
            call_args = (grid, problem) + (
                (refine_problem,) if refine_problem is not None else ())
            flat = self._host(fn(*call_args)).astype(np.float64)
            C_w = len(window)
            O_w = problem.uv.shape[0]
            rv = flat[: 3 * C_w].reshape(C_w, 3)
            tv = flat[3 * C_w: 6 * C_w].reshape(C_w, 3)
            sv = flat[6 * C_w: 6 * C_w + 6]
            refv = flat[6 * C_w + 6: 6 * C_w + 18]
            bad_mask = flat[6 * C_w + 18: 6 * C_w + 18 + O_w] > 0.5
            pts = flat[6 * C_w + 18 + O_w:].reshape(-1, 3)
            stats = ba.BAStats(initial_cost=sv[0], final_cost=sv[1], initial_sq=sv[2],
                               final_sq=sv[3], iterations=int(sv[4]), accepted=sv[5] > 0.5)
            if refine_problem is not None and bool(refv[9] > 0.5) and refv[7] < refv[6]:
                kf_r = self.map.keyframes[refine_kf_id]
                kf_r.R = so3_exp_np(refv[0:3])
                kf_r.t = refv[3:6].copy()
        elapsed = time.perf_counter() - t0

        # divergence rejection on the raw squared cost
        diverged = float(stats.final_sq) >= float(stats.initial_sq)
        self.log.lba(window[-1], float(stats.initial_sq), float(stats.final_sq),
                     int(stats.iterations), diverged, elapsed, global_ba=global_ba)
        if diverged:
            return {"diverged": True, "initial": float(stats.initial_sq),
                    "final": float(stats.final_sq), "elapsed_s": elapsed}

        self.map.apply_ba_result(window, mp_ids, rv, tv, pts, n_fixed=n_fixed)
        self._front_dirty = True

        if self.cfg.prune_obs_reproj_px > 0:
            n_bad = int(bad_mask[: len(obs_rows)].sum())
            if n_bad:
                self.map.kill_observations(obs_rows[bad_mask[: len(obs_rows)]])
                self.log.emit("prune",
                              f"    -> Pruned {n_bad} outlier observations after BA.",
                              pruned=n_bad)

        if self.cfg.propagate_ba_correction:
            R_b, t_b = E_before
            R_a, t_a = last_opt.R, last_opt.t
            for j in all_ids:
                if j <= window[-1]:
                    continue
                kf = self.map.keyframes[j]
                R_rel = kf.R @ R_b.T
                t_rel = kf.t - R_rel @ t_b
                kf.R = R_rel @ R_a
                kf.t = R_rel @ t_a + t_rel

        if self.cfg.debug:
            pts_w, colors = self.map.get_pcd()
            write_pcd(os.path.join(self.cfg.output_dir, "lba_steps",
                                   f"map_after_lba_kf_{window[0]:04d}.pcd"), pts_w, colors)
        return {
            "diverged": False,
            "initial": float(stats.initial_sq),
            "final": float(stats.final_sq),
            "iterations": int(stats.iterations),
            "elapsed_s": elapsed,
            "n_cams": len(window),
            "n_points": len(mp_ids),
            "n_obs": len(obs_rows),
        }

    def _solve_pcg(self, grid, problem, n_fixed: int, n_cams: int, solver_kwargs: dict):
        """A window above ``pcg_min_cameras`` cameras (global BA over a long
        chain): the matrix-free PCG camera solve, with neither the
        (P, C', 6, 3) coupling tensor nor the dense (6C')^2 system.  On the
        card, with the plain block-Jacobi preconditioner and a shape inside
        their gate, the global-BA kernels (``ops/ba_global_kernel``, float32
        throughout); otherwise the grid PCG solver, whose memory cost is its
        (C', P*D) float32 one-hot, and above 2 GiB of that the flat
        segment-sum solver, all float32 (the JAX package's bfloat16
        reduction saves TPU bandwidth and is not switched on here).  A window
        that the kernels do not take on the card leaves a
        ``pcg_plain_solver`` event saying why.  Returns (rvecs, tvecs,
        points, stats and the post-BA outlier mask over the observations) on
        the host."""
        cfg = self.cfg.ba
        kw = dict(solver_kwargs, n_fixed=n_fixed, cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
        P_g, D_g = grid.cam_slot.shape
        onehot_bytes = 4 * P_g * D_g * max(n_cams - n_fixed, 1)
        skipped = None      # on the card: why the kernels do not take this window
        if self.device.type == "cuda":
            if cfg.cg_precond_group != 1:
                skipped = f"cg_precond_group={cfg.cg_precond_group}"
            elif not ba_global_kernel.kernel_eligible_global(grid, n_fixed):
                skipped = f"shape C={n_cams} P={P_g} D={D_g} outside the kernels' gate"
        if self.device.type == "cuda" and skipped is None:
            rv, tv, pts, stats = ba_global_kernel.solve(grid, cg_forcing=True, **kw)
        else:
            flat = onehot_bytes > 2 << 30
            if skipped is not None:
                solver = "flat PCG solver" if flat else "grid PCG solver"
                self.log.emit(
                    "pcg_plain_solver",
                    f"    -> Global-BA kernels not used ({skipped}): {solver} in plain PyTorch",
                    why=skipped, solver=solver, n_cams=n_cams)
            if flat:
                rv, tv, pts, stats = ba.ba_solve_impl(problem, **kw)
            else:
                rv, tv, pts, stats = ba_grid.ba_solve_grid_impl(
                    grid, cg_forcing=True, cg_precond_group=cfg.cg_precond_group, **kw)
        return self._host_result(problem, rv, tv, pts, stats)

    def _solve_sharded(self, problem, n_fixed: int, n_pt: int, n_cams: int,
                       solver_kwargs: dict):
        """``mesh_shape`` over more than one rank: the point-sharded Schur
        solve (``parallel/dist_ba``), taken before K3 and K4 as the JAX
        package orders it.  Every rank of the (1, n_pt) mesh solves its
        shard of the points with the cameras replicated, the camera system
        summed over the ranks; eagerly, since a CUDA graph cannot capture a
        gloo collective.  Above ``pcg_min_cameras`` cameras the camera
        system is solved by the flat matrix-free PCG, one ``all_reduce`` per
        CG iteration.  Returns what ``_solve_pcg`` returns."""
        if self._mesh is None:
            self._mesh = mesh_mod.make_mesh(1, n_pt, self.device.type)
        kw = dict(solver_kwargs, n_fixed=n_fixed)
        if n_cams > self.cfg.ba.pcg_min_cameras:
            kw.update(cg_iters=self.cfg.ba.cg_iters, cg_tol=self.cfg.ba.cg_tol)
        rv, tv, pts, stats = dist_ba.ba_solve_sharded(
            dist_ba.shard_problem(problem, n_pt), self._mesh, "pt", **kw)
        # the shard layout keeps every point at its index (blocks of P / n_pt)
        return self._host_result(problem, rv, tv, pts[: problem.points.shape[0]], stats)

    def _host_result(self, problem, rv, tv, pts, stats):
        """A solve's (rvecs, tvecs, points, stats) and its post-BA outlier
        mask over the observations, on the host."""
        if self.cfg.prune_obs_reproj_px > 0:
            r = ba._residuals(rv, tv, pts, problem)
            bad = (problem.obs_mask > 0) & (torch.linalg.norm(r, dim=1)
                                            > self.cfg.prune_obs_reproj_px)
        else:
            bad = torch.zeros(problem.uv.shape[0], dtype=torch.bool, device=rv.device)
        sv = self._host(torch.stack([torch.as_tensor(x, device=rv.device).to(torch.float64)
                                     for x in stats])).astype(np.float64)
        stats = ba.BAStats(*sv[:4], int(sv[4]), bool(sv[5]))
        return (self._host(rv).astype(np.float64), self._host(tv).astype(np.float64),
                self._host(pts).astype(np.float64), stats, self._host(bad))

    def run_global_ba(self) -> Optional[dict]:
        """Final global BA: window = every keyframe but the newest."""
        return self.run_local_ba(window_size=self.map.num_keyframes, global_ba=True)

    # -- finalization ------------------------------------------------------

    def _write_debug_videos(self, out: str) -> list:
        """The keypoint, match and depth overlay videos (mp4v, 5 frames/s)
        from the per-keyframe debug images, through cv2's ``VideoWriter``.
        Where cv2 is not installed none is written: a ``debug_videos_skipped``
        event names cv2 and the files, which are returned."""
        names = [name for _, name in DEBUG_VIDEOS]
        try:
            cv2 = _cv2("the debug videos (" + ", ".join(names) + ")")
        except ImportError as e:
            self.log.emit("debug_videos_skipped", f"    -> Debug videos not written: {e}",
                          needs="cv2", files=names)
            return names
        for sub, name in DEBUG_VIDEOS:
            paths = sorted(glob.glob(os.path.join(out, sub, "*.png")))
            if not paths:
                continue
            h, w = read_png(paths[0]).shape[:2]
            vw = cv2.VideoWriter(os.path.join(out, name), cv2.VideoWriter_fourcc(*"mp4v"), 5,
                                 (w, h))
            for p in paths:
                img = read_png(p)
                if img.shape[:2] == (h, w):
                    vw.write(img)
            vw.release()
        return []

    def finalize(self, out_dir: Optional[str] = None) -> dict:
        """Global BA + full BA, then the outputs in ``out_dir``:
        final_map_global_ba.pcd, with ``debug`` the overlay videos, the final
        2-D and 3-D trajectory plots, trajectory.txt, events.jsonl,
        summary.json."""
        out = out_dir or self.cfg.output_dir
        result = self.run_global_ba()
        if self.cfg.final_full_ba:
            full = self.run_full_ba()
            if full is not None:
                result = full
        pts, colors = self.map.get_pcd()
        os.makedirs(out, exist_ok=True)
        if len(pts):
            if self.cfg.export_voxel > 0:
                pts, colors = voxel_downsample_native(pts, colors, self.cfg.export_voxel)
            write_pcd(os.path.join(out, "final_map_global_ba.pcd"), pts, colors)

        skipped = self._write_debug_videos(out) if self.cfg.debug else []
        traj = self.map.trajectory(self.cfg.consistent_convention)
        viz.plot_and_save_trajectory_2d(traj, os.path.join(out, "trajectory_2d"), "final",
                                        device=self.device)
        rots = [self.map.keyframes[k].R for k in self.map.sorted_kf_ids()]
        viz.plot_and_save_trajectory_3d(traj, rots, os.path.join(out, "trajectory_3d"), "final",
                                        device=self.device)
        self.host_reads += 2

        with open(os.path.join(out, "trajectory.txt"), "w") as f:
            f.write("# frame_idx kf_id cx cy cz wx wy wz\n")
            for k, c in zip(self.map.sorted_kf_ids(), traj):
                kf = self.map.keyframes[k]
                w = so3_log_np(kf.R)
                f.write(f"{kf.frame_idx} {k} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                        f"{w[0]:.6f} {w[1]:.6f} {w[2]:.6f}\n")
        summary = {
            "num_keyframes": self.map.num_keyframes,
            "num_points": self.map.num_points,
            "num_observations": self.map.num_observations,
            "frames": self.frame_idx + 1,
            "device": str(self.device),
            "global_ba": result,
        }
        if skipped:
            summary["debug_videos_skipped"] = skipped
        events_path = os.path.join(out, "events.jsonl")
        if not (self.log.path and os.path.abspath(self.log.path)
                == os.path.abspath(events_path)):
            with open(events_path, "w") as f:
                for rec in self.log.events:
                    f.write(json.dumps(rec) + "\n")
        with open(os.path.join(out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary
