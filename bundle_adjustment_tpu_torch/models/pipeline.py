"""The frame-pipeline orchestrator (port of
``bundle_adjustment_tpu.models.pipeline``).

Per frame: grayscale -> (first frame: initialize the map) -> the fused
tracked-frame step on the device (ORB extract, Hamming 2-NN, PnP, Sampson
inliers, keyframe metrics) -> host gates and keyframe decision -> keyframe
insertion with covisibility re-observation -> windowed local BA with the
newest keyframe's motion-only refine.  ``finalize`` runs the global and full
BA and writes the outputs.

The port runs the branches the default configuration reaches with at most
``pcg_min_cameras`` keyframes per solve, plus the staged (unfused) path.
With ``BAConfig.use_pallas_ba`` (the default) a window whose shape the
window LM kernel admits (``ops/ba_kernel.kernel_eligible``) is solved in one
kernel launch; any other window, and every window with the switch off, goes
to the grid solver.  The shape is the only gate: a kernel that fails to
build or launch raises.  Configurations that need a kernel or module not
ported yet raise ``NotImplementedError`` naming it; none of them quietly
takes another path.

Random draws: the JAX pipeline draws RANSAC sample uniforms from
``PRNGKey(0)`` (split once per essential or PnP RANSAC call) and from
``fold_in(PRNGKey(1), frame_idx)`` (the fused step's PnP).  Here they come
from a ``draws`` object with the same two methods; ``Draws`` is the default,
seeded ``torch.Generator``s.  A test can replay the JAX schedule through it.
"""

from __future__ import annotations

import json
import os
import time
import types
from typing import Optional

import numpy as np
import torch

from bundle_adjustment_tpu_torch import device as device_mod
from bundle_adjustment_tpu_torch.config import PipelineConfig
from bundle_adjustment_tpu_torch.models import frontend
from bundle_adjustment_tpu_torch.models.keyframe import decide_from_metrics, decide_keyframe
from bundle_adjustment_tpu_torch.models.map_store import Keyframe, Map
from bundle_adjustment_tpu_torch.ops import (ba, ba_grid, ba_kernel, hamming, orb, ransac,
                                             triangulation)
from bundle_adjustment_tpu_torch.ops.lie import rotation_angle, so3_exp_np, so3_hat, so3_log_np
from bundle_adjustment_tpu_torch.ops.projection import epipolar_errors_px
from bundle_adjustment_tpu_torch.utils.event_log import EventLog
from bundle_adjustment_tpu_torch.utils.io import write_pcd


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

    def for_frame(self, frame_idx: int, shape) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed + 1) * 1_000_003 + int(frame_idx))
        return torch.rand(shape, generator=g, device=self.device)


def _unported(cfg: PipelineConfig, dev: torch.device) -> Optional[str]:
    """The first configuration switch the port cannot run yet, with what
    it needs, or None."""
    if cfg.reloc_enabled:
        return "reloc_enabled needs models/relocalize and ops/ann, not ported yet"
    if cfg.cull_enabled:
        return "cull_enabled needs map-point culling, not ported yet"
    if cfg.loop_closure:
        return "loop_closure needs models/loop_closure, not ported yet"
    if tuple(cfg.mesh_shape) != (1, 1):
        return "mesh_shape != (1, 1) needs parallel/ (dist_ba), not ported yet"
    if cfg.features_source != "orb_tpu":
        return f"features_source={cfg.features_source!r} needs the cv2 feature path, not ported"
    if cfg.debug:
        return "debug=True needs utils/viz (matplotlib/cv2 plots), not ported yet"
    if cfg.export_voxel > 0:
        return "export_voxel > 0 needs the native voxel downsampler, not ported yet"
    return None


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
                rp, n_fixed=0, max_iterations=refine_iters, huber_delta=refine_huber)
            refine_v = torch.cat([
                rrv[0].to(f32), rtv[0].to(f32),
                vec(rstats.initial_sq, rstats.final_sq, rstats.iterations,
                    rstats.accepted, 0.0, 0.0)])
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
        why = _unported(config, self.device)
        if why is not None:
            raise NotImplementedError(why)
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
        self._front_state = None
        self._front_state_kf = -1
        self._front_dirty = False

    # -- pipeline ----------------------------------------------------------

    def _extract(self, gray: np.ndarray) -> orb.Keypoints:
        return orb.extract(
            torch.as_tensor(gray, device=self.device),
            num_features=self.cfg.num_features,
            levels=self.cfg.pyramid_levels,
            scale=self.cfg.pyramid_scale,
            threshold=float(self.cfg.fast_threshold),
            height=gray.shape[0],
            width=gray.shape[1],
        )

    def process_frame(self, frame_bgr: np.ndarray) -> dict:
        """Process one BGR frame; returns a dict with the decision chain."""
        t_start = time.perf_counter()
        result = self._process_frame_inner(frame_bgr)
        self.log.emit("frame_timing", None, frame_idx=self.frame_idx,
                      status=result.get("status"),
                      total_ms=round((time.perf_counter() - t_start) * 1e3, 2))
        return result

    def _fusable(self) -> bool:
        return (self.cfg.fused_frontend and self.cfg.pnp_first
                and self.cfg.pnp_scale and self.map.num_keyframes > 0)

    def _ensure_front_state(self) -> int:
        """Refresh the device mirror of the last keyframe if stale."""
        last_id = self.map.sorted_kf_ids()[-1]
        if (self._front_state is None or self._front_state_kf != last_id
                or self._front_dirty):
            self._front_state = frontend.make_state(
                self.map.keyframes[last_id], self.map.points(),
                self.cfg.num_features, device=self.device)
            self._front_state_kf = last_id
            self._front_dirty = False
        return last_id

    def _fused_dispatch(self, gray: np.ndarray, frame_idx: int = None):
        """The fused tracked-frame step against the current front state."""
        if frame_idx is None:
            frame_idx = self.frame_idx
        self._ensure_front_state()
        u = self.draws.for_frame(frame_idx, ransac.pnp_draw_shape(self.cfg.pnp_iters))
        return frontend.track_step(
            torch.as_tensor(gray, device=self.device), self._front_state,
            self.K_t, u,
            num_features=self.cfg.num_features, levels=self.cfg.pyramid_levels,
            pyramid_scale=self.cfg.pyramid_scale,
            fast_threshold=float(self.cfg.fast_threshold),
            height=gray.shape[0], width=gray.shape[1],
            ratio=self.cfg.ratio_test, cross_check=self.cfg.cross_check,
            pnp_iters=self.cfg.pnp_iters,
            pnp_reproj_px=self.cfg.pnp_reproj_err_px,
            sampson_thr_px=self.cfg.ransac_threshold_px,
            consistent=self.cfg.consistent_convention,
        )

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

    def _process_frame_inner(self, frame_bgr: np.ndarray) -> dict:
        self.frame_idx += 1
        self.log.frame(self.frame_idx)
        gray = bgr_to_gray(frame_bgr)

        if self._fusable():
            return self._process_frame_fused(gray, frame_bgr)

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
        match_idx = idx.cpu().numpy().astype(np.int64)
        match_mask = mask.cpu().numpy()
        n_matches = int(match_mask.sum())
        if n_matches < self.cfg.min_tracked_features:
            self.log.frame_discarded(self.frame_idx, "Not enough matches to track.")
            return self._tracking_lost("matches")

        kp_xy = kp.xy.cpu().numpy()
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
            if not bool(pose.ok):
                self.log.pose(self.frame_idx, 0, n_matches, 0.0)
                self.log.frame_discarded(self.frame_idx, "Could not estimate pose.")
                return self._tracking_lost("pose")
            R_rel = pose.R.cpu().numpy().astype(np.float64)
            t_rel = pose.t.cpu().numpy().astype(np.float64)
            inl = pose.inliers.cpu().numpy()
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
            return self._tracking_lost("unreliable")
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
                                        valid=kp.valid.cpu().numpy())
        self._add_new_keyframe(frame_bgr, kp_host, last_kf, match_idx, inl,
                               R_rel, t_rel, world_pose=world_pose_override)
        ba_result = self.run_local_ba(
            refine_kf_id=kf_id if self.cfg.pose_refine else None)
        return {"status": "keyframe", "kf_id": kf_id, "reason": decision.reason,
                "inliers": num_inliers, "inlier_ratio": inlier_ratio,
                "ba": ba_result, "loop": None}

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

    def _process_frame_fused(self, gray: np.ndarray, frame_bgr: np.ndarray) -> dict:
        """Tracked frame as one fused device step plus one scalar readback;
        big arrays cross to the host only on keyframe insertion or the
        essential-RANSAC fallback."""
        last_id = self._ensure_front_state()
        last_kf = self.map.keyframes[last_id]
        res = self._fused_dispatch(gray)

        sc = frontend.unpack_scalars(res.packed)
        n_matches = sc.n_matches
        num_inliers = sc.num_inliers
        kp = types.SimpleNamespace(xy=res.kp_xy, desc=res.kp_desc, valid=res.kp_valid)

        if n_matches < self.cfg.min_tracked_features:
            self.log.frame_discarded(self.frame_idx, "Not enough matches to track.")
            return self._tracking_lost("matches")

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
            match_idx = res.match_idx.cpu().numpy().astype(np.int64)
            kp_xy = res.kp_xy.cpu().numpy()
            pose = self._essential(last_kf.xy, kp_xy[match_idx], res.match_mask,
                                   quality=res.match_dist)
            if not bool(pose.ok):
                self.log.pose(self.frame_idx, 0, n_matches, 0.0)
                self.log.frame_discarded(self.frame_idx, "Could not estimate pose.")
                return self._tracking_lost("pose")
            R_rel = pose.R.cpu().numpy().astype(np.float64)
            t_rel = pose.t.cpu().numpy().astype(np.float64)
            inl = pose.inliers.cpu().numpy()
            num_inliers = int(inl.sum())
            metrics_from_device = False

        inlier_ratio = num_inliers / max(n_matches, 1)
        self.log.pose(self.frame_idx, num_inliers, n_matches, inlier_ratio)
        if not (inlier_ratio > self.cfg.pose_inlier_ratio
                and num_inliers > self.cfg.pose_inlier_numbers):
            self.log.frame_discarded(
                self.frame_idx, "Low inlier ratio or insufficient inliers.")
            return self._tracking_lost("unreliable")
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
            match_idx = res.match_idx.cpu().numpy().astype(np.int64)
            kp_xy = res.kp_xy.cpu().numpy()
            decision = self._host_decision(
                last_kf, inl, R_rel, t_rel, last_kf.xy[inl],
                kp_xy[match_idx[inl]], sc.rot_mag, num_inliers)

        if not decision.is_keyframe:
            return {"status": "tracked", "inliers": num_inliers,
                    "inlier_ratio": inlier_ratio}

        kf_id = self.map.new_keyframe_id()
        self.log.keyframe_trigger(self.frame_idx, kf_id, decision.reason,
                                  decision.metrics)
        ins = frontend.unpack_insert(res.insert_packed)
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
                "ba": ba_result, "loop": None}

    def _epipolar_inliers(self, R_rel, t_rel, uv1, uv2, match_mask):
        """Sampson inlier classification against a known relative model."""
        f32 = torch.float32
        t = t_rel / max(np.linalg.norm(t_rel), 1e-12)
        E = (so3_hat(torch.as_tensor(t, dtype=f32))
             @ torch.as_tensor(R_rel, dtype=f32)).to(self.device)
        errs = epipolar_errors_px(
            E, self.K_t, torch.as_tensor(uv1, dtype=f32, device=self.device),
            torch.as_tensor(uv2, dtype=f32, device=self.device)).cpu().numpy()
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
        if not bool(res.ok) or int(res.num_inliers) < self.cfg.pnp_scale_min_tracked:
            return None
        R_pnp = res.R.cpu().numpy().astype(np.float64)
        t_pnp = res.t.cpu().numpy().astype(np.float64)
        if not (np.isfinite(R_pnp).all() and np.isfinite(t_pnp).all()):
            return None
        return R_pnp, t_pnp

    def _tracking_lost(self, why: str) -> dict:
        self._lost_frames += 1
        return {"status": "discarded", "why": why}

    def _initialize_map(self, frame_bgr, kp: orb.Keypoints):
        self.log.emit("init", "Initializing with first keyframe...", frame_idx=self.frame_idx)
        kf = Keyframe(
            kf_id=self.map.new_keyframe_id(), R=np.eye(3), t=np.zeros(3),
            xy=kp.xy.cpu().numpy().astype(np.float64), desc=kp.desc,
            kp_valid=kp.valid.cpu().numpy(), frame_idx=self.frame_idx,
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
                X_rel = X_rel.cpu().numpy().astype(np.float64)
                valid = valid.cpu().numpy()
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

        if self.cfg.export_pcd_series:
            pts_w, colors = self.map.get_pcd()
            if len(pts_w):
                write_pcd(os.path.join(self.cfg.output_dir, "pcd_series",
                                       f"frame_{new_kf.kf_id:05d}.pcd"), pts_w, colors)

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
        out = frontend.covis_step(
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
        ).cpu().numpy()

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
                                       huber_delta=self.cfg.ba.huber_delta)
        if bool(stats.accepted) and float(stats.final_sq) < float(stats.initial_sq):
            kf = self.map.keyframes[kf_id]
            kf.R = so3_exp_np(rv[0].cpu().numpy().astype(np.float64))
            kf.t = tv[0].cpu().numpy().astype(np.float64)

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

    def run_full_ba(self, max_iterations: Optional[int] = None) -> Optional[dict]:
        """Full BA over all keyframes, the newest included."""
        all_ids = self.map.sorted_kf_ids()
        if len(all_ids) < 3:
            return None
        return self._solve_window(all_ids, all_ids, global_ba=True,
                                  max_iterations=max_iterations)

    def _solve_window(self, window, all_ids, global_ba: bool = False,
                      refine_kf_id: Optional[int] = None,
                      max_iterations: Optional[int] = None) -> Optional[dict]:
        if len(window) > self.cfg.ba.pcg_min_cameras:
            raise NotImplementedError(
                f"a BA window of {len(window)} cameras (> pcg_min_cameras="
                f"{self.cfg.ba.pcg_min_cameras}) needs the PCG camera solve and "
                "the global-BA kernels (K4, ops/ba_global_pallas.py), not ported yet")
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
        grid = ba_grid.from_flat(problem, on_drop=lambda n: self.log.emit(
            "capacity_drop",
            f"    -> Grid layout dropped {n} observations (max_slots cap)",
            dropped_obs=int(n)))
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
        call_args = (grid, problem) + ((refine_problem,) if refine_problem is not None else ())
        flat = fn(*call_args).cpu().numpy().astype(np.float64)
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

    def run_global_ba(self) -> Optional[dict]:
        """Final global BA: window = every keyframe but the newest."""
        return self.run_local_ba(window_size=self.map.num_keyframes, global_ba=True)

    # -- finalization ------------------------------------------------------

    def finalize(self, out_dir: Optional[str] = None) -> dict:
        """Global BA + full BA, then the outputs in ``out_dir``:
        final_map_global_ba.pcd, trajectory.txt, events.jsonl, summary.json."""
        out = out_dir or self.cfg.output_dir
        result = self.run_global_ba()
        if self.cfg.final_full_ba:
            full = self.run_full_ba()
            if full is not None:
                result = full
        pts, colors = self.map.get_pcd()
        os.makedirs(out, exist_ok=True)
        if len(pts):
            write_pcd(os.path.join(out, "final_map_global_ba.pcd"), pts, colors)

        traj = self.map.trajectory(self.cfg.consistent_convention)
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
        events_path = os.path.join(out, "events.jsonl")
        if not (self.log.path and os.path.abspath(self.log.path)
                == os.path.abspath(events_path)):
            with open(events_path, "w") as f:
                for rec in self.log.events:
                    f.write(json.dumps(rec) + "\n")
        with open(os.path.join(out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary
