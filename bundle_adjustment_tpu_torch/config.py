"""Typed configuration for the SfM/VO engine (the PyTorch port's own copy:
same fields, defaults and presets as ``bundle_adjustment_tpu.config``).

The reference keeps its knobs in a constants module plus hard-coded dicts in
``main`` (ref: src/parameters.py:1-21, src/main.py:27-41); the legacy scripts
carry per-dataset deltas (ratio 0.5/0.6/0.75, essential threshold 0.5/1.0/3.0,
reliability gate 0.4/0.7 — ref: legacy/local_BA_sparsity.py:359,
legacy/local_BA_sparsity_images.py:340,618, legacy/local_BA.py:503).  Here all
of that is one frozen dataclass with named per-dataset presets, plus the
static-shape capacities the TPU design needs (the reference has none because
it is fully dynamic Python).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """Pinhole intrinsics, zero distortion (the only model the reference uses:
    dist_coeffs are all-zero at src/main.py:41)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 1280
    height: int = 720

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )


@dataclasses.dataclass(frozen=True)
class KeyframeCriteria:
    """Ordered keyframe triggers (ref: src/keyframe_detector.py:36-86,
    thresholds from src/main.py:27-33)."""

    min_parallax_deg: float = 1.0
    min_tracked_for_parallax: int = 20
    min_median_displacement_px: float = 20.0
    min_rotation_rad: float = 0.15
    min_feature_ratio: float = 0.25


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Windowed local BA settings (ref: src/bundle_adjuster.py:122-193,
    src/parameters.py:19)."""

    window_size: int = 5          # adjustable KFs per window; oldest is the fixed gauge anchor
    # cameras gauge-fixed per window.  1 = reference behavior
    # (src/bundle_adjuster.py:141-142) which leaves the monocular SCALE gauge
    # free — each window can rescale, drifting the trajectory.  2 pins scale
    # too (the effective value is capped at window length - 1).
    n_fixed: int = 2
    max_iterations: int = 50      # mirrors scipy max_nfev=50 (src/bundle_adjuster.py:173)
    xtol: float = 1e-5
    ftol: float = 1e-5
    huber_delta: float = 1.0      # scipy loss='huber' default f_scale
    # LM damping schedule
    lambda_init: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    lambda_min: float = 1e-10
    lambda_max: float = 1e8
    # static capacities for the windowed problem (padded, masked)
    max_points: int = 8192        # map points per window
    max_obs: int = 32768          # observations per window
    # Camera-system solver switch: windows larger than this many cameras use
    # matrix-free block-Jacobi PCG on the Schur complement instead of the
    # dense (6C')^2 solve — global BA over hundreds of keyframes stays
    # O(cg_iters * observations) in time and O(observations) in memory.
    pcg_min_cameras: int = 24
    # PCG iteration cap (early exit on cg_tol).  Measured on TPU v5e at
    # C=200/P=30k/O=120k (band visibility, ~6 px rms initial error): the
    # final cost after 50 LM iterations is IDENTICAL to 4 decimal places for
    # caps 4/8/32 (3.7224e4 vs 3.7222e4) while per-LM-iteration wall time is
    # 14.5 / 16.7 / 29.8 ms — LM accept/reject absorbs inexact steps, and
    # each LM iteration's fixed cost (terms+setup+trial cost, ~12.7 ms)
    # dominates once the CG loop is short.  Cap 8 keeps headroom for
    # worse-conditioned real maps; Eisenstat-Walker forcing exits earlier
    # when the gradient is small either way.
    cg_iters: int = 8
    cg_tol: float = 1e-6          # relative-residual stop
    # Grouped block-Jacobi PCG preconditioner: exact (6g x 6g) group-diagonal
    # blocks of the Schur complement (g consecutive cameras per group),
    # inverted batched once per LM iteration.  MEASURED NOT TO PAY at bench
    # scales (C=200: g=16 costs +3 ms/LM-iter in setup and the saved CG
    # iterations are worth less than that once the cap is 8) — kept
    # config-gated (correctness-tested in tests/test_ba_pcg.py) for
    # ill-conditioned maps where plain block-Jacobi stalls; 1 disables.
    cg_precond_group: int = 1
    # Above this many adjustable cameras, the PCG camera reductions run the
    # MXU bf16 path (the f32 one-hot read is the dominant HBM traffic and
    # scales O(C * observations); 0/1 is exact in bf16, reduction values
    # round to ~3 decimal digits — direction noise the block-Jacobi
    # preconditioner and LM accept/reject absorb).
    cg_bf16_min_cameras: int = 512
    # Window-scale solver: the window LM kernel (ops/ba_kernel.py, the
    # counterpart of the JAX package's ops/ba_pallas.py; the field keeps its
    # name) runs the whole solve in one kernel launch.  Windows outside the
    # kernel's shape gate go to the grid solver, as does every window when
    # this is False.
    use_pallas_ba: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    camera: CameraModel
    keyframe: KeyframeCriteria = KeyframeCriteria()
    ba: BAConfig = BAConfig()

    # feature extraction (ref: src/features.py:12 default 3000; driver uses
    # 4000 at src/main.py:60).  num_features is the static keypoint capacity.
    num_features: int = 4000
    # "orb_tpu" = our JAX/Pallas extractor; "cv2" = inject cv2.ORB keypoints/
    # descriptors (ref: src/features.py:13-16) through the rest of the
    # pipeline — the SURVEY §7 escape hatch that isolates detector parity
    # from geometry parity (detector differences vs pose/BA differences in
    # ATE).  cv2 mode runs the staged frontend (extraction is host-side).
    features_source: str = "orb_tpu"
    fast_threshold: int = 20
    pyramid_levels: int = 8
    pyramid_scale: float = 1.2

    # matching (ref: src/features.py:31-37)
    ratio_test: float = 0.75
    cross_check: bool = False

    # essential-matrix RANSAC (ref: src/pose_estimator.py:27)
    ransac_prob: float = 0.999
    ransac_threshold_px: float = 3.0
    ransac_iters: int = 4096      # static hypothesis batch (vmapped; 8-point
                                  # samples need ~4x cv2's 5-point trial count
                                  # at equal success probability)

    # PnP RANSAC (ref: src/pose_estimator.py:72-81)
    pnp_iters: int = 128
    pnp_reproj_err_px: float = 8.0

    # frame reliability gates (ref: src/parameters.py:18,20-21, src/pipeline.py:79-87)
    min_tracked_features: int = 20
    pose_inlier_ratio: float = 0.7
    pose_inlier_numbers: int = 20

    # PnP-based metric scale propagation (the "PnP pose chain" of BASELINE
    # config 2): recoverPose translations are unit-norm, so without this every
    # keyframe step has length 1 and the trajectory scale-drifts (the
    # reference leans on BA to mop this up; PnP against tracked map points
    # recovers the true relative scale directly).
    pnp_scale: bool = True
    pnp_scale_min_tracked: int = 8
    # Tracked frames skip essential-matrix RANSAC entirely: the PnP pose
    # against the map defines the relative model, and epipolar inliers come
    # from one Sampson pass against it.  The 5-point hypothesis machinery
    # (the priciest per-frame op) then only runs at initialization and on
    # tracking loss.  Disable to always run full essential RANSAC (the
    # reference's behavior, src/pipeline.py:73).
    pnp_first: bool = True

    # Fuse the whole tracked-frame path (extract -> match -> PnP -> Sampson
    # inliers -> keyframe metrics) into ONE device dispatch
    # (models/frontend.py); the host reads back a scalar bundle for the
    # gates.  Requires pnp_first+pnp_scale; False falls back to the staged
    # per-op path (one dispatch per stage — the round-1 behavior, ~5-8
    # host<->device round trips per frame).
    fused_frontend: bool = True

    # After LBA, keyframes newer than the window (always at least the newest
    # one, which the reference's window choice excludes —
    # src/bundle_adjuster.py:140) keep stale poses relative to the adjusted
    # map; each insertion then compounds the inconsistency (observed: BA
    # initial costs exploding 1e3 -> 1e12 over 14 keyframes).  This applies
    # the last optimized keyframe's pose correction to them, preserving their
    # relative pose — standard sliding-window chain propagation.  The
    # reference does not do this; disable for strict behavior parity.
    propagate_ba_correction: bool = True

    # Covisibility re-observation: match each new keyframe against this many
    # ADDITIONAL recent keyframes (beyond the last one) and register
    # reprojection-verified re-observations.  Longer feature tracks pin the
    # gauge across windows and cut drift.  The reference only matches the
    # last keyframe (src/pipeline.py:52-53); its exhaustive variant exists as
    # dead code (src/pipeline.py:112-223).  0 = reference behavior.
    covis_keyframes: int = 2
    covis_reproj_px: float = 4.0

    # Post-BA observation pruning: after an accepted BA, observations whose
    # reprojection residual exceeds this are removed (0 = off).  Standard map
    # hygiene the reference lacks; its BA guard at src/bundle_adjuster.py:213
    # is the hook (SURVEY §5).
    prune_obs_reproj_px: float = 12.0

    # One completion BA over ALL keyframes at finalize time: the reference's
    # global BA always excludes the newest keyframe (window [-(w+1):-1] with
    # window_size = num_keyframes, src/main.py:80-89), leaving the chain head
    # unoptimized.
    final_full_ba: bool = True

    # Pose-only refinement of each new keyframe over all its registered
    # observations with the map held fixed (ORB-SLAM-style motion-only BA;
    # runs through the same Schur solver with every point masked out of the
    # parameter set).  The reference has no counterpart.
    pose_refine: bool = True

    # relocalization (lehman_indoor config; built fresh per SURVEY §5).
    # The bank is searched as ONE stacked descriptor matrix; above
    # reloc_ann_threshold descriptors the coarse-to-fine approximate matcher
    # takes over (ops/ann.py — the FLANN/LSH successor).
    reloc_enabled: bool = False
    reloc_bank_size: int = 8      # recent keyframes searched on tracking loss
    reloc_ann_threshold: int = 16384

    # map-point culling (lehman long-sequence config)
    cull_enabled: bool = False
    cull_min_observations: int = 2
    cull_max_reproj_err_px: float = 8.0

    # Loop closure (models/loop_closure.py): bank detection of revisits,
    # RANSAC-Umeyama sim(3) drift fit on matched 3D-3D point pairs,
    # interpolated pose-chain correction, duplicate-point fusion, global-BA
    # polish.  The reference has no counterpart (its global BA cannot close
    # a loop whose observation topology never ties — measured ~10% of path
    # ATE on a 600-frame loop without this, pure distributed scale drift).
    loop_closure: bool = False
    loop_min_gap: int = 30        # only keyframes this much older are candidates
    loop_min_matches: int = 25    # ratio-test matches to accept an anchor
    loop_min_inliers: int = 12    # sim(3) RANSAC inliers required
    loop_sim3_tol_rel: float = 0.05   # inlier tol as fraction of scene scale
    loop_run_global_ba: bool = True   # polish the whole map after a closure
    loop_ba_iters: int = 20       # LM cap for that polish (see loop_closure.py)
    loop_cooldown: int = 15       # keyframes between closure attempts

    # Pose-chain convention.  False (default) reproduces the reference's
    # composition world_R = last_R @ R_rel, world_t = last_t + last_R @ t_rel
    # with points world-transformed as X_w = last_R @ X_rel + last_t — which
    # is mutually inconsistent with the BA's extrinsic interpretation of
    # (R, t) from the 3rd keyframe on (documented quirk, SURVEY §2.4).
    # True uses the correct extrinsic chain (R_new = R_rel @ R_last,
    # t_new = R_rel @ t_last + t_rel; X_w = R_last^T (X_rel - t_last)), which
    # keeps initialization geometrically consistent.
    consistent_convention: bool = False

    # distributed mesh (data-parallel x model/point-parallel), (1,1) = single chip
    mesh_shape: Tuple[int, int] = (1, 1)

    # output / debug artifacts
    output_dir: str = "output_map"
    debug: bool = False
    # per-keyframe PCD replay series (legacy/pc_generator.py:98-101)
    export_pcd_series: bool = False
    # voxel size for downsampling the final exported cloud; 0 = off
    # (legacy voxel_down_sample 0.1 at legacy/local_BA.py:586)
    export_voxel: float = 0.0


# ---------------------------------------------------------------------------
# Per-dataset presets mirroring the reference's configurations
# ---------------------------------------------------------------------------

#: video_0001 / lehman camera (ref: src/main.py:36-41)
CAMERA_LEHMAN = CameraModel(fx=912.7816, fy=913.0293, cx=650.2930, cy=362.7243)

#: srge_lab / desk camera (ref: legacy/local_BA.py:550-554)
CAMERA_DESK = CameraModel(fx=431.40, fy=431.40, cx=640.0, cy=360.0)

#: Oxford dinosaur camera (ref: legacy/mapping_mvs.py:158-162)
CAMERA_DINOSAUR = CameraModel(fx=2360.13, fy=2360.13, cx=360.0, cy=288.0, width=720, height=576)


def preset_video(camera: CameraModel = CAMERA_LEHMAN) -> PipelineConfig:
    """Full VO pipeline on video, sliding-window BA (BASELINE config 3)."""
    return PipelineConfig(camera=camera)


def preset_desk() -> PipelineConfig:
    """desk_images 3-frame run: every frame a keyframe, permissive gates
    (ref: legacy/local_BA_sparsity_images.py:340,416,427-429,618)."""
    return PipelineConfig(
        camera=CAMERA_DESK,
        # the legacy desk run used ratio 0.60 with cv2's learned descriptors;
        # our rBRIEF tests are tuned at 0.75 for equivalent selectivity
        ratio_test=0.75,
        ransac_threshold_px=0.5,
        min_tracked_features=1,
        pose_inlier_ratio=0.0,
        pose_inlier_numbers=5,
        keyframe=KeyframeCriteria(
            min_parallax_deg=0.0,
            min_median_displacement_px=0.0,
            min_rotation_rad=0.0,
            min_feature_ratio=1.1,  # ratio is always < 1.1 → every frame triggers
        ),
        ba=BAConfig(window_size=5, max_points=4096, max_obs=16384),
    )


def preset_scout() -> PipelineConfig:
    """scout_images short sequence: keyframe detection + PnP pose chain
    (BASELINE config 2)."""
    return PipelineConfig(
        camera=CAMERA_DESK,
        # scout pairs are wide-baseline with sparse texture: a lean, high-
        # quality feature set scores better than the full 4000 budget (the
        # extra low-response keypoints only add ratio-test noise)
        num_features=1500,
        pyramid_levels=4,
        min_tracked_features=8,
        pose_inlier_ratio=0.3,
        pose_inlier_numbers=8,
        ba=BAConfig(window_size=5, max_points=4096, max_obs=16384),
    )


def preset_lehman_indoor() -> PipelineConfig:
    """Long sequence: culling + relocalization on match failure (config 4),
    plus loop closure (revisit-heavy indoor sequences)."""
    return PipelineConfig(
        camera=CAMERA_LEHMAN,
        reloc_enabled=True,
        cull_enabled=True,
        loop_closure=True,
    )


def preset_multihost(mesh_shape: Tuple[int, int]) -> PipelineConfig:
    """lehmanL multi-host run: partitioned windows + distributed Schur BA
    (config 5)."""
    return PipelineConfig(camera=CAMERA_LEHMAN, mesh_shape=mesh_shape)
