"""Keyframe decision policy — the reference's ordered trigger cascade.

Replicates src/keyframe_detector.py:21-87 with the trigger-reason taxonomy
the log analytics depend on (ref: src/analyze_log.py:80-85): ``Parallax``,
``Pixel Displacement``, ``Rotation``, ``Feature Ratio`` (plus
``Initialization`` for the first frame).  Criteria, in order:

1. median ray parallax over tracked map points > min_parallax_deg, evaluated
   only when > min_tracked_for_parallax points are tracked
   (ref: keyframe_detector.py:36-69 — ray angle via arccos of normalized dot)
2. median pixel displacement of matches > min_median_displacement_px (72-75)
3. relative rotation magnitude > min_rotation_rad (77-81)
4. inliers / last-KF feature count < min_feature_ratio (83-86)

Host-side numpy on small arrays (a few thousand scalars — not worth a device
round trip); camera "positions" use the reference's t-as-position convention.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from bundle_adjustment_tpu_torch.config import KeyframeCriteria


class KeyframeDecision(NamedTuple):
    is_keyframe: bool
    reason: str                 # taxonomy string, "" if not a keyframe
    metrics: dict


def decide_from_metrics(
    criteria: KeyframeCriteria,
    *,
    n_tracked: int,               # tracked inlier count (parallax gate)
    median_parallax_deg: float,   # nan when unavailable
    median_displacement_px: float,  # nan when no inlier matches
    rotation_rad: float,
    num_inliers: int,
    num_last_features: int,
) -> KeyframeDecision:
    """The ordered trigger cascade on precomputed metrics — the host half of
    the fused frontend (medians computed on device in one dispatch,
    thresholds applied here so the reason taxonomy stays host-side)."""
    metrics: dict = {
        "tracked": int(n_tracked),
        "rotation_rad": float(rotation_rad),
        "num_inliers": int(num_inliers),
        "num_last_features": int(num_last_features),
    }

    # 1. parallax (ref: keyframe_detector.py:36-69)
    if n_tracked > criteria.min_tracked_for_parallax and np.isfinite(
            median_parallax_deg):
        metrics["median_parallax_deg"] = float(median_parallax_deg)
        if median_parallax_deg > criteria.min_parallax_deg:
            return KeyframeDecision(True, "Parallax", metrics)

    # 2. median pixel displacement (ref: 72-75)
    if np.isfinite(median_displacement_px):
        metrics["median_displacement_px"] = float(median_displacement_px)
        if median_displacement_px > criteria.min_median_displacement_px:
            return KeyframeDecision(True, "Pixel Displacement", metrics)

    # 3. rotation magnitude (ref: 77-81)
    if rotation_rad > criteria.min_rotation_rad:
        return KeyframeDecision(True, "Rotation", metrics)

    # 4. feature ratio (ref: 83-86)
    ratio = num_inliers / max(num_last_features, 1)
    metrics["feature_ratio"] = ratio
    if ratio < criteria.min_feature_ratio:
        return KeyframeDecision(True, "Feature Ratio", metrics)

    return KeyframeDecision(False, "", metrics)


def decide_keyframe(
    criteria: KeyframeCriteria,
    *,
    tracked_points: np.ndarray,      # (T, 3) world positions of tracked map points
    last_cam_center: np.ndarray,     # (3,) last KF position (t, reference convention)
    new_cam_center: np.ndarray,      # (3,) candidate position (composed t)
    uv_last: np.ndarray,             # (M, 2) matched keypoints on last KF (inliers)
    uv_new: np.ndarray,              # (M, 2) matched keypoints on current frame
    rotation_rad: float,             # |so3_log(R_rel)|
    num_inliers: int,
    num_last_features: int,
) -> KeyframeDecision:
    med_par = float("nan")
    if len(tracked_points):
        r1 = tracked_points - last_cam_center
        r2 = tracked_points - new_cam_center
        n1 = np.linalg.norm(r1, axis=1)
        n2 = np.linalg.norm(r2, axis=1)
        good = (n1 > 1e-9) & (n2 > 1e-9)
        if good.any():
            cosang = np.sum(r1[good] * r2[good], axis=1) / (n1[good] * n2[good])
            ang = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
            med_par = float(np.median(ang))

    med_disp = float("nan")
    if len(uv_last):
        med_disp = float(np.median(np.linalg.norm(uv_new - uv_last, axis=1)))

    return decide_from_metrics(
        criteria,
        n_tracked=len(tracked_points),
        median_parallax_deg=med_par,
        median_displacement_px=med_disp,
        rotation_rad=rotation_rad,
        num_inliers=num_inliers,
        num_last_features=num_last_features,
    )
