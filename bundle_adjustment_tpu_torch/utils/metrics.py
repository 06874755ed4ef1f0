"""Trajectory metrics: similarity alignment and absolute trajectory error.

The reference validates trajectories visually (plots) and externally against
COLMAP (SURVEY §4: the absent colmap_test.py).  Here ATE is first-class: the
estimated keyframe trajectory is aligned to ground truth with a similarity
transform (Umeyama — monocular scale is unobservable) and scored as RMSE,
the standard used by the north-star targets ("reference-parity ATE",
BASELINE.md).
"""

from __future__ import annotations

import numpy as np


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform: s, R, t minimizing
    ||dst - (s R src + t)||^2.  src, dst: (N, 3)."""
    assert src.shape == dst.shape and src.shape[0] >= 3
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(estimated: np.ndarray, ground_truth: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE) after similarity alignment."""
    s, R, t = umeyama_align(estimated, ground_truth, with_scale)
    aligned = (s * (R @ estimated.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - ground_truth) ** 2, axis=1))))
