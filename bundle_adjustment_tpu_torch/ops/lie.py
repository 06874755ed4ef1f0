"""so(3)/SE(3) Lie-group operations: closed-form Rodrigues exp/log maps.

Port of ``bundle_adjustment_tpu.ops.lie``.  Functions broadcast over leading
dims, keep the input dtype, and use the same Taylor branches near
``theta = 0`` (both branches evaluated, then selected with ``torch.where``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-8


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: hat(w) @ v == cross(w, v)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> rotation matrix (Rodrigues), Taylor near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS))
    W = so3_hat(w)
    W2 = torch.matmul(W, W)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_exp_and_jac(w: torch.Tensor):
    """Rodrigues map and its analytic derivative: ``(R, dRdw)`` with
    ``dRdw[..., i, j, k] = dR_ij / dw_k`` (see the JAX docstring for the
    derivation)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - cos_t) / theta2.clamp(min=_EPS * _EPS))
    t3 = (theta2 * theta).clamp(min=_EPS ** 3)
    t4 = (theta2 * theta2).clamp(min=_EPS ** 4)
    ratio_a = torch.where(small, -1.0 / 3.0 + theta2 / 30.0,
                          (theta * cos_t - sin_t) / t3)
    ratio_b = torch.where(small, -1.0 / 12.0 + theta2 / 180.0,
                          (theta * sin_t - 2.0 * (1.0 - cos_t)) / t4)

    W = so3_hat(w)
    W2 = torch.matmul(W, W)
    R = _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2

    E = so3_hat(torch.eye(3, dtype=w.dtype, device=w.device))   # E[k] = hat(e_k)
    E = E.expand(w.shape[:-1] + (3, 3, 3))
    EW = torch.matmul(E, W[..., None, :, :])
    WE = torch.matmul(W[..., None, :, :], E)
    dR = (
        (ratio_a[..., None, None, None] * w[..., :, None, None]) * W[..., None, :, :]
        + a[..., None, None, None] * E
        + (ratio_b[..., None, None, None] * w[..., :, None, None]) * W2[..., None, :, :]
        + b[..., None, None, None] * (EW + WE)
    )
    return R, torch.movedim(dR, -3, -1)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector: generic, near-identity and near-pi
    regimes, as in the JAX package."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    vee = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-5
    near_pi = theta > math.pi - 1e-3
    sin_safe = torch.where(torch.abs(sin_t) < _EPS,
                           torch.full_like(sin_t, _EPS), sin_t)
    scale_generic = torch.where(small, 0.5 + theta * theta / 12.0,
                                theta / (2.0 * sin_safe))
    w_generic = scale_generic[..., None] * vee

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0)
    axis = torch.sqrt(axis2)
    s01 = torch.sign(R[..., 0, 1] + R[..., 1, 0])
    s02 = torch.sign(R[..., 0, 2] + R[..., 2, 0])
    s12 = torch.sign(R[..., 1, 2] + R[..., 2, 1])
    imax = torch.argmax(axis2, dim=-1)
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    anchor_x = torch.stack([ax, s01 * ay, s02 * az], dim=-1)
    anchor_y = torch.stack([s01 * ax, ay, s12 * az], dim=-1)
    anchor_z = torch.stack([s02 * ax, s12 * ay, az], dim=-1)
    axis_fixed = torch.where(
        (imax == 0)[..., None], anchor_x,
        torch.where((imax == 1)[..., None], anchor_y, anchor_z))
    norm = torch.linalg.norm(axis_fixed, dim=-1, keepdim=True).clamp(min=_EPS)
    w_pi = theta[..., None] * axis_fixed / norm
    return torch.where(near_pi[..., None], w_pi, w_generic)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude in radians (|so3_log(R)|, from the trace)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def compose_pose_reference(last_R, last_t, R_rel, t_rel):
    """The reference's pose composition (see the JAX docstring):
    world_R = last_R @ R_rel, world_t = last_t + last_R @ t_rel."""
    return (torch.matmul(last_R, R_rel),
            last_t + torch.matmul(last_R, t_rel[..., None])[..., 0])


def invert_rt(R, t):
    """Invert an [R|t] rigid transform: returns (R^T, -R^T t)."""
    Rt = torch.swapaxes(R, -1, -2)
    return Rt, -torch.matmul(Rt, t[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Host-side float64 twins (numpy) for map bookkeeping
# ---------------------------------------------------------------------------

def so3_exp_np(w):
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w)
    if theta < 1e-10:
        W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        return np.eye(3) + W
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def so3_log_np(R):
    R = np.asarray(R, np.float64)
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos_t)
    if theta < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    if theta > np.pi - 1e-6:
        A = (R + np.eye(3)) / 2
        axis = np.sqrt(np.clip(np.diag(A), 0, 1))
        i = int(np.argmax(axis))
        s = np.array([A[i, 0], A[i, 1], A[i, 2]])
        signs = np.sign(np.where(np.arange(3) == i, 1.0, s))
        axis = axis * signs
        return theta * axis / np.linalg.norm(axis)
    return theta / (2 * np.sin(theta)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )
