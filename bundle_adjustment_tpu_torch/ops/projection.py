"""Pinhole projection and epipolar distances (port of
``bundle_adjustment_tpu.ops.projection``).  Functions broadcast over leading
batch dims."""

from __future__ import annotations

import torch

from bundle_adjustment_tpu_torch.ops.lie import so3_exp


def project(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor):
    """Project world points X (..., N, 3) through [R|t] and K.  Returns
    (uv (..., N, 2), depth z (..., N))."""
    Xc = torch.matmul(X, torch.swapaxes(R, -1, -2)) + t[..., None, :]
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    x = Xc[..., 0] / z_safe
    y = Xc[..., 1] / z_safe
    u = K[0, 0] * x + K[0, 2]
    v = K[1, 1] * y + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def project_rvec(K, rvec, tvec, X):
    """Rotation-vector parameterised projection (cv2.projectPoints form)."""
    return project(K, so3_exp(rvec), tvec, X)


def pixel_to_normalized(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized camera coordinates (undistorted pinhole)."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], dim=-1)


def sampson_distance(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order (Sampson) epipolar distance in normalized units:
    (x2ᵀ E x1)² / (‖(E x1)₀₁‖² + ‖(Eᵀ x2)₀₁‖²)."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    Ep1 = torch.matmul(p1, torch.swapaxes(E, -1, -2))
    Etp2 = torch.matmul(p2, E)
    err = torch.sum(p2 * Ep1, dim=-1)
    denom = (Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2
             + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2).clamp(min=1e-12)
    return err * err / denom


def epipolar_errors_px(E, K, uv1, uv2):
    """Sampson distance in squared pixels via the mean focal length."""
    f = (K[0, 0] + K[1, 1]) * 0.5
    x1 = pixel_to_normalized(K, uv1)
    x2 = pixel_to_normalized(K, uv2)
    return sampson_distance(E, x1, x2) * (f * f)
