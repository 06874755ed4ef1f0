"""Batched DLT triangulation with two-sided cheirality masking (port of
``bundle_adjustment_tpu.ops.triangulation``).  Returns validity masks
instead of filtering, as the JAX package does."""

from __future__ import annotations

import torch

from bundle_adjustment_tpu_torch.ops import small_linalg


def camera_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = K [R | t], broadcasting over leading dims."""
    return torch.matmul(K, torch.cat([R, t[..., :, None]], dim=-1))


def triangulate_dlt(P1, P2, uv1, uv2):
    """Linear (DLT) triangulation of N correspondences via the null vector
    of each 4x4 system A (``small_linalg.null_vector``): on the CPU the
    smallest-eigenvalue eigenvector of A^T A from LAPACK, as the JAX
    package computes it there; on the card the SVD of A (cuSOLVER's
    gesvdj), as accurate as the TPU's Jacobi eigh of the JAX package, where
    cuSOLVER's eigh of A^T A left the DLT's residuals 6 to 7 times
    LAPACK's (PERF.md section 5).  Its sign cancels in the homogeneous
    divide."""
    u1, v1 = uv1[..., 0], uv1[..., 1]
    u2, v2 = uv2[..., 0], uv2[..., 1]
    A = torch.stack(
        [
            u1[:, None] * P1[2] - P1[0],
            v1[:, None] * P1[2] - P1[1],
            u2[:, None] * P2[2] - P2[0],
            v2[:, None] * P2[2] - P2[1],
        ],
        dim=-2,
    )
    Xh = small_linalg.null_vector(A)
    w = Xh[..., 3]
    w_safe = w + torch.where(w >= 0, 1e-6, -1e-6)
    return Xh[..., :3] / w_safe[..., None]


def cheirality_mask(R1, t1, R2, t2, X, max_depth: float = 1e6):
    """True where X is in front of both cameras and nearer than max_depth."""
    z1 = (X @ R1[2, :]) + t1[2]
    z2 = (X @ R2[2, :]) + t2[2]
    return (z1 > 0) & (z2 > 0) & (z1 < max_depth) & (z2 < max_depth)


def triangulate_pair(K, R_rel, t_rel, uv1, uv2):
    """Two-view triangulation in the first camera's frame: P1 = K[I|0],
    P2 = K[R_rel|t_rel].  Returns (X, valid_mask)."""
    eye = torch.eye(3, dtype=R_rel.dtype, device=R_rel.device)
    zero = torch.zeros(3, dtype=R_rel.dtype, device=R_rel.device)
    Kd = K.to(R_rel.dtype)
    P1 = camera_matrix(Kd, eye, zero)
    P2 = camera_matrix(Kd, R_rel, t_rel)
    X = triangulate_dlt(P1, P2, uv1, uv2)
    return X, cheirality_mask(eye, zero, R_rel, t_rel, X)
