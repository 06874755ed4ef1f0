"""Minimal 5-point essential-matrix solver (port of
``bundle_adjustment_tpu.ops.five_point``): Stewenius' action-matrix
formulation, batched over samples, with the real eigenvalues of the 10x10
action matrix found by Ehrlich-Aberth iteration in complex arithmetic
(complex64 for float32 inputs, on the CPU and on CUDA alike)."""

from __future__ import annotations

import math

import numpy as np
import torch

_L1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]                # x, y, z, 1
_L2 = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]                                                                  # quotient basis
_D3 = [
    (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
    (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3),
]
_L3 = _D3 + _L2                                                    # 20 columns


def _mul_table(a_basis, b_basis, out_basis):
    T = np.zeros((len(a_basis), len(b_basis), len(out_basis)), np.float32)
    index = {m: k for k, m in enumerate(out_basis)}
    for i, ma in enumerate(a_basis):
        for j, mb in enumerate(b_basis):
            m = (ma[0] + mb[0], ma[1] + mb[1], ma[2] + mb[2])
            T[i, j, index[m]] = 1.0
    return T


_T11 = _mul_table(_L1, _L1, _L2)   # (4, 4, 10)
_T21 = _mul_table(_L2, _L1, _L3)   # (10, 4, 20)
_ACTION_D3_ROWS = (0, 1, 2, 3, 4, 5)
_ABERTH_ITERS = 40


def _constraint_matrix(Ep, T11, T21):
    """Ep: (S, 3, 3, 4) polynomial essential matrices -> M (S, 10, 20)."""
    EEt = torch.einsum("sika,sjkb,abm->sijm", Ep, Ep, T11)
    EEtE = torch.einsum("sikm,skja,mab->sijb", EEt, Ep, T21)
    tr = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    trE = torch.einsum("sm,sija,mab->sijb", tr, Ep, T21)
    C = 2.0 * EEtE - trE

    def pmul11(a, b):
        return torch.einsum("si,sj,ijk->sk", a, b, T11)

    def pmul21(a, b):
        return torch.einsum("si,sj,ijk->sk", a, b, T21)

    def minor(r1, r2, c1, c2):
        return (pmul11(Ep[:, r1, c1], Ep[:, r2, c2])
                - pmul11(Ep[:, r1, c2], Ep[:, r2, c1]))

    det = (pmul21(minor(1, 2, 1, 2), Ep[:, 0, 0])
           - pmul21(minor(1, 2, 0, 2), Ep[:, 0, 1])
           + pmul21(minor(1, 2, 0, 1), Ep[:, 0, 2]))
    return torch.cat([det[:, None, :], C.reshape(-1, 9, 20)], dim=1)


def _action_matrix(x1, x2):
    """Minimal samples (S, 5, 2) x2 -> (A_x (S, 10, 10), basis (S, 4, 3, 3))."""
    dt, dev = x1.dtype, x1.device
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    A = (p2[..., :, None] * p1[..., None, :]).reshape(-1, 5, 9)
    AtA = torch.matmul(A.transpose(-1, -2), A)
    _, vecs = torch.linalg.eigh(AtA)
    basis = vecs[..., :4].transpose(-1, -2).reshape(-1, 4, 3, 3)
    Ep = basis.permute(0, 2, 3, 1)                       # (S, 3, 3, 4)
    T11 = torch.as_tensor(_T11, dtype=dt, device=dev)
    T21 = torch.as_tensor(_T21, dtype=dt, device=dev)
    M = _constraint_matrix(Ep, T11, T21)
    M1, M2 = M[..., :10], M[..., 10:]
    eye10 = torch.eye(10, dtype=dt, device=dev)
    B = torch.linalg.solve_ex(M1 + 1e-12 * eye10, M2)[0]
    S = x1.shape[0]
    Ax = torch.zeros((S, 10, 10), dtype=dt, device=dev)
    for i, r in enumerate(_ACTION_D3_ROWS):
        Ax[:, i] = -B[:, r]
    Ax[:, 6, 0] = 1.0
    Ax[:, 7, 1] = 1.0
    Ax[:, 8, 2] = 1.0
    Ax[:, 9, 6] = 1.0
    return Ax, basis


def _tr_inv_complex(Ax, z):
    """tr((Ax - z I)^-1) for complex shifts z (S, 10) via the real 20x20
    block embedding [[X, -Y], [Y, X]] of X + iY."""
    eye = torch.eye(10, dtype=Ax.dtype, device=Ax.device)
    a = z.real
    b = z.imag
    X = Ax[:, None] - a[..., None, None] * eye
    Yb = -b[..., None, None] * eye
    top = torch.cat([X, -Yb], dim=-1)
    bot = torch.cat([Yb, X], dim=-1)
    Kmat = torch.cat([top, bot], dim=-2)                     # (S, 10, 20, 20)
    eye20 = torch.eye(20, dtype=Ax.dtype, device=Ax.device)
    Kinv = torch.linalg.inv_ex(Kmat + 1e-20 * eye20)[0]
    tr_re = torch.diagonal(Kinv[..., :10, :10], dim1=-2, dim2=-1).sum(-1)
    tr_im = torch.diagonal(Kinv[..., 10:, :10], dim1=-2, dim2=-1).sum(-1)
    return torch.complex(tr_re, tr_im)


def _fill(cond, value, x):
    """torch.where(cond, value, x) for a complex x and a real scalar value."""
    return torch.where(cond, torch.full_like(x, value), x)


def _real_eigs(Ax):
    """All real eigenvalues of a batch of 10x10 matrices by Ehrlich-Aberth
    on det(Ax - zI).  Returns (roots (S, 10), valid (S, 10))."""
    s = torch.amax(torch.sum(torch.abs(Ax), dim=-1), dim=-1) + 1e-6     # (S,)
    cdtype = torch.complex128 if Ax.dtype == torch.float64 else torch.complex64
    k = torch.arange(10, device=Ax.device, dtype=Ax.dtype)
    phase = 2.0 * math.pi * (k + 0.35) / 10.0
    z = (s[:, None] * 0.9).to(cdtype) * torch.polar(torch.ones_like(phase), phase).to(cdtype)
    off_diag = ~torch.eye(10, dtype=torch.bool, device=Ax.device)
    for _ in range(_ABERTH_ITERS):
        tr = _tr_inv_complex(Ax, z)
        tr_safe = _fill(torch.abs(tr) < 1e-14, 1e-14, tr)
        newton = -1.0 / tr_safe
        newton = _fill(~torch.isfinite(newton), 0.0, newton)
        diff = z[:, :, None] - z[:, None, :]
        diff = _fill(torch.abs(diff) < 1e-12, 1e-12, diff)
        inv = 1.0 / diff
        sums = torch.sum(_fill(~off_diag, 0.0, inv), dim=-1)
        denom = 1.0 - newton * sums
        denom = _fill(torch.abs(denom) < 1e-12, 1e-12, denom)
        corr = newton / denom
        corr = _fill(~torch.isfinite(corr), 0.0, corr)
        mag = torch.abs(corr)
        lim = 0.5 * s[:, None]
        scale = torch.where(mag > lim, lim / mag, torch.ones_like(mag))
        corr = torch.where(mag > lim, corr * scale.to(cdtype), corr)
        z = z - corr
    lam = z.real
    valid = (torch.abs(z.imag) < 1e-4 * s[:, None]) & torch.isfinite(lam)
    return lam, valid


def five_point_candidates(x1_samples, x2_samples):
    """Batched minimal solves.  x*_samples: (S, 5, 2) normalized coords.
    Returns (Es (S, 10, 3, 3), valid (S, 10))."""
    Ax, basis = _action_matrix(x1_samples, x2_samples)
    roots, valid = _real_eigs(Ax)
    eye = torch.eye(10, dtype=Ax.dtype, device=Ax.device)
    # eigenvector per root: null vector of (Ax - t I) via SVD
    _, _, Vt = torch.linalg.svd(Ax[:, None] - roots[..., None, None] * eye)
    vs = Vt[..., -1, :]                                          # (S, 10, 10)
    w = vs[..., 9]
    w_safe = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    xs = vs[..., 6] / w_safe
    ys = vs[..., 7] / w_safe
    zs = vs[..., 8] / w_safe
    valid = valid & (torch.abs(w) > 1e-10)
    Es = (xs[..., None, None] * basis[:, None, 0]
          + ys[..., None, None] * basis[:, None, 1]
          + zs[..., None, None] * basis[:, None, 2]
          + basis[:, None, 3])                                   # (S, 10, 3, 3)
    U, _, Vt3 = torch.linalg.svd(Es)
    sv = torch.tensor([1.0, 1.0, 0.0], dtype=Es.dtype, device=Es.device)
    Es = torch.matmul(U * sv, Vt3)
    return Es, valid
