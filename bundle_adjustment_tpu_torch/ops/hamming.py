"""Binary-descriptor 2-NN matching (port of ``bundle_adjustment_tpu.ops.hamming``).

Descriptors are 256 bits packed into 8 words per row.  The JAX package keeps
them as uint32; the port keeps the same bits as ``int32`` (torch's uint32
support is thin), so shifts below mask with ``& 1`` after every right shift
and are independent of sign extension.

- ``hamming_matrix`` / ``knn2``: the plain path (unpack -> matmul ->
  two-pass top-2), the oracle of the fused kernel.
- ``match``: 2-NN + ratio test (+ optional crosscheck) through the fused
  Hamming 2-NN kernel wrapper (``ops/hamming_kernel.py``), which launches
  the CUDA kernel on a CUDA tensor and runs the plain path on a CPU tensor.

Invalid slots are masked with a sentinel distance rather than filtered.
"""

from __future__ import annotations

import torch

#: sentinel distance for masked-out descriptor slots (max real distance is 256)
INVALID_DIST = 1e9


def pack_u8_to_u32(descriptors_u8: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 descriptors -> (N, 8) int32 words (little-endian; the
    bit pattern of the JAX package's uint32 lanes)."""
    d = descriptors_u8.to(torch.int64).reshape(*descriptors_u8.shape[:-1], 8, 4)
    w = d[..., 0] | (d[..., 1] << 8) | (d[..., 2] << 16) | (d[..., 3] << 24)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_bits(descriptors_u32: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 256) float32 bit matrix (0.0 / 1.0)."""
    shifts = torch.arange(32, dtype=torch.int32, device=descriptors_u32.device)
    bits = (descriptors_u32[..., :, None] >> shifts) & 1
    return bits.reshape(*descriptors_u32.shape[:-1], 256).to(torch.float32)


def hamming_matrix_popcount(d1_u32: torch.Tensor, d2_u32: torch.Tensor) -> torch.Tensor:
    """Direct popcount(XOR) distance matrix, int32 (N1, N2); O(N1 N2) memory,
    a test oracle."""
    from bundle_adjustment_tpu_torch.ops.ann import popcount32

    return popcount32(d1_u32[:, None, :] ^ d2_u32[None, :, :]).sum(-1).to(torch.int32)


def hamming_matrix(d1_u32: torch.Tensor, d2_u32: torch.Tensor) -> torch.Tensor:
    """distance = |a| + |b| - 2 a.b over unpacked bits, float32 (N1, N2).
    Every term is an integer <= 256, so the float32 product is exact."""
    b1 = unpack_bits(d1_u32)
    b2 = unpack_bits(d2_u32)
    pop1 = torch.sum(b1, dim=-1)
    pop2 = torch.sum(b2, dim=-1)
    inner = torch.matmul(b1, b2.T)
    return pop1[:, None] + pop2[None, :] - 2.0 * inner


def _top2_rows(D: torch.Tensor):
    """Per-row (best_dist, best_idx, second_dist); first index on ties."""
    best_idx = torch.argmin(D, dim=1)
    best = torch.gather(D, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(D.shape[1], device=D.device)[None, :]
    D2 = torch.where(cols == best_idx[:, None], torch.inf, D)
    second = torch.min(D2, dim=1).values
    return best, best_idx.to(torch.int32), second


def knn2(d1_u32, d2_u32, valid1=None, valid2=None):
    """2-NN of every query against the train set (plain path).  Invalid
    train slots score INVALID_DIST; invalid query slots get INVALID_DIST."""
    D = hamming_matrix(d1_u32, d2_u32)
    if valid2 is not None:
        D = torch.where(valid2[None, :], D, INVALID_DIST)
    best, best_idx, second = _top2_rows(D)
    if valid1 is not None:
        best = torch.where(valid1, best, INVALID_DIST)
        second = torch.where(valid1, second, INVALID_DIST)
    return best, best_idx, second


def ratio_test_mask(best, second, ratio: float):
    """Lowe's ratio gate, strict: best < ratio * second."""
    return (best < ratio * second) & (best < INVALID_DIST)


def crosscheck_mask(best_idx_12, best_idx_21):
    """Mutual-best-match gate."""
    n1 = best_idx_12.shape[0]
    back = best_idx_21[best_idx_12.long()]
    return back == torch.arange(n1, dtype=best_idx_12.dtype,
                                device=best_idx_12.device)


def match(d1_u32, d2_u32, valid1, valid2, ratio: float = 0.75,
          cross_check: bool = False):
    """2-NN + ratio test (+ optional crosscheck) through the fused kernel
    wrapper.  Returns (match_idx, match_mask, best_dist), each (N1,)."""
    from bundle_adjustment_tpu_torch.ops.hamming_kernel import knn2_fused

    best, best_idx, second = knn2_fused(d1_u32, d2_u32, valid2)
    best = torch.where(valid1, best, INVALID_DIST)
    second = torch.where(valid1, second, INVALID_DIST)
    mask = ratio_test_mask(best, second, ratio)
    if cross_check:
        _, best_idx_21, _ = knn2_fused(d2_u32, d1_u32, valid1)
        mask = mask & crosscheck_mask(best_idx, best_idx_21)
    return best_idx, mask, best
