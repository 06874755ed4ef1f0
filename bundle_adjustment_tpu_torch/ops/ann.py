"""Approximate nearest-neighbour descriptor search, coarse to fine (port of
``bundle_adjustment_tpu.ops.ann``).

Two stages, both dense:

  coarse: the Hamming distance over the first ``coarse_lanes`` of the 8
    descriptor words (64 of 256 bits by default) against the whole bank, a
    0/1 bit product with float32 accumulation (exact integers <= 64); the
    ``k_candidates`` nearest per query, ties to the lower bank index as
    ``lax.top_k`` orders them;
  fine: the exact 256-bit popcount of the XOR on those candidates only; the
    first minimum wins, as ``jnp.argmin`` picks it.

The approximation is only in which candidates reach the fine stage.  Used
for banks above ``reloc_ann_threshold`` descriptors (relocalization, loop
detection); smaller banks go through the exact Hamming 2-NN (``ops/hamming``,
the K1 kernel on the card).  Plain PyTorch on any device: the JAX package
computes this with ``jnp`` too, not with a Pallas kernel.

Queries are taken in chunks so that the (chunk, M) coarse distances and
their int64 sort keys stay bounded; each query's result depends on its own
row only, so any chunk size gives the same result.
"""

from __future__ import annotations

import torch

from bundle_adjustment_tpu_torch.ops import hamming

#: the largest (queries x bank) block of coarse distances made at once: 2^25
#: elements, 128 MB of float32 distances and 256 MB of int64 keys
MAX_BLOCK = 1 << 25


def _lane_bits(d: torch.Tensor, lanes: int) -> torch.Tensor:
    """The first ``lanes`` words of (N, 8) int32 descriptors as an (N, 32 *
    lanes) float32 0/1 bit matrix."""
    shifts = torch.arange(32, dtype=torch.int32, device=d.device)
    bits = (d[:, :lanes, None] >> shifts) & 1
    return bits.reshape(d.shape[0], -1).to(torch.float32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as int64), sign bit included."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _knn2_block(q, bank, bank_bits, pop_b, bank_valid, k: int, lanes: int):
    M = bank.shape[0]
    qb = _lane_bits(q, lanes)
    d_coarse = qb.sum(1)[:, None] + pop_b[None, :] - 2.0 * (qb @ bank_bits.T)
    if bank_valid is not None:
        d_coarse = torch.where(bank_valid[None, :], d_coarse, hamming.INVALID_DIST)
    # unique int64 keys (distance, index): the k smallest in lax.top_k's order
    key = d_coarse.to(torch.int64) * M + torch.arange(M, device=q.device)[None, :]
    cand = torch.topk(key, k, dim=1, largest=False, sorted=True).indices     # (n, k)

    x = q[:, None, :] ^ bank[cand]                                           # (n, k, 8)
    d_fine = popcount32(x).sum(-1).to(torch.float32)
    if bank_valid is not None:
        d_fine = torch.where(bank_valid[cand], d_fine, hamming.INVALID_DIST)
    best_pos = torch.argmin(d_fine, dim=1)
    best = torch.gather(d_fine, 1, best_pos[:, None])[:, 0]
    best_idx = torch.gather(cand, 1, best_pos[:, None])[:, 0]
    cols = torch.arange(k, device=q.device)[None, :]
    second = torch.where(cols == best_pos[:, None], torch.inf, d_fine).min(1).values
    return best, best_idx.to(torch.int32), second


def knn2_coarse_fine(query: torch.Tensor, bank: torch.Tensor,
                     bank_valid: torch.Tensor | None = None,
                     k_candidates: int = 32, coarse_lanes: int = 2):
    """Approximate 2-NN of each (N, 8) int32 query against the (M, 8) bank:
    (best_dist f32, best_idx i32, second_dist f32), each (N,), the contract
    of ``hamming.knn2`` (invalid bank slots at INVALID_DIST).  ``best`` and
    ``second`` are exact 256-bit distances of the re-ranked candidates."""
    N, M = query.shape[0], bank.shape[0]
    k = min(k_candidates, M)
    bank_bits = _lane_bits(bank, coarse_lanes)
    pop_b = bank_bits.sum(1)
    rows = max(1, MAX_BLOCK // max(M, 1))
    parts = [_knn2_block(query[i: i + rows], bank, bank_bits, pop_b, bank_valid, k,
                         coarse_lanes) for i in range(0, max(N, 1), rows)]
    return tuple(torch.cat(p) for p in zip(*parts))


def match_bank(query, bank, bank_valid=None, ratio: float = 0.75, k_candidates: int = 32):
    """Ratio-tested approximate match against a large bank: (match_idx,
    match_mask, best_dist), as ``hamming.match`` returns them."""
    best, idx, second = knn2_coarse_fine(query, bank, bank_valid, k_candidates=k_candidates)
    return idx, hamming.ratio_test_mask(best, second, ratio), best
