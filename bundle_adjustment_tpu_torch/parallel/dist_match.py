"""Descriptor matching split over ranks (port of
``bundle_adjustment_tpu.parallel.dist_match``), with the Hamming 2-NN
kernel (K1, ``ops/hamming_kernel.knn2_fused``) on each rank's block.

- ``match_sharded``: the queries split over a mesh axis, the train bank
  replicated; no collective but the exchange that gives every rank the
  whole result.
- ``match_ring``: the train bank split over the axis; each rank matches all
  queries against the block it holds, folds the running top-2 and passes
  the block to its neighbour, so no rank ever holds more than one block.
  The rotation is a point-to-point exchange (``batch_isend_irecv``): with
  NCCL the blocks move card to card; gloo has no point-to-point on CUDA
  tensors, so under gloo each block is copied to host memory, exchanged
  there and copied back to the card, explicitly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from bundle_adjustment_tpu_torch.ops import hamming
from bundle_adjustment_tpu_torch.ops.hamming_kernel import knn2_fused
from bundle_adjustment_tpu_torch.parallel import dist_ba, mesh as mesh_mod


def match_sharded(d1, d2, valid1, valid2, mesh, axis: str = "win", ratio: float = 0.75):
    """2-NN and ratio test of the queries ``d1`` (N1, 8) against the bank
    ``d2`` with the queries split into equal blocks over ``axis`` (N1 must
    divide by its size), each rank launching K1 on its block.  Returns
    (idx, mask, best) over all queries, as ``hamming.match``, on every
    rank."""
    n = mesh_mod.shape(mesh)[axis]
    s = mesh_mod.axis_index(mesh, axis)
    n1 = d1.shape[0]
    if n1 % n:
        raise ValueError(f"{n1} queries do not split over {n} ranks")
    q = n1 // n
    sel = slice(s * q, (s + 1) * q)
    best, idx, second = knn2_fused(d1[sel], d2, valid2)
    best = torch.where(valid1[sel], best, hamming.INVALID_DIST)
    second = torch.where(valid1[sel], second, hamming.INVALID_DIST)
    mask = hamming.ratio_test_mask(best, second, ratio)
    out_i = torch.zeros((2, n1), dtype=torch.int32, device=d1.device)
    out_i[0, sel], out_i[1, sel] = idx, mask.to(torch.int32)
    out_b = torch.zeros(n1, dtype=torch.float32, device=d1.device)
    out_b[sel] = best
    group = mesh_mod.axis_group(mesh, axis)
    out_i, out_b = dist_ba.exchange(out_i, group), dist_ba.exchange(out_b, group)
    return out_i[0], out_i[1].bool(), out_b


def _rotate(tensors, group, to_rank: int, from_rank: int, through_host: bool):
    """Send each tensor to global rank ``to_rank`` and receive its
    replacement from ``from_rank``; under gloo through host memory."""
    dev = tensors[0].device
    send = [t.cpu() if through_host else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for a, b in zip(send, recv):
        ops += [dist.P2POp(dist.isend, a, to_rank, group),
                dist.P2POp(dist.irecv, b, from_rank, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(dev) for b in recv] if through_host else recv


def match_ring(d1, d2, valid2, mesh, axis: str = "pt", ratio: float = 0.75):
    """2-NN and ratio test of the queries ``d1`` (replicated) against a bank
    split over ``axis``: ``d2``, ``valid2`` are this rank's block (equal
    blocks, block s holding train rows [s * B, (s + 1) * B)).  At step i the
    rank holding block src = (s + i) % n launches K1 against it, folds the
    result into its running (best, idx, second) exactly as the JAX package
    does (a block's best is taken on strict '<', so ties keep the block seen
    first), and passes the block to rank s - 1.  Returns (idx, mask, best)
    with global train indices; rank 0 sees the blocks in order and so equals
    one K1 call over the whole bank, exactly."""
    n = mesh_mod.shape(mesh)[axis]
    s = mesh_mod.axis_index(mesh, axis)
    group = mesh_mod.axis_group(mesh, axis)
    ranks = dist.get_process_group_ranks(group)
    through_host = dist.get_backend(group) == "gloo" and d2.device.type == "cuda"
    block = d2.shape[0]
    n1 = d1.shape[0]
    best = torch.full((n1,), float("inf"), dtype=torch.float32, device=d1.device)
    second = torch.full_like(best, float("inf"))
    bidx = torch.zeros(n1, dtype=torch.int32, device=d1.device)
    blk_desc, blk_valid = d2, valid2
    for i in range(n):
        src = (s + i) % n
        b, bi, sec = knn2_fused(d1, blk_desc, blk_valid)
        take = b < best
        bidx = torch.where(take, bi + src * block, bidx)
        second = torch.where(take, torch.minimum(best, sec), torch.minimum(second, b))
        best = torch.where(take, b, best)
        if i + 1 < n:
            blk_desc, blk_valid = _rotate([blk_desc, blk_valid], group, ranks[(s - 1) % n],
                                          ranks[(s + 1) % n], through_host)
    return bidx, hamming.ratio_test_mask(best, second, ratio), best
