"""Fused Hamming 2-NN: the CUDA kernel's wrapper and its plain version.

Counterpart of ``bundle_adjustment_tpu.ops.hamming_pallas`` (K1).  The
kernel (``csrc/hamming_knn2.cu``) computes the distances on the tensor cores
as ``popc(a) + popc(b) - 2 popc(a AND b)`` and never stores the N1 x N2
matrix: a 2-D grid of query tiles x train splits (``split_plan``) folds a
running (best, idx, second) per query and split, and a second pass merges the
splits by ``merge_top2``'s rule.

``knn2_fused`` launches the kernel for CUDA tensors and runs ``knn2_plain``
(the matmul oracle, ``hamming.knn2``) for CPU tensors; nothing falls back
from the card to the plain path.

Invalid train slots score exactly INVALID_DIST in both versions, as in the
XLA oracle.  The Pallas kernel adds INVALID_DIST to the count instead
(hamming_pallas.py:49); the two differ only where best >= INVALID_DIST,
which the ratio test rejects either way.
"""

from __future__ import annotations

import torch

from bundle_adjustment_tpu_torch import kernels
from bundle_adjustment_tpu_torch.ops import hamming

NAME = "hamming_knn2"

#: queries per block: the kernel's kBlockQ, which its C entry checks
QUERY_TILE = 128
BLOCKS_PER_SM = 4

_sm_count: dict = {}


def split_plan(n1: int, n2: int, sm_count: int):
    """(splits, rows per split) of the train set: enough blocks to cover the
    card's ``sm_count`` SMs ``BLOCKS_PER_SM`` times, at least 8 train rows
    per split, no split empty."""
    q_tiles = max(1, -(-n1 // QUERY_TILE))
    splits = max(1, min(-(-n2 // 8), -(-BLOCKS_PER_SM * sm_count // q_tiles)))
    rows = -(-n2 // splits)
    return -(-n2 // rows), rows


def merge_top2(a, b):
    """The kernel's merge of two partial (best, idx, second) results, each
    three (N,) tensors: best is the lexicographic minimum of (best, idx),
    second the smallest of the other candidates' values.  The rule is
    independent of merge order and equals one scan of the whole train set
    with strict '<' (the first index of the minimum; a tie gives second ==
    best)."""
    (b1, i1, s1), (b2, i2, s2) = a, b
    take = (b2 < b1) | ((b2 == b1) & (i2 < i1))
    best = torch.where(take, b2, b1)
    idx = torch.where(take, i2, i1)
    second = torch.where(take, torch.minimum(b1, s2), torch.minimum(s1, b2))
    return best, idx, second


def knn2_plain(d1_u32, d2_u32, valid2=None):
    """Plain PyTorch version: (best f32, idx i32, second f32), each (N1,)."""
    return hamming.knn2(d1_u32, d2_u32, None, valid2)


def _check(d: torch.Tensor, what: str):
    if d.dtype != torch.int32 or d.ndim != 2 or d.shape[1] != 8:
        raise ValueError(f"{what}: expected (N, 8) int32 words, got "
                         f"{tuple(d.shape)} {d.dtype}")


def launch(d1: torch.Tensor, d2: torch.Tensor, valid2: torch.Tensor):
    """Launch the kernel on checked, contiguous CUDA inputs (n2 >= 1)."""
    n1, n2 = d1.shape[0], d2.shape[0]
    dev = d1.device
    sms = _sm_count.get(dev)
    if sms is None:
        sms = _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rows = split_plan(n1, n2, sms)
    # one allocation: the splits' partials, then best, idx and second (the
    # call is short enough for its allocations to show in its time)
    buf = torch.empty((3 * splits + 3) * n1, dtype=torch.int32, device=dev)
    part = buf[: 3 * splits * n1]
    best, idx, second = buf[3 * splits * n1:].view(3, n1)
    best, second = best.view(torch.float32), second.view(torch.float32)
    fn = kernels.library_fn(NAME)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(d1.data_ptr(), n1, d2.data_ptr(), n2, valid2.data_ptr(), splits, rows,
             part.data_ptr(), QUERY_TILE, best.data_ptr(), idx.data_ptr(),
             second.data_ptr(), stream)
    kernels.check(NAME, err)
    kernels.count_launch(NAME)
    return best, idx, second


def knn2_fused(d1_u32: torch.Tensor, d2_u32: torch.Tensor,
               valid2: torch.Tensor | None = None):
    """2-NN Hamming match.  d1 (N1, 8) / d2 (N2, 8) int32 words, valid2 (N2,)
    bool.  CUDA tensors launch the kernel; CPU tensors take the plain path."""
    _check(d1_u32, "d1")
    _check(d2_u32, "d2")
    n1, n2 = d1_u32.shape[0], d2_u32.shape[0]
    if valid2 is None:
        valid2 = torch.ones(n2, dtype=torch.bool, device=d2_u32.device)
    if valid2.dtype != torch.bool or valid2.shape != (n2,):
        raise ValueError(f"valid2: expected ({n2},) bool, got "
                         f"{tuple(valid2.shape)} {valid2.dtype}")
    devs = {d1_u32.device, d2_u32.device, valid2.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    if d1_u32.device.type == "cpu":
        return knn2_plain(d1_u32, d2_u32, valid2)
    if d1_u32.device.type != "cuda":
        raise ValueError(f"unsupported device {d1_u32.device}")
    if n2 < 1:
        raise ValueError("knn2 needs at least one train descriptor")
    return launch(d1_u32.contiguous(), d2_u32.contiguous(), valid2.contiguous())
