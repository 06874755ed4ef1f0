"""Fused Hamming 2-NN: the CUDA kernel's wrapper and its plain version.

Counterpart of ``bundle_adjustment_tpu.ops.hamming_pallas`` (K1).  The
kernel (``csrc/hamming_knn2.cu``) streams train descriptors past a running
(best, idx, second) per query and never stores the N1 x N2 matrix.

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


def knn2_plain(d1_u32, d2_u32, valid2=None):
    """Plain PyTorch version: (best f32, idx i32, second f32), each (N1,)."""
    return hamming.knn2(d1_u32, d2_u32, None, valid2)


def _check(d: torch.Tensor, what: str):
    if d.dtype != torch.int32 or d.ndim != 2 or d.shape[1] != 8:
        raise ValueError(f"{what}: expected (N, 8) int32 words, got "
                         f"{tuple(d.shape)} {d.dtype}")


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
    d1c, d2c, v2c = (d1_u32.contiguous(), d2_u32.contiguous(),
                     valid2.contiguous())
    best = torch.empty(n1, dtype=torch.float32, device=d1c.device)
    idx = torch.empty(n1, dtype=torch.int32, device=d1c.device)
    second = torch.empty(n1, dtype=torch.float32, device=d1c.device)
    fn = kernels.library_fn(NAME)
    stream = torch.cuda.current_stream(d1c.device).cuda_stream
    err = fn(d1c.data_ptr(), n1, d2c.data_ptr(), n2, v2c.data_ptr(),
             best.data_ptr(), idx.data_ptr(), second.data_ptr(), stream)
    kernels.check(NAME, err)
    kernels.LAUNCHES[NAME] += 1
    return best, idx, second
