"""ORB patch gather: the CUDA kernel's wrapper and its plain version.

Counterpart of ``bundle_adjustment_tpu.ops.orb_pallas`` (K2).  For each
keypoint b the output is the 40x40 window of the blurred level image at
(start_y[b], start_x[b]) minus 128, with pixels past the image edge reading
as 0 (so -128 after the shift) -- the zero-padded ``dynamic_slice`` path of
``orb._extract_patches``.  Exact in float32 on both paths.

``gather_patches40`` launches ``csrc/orb_gather.cu`` for CUDA tensors and
runs ``gather_patches40_plain`` for CPU tensors; nothing falls back from the
card to the plain path.
"""

from __future__ import annotations

import torch

from bundle_adjustment_tpu_torch import kernels

NAME = "orb_gather40"
SIDE = 40


def gather_patches40_plain(img: torch.Tensor, start_y: torch.Tensor,
                           start_x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (B, 40, 40) float32."""
    H, W = img.shape
    off = torch.arange(SIDE, device=img.device)
    ys = start_y.long()[:, None] + off[None, :]                 # (B, 40)
    xs = start_x.long()[:, None] + off[None, :]
    inside = (((ys >= 0) & (ys < H))[:, :, None]
              & ((xs >= 0) & (xs < W))[:, None, :])              # (B, 40, 40)
    vals = img[ys.clamp(0, H - 1)[:, :, None], xs.clamp(0, W - 1)[:, None, :]]
    return torch.where(inside, vals, torch.zeros((), dtype=img.dtype,
                                                 device=img.device)) - 128.0


def gather_patches40(img: torch.Tensor, start_y: torch.Tensor,
                     start_x: torch.Tensor) -> torch.Tensor:
    """img (H, W) float32, start_y/start_x (B,) int32 -> (B, 40, 40) float32.
    CUDA tensors launch the kernel; CPU tensors take the plain path."""
    if img.dtype != torch.float32 or img.ndim != 2:
        raise ValueError(f"img: expected (H, W) float32, got "
                         f"{tuple(img.shape)} {img.dtype}")
    for what, s in (("start_y", start_y), ("start_x", start_x)):
        if s.dtype != torch.int32 or s.ndim != 1:
            raise ValueError(f"{what}: expected (B,) int32, got "
                             f"{tuple(s.shape)} {s.dtype}")
    if start_y.shape != start_x.shape:
        raise ValueError("start_y and start_x differ in shape")
    devs = {img.device, start_y.device, start_x.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    if img.device.type == "cpu":
        return gather_patches40_plain(img, start_y, start_x)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    H, W = img.shape
    B = start_y.shape[0]
    imgc, syc, sxc = img.contiguous(), start_y.contiguous(), start_x.contiguous()
    out = torch.empty((B, SIDE, SIDE), dtype=torch.float32, device=img.device)
    fn = kernels.library_fn(NAME)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = fn(imgc.data_ptr(), H, W, syc.data_ptr(), sxc.data_ptr(), B,
             out.data_ptr(), stream)
    kernels.check(NAME, err)
    kernels.count_launch(NAME)
    return out
