"""Device selection and float32 numerics for the port.

Every entry point takes ``device`` (default ``"cuda"``) and resolves it
here.  A CUDA device with no card present raises: the port never moves
itself to the CPU.  The CPU is used only when the caller asks for it, as the
tests do.
"""

from __future__ import annotations

import functools

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def set_float32_numerics() -> None:
    """Full float32 products and convolutions on the card.  The JAX package
    runs its geometry at Precision.HIGHEST; cuDNN's default TF32 keeps about
    three decimal digits, which would cost whole pixels at 4-digit pixel
    coordinates.  Both flags are process-wide PyTorch settings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """The tensor of ``values`` (nested tuples), made once per (values, dtype,
    device) and shared: a copy from pageable host memory cannot be captured
    into a CUDA graph, so code that a graph replays takes its small
    constants from here, made on the eager warm-up call.  Callers must not
    write to it."""
    return torch.tensor(values, dtype=dtype, device=device)
