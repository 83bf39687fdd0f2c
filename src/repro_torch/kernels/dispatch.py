"""Which implementation of a kernel runs: decided by where the inputs lie.

A kernel wrapper runs the kernel's plain PyTorch version for CPU
tensors and launches the CUDA kernel for CUDA tensors.  There is no
mode switch and no fallback: a CUDA input that the kernel cannot take
raises rather than running the plain version on the card or the CPU.
"""

from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every input is a CUDA tensor, False when every one is on the CPU."""
    if all(t.is_cpu for t in tensors):
        return False
    index = tensors[0].get_device()
    if all(t.is_cuda and t.get_device() == index for t in tensors):
        return True
    raise ValueError(
        "kernel inputs must all lie on the CPU or all on one CUDA device, got "
        f"{sorted({str(t.device) for t in tensors})}"
    )


def backend_for(device: torch.device) -> str:
    """The filter backend for state on ``device``: the kernel path
    (``"pallas"``) on the card, the plain path (``"reference"``) elsewhere."""
    return "pallas" if device.type == "cuda" else "reference"


def require(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Check a kernel input's type and layout before its pointer is passed."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
