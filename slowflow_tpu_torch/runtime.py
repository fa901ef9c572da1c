"""Device selection. The port's entry points run on the card unless the
caller asks for the CPU; a CUDA path that finds no GPU raises, and nothing
falls back to the CPU behind the caller's back."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means CUDA. Only an explicit CPU device gives the CPU (where
    the kernels' plain twins run); a CUDA device without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested (the default) but "
                           f"torch finds no GPU (torch {torch.__version__}); "
                           "pass device='cpu' (the CLI: -device cpu) to run "
                           "the plain PyTorch twins on the CPU")
    return device


def device_of(x, device: str | torch.device | None = None) -> torch.device:
    """`device` if given, else the device of `x` when it is a tensor, else
    CUDA (resolved as `resolve_device` does: raises without a GPU)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def on_device(device: torch.device):
    """`torch.cuda.device(device)` for a CUDA device (the hand-written
    kernels launch on the calling thread's current device), else a no-op."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def as_f32(x, device: torch.device) -> torch.Tensor:
    """A contiguous float32 tensor on `device` from a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)


def kernels_available() -> bool:
    """Whether the hand-written kernels' library is built and loaded in this
    process. Reports only; it builds nothing and substitutes nothing."""
    from . import kernels

    return kernels.library_loaded()
