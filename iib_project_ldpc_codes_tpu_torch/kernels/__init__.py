"""Hand-written CUDA kernels: build, binding and argument checks.

The wrappers in ``ops/`` decide by device alone: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the kernel (or an
exception).  No wrapper catches a kernel error and falls back.
"""

from __future__ import annotations

import functools

import torch

from .build import launch

__all__ = ["launch", "alignment", "check_int32", "l2_bytes", "use_kernel"]


def check_int32(name: str, t, ndim: int) -> torch.Tensor:
    """Raise unless ``t`` is a contiguous int32 tensor of rank ``ndim``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


def alignment(*tensors) -> int:
    """The largest power of two up to 16 that divides every data pointer."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


@functools.lru_cache(maxsize=None)
def l2_bytes(index: int) -> int:
    """The L2 cache of CUDA device ``index``, in bytes."""
    return torch.cuda.get_device_properties(index).L2_cache_size


def use_kernel(*items) -> bool:
    """True when the tensors (or devices) are on a CUDA device (launch the
    kernel), False when they are on the CPU (run the plain version).
    Raises on mixed devices and on any other device type."""
    devices = {i.device if isinstance(i, torch.Tensor) else torch.device(i)
               for i in items}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")
