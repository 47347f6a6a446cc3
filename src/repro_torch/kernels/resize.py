"""Integer nearest-neighbour upsample over NHWC.

Replaces the Pallas kernel ``src/repro/kernels/resize.py:resize_nearest``.
On a CUDA tensor the wrapper launches ``csrc/resize.cu`` (one thread per
output element); on a CPU tensor it runs
:func:`repro_torch.kernels.ref.resize_nearest`. Bound on the H100: bytes.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import LaunchCounter, check_operand, launch

launches = LaunchCounter()
plain = ref.resize_nearest


def resize_nearest(x: torch.Tensor, *, scale: int = 2) -> torch.Tensor:
    """x: (N, H, W, C) → (N, sH, sW, C)."""
    if not x.is_cuda:
        return plain(x, scale=scale)
    s = int(scale)
    if s < 1:
        raise ValueError(f"scale={scale}: expected a positive integer")
    dev = x.device
    check_operand("x", x, dev)
    N, H, W, C = x.shape
    y = torch.empty((N, H * s, W * s, C), device=dev, dtype=torch.float32)
    check_operand("y", y, dev)
    launch("repro_resize_nearest_nhwc_f32", dev, x.data_ptr(), y.data_ptr(),
           N, H, W, C, s)
    launches.add()
    return y
