"""Integer nearest-neighbour upsample over NHWC.

Replaces the Pallas kernel ``src/repro/kernels/resize.py:resize_nearest``.
On a CUDA tensor the wrapper launches ``csrc/resize.cu`` (each input
vector read once and written to its s² copies) as :func:`_plan` lays it
out; on a CPU tensor it runs :func:`repro_torch.kernels.ref.
resize_nearest`. An empty tensor returns an empty result with no launch.
Bound on the H100: bytes.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import LaunchCounter, check_operand, launch

launches = LaunchCounter()
plain = ref.resize_nearest

MAX_THREADS = 256
MAX_GRID_Y = 65535      # CUDA's limit on gridDim.y


def _plan(N: int, H: int, W: int, C: int,
          aligned: bool) -> tuple[int, int, int, int]:
    """(vec, threads, gx, gy) of ``csrc/resize.cu`` for an (N, H, W, C)
    input (N·H > 0). ``vec`` (float4 vectors) when C % 4 == 0 and both
    pointers are 16-byte ``aligned``, else one float at a time; a block
    row of ``threads`` (whole warps, at most MAX_THREADS) and ``gx`` of
    them cover one input row's vectors; ``gy`` blocks walk the N·H rows
    (grid-stride past MAX_GRID_Y)."""
    vec = aligned and C % 4 == 0
    row = W * (C // 4 if vec else C)
    threads = min(MAX_THREADS, -(-row // 32) * 32)
    return int(vec), threads, -(-row // threads), min(N * H, MAX_GRID_Y)


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
    if y.numel() == 0:
        return y
    xp, yp = x.data_ptr(), y.data_ptr()
    launch("repro_resize_nearest_nhwc_f32", dev, xp, yp, N, H, W, C, s,
           *_plan(N, H, W, C, (xp | yp) % 16 == 0))
    launches.add()
    return y
