"""SAME-padded NHWC max pool with an optional epilogue activation.

Replaces the Pallas kernel ``src/repro/kernels/maxpool.py:maxpool2d``.
On a CUDA tensor the wrapper launches ``csrc/maxpool.cu`` (one thread per
output element, out-of-image taps counted as ``finfo.min``, bit-equal to
the plain version); on a CPU tensor it runs
:func:`repro_torch.kernels.ref.maxpool2d`. Bound on the H100: bytes.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import LaunchCounter, act_code, check_operand, launch

launches = LaunchCounter()
plain = ref.maxpool2d


def maxpool2d(x: torch.Tensor, *, k: int = 2, stride: int | None = None,
              act: str = "identity") -> torch.Tensor:
    """x: (N, H, W, C) → (N, ceil(H/s), ceil(W/s), C)."""
    if not x.is_cuda:
        return plain(x, k=k, stride=stride, act=act)
    code = act_code(act)
    stride = int(stride or k)
    dev = x.device
    check_operand("x", x, dev)
    N, H, W, C = x.shape
    Ho, pad_top, _ = ref.same_pads(H, k, stride)
    Wo, pad_left, _ = ref.same_pads(W, k, stride)
    y = torch.empty((N, Ho, Wo, C), device=dev, dtype=torch.float32)
    launch("repro_maxpool2d_nhwc_f32", dev, x.data_ptr(), y.data_ptr(),
           N, H, W, C, int(k), stride, Ho, Wo, pad_top, pad_left, code)
    launches.add()
    return y
