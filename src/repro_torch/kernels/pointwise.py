"""Elementwise activation over a float32 tensor of any shape.

Replaces the Pallas kernel ``src/repro/kernels/pointwise.py:pointwise``.
On a CUDA tensor the wrapper launches ``csrc/pointwise.cu`` (grid-stride,
every key of ``ref.ACTIVATIONS``); on a CPU tensor it runs
:func:`repro_torch.kernels.ref.pointwise`. Any other activation name
raises ``ValueError`` on both paths. Bound on the H100: bytes.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import LaunchCounter, act_code, check_operand, launch

launches = LaunchCounter()
plain = ref.pointwise


def pointwise(x: torch.Tensor, act: str = "hardswish") -> torch.Tensor:
    if not x.is_cuda:
        return plain(x, act)
    code = act_code(act)
    dev = x.device
    check_operand("x", x, dev)
    y = torch.empty_like(x)
    launch("repro_pointwise_f32", dev, x.data_ptr(), y.data_ptr(),
           x.numel(), code)
    launches.add()
    return y
