"""Elementwise activation, and row RMSNorm, over float32 tensors.

:func:`pointwise` replaces the Pallas kernel
``src/repro/kernels/pointwise.py:pointwise``. On a CUDA tensor it
launches ``csrc/pointwise.cu`` (grid-stride, every key of
``ref.ACTIVATIONS``); on a CPU tensor it runs
:func:`repro_torch.kernels.ref.pointwise`. Any other activation name
raises ``ValueError`` on both paths. Bound on the H100: bytes.

:func:`rmsnorm` replaces ``src/repro/kernels/pointwise.py:rmsnorm``
(``_rms_kernel``): ``x·rsqrt(mean(x²) + eps)·(1 + g)`` over the last
axis, one block per row (``csrc/rmsnorm.cu``), counted on
``rmsnorm_launches``; on a CPU tensor :func:`ref.rmsnorm`. Bound on the
H100: bytes.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import (LaunchCounter, act_code, check_no_grad,
                     check_operand, launch)

launches = LaunchCounter()
plain = ref.pointwise
rmsnorm_launches = LaunchCounter()


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


def rmsnorm(x: torch.Tensor, g: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) float32; g: (D,). Any row count; D need not be a
    multiple of 4 (the kernel then reads one float at a time)."""
    if not x.is_cuda:
        return ref.rmsnorm(x, g, eps)
    check_no_grad(x, g)
    dev = x.device
    D = int(x.shape[-1])
    check_operand("x", x, dev)
    check_operand("g", g, dev, (D,))
    y = torch.empty_like(x)
    vec = D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, g, y))
    launch("repro_rmsnorm_f32", dev, x.data_ptr(), g.data_ptr(),
           y.data_ptr(), x.numel() // max(D, 1), D, float(eps), int(vec))
    rmsnorm_launches.add()
    return y
