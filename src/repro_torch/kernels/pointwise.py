"""Elementwise activation, and row RMSNorm, over float32 tensors.

:func:`pointwise` replaces the Pallas kernel
``src/repro/kernels/pointwise.py:pointwise``. On a CUDA tensor it
launches ``csrc/pointwise.cu`` (16-byte vectors, grid-stride, every key
of ``ref.ACTIVATIONS``) as :func:`_plan` lays it out; on a CPU tensor it
runs :func:`repro_torch.kernels.ref.pointwise`. Any other activation name
raises ``ValueError`` on both paths; an empty tensor returns an empty
result with no launch. Bound on the H100: bytes.

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
                     check_operand, launch, sm_count)

launches = LaunchCounter()
plain = ref.pointwise
rmsnorm_launches = LaunchCounter()

THREADS = 256           # csrc/pointwise.cu kThreads
BLOCKS_PER_SM = 8       # 2048 resident threads an SM / THREADS


def _plan(n: int, x_ptr: int, y_ptr: int, sms: int) -> tuple[int, int, int]:
    """(head, nvec, blocks) of ``csrc/pointwise.cu`` for ``n`` floats
    from address ``x_ptr`` to ``y_ptr`` on a card of ``sms`` SMs.

    When x and y lie at the same offset from a 16-byte boundary, the
    first ``head`` (< 4) elements bring both to it and ``nvec`` float4s
    follow; else nvec is 0 and every element is a scalar. The grid is
    one thread per float4 (or scalar) up to one full wave of
    BLOCKS_PER_SM blocks on every SM: a larger array is walked
    grid-stride, two float4s a thread an iteration, and a smaller one
    runs on as many threads as it has float4s (its time is latency)."""
    head = nvec = 0
    if x_ptr % 16 == y_ptr % 16:
        head = min(n, (-x_ptr % 16) // 4)
        nvec = (n - head) // 4
    blocks = -(-(nvec or n) // THREADS)
    return head, nvec, max(1, min(blocks, sms * BLOCKS_PER_SM))


def pointwise(x: torch.Tensor, act: str = "hardswish") -> torch.Tensor:
    if not x.is_cuda:
        return plain(x, act)
    code = act_code(act)
    dev = x.device
    check_operand("x", x, dev)
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    xp, yp = x.data_ptr(), y.data_ptr()
    head, nvec, blocks = _plan(n, xp, yp, sm_count(dev))
    launch("repro_pointwise_f32", dev, xp, yp, n, head, nvec, code, blocks)
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
