"""SAME-padded NHWC conv with the fused ``act(conv + b) + res`` epilogue.

Replaces the two Pallas bodies of ``src/repro/kernels/conv2d.py:conv2d``:
the grid kernel (``_conv_kernel``, K² shifted MXU matmuls over halo'd row
strips; #1) and ``pipeline="double"`` (``_conv_dma_kernel``, the strips
DMA double-buffered; #2). On a CUDA tensor the wrapper launches
``csrc/conv2d.cu``: ``repro_conv2d_nhwc_f32``, a direct implicit-GEMM
conv that reads the unpadded input (asymmetric SAME pads applied in the
kernel, fp32 FMA, no TF32), or ``repro_conv2d_nhwc_f32_double``, the same
tile with its reduction slices double-buffered by ``cp.async``. Each
counts its launches on its own counter (``launches``,
``launches_double``). On a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.conv2d`, whatever the knob. Bound on the
H100: operations (see the source's note).
"""
from __future__ import annotations

import torch

from . import ref
from ._build import (LaunchCounter, act_code, check_operand, check_pipeline,
                     launch)

launches = LaunchCounter()
launches_double = LaunchCounter()
plain = ref.conv2d


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, stride: int = 1, act: str = "identity",
           res: torch.Tensor | None = None,
           pipeline: str = "grid") -> torch.Tensor:
    """x: (N, H, W, C); w: (K, K, C, F); b: (F,); res: (N, Ho, Wo, F).
    Returns ``act(conv(x, w) + b) + res`` as (N, Ho, Wo, F).

    ``pipeline``: ``"grid"`` launches #1, ``"double"`` #2 (the JAX
    signature's knob); any other value raises ``ValueError``. Both
    kernels take a fixed 64-pixel × 64-filter output tile, so the JAX
    signature's tiling hints ``th``/``tf`` are not taken."""
    check_pipeline(pipeline)
    if not x.is_cuda:
        return plain(x, w, b, stride=stride, act=act, res=res)
    code = act_code(act)
    dev = x.device
    check_operand("x", x, dev)
    N, H, W, C = x.shape
    K, F = int(w.shape[0]), int(w.shape[-1])
    check_operand("w", w, dev, (K, K, C, F))
    if b is None:
        b = torch.zeros(F, device=dev, dtype=torch.float32)
    check_operand("b", b, dev, (F,))
    Ho, pad_top, _ = ref.same_pads(H, K, stride)
    Wo, pad_left, _ = ref.same_pads(W, K, stride)
    if res is not None:
        check_operand("res", res, dev, (N, Ho, Wo, F))
    y = torch.empty((N, Ho, Wo, F), device=dev, dtype=torch.float32)
    check_operand("y", y, dev)
    double = pipeline == "double"
    launch("repro_conv2d_nhwc_f32_double" if double
           else "repro_conv2d_nhwc_f32", dev, x.data_ptr(), w.data_ptr(),
           b.data_ptr(), res.data_ptr() if res is not None else None,
           y.data_ptr(), N, H, W, C, K, F, int(stride), Ho, Wo, pad_top,
           pad_left, code)
    (launches_double if double else launches).add()
    return y
