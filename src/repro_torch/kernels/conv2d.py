"""SAME-padded NHWC conv with the fused ``act(conv + b) + res`` epilogue.

Replaces the two Pallas bodies of ``src/repro/kernels/conv2d.py:conv2d``:
the grid kernel (``_conv_kernel``, K² shifted MXU matmuls over halo'd row
strips; #1) and ``pipeline="double"`` (``_conv_dma_kernel``, the strips
DMA double-buffered; #2). On a CUDA tensor the wrapper launches
``csrc/conv2d.cu``: ``repro_conv2d_nhwc_f32`` (#1) or
``repro_conv2d_nhwc_f32_double`` (#2), one implicit-GEMM template on the
TF32 tensor cores (both operands split into TF32 hi and lo terms, three
MMAs a product, within 3·2^-22 of each product: the source states the
bound), reading the unpadded input (asymmetric SAME pads applied in the
kernel). Tile and split of K come from :func:`_plan` (a split's partial
sums go to a scratch kept a stream); #2 copies the
windows by ``cp.async`` into several stages, #1 through registers (W,
split on its way into shared memory, goes through registers in both), and
the two give the same bits. Each counts its launches on its own counter
(``launches``, ``launches_double``). On a CPU tensor it runs the plain
version, :func:`repro_torch.kernels.ref.conv2d`, whatever the knob. Bound
on the H100: see the source's note.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from ._build import H100_SMS as _H100_SMS
from ._build import RESIDENT as _RESIDENT
from ._build import (LaunchCounter, act_code, check_operand, check_pipeline,
                     grown_scratch, launch, pick_tile, scratch_slot,
                     sm_count, split_k)

launches = LaunchCounter()
launches_double = LaunchCounter()
plain = ref.conv2d

# The (BM, BN) output tiles csrc/conv2d.cu compiles for #1 and #2
# (kernels/_build.py writes them, with the slice depth _CONV_BK, into the
# header the source includes): eight warps split the pixels, 16 rows a warp
# (32 in the 256-row tile), and the 64-row tile's filters in two, so BN is
# a multiple of 8 (of 16 at BM 64). Every tile runs _RESIDENT blocks an
# SM (csrc CV_RESIDENT; the rule _build.split_k sizes a split of K to).
CONV_TILES = ((256, 16), (128, 32), (128, 64), (128, 80), (64, 128))
_CONV_BK = 32


@functools.lru_cache(maxsize=1024)
def _plan(M: int, KKC: int, F: int, sms: int = _H100_SMS,
          cap: int | None = None) -> tuple[int, int, int]:
    """(BM, BN, splits) of #1 and #2 for M output pixels, a reduction of
    ``KKC`` = K·K·C features and F filters, on a card of ``sms``
    streaming multiprocessors.

    The tile is :func:`repro_torch.kernels._build.pick_tile`'s of the
    compiled ones (within 25% of F, fewest column tiles, each gathering
    the windows once more). Where the tiles number fewer than the
    ``_RESIDENT`` x ``sms`` blocks the card holds at once, K·K·C is split
    into chunks of whole ``_CONV_BK``-feature slices, none empty, by
    :func:`repro_torch.kernels._build.split_k` (enough chunks to fill the
    slots, at most twice that, the busiest block shortest; at most
    ``cap`` of them where given). The same inputs give the same plan, so
    #1 and #2 the same bits."""
    bm, bn = pick_tile(CONV_TILES, F)
    return bm, bn, split_k(-(-M // bm) * -(-F // bn), -(-KKC // _CONV_BK),
                           _RESIDENT * sms, cap)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, stride: int = 1, act: str = "identity",
           res: torch.Tensor | None = None,
           pipeline: str = "grid") -> torch.Tensor:
    """x: (N, H, W, C); w: (K, K, C, F); b: (F,); res: (N, Ho, Wo, F).
    Returns ``act(conv(x, w) + b) + res`` as (N, Ho, Wo, F).

    ``pipeline``: ``"grid"`` launches #1, ``"double"`` #2 (the JAX
    signature's knob); any other value raises ``ValueError``. Both take
    the tile and split of :func:`_plan`, so the JAX signature's tiling
    hints ``th``/``tf`` are not taken."""
    check_pipeline(pipeline)
    if not x.is_cuda:
        return plain(x, w, b, stride=stride, act=act, res=res)
    code = act_code(act)
    dev = x.device
    check_operand("x", x, dev)
    N, H, W, C = x.shape
    K, F = int(w.shape[0]), int(w.shape[-1])
    check_operand("w", w, dev, (K, K, C, F))
    if H >= 2 ** 15 or W >= 2 ** 15:
        raise ValueError(f"x is {H} x {W}; the kernels take H, W < 32768")
    if b is None:
        b = torch.zeros(F, device=dev, dtype=torch.float32)
    check_operand("b", b, dev, (F,))
    Ho, pad_top, _ = ref.same_pads(H, K, stride)
    Wo, pad_left, _ = ref.same_pads(W, K, stride)
    if res is not None:
        check_operand("res", res, dev, (N, Ho, Wo, F))
    y = torch.empty((N, Ho, Wo, F), device=dev, dtype=torch.float32)
    check_operand("y", y, dev)
    M = N * Ho * Wo
    bm, bn, splits = _plan(M, K * K * C, F, sm_count(dev))
    double = pipeline == "double"
    args = ("repro_conv2d_nhwc_f32_double" if double
            else "repro_conv2d_nhwc_f32", dev, x.data_ptr(), w.data_ptr(),
            b.data_ptr(), res.data_ptr() if res is not None else None,
            y.data_ptr(), N, H, W, C, K, F, int(stride), Ho, Wo, pad_top,
            pad_left, code, bm, bn, splits)
    if splits == 1:
        launch(*args, None)
    else:
        # split K: the partial sums (splits, M, F), added in split order
        # by the second pass, in this stream's scratch
        slot = scratch_slot(dev, torch._C._cuda_getCurrentRawStream(
            dev.index))
        with slot[0]:
            launch(*args, grown_scratch(slot, splits * M * F, dev).data_ptr())
    (launches_double if double else launches).add()
    return y
