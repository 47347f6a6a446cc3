"""Flash attention forward: GQA, causal (offset ``Tk - Tq``), sliding
window, logit soft-capping.

Replaces the Pallas kernel ``src/repro/kernels/attention.py:mha``
(``_attn_kernel``). On a CUDA tensor :func:`mha` launches
``csrc/attention.cu`` (one block per (b·q-head, 64-row q tile), K and V
streamed through shared memory with online softmax; see the source's
note) and counts the launch on ``launches``; on a CPU tensor it runs
:func:`repro_torch.kernels.ref.mha`. Bound on the H100: operations
(fp32 FMA).
"""
from __future__ import annotations

import math

import torch

from . import ref
from ._build import (LaunchCounter, check_aligned, check_no_grad,
                     check_operand, launch)

launches = LaunchCounter()
plain = ref.mha
HEAD_DIMS = (64, 128, 256)      # the head widths the kernel is built for


def check_window(window) -> int:
    """``window`` as the kernels' int: 0 for none, else >= 1."""
    if window is None:
        return 0
    if int(window) < 1:
        raise ValueError(f"window={window}: expected None or >= 1")
    return int(window)


def check_softcap(softcap) -> float:
    """``softcap`` as the kernels' float: 0 for none, else > 0."""
    if softcap is None:
        return 0.0
    if float(softcap) <= 0:
        raise ValueError(f"softcap={softcap}: expected None or > 0")
    return float(softcap)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None,
        softcap: float | None = None,
        scale: float | None = None) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, D) → (B, Tq, Hq, D), with
    Hq a multiple of Hkv. The kernel takes D in ``HEAD_DIMS``."""
    if not q.is_cuda:
        return plain(q, k, v, causal=causal, window=window,
                     softcap=softcap, scale=scale)
    check_no_grad(q, k, v)
    B, Tq, Hq, D = (int(d) for d in q.shape)
    _, Tk, Hkv, _ = (int(d) for d in k.shape)
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the attention kernel takes "
                         f"{HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hkv} kv "
                         f"heads")
    dev = q.device
    check_operand("q", q, dev)
    check_operand("k", k, dev, (B, Tk, Hkv, D))
    check_operand("v", v, dev, (B, Tk, Hkv, D))
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_aligned(name, t)
    o = torch.empty_like(q)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    launch("repro_mha_f32", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), B, Tq, Tk, Hq, Hkv, D, int(bool(causal)),
           check_window(window), check_softcap(softcap), scale)
    launches.add()
    return o
