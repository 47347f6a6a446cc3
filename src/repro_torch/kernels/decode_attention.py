"""One-token decode attention over a KV cache: GQA, per-row cache
length read on the card, sliding window, logit soft-capping.

Replaces the Pallas kernel
``src/repro/kernels/decode_attention.py:decode_attention``
(``_dec_kernel``). On a CUDA tensor :func:`decode_attention` launches
``csrc/decode_attention.cu`` (a split pass per (b·kv-head, share of the
live range) and a merge pass; see the source's note) and counts the
call on ``launches``; on a CPU tensor it runs
:func:`repro_torch.kernels.ref.decode_attention`. Bound on the H100:
bytes (the live K and V rows).
"""
from __future__ import annotations

import math

import torch

from . import ref
from ._build import (LaunchCounter, check_aligned, check_no_grad,
                     check_operand, launch)
from .attention import check_softcap, check_window

launches = LaunchCounter()
plain = ref.decode_attention
TILE = 32                       # cache positions per tile (csrc: TS)
TARGET_BLOCKS = 4 * 132         # split blocks to aim for: 4 per H100 SM
MAX_SPLIT = 64


def n_split(B: int, Hkv: int, S: int) -> int:
    """Shares of the live range per (row, kv head): enough blocks to
    fill the card, no more shares than cache tiles."""
    want = -(-TARGET_BLOCKS // max(B * Hkv, 1))
    return max(1, min(want, MAX_SPLIT, -(-S // TILE)))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int | None = None,
                     softcap: float | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, S, Hkv, D); cache_len: (B,) int32 on
    q's device (the number of valid positions per row) → (B, Hq, D)."""
    if not q.is_cuda:
        return plain(q, k_cache, v_cache, cache_len, window=window,
                     softcap=softcap, scale=scale)
    check_no_grad(q, k_cache, v_cache)
    B, Hq, D = (int(d) for d in q.shape)
    _, S, Hkv, _ = (int(d) for d in k_cache.shape)
    if D % 4 or D > 256:
        raise ValueError(f"head_dim {D}: the decode kernel takes a "
                         f"multiple of 4 up to 256")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hkv} kv "
                         f"heads")
    dev = q.device
    check_operand("q", q, dev)
    check_operand("k_cache", k_cache, dev, (B, S, Hkv, D))
    check_operand("v_cache", v_cache, dev, (B, S, Hkv, D))
    check_operand("cache_len", cache_len, dev, (B,), (torch.int32,))
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        check_aligned(name, t)
    ns = n_split(B, Hkv, S)
    o = torch.empty_like(q)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    # each share's running max and sum, and its unnormalised output
    stats = torch.empty((2, B * Hq * ns), device=dev, dtype=torch.float32)
    acc = torch.empty((B * Hq * ns, D), device=dev, dtype=torch.float32)
    launch("repro_decode_attention_f32", dev, q.data_ptr(),
           k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
           o.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
           acc.data_ptr(), B, S, Hq, Hkv, D, ns, check_window(window),
           check_softcap(softcap), scale)
    launches.add()
    return o
