"""One-token decode attention over a KV cache: GQA, per-row cache length
read on the card, sliding window, logit soft-capping.

Replaces the Pallas kernel
``src/repro/kernels/decode_attention.py:decode_attention``
(``_dec_kernel``). On a CUDA tensor :func:`decode_attention` launches
``csrc/decode_attention.cu`` and counts the call on ``launches``:
fixed-size shares of each row's live range (``L`` positions from
:func:`_plan`, which never reads the lengths), each streamed through
the warps' ``cp.async`` rings, merged by the row's last block in the
same launch; partials in the (device, stream)'s scratch
(``_build.scratch_slot``). On a CPU tensor it runs
:func:`repro_torch.kernels.ref.decode_attention`. Bound on the H100:
bytes (the live K and V rows); see the source's note.
"""
from __future__ import annotations

import functools
import math

import torch

from . import ref
from ._build import H100_SMS as _H100_SMS
from ._build import (LaunchCounter, check_aligned, check_no_grad,
                     check_operand, grown_scratch, launch, scratch_slot,
                     sm_count)
from .attention import check_softcap, check_window

launches = LaunchCounter()
plain = ref.decode_attention

# The block of csrc/decode_attention.cu: warps, ring stages a warp,
# float4 of K (and of V) a stage, the most q heads a block holds, and the
# cap on shares a row (the merge's weights live in shared memory).
WARPS = 4
STAGES = 3
SLOTS = 128
MAX_HEADS = 8
MAX_SHARES = 256
SM_SMEM = 228 * 1024            # an SM's, 1 KB of it reserved a block
# The plan: shares of at least MIN_SHARE positions, at most SHARE_BYTES
# of K and V, and no longer than a full cache's grid filling WAVES waves
# of the card allows.
MIN_SHARE = 32
SHARE_BYTES = 128 * 1024
WAVES = 1


def head_block(rep: int) -> int:
    """q heads a block holds (RB): the next power of two of ``rep``, at
    most ``MAX_HEADS`` (a kv head with more q heads takes more blocks)."""
    return min(MAX_HEADS, 1 << max(rep - 1, 0).bit_length())


def row_slots(D: int) -> int:
    """float4 a stored K or V row (LP lanes × NC float4 a lane)."""
    return 16 if D <= 64 else 32 if D <= 128 else 64


def smem_bytes(D: int, rep: int) -> int:
    """Shared memory of a block (csrc ``smem_bytes``, which the library
    reports as ``repro_decode_smem_bytes``; a card test holds the two
    equal): the warps' rings, or the merges that reuse them."""
    rb = head_block(rep)
    ring = WARPS * STAGES * 2 * SLOTS * 16
    merge = 4 * (WARPS * rb * row_slots(D) * 4 + 2 * WARPS * rb
                 + rb * MAX_SHARES + rb)
    return max(ring, merge)


def resident(D: int, rep: int) -> int:
    """Blocks an SM holds at once, by shared memory."""
    return SM_SMEM // (smem_bytes(D, rep) + 1024)


@functools.lru_cache(maxsize=1024)
def _plan(S: int, window: int, D: int, rep: int, bh: int,
          sms: int = _H100_SMS) -> tuple[int, int]:
    """(L, shares): the positions a share, and the shares a row, for a
    cache of S positions (``window`` 0 for none) at head width D, ``rep``
    q heads a kv head and ``bh`` = B·Hkv (row, kv head) pairs on a card of
    ``sms`` SMs. The grid is the upper bound, ceil(min(S, window) / L)
    shares, since the host never reads the lengths: L is the longest
    power of two from ``MIN_SHARE`` whose share holds at most
    ``SHARE_BYTES`` of K and V and at which a full cache's grid still
    fills ``WAVES`` waves of ``resident`` blocks an SM, then raised until
    at most ``MAX_SHARES`` shares cover the span. (On the H100 the
    planned share read fastest, or within 0.3%, against half and twice
    it at every chip_smoke.py decode case: ``--only dec``.)"""
    span = min(S, window) if window else S
    blocks = bh * -(-rep // head_block(rep))
    slots = resident(D, rep) * sms
    L = MIN_SHARE
    while (L < span and 2 * L * 8 * D <= SHARE_BYTES
           and blocks * -(-span // (2 * L)) >= WAVES * slots):
        L *= 2
    while -(-span // L) > MAX_SHARES:
        L *= 2
    return L, -(-span // L)


# A ticket a (row, kv head, head group) a (device, stream), int32, made
# zero; the kernel's merging block sets its ticket back to 0.
_tickets: dict = {}


def _ticket_buffer(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The stream's tickets, made anew (zeroed) where fewer than ``n``;
    call it with the stream's scratch lock held."""
    t = _tickets.get((dev.index, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1), device=dev, dtype=torch.int32)
        _tickets[(dev.index, stream)] = t
    return t


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
    if D % 4 or not 0 < D <= 256:
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
    win = check_window(window)
    rep = Hq // Hkv
    L, shares = _plan(S, win, D, rep, B * Hkv, sm_count(dev))
    o = torch.empty_like(q)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    slot = scratch_slot(dev, stream)
    with slot[0]:
        part = grown_scratch(slot, B * Hq * shares * (D + 2), dev)
        tickets = _ticket_buffer(dev, stream,
                                 B * Hkv * -(-rep // head_block(rep)))
        launch("repro_decode_attention_f32", dev, q.data_ptr(),
               k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
               o.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, S, Hq,
               Hkv, D, L, shares, win, check_softcap(softcap), scale,
               dev.index)
    launches.add()
    return o

