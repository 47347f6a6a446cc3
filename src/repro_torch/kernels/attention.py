"""Flash attention forward: GQA, causal (offset ``Tk - Tq``), sliding
window, logit soft-capping.

Replaces the Pallas kernel ``src/repro/kernels/attention.py:mha``
(``_attn_kernel``). On a CUDA tensor :func:`mha` launches
``csrc/attention.cu`` and counts the launch on ``launches``: one block per
(b·q-head, BQ-row q tile), K and V tiles brought in by ``cp.async``, both
products on the TF32 tensor cores with every operand split into TF32 hi
and lo terms (three MMAs a product, within 3·2^-22 of it: the source
states the bound), the scores handed to P·V in registers. Its tile comes
from :func:`_plan` over ``ATTN_TILES``, and so does a split of the kv
sweep where the blocks would leave most of the card idle (short Tq): each
chunk a block, the chunks combined in order by a second kernel of the
same call (scratch from ``torch.empty``; no atomics). On a CPU tensor it
runs :func:`repro_torch.kernels.ref.mha`. Bound on the H100: see the
source's note.
"""
from __future__ import annotations

import functools
import math

import torch

from . import ref
from ._build import H100_SMS as _H100_SMS
from ._build import (LaunchCounter, check_aligned, check_no_grad,
                     check_operand, launch, sm_count)

launches = LaunchCounter()
plain = ref.mha
HEAD_DIMS = (64, 128, 256)      # the head widths the kernel is built for

# The tile of each head width, (BQ query rows, BK keys a kv tile, cp.async
# stages of K and V), the one table csrc/attention.cu compiles
# (kernels/_build.py writes it into the header the source includes). A
# warp owns 16 query rows; at D = 256 two warps share them, each with half
# of the output columns. Shared memory (``smem_bytes``) holds q split in
# two, the K and V slots and one split-off lo buffer of each, within the
# 227 KB a block may take; each of these tiles leaves room for two blocks
# an SM.
ATTN_TILES = {64: (64, 32, 2), 128: (64, 16, 2), 256: (32, 8, 2)}
SM_SMEM = 228 * 1024            # an SM's, 1 KB of it reserved a block
# Where the (b·q-head, q tile) blocks fill at most half of the blocks the
# card holds at once (short Tq), the kv sweep is split into chunks of at
# least this many tiles, each a block, and combined in chunk order.
MIN_SPLIT_TILES = 8


def smem_bytes(D: int, bq: int, bk: int, stages: int) -> int:
    """A block's shared memory (csrc/attention.cu ``AttnTile::SMEM``):
    q_hi and q_lo, ``stages`` slots of K and of V, and one lo buffer of
    each, in rows of D floats."""
    return 4 * D * (2 * bq + 2 * (stages + 1) * bk)


def resident(D: int, bq: int, bk: int, stages: int) -> int:
    """Blocks of a tile an SM holds at once, by shared memory (each also
    within the SM's registers: csrc/attention.cu's tiles use at most 229
    a thread, so two 4-warp blocks fit)."""
    return SM_SMEM // (smem_bytes(D, bq, bk, stages) + 1024)


@functools.lru_cache(maxsize=1024)
def _plan(D: int, B: int = 1, Tq: int = 1, Tk: int = 1, Hq: int = 1,
          sms: int = _H100_SMS) -> tuple[int, int, int, int]:
    """(BQ, BK, stages, splits) of the launch at head width ``D`` for
    (B, Tq, Hq) queries over Tk keys on a card of ``sms`` SMs: the
    ``ATTN_TILES`` entry, and the kv sweep unsplit (1) unless its blocks
    fill at most half of the ``resident`` x ``sms`` the card holds at
    once; then split into enough chunks to fill them, each of at least
    ``MIN_SPLIT_TILES`` of the Tk / BK tiles."""
    bq, bk, stages = ATTN_TILES[D]
    blocks = -(-Tq // bq) * B * Hq
    slots = resident(D, bq, bk, stages) * sms
    splits = 1
    if 2 * blocks <= slots:
        splits = max(1, min(-(-slots // blocks),
                            -(-Tk // bk) // MIN_SPLIT_TILES))
    return bq, bk, stages, splits


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
    plan = _plan(D, B, Tq, Tk, Hq, sm_count(dev))
    # a split sweep's chunks: O unnormalised, then m and l, a row each
    part = torch.empty(plan[3] * B * Tq * Hq * (D + 2), device=dev,
                       dtype=torch.float32) if plan[3] > 1 else None
    launch("repro_mha_f32", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), B, Tq, Tk, Hq, Hkv, D, int(bool(causal)),
           check_window(window), check_softcap(softcap), scale, *plan,
           part.data_ptr() if part is not None else None)
    launches.add()
    return o
