"""The int8 KV cache of the attention families (``kv_bits=8``).

A torch port of the JAX package's ``nn/flash.py:94-136``:
:func:`quantize_kv_rows`, the symmetric per-(position, head) int8 codes
of a K or V row (SATAY Eq. 2), and :func:`decode_grouped_q8`, one-token
grouped attention over such a cache with the row scales folded into the
two contractions. Both are XLA code in the JAX package, with no Pallas
kernel behind them, so both are plain tensor code here, on the CPU and
on the card alike (as the SSM decode recurrence is). The rest of the JAX
module (``flash_mha``, ``decode_grouped``) is ``ops.mha`` and
``ops.decode_attention`` in the port.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def quantize_kv_rows(x: torch.Tensor):
    """Per-(position, head) symmetric int8. x: (..., D) → (codes int8 of
    x's shape, scale (...,) float32), scale = max(amax / 127, 1e-8) and
    codes round(x / scale) (half to even, as ``jnp.round``) clipped to
    ±127."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q8 = torch.clamp(torch.round(xf / scale[..., None]), -127, 127
                     ).to(torch.int8)
    return q8, scale


def decode_grouped_q8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                      vq: torch.Tensor, vs: torch.Tensor,
                      cache_len: torch.Tensor, *, window: int | None = None,
                      softcap: float | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Decode against an int8 KV cache with per-row scales, in the JAX
    package's order: the k scales multiply the scores after q·kq, the v
    scales fold into p before p·vq; positions outside ``pos < len`` (and
    ``pos >= len - window``) are masked with ``NEG_INF``.

    q: (B, Hq, D); kq/vq: (B, S, Hkv, D) int8; ks/vs: (B, S, Hkv) f32;
    cache_len: (B,) → (B, Hq, D).
    """
    B, Hq, D = q.shape
    _, S, Hkv, _ = kq.shape
    rep = Hq // Hkv
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    qg = (q * scale).reshape(B, Hkv, rep, D)
    s = torch.einsum("bgrd,bsgd->bgrs", qg.to(torch.float32),
                     kq.to(torch.float32))
    s = s * ks.transpose(1, 2)[:, :, None, :]            # row dequant
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    clen = cache_len[:, None]
    valid = pos < clen
    if window is not None:
        valid &= pos >= clen - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    pv = p * vs.transpose(1, 2)[:, :, None, :]            # fold v scales
    o = torch.einsum("bgrs,bsgd->bgrd", pv, vq.to(torch.float32))
    return o.reshape(B, Hq, D).to(q.dtype)
