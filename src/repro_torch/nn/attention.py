"""GQA attention layer: projections + RoPE + the attention kernels.

A torch port of the JAX package's ``nn/attention.py``: grouped KV heads,
explicit head_dim, sliding windows, logit soft-capping, QK-norm,
cross-attention (``kv_x``: no RoPE, non-causal, Tq ≠ Tk) and cached
single-token decode over a float or an int8 KV cache. Where the JAX
package calls its XLA-native ``nn/flash.py`` (``flash_mha``,
``decode_grouped``), the same online-softmax function as its Pallas
kernels, the port calls ``ops.mha`` and ``ops.decode_attention``: the
CUDA kernels on the card, their plain versions on the CPU. The int8
cache's decode (``flash.decode_grouped_q8``) is tensor code in both
packages.

``window=None`` is full attention (the JAX model passes the sentinel
``NO_WINDOW = 2**30`` instead; the two mask the same keys).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import flash
from . import layers as L


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    window: int | None = None          # sliding-window size, None = full
    softcap: float | None = None       # attention logit softcap
    qk_norm: bool = False
    causal: bool = True
    use_rope: bool = True


def init(gen: torch.Generator, cfg: AttnCfg, lead=(), device=None,
         dtype=torch.float32) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(lead=lead, device=device, dtype=dtype)
    p = {
        "wq": L.linear_init(gen, d, H * Dh, **kw),
        "wk": L.linear_init(gen, d, Hkv * Dh, **kw),
        "wv": L.linear_init(gen, d, Hkv * Dh, **kw),
        "wo": L.linear_init(gen, H * Dh, d, **kw),
    }
    if cfg.qk_norm:
        p["qnorm"] = L.rmsnorm_init(Dh, **kw)
        p["knorm"] = L.rmsnorm_init(Dh, **kw)
    return p


def _project_qkv(p, cfg: AttnCfg, x, kv_x=None):
    """q from ``x``; k and v from ``kv_x`` (cross-attention), else from
    ``x``."""
    B, T = x.shape[:2]
    kv_x = x if kv_x is None else kv_x
    Tk = kv_x.shape[1]
    q = L.linear(p["wq"], x).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = L.linear(p["wk"], kv_x).reshape(B, Tk, cfg.n_kv_heads, cfg.head_dim)
    v = L.linear(p["wv"], kv_x).reshape(B, Tk, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(p["qnorm"], q)
        k = L.rmsnorm(p["knorm"], k)
    return q, k, v


_CFG = "__use_cfg__"


def _rope(cfg: AttnCfg, q, k, pos, tables):
    """RoPE on q and k, from ``tables`` (``layers.rope_tables`` of the
    positions, shared by every layer of a call) when given."""
    if not cfg.use_rope:
        return q, k
    if tables is None:
        tables = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    return (L.apply_rope(q, None, tables=tables),
            L.apply_rope(k, None, tables=tables))


def forward(p: dict, cfg: AttnCfg, x: torch.Tensor,
            positions: torch.Tensor | None = None,
            kv_x: torch.Tensor | None = None, window=_CFG,
            rope: tuple | None = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder / cross).
    ``rope``: precomputed ``layers.rope_tables`` of ``positions``. With
    ``kv_x`` (B, Tk, d), cross-attention: k and v from ``kv_x``, no
    RoPE, nothing masked causally."""
    B, T, _ = x.shape
    window = cfg.window if window is _CFG else window
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    if kv_x is None:
        pos = positions if positions is not None \
            else torch.arange(T, device=x.device)[None, :]
        q, k = _rope(cfg, q, k, pos, rope)
    o = ops.mha(q, k, v, causal=cfg.causal and kv_x is None, window=window,
                softcap=cfg.softcap)
    return L.linear(p["wo"], o.reshape(B, T, -1))


def prefill(p: dict, cfg: AttnCfg, x: torch.Tensor, cache_size: int,
            window=_CFG, rope: tuple | None = None):
    """Returns (out, (k_cache, v_cache)) with caches padded to
    cache_size. ``rope``: precomputed tables of positions 0..T-1."""
    B, T, _ = x.shape
    window = cfg.window if window is _CFG else window
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope(cfg, q, k, torch.arange(T, device=x.device)[None, :]
                 if rope is None else None, rope)
    o = ops.mha(q, k, v, causal=cfg.causal, window=window,
                softcap=cfg.softcap)
    pad = cache_size - T
    kc = F.pad(k, (0, 0, 0, 0, 0, pad))
    vc = F.pad(v, (0, 0, 0, 0, 0, pad))
    return L.linear(p["wo"], o.reshape(B, T, -1)), (kc, vc)


def decode_step(p: dict, cfg: AttnCfg, x: torch.Tensor, cache: tuple,
                cache_len: torch.Tensor, window=_CFG,
                rope: tuple | None = None):
    """x: (B, 1, d). cache: (k, v) of (B, S, Hkv, Dh), or the int8 cache
    (kq, ks, vq, vs): codes (B, S, Hkv, Dh) int8 and scales (B, S, Hkv)
    float32. cache_len: (B,) int32 on x's device.

    Returns (out (B, 1, d), cache). The new token's k/v (its codes and
    scales, for the int8 cache) are written IN PLACE at position
    cache_len of each row (one indexed write; the JAX package rewrites
    the whole cache with ``jnp.where`` and returns a new one — the
    resulting cache is the same), and the token attends to cache_len + 1
    entries: through ``ops.decode_attention``, or
    ``flash.decode_grouped_q8`` for the int8 cache. ``rope``:
    precomputed tables of positions cache_len."""
    B = x.shape[0]
    window = cfg.window if window is _CFG else window
    q, k, v = _project_qkv(p, cfg, x)               # T = 1
    q, k = _rope(cfg, q, k, cache_len[:, None] if rope is None else None,
                 rope)
    rows = torch.arange(B, device=x.device)
    at = cache_len.to(torch.long)
    if len(cache) == 4:
        kc, ksc, vc, vsc = cache
        k8, k_s = flash.quantize_kv_rows(k[:, 0])
        v8, v_s = flash.quantize_kv_rows(v[:, 0])
        kc[rows, at] = k8
        ksc[rows, at] = k_s
        vc[rows, at] = v8
        vsc[rows, at] = v_s
        o = flash.decode_grouped_q8(q[:, 0], kc, ksc, vc, vsc,
                                    cache_len + 1, window=window,
                                    softcap=cfg.softcap)
        return L.linear(p["wo"], o.reshape(B, 1, -1)), cache
    kc, vc = cache
    kc[rows, at] = k[:, 0].to(kc.dtype)
    vc[rows, at] = v[:, 0].to(vc.dtype)
    o = ops.decode_attention(q[:, 0], kc, vc, cache_len + 1, window=window,
                             softcap=cfg.softcap)
    return L.linear(p["wo"], o.reshape(B, 1, -1)), (kc, vc)
