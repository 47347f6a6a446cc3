"""Language models of the ``dense`` family: granite-3-8b, gemma2-2b
(local/global windows, softcaps, sandwich norms), llama3-405b,
starcoder2-7b.

A torch port of the dense half of the JAX package's ``models/lm.py``:
``attn_cfg``, ``init_params``, ``forward``, ``init_cache``, ``prefill``
and ``decode_step``, with every dense flag (``window_pattern``,
``attn_softcap``, ``final_softcap``, ``post_norm``, ``embed_scale``,
``mlp_gated``, ``qk_norm``, ``tie_embeddings``). The parameter tree is
the JAX package's, layers stacked on axis 0; where the JAX package
scans over that axis, the port loops over the layers in Python (eager
PyTorch has no compile step to spare). The families ``moe``, ``vlm``,
``encdec``, ``ssm`` and ``hybrid``, and the int8 KV cache
(``kv_bits=8``), raise ``NotImplementedError``.

Per layer, on the card: two RMSNorm launches (``ln1``, ``ln2``; four
more with ``post_norm``, two with ``qk_norm``), one attention launch
(``mha`` in forward and prefill, ``decode_attention`` in a decode
step), and the projections as ``torch.matmul`` (``ops.qmatmul`` for a
quantized weight); one more RMSNorm for the final norm.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ModelCfg
from ..core.quant import QTensor
from ..device import resolve_device
from ..nn import attention as A
from ..nn import layers as L

_NOT_PORTED = {
    "moe": "moe/vlm/encdec", "vlm": "moe/vlm/encdec",
    "encdec": "moe/vlm/encdec", "ssm": "the SSM/hybrid serving slice",
    "hybrid": "the SSM/hybrid serving slice"}


def check_supported(cfg: ModelCfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense model with
    a float KV cache, the part of the LM stack the port has."""
    if cfg.family != "dense":
        item = _NOT_PORTED.get(cfg.family, cfg.family)
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP.md, modules to port: {item})")
    if cfg.kv_bits != 16:
        raise NotImplementedError(
            f"kv_bits={cfg.kv_bits}: the int8 KV cache is not ported yet "
            f"(ROADMAP.md, modules to port: kv_bits=8)")


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------

def attn_cfg(cfg: ModelCfg, causal: bool = True,
             use_rope: bool = True) -> A.AttnCfg:
    return A.AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, window=None,
        softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm, causal=causal,
        use_rope=use_rope)


def layer_windows(cfg: ModelCfg) -> list:
    """Per-layer window sizes; None is full attention."""
    return [cfg.layer_window(i) for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` over every tensor and QTensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def place(params: dict, device) -> dict:
    """A copy of ``params`` on ``device`` (no copy where already there)."""
    return tree_map(lambda v: v.to(device), params)


def _layer_leaf(v, i: int):
    if isinstance(v, QTensor):
        if v.packed:
            raise NotImplementedError(
                "a layer-stacked packed-int4 weight cannot be sliced per "
                "layer")
        q = v.q[i]

        def meta(t):            # stacked per layer, or one for all
            return t[i] if t.ndim == v.q.ndim else t
        return QTensor(q=q, scale=meta(v.scale), zero=meta(v.zero),
                       bits=v.bits, shape=tuple(q.shape), packed=False)
    return v[i]


def layer(stacked, i: int) -> dict:
    """Layer ``i`` of a layer-stacked tree (views, no copy), or of the
    list :func:`split_layers` makes."""
    if isinstance(stacked, list):
        return stacked[i]
    return tree_map(lambda v: _layer_leaf(v, i), stacked)


def split_layers(params: dict, cfg: ModelCfg) -> dict:
    """``params`` with ``layers`` as a list of per-layer trees (views of
    the stacked tensors, no copy): a caller that runs many steps, such
    as ``LmReplica``, slices once instead of once per layer per step."""
    return dict(params, layers=[layer(params["layers"], i)
                                for i in range(cfg.n_layers)])


def _init_dense_layers(gen, cfg: ModelCfg, device, dtype) -> dict:
    kw = dict(lead=(cfg.n_layers,), device=device, dtype=dtype)
    p = {"ln1": L.rmsnorm_init(cfg.d_model, **kw),
         "ln2": L.rmsnorm_init(cfg.d_model, **kw),
         "attn": A.init(gen, attn_cfg(cfg), **kw)}
    if cfg.post_norm:
        p["ln1p"] = L.rmsnorm_init(cfg.d_model, **kw)
        p["ln2p"] = L.rmsnorm_init(cfg.d_model, **kw)
    p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated,
                          **kw)
    return p


def init_params(cfg: ModelCfg, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict:
    """Random parameters with the JAX package's tree and distributions,
    made on ``device`` (default ``cuda:0``; raises without CUDA) from
    ``generator``, which must be a generator of that device."""
    check_supported(cfg)
    device = resolve_device(device)
    p: dict[str, Any] = {"embed": L.embed_init(generator, cfg.vocab,
                                               cfg.d_model, device, dtype)}
    p["layers"] = _init_dense_layers(generator, cfg, device, dtype)
    p["final_norm"] = L.rmsnorm_init(cfg.d_model, device=device,
                                     dtype=dtype)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.linear_init(generator, cfg.d_model, cfg.vocab,
                                     device=device, dtype=dtype)
    return p


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _mlp_block(cfg: ModelCfg, pl, h):
    m = L.mlp(pl["mlp"], L.rmsnorm(pl["ln2"], h, cfg.norm_eps), act=cfg.act)
    if cfg.post_norm:
        m = L.rmsnorm(pl["ln2p"], m, cfg.norm_eps)
    return h + m


def _attn_out(cfg: ModelCfg, pl, a):
    return L.rmsnorm(pl["ln1p"], a, cfg.norm_eps) if cfg.post_norm else a


def _dense_layer_fwd(cfg: ModelCfg, pl, h, pos, window, rope):
    a = A.forward(pl["attn"], attn_cfg(cfg),
                  L.rmsnorm(pl["ln1"], h, cfg.norm_eps), positions=pos,
                  window=window, rope=rope)
    return _mlp_block(cfg, pl, h + _attn_out(cfg, pl, a))


def _rope(cfg: ModelCfg, pos):
    """The RoPE tables of ``pos``, computed once for all layers."""
    return L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)


def _embed_tokens(cfg: ModelCfg, params, tokens):
    h = L.embed(params["embed"], tokens)
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    return h


def _readout(cfg: ModelCfg, params, h):
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = (L.unembed(params["embed"], h) if cfg.tie_embeddings
              else L.linear(params["lm_head"], h))
    if cfg.final_softcap is not None:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def forward(params: dict, cfg: ModelCfg, batch: dict) -> tuple:
    """Full-sequence forward. batch: {"tokens": (B, T) integer tensor}.
    Returns (logits (B, T, V), aux dict)."""
    check_supported(cfg)
    h = _embed_tokens(cfg, params, batch["tokens"])
    pos = torch.arange(h.shape[1], device=h.device)[None, :]
    rope = _rope(cfg, pos)
    for i, w in enumerate(layer_windows(cfg)):
        h = _dense_layer_fwd(cfg, layer(params["layers"], i), h, pos, w,
                             rope)
    return _readout(cfg, params, h), {}


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelCfg, batch: int, cache_size: int,
               dtype=torch.float32, device=None) -> dict:
    """Static-shape decode cache: ``len`` (B,) int32 and ``k``/``v``
    (L, B, cache_size, Hkv, Dh), on ``device`` (default ``cuda:0``)."""
    check_supported(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_size, cfg.n_kv_heads, cfg.head_dim)
    return {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(params: dict, cfg: ModelCfg, batch: dict, cache_size: int):
    """Process the prompt; returns (last_logits (B, V), cache)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    h = _embed_tokens(cfg, params, tokens)
    cache = init_cache(cfg, B, cache_size, h.dtype, device=h.device)
    acfg = attn_cfg(cfg)
    rope = _rope(cfg, torch.arange(T, device=h.device)[None, :])
    for i, w in enumerate(layer_windows(cfg)):
        pl = layer(params["layers"], i)
        a, (kc, vc) = A.prefill(pl["attn"], acfg,
                                L.rmsnorm(pl["ln1"], h, cfg.norm_eps),
                                cache_size, window=w, rope=rope)
        cache["k"][i] = kc
        cache["v"][i] = vc
        h = _mlp_block(cfg, pl, h + _attn_out(cfg, pl, a))
    cache["len"] = torch.full((B,), T, dtype=torch.int32, device=h.device)
    logits = _readout(cfg, params, h[:, -1:])[:, 0]
    return logits, cache


def decode_step(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                cache: dict):
    """One decode step. tokens: (B,) integer tensor → (logits (B, V),
    cache). The cache is updated IN PLACE (each row's k/v written at its
    ``len``, then ``len`` advanced) and returned; the JAX package
    returns a new one."""
    check_supported(cfg)
    h = _embed_tokens(cfg, params, tokens[:, None])
    clen = cache["len"]
    acfg = attn_cfg(cfg)
    rope = _rope(cfg, clen[:, None])
    for i, w in enumerate(layer_windows(cfg)):
        pl = layer(params["layers"], i)
        a, _ = A.decode_step(pl["attn"], acfg,
                             L.rmsnorm(pl["ln1"], h, cfg.norm_eps),
                             (cache["k"][i], cache["v"][i]), clen, window=w,
                             rope=rope)
        h = _mlp_block(cfg, pl, h + _attn_out(cfg, pl, a))
    cache["len"] = clen + 1
    logits = _readout(cfg, params, h)[:, 0]
    return logits, cache
