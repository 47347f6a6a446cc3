"""Language models of the ``dense``, ``ssm`` and ``hybrid`` families:
granite-3-8b, gemma2-2b (local/global windows, softcaps, sandwich
norms), llama3-405b, starcoder2-7b; mamba2-130m (attention-free, SSD);
zamba2-1.2b (a Mamba-2 backbone with ONE shared transformer block
applied every ``shared_attn_every`` layers, the embedding re-injected
into it each time).

A torch port of the JAX package's ``models/lm.py`` for these families:
``attn_cfg``, ``init_params``, ``forward``, ``init_cache``, ``prefill``
and ``decode_step``, with every dense flag (``window_pattern``,
``attn_softcap``, ``final_softcap``, ``post_norm``, ``embed_scale``,
``mlp_gated``, ``qk_norm``, ``tie_embeddings``). The parameter tree is
the JAX package's, layers stacked on axis 0; where the JAX package
scans over that axis, the port loops over the layers in Python (eager
PyTorch has no compile step to spare). The families ``moe``, ``vlm``
and ``encdec``, and the int8 KV cache (``kv_bits=8``) of the attention
families, raise ``NotImplementedError``; the SSM and hybrid caches
ignore ``kv_bits``, as in the JAX package.

Per layer, on the card: dense, two RMSNorm launches (``ln1``, ``ln2``;
four more with ``post_norm``, two with ``qk_norm``) and one attention
launch (``mha`` in forward and prefill, ``decode_attention`` in a
decode step); SSM, two RMSNorm launches (``ln`` and the mixer's norm)
and, in forward and prefill, one ``ssd_scan`` launch (a decode step
runs the one-token recurrence as plain tensor code, as the JAX package
does); each call of zamba2's shared block, two RMSNorm launches and one
attention launch. The projections are ``torch.matmul``
(``ops.qmatmul`` for a quantized weight); one more RMSNorm for the
final norm.
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
from ..nn import ssm as S

_PORTED = ("dense", "ssm", "hybrid")


def check_supported(cfg: ModelCfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a family the port
    has (dense, ssm, hybrid) and, for the dense family, has a float KV
    cache. ``kv_bits`` is not read by the SSM and hybrid caches."""
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP.md, modules to port: moe/vlm/encdec)")
    if cfg.family == "dense" and cfg.kv_bits != 16:
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


def _init_ssm_layers(gen, cfg: ModelCfg, device, dtype) -> dict:
    kw = dict(lead=(cfg.n_layers,), device=device, dtype=dtype)
    return {"ln": L.rmsnorm_init(cfg.d_model, **kw),
            "mixer": S.init(gen, cfg.ssm, **kw)}


def _init_shared_block(gen, cfg: ModelCfg, device, dtype) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {
        "in_proj": L.linear_init(gen, 2 * cfg.d_model, cfg.d_model, **kw),
        "ln1": L.rmsnorm_init(cfg.d_model, **kw),
        "attn": A.init(gen, attn_cfg(cfg), **kw),
        "ln2": L.rmsnorm_init(cfg.d_model, **kw),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, **kw),
        "out_proj": L.linear_init(gen, cfg.d_model, cfg.d_model, **kw),
    }


def init_params(cfg: ModelCfg, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict:
    """Random parameters with the JAX package's tree and distributions,
    made on ``device`` (default ``cuda:0``; raises without CUDA) from
    ``generator``, which must be a generator of that device."""
    check_supported(cfg)
    device = resolve_device(device)
    p: dict[str, Any] = {"embed": L.embed_init(generator, cfg.vocab,
                                               cfg.d_model, device, dtype)}
    init_layers = _init_dense_layers if cfg.family == "dense" \
        else _init_ssm_layers
    p["layers"] = init_layers(generator, cfg, device, dtype)
    p["final_norm"] = L.rmsnorm_init(cfg.d_model, device=device,
                                     dtype=dtype)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.linear_init(generator, cfg.d_model, cfg.vocab,
                                     device=device, dtype=dtype)
    if _shared_every(cfg):
        p["shared"] = _init_shared_block(generator, cfg, device, dtype)
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
    """The RoPE tables of ``pos``, computed once for all layers; None
    for an attention-free model."""
    if cfg.family == "ssm":
        return None
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
    if cfg.family == "dense":
        for i, w in enumerate(layer_windows(cfg)):
            h = _dense_layer_fwd(cfg, layer(params["layers"], i), h, pos, w,
                                 rope)
    else:
        acfg = attn_cfg(cfg)
        h = _ssm_stack(
            params, cfg, h,
            lambda i, pm, x: S.forward(pm, cfg.ssm, x)[0],
            lambda call, a_in: A.forward(params["shared"]["attn"], acfg,
                                         a_in, positions=pos, window=None,
                                         rope=rope))
    return _readout(cfg, params, h), {}


# ---------------------------------------------------------------------------
# the SSM and hybrid stacks
# ---------------------------------------------------------------------------

def _shared_every(cfg: ModelCfg) -> int:
    """Layers per shared-block call of a hybrid model, 0 for none."""
    return cfg.shared_attn_every if cfg.family == "hybrid" else 0


def _shared_block(cfg: ModelCfg, sp, h, h0, attend):
    """Zamba2's shared transformer block: the embedding ``h0``
    re-injected through ``in_proj(concat([h, h0]))``, attention (by
    ``attend`` on the normed input), the MLP, and ``out_proj`` added to
    the residual stream."""
    x = L.linear(sp["in_proj"], torch.cat([h, h0], dim=-1))
    x = x + attend(L.rmsnorm(sp["ln1"], x, cfg.norm_eps))
    x = x + L.mlp(sp["mlp"], L.rmsnorm(sp["ln2"], x, cfg.norm_eps),
                  act=cfg.act)
    return h + L.linear(sp["out_proj"], x)


def _ssm_stack(params, cfg: ModelCfg, h, mix, attend):
    """The Mamba-2 layers (``h += mix(i, mixer params, ln(h))``) and, for
    a hybrid model, the shared block (``attend(call, normed input)``)
    before every segment of ``shared_attn_every`` layers, as the JAX
    package's ``_hybrid_forward/_prefill/_decode`` run them. ``h0`` is
    the embedding ``h`` at entry: per position in forward and prefill,
    the current token's in a decode step (the same quantity)."""
    h0 = h
    every = _shared_every(cfg) or cfg.n_layers
    for call, start in enumerate(range(0, cfg.n_layers, every)):
        if _shared_every(cfg):
            h = _shared_block(cfg, params["shared"], h, h0,
                              lambda a_in, call=call: attend(call, a_in))
        for i in range(start, min(start + every, cfg.n_layers)):
            pl = layer(params["layers"], i)
            h = h + mix(i, pl["mixer"], L.rmsnorm(pl["ln"], h, cfg.norm_eps))
    return h


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelCfg, batch: int, cache_size: int,
               dtype=torch.float32, device=None) -> dict:
    """Static-shape decode cache on ``device`` (default ``cuda:0``):
    ``len`` (B,) int32; dense: ``k``/``v`` (L, B, cache_size, Hkv, Dh);
    ssm and hybrid: ``conv`` (L, B, K-1, conv_dim) and ``ssm`` (L, B, H,
    N, P) float32; hybrid: ``sk``/``sv`` (calls, B, cache_size, Hkv, Dh)
    for the ceil(L / shared_attn_every) calls of the shared block."""
    check_supported(cfg)
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    kv = (batch, cache_size, cfg.n_kv_heads, cfg.head_dim)
    if cfg.family == "dense":
        cache["k"] = torch.zeros((cfg.n_layers,) + kv, **kw)
        cache["v"] = torch.zeros((cfg.n_layers,) + kv, **kw)
        return cache
    st = S.init_state(cfg.ssm, batch, **kw)
    cache["conv"] = st["conv"][None].repeat(cfg.n_layers, 1, 1, 1)
    cache["ssm"] = st["ssm"][None].repeat(cfg.n_layers, 1, 1, 1, 1)
    if _shared_every(cfg):
        n_calls = -(-cfg.n_layers // cfg.shared_attn_every)
        cache["sk"] = torch.zeros((n_calls,) + kv, **kw)
        cache["sv"] = torch.zeros((n_calls,) + kv, **kw)
    return cache


def prefill(params: dict, cfg: ModelCfg, batch: dict, cache_size: int):
    """Process the prompt; returns (last_logits (B, V), cache)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    h = _embed_tokens(cfg, params, tokens)
    cache = init_cache(cfg, B, cache_size, h.dtype, device=h.device)
    acfg = attn_cfg(cfg)
    rope = _rope(cfg, torch.arange(T, device=h.device)[None, :])
    if cfg.family == "dense":
        for i, w in enumerate(layer_windows(cfg)):
            pl = layer(params["layers"], i)
            a, (kc, vc) = A.prefill(pl["attn"], acfg,
                                    L.rmsnorm(pl["ln1"], h, cfg.norm_eps),
                                    cache_size, window=w, rope=rope)
            cache["k"][i] = kc
            cache["v"][i] = vc
            h = _mlp_block(cfg, pl, h + _attn_out(cfg, pl, a))
    else:
        def mix(i, pm, x):
            y, st = S.forward(pm, cfg.ssm, x)
            cache["conv"][i] = st["conv"]
            cache["ssm"][i] = st["ssm"]
            return y

        def attend(call, a_in):
            a, (kc, vc) = A.prefill(params["shared"]["attn"], acfg, a_in,
                                    cache_size, window=None, rope=rope)
            cache["sk"][call] = kc
            cache["sv"][call] = vc
            return a

        h = _ssm_stack(params, cfg, h, mix, attend)
    cache["len"] = torch.full((B,), T, dtype=torch.int32, device=h.device)
    logits = _readout(cfg, params, h[:, -1:])[:, 0]
    return logits, cache


def decode_step(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                cache: dict):
    """One decode step. tokens: (B,) integer tensor → (logits (B, V),
    cache). The cache is updated IN PLACE (each row's k/v written at its
    ``len``, the SSM layers' conv ring and state overwritten, then
    ``len`` advanced) and returned; the JAX package returns a new
    one."""
    check_supported(cfg)
    h = _embed_tokens(cfg, params, tokens[:, None])
    clen = cache["len"]
    acfg = attn_cfg(cfg)
    rope = _rope(cfg, clen[:, None])
    if cfg.family == "dense":
        for i, w in enumerate(layer_windows(cfg)):
            pl = layer(params["layers"], i)
            a, _ = A.decode_step(pl["attn"], acfg,
                                 L.rmsnorm(pl["ln1"], h, cfg.norm_eps),
                                 (cache["k"][i], cache["v"][i]), clen,
                                 window=w, rope=rope)
            h = _mlp_block(cfg, pl, h + _attn_out(cfg, pl, a))
    else:
        h = _ssm_stack(
            params, cfg, h,
            lambda i, pm, x: S.decode_step(
                pm, cfg.ssm, x,
                {"conv": cache["conv"][i], "ssm": cache["ssm"][i]})[0],
            lambda call, a_in: A.decode_step(
                params["shared"]["attn"], acfg, a_in,
                (cache["sk"][call], cache["sv"][call]), clen, window=None,
                rope=rope)[0])
    cache["len"] = clen + 1
    logits = _readout(cfg, params, h)[:, 0]
    return logits, cache
