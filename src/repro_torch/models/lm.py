"""Language models of every family of the JAX package's ``models/lm.py``:
dense (granite-3-8b, gemma2-2b with local/global windows, softcaps and
sandwich norms, llama3-405b, starcoder2-7b), moe (qwen3-moe-30b-a3b:
128 experts top-8 and QK-norm; llama4-maverick-400b-a17b: 128 experts
top-1 with a shared expert every second layer), vlm (llava-next-34b:
the batch carries precomputed patch embeddings, ``embeds``, before the
tokens), ssm (mamba2-130m, attention-free, SSD), hybrid (zamba2-1.2b: a
Mamba-2 backbone with ONE shared transformer block applied every
``shared_attn_every`` layers, the embedding re-injected into it each
time) and encdec (seamless-m4t-medium: a bidirectional encoder over
precomputed frame embeddings, ``src_embeds``, and a decoder with
cross-attention).

A torch port of ``attn_cfg``, ``init_params``, ``forward``,
``init_cache``, ``prefill`` and ``decode_step``, with every dense flag
(``window_pattern``, ``attn_softcap``, ``final_softcap``,
``post_norm``, ``embed_scale``, ``mlp_gated``, ``qk_norm``,
``tie_embeddings``) and the int8 KV cache of the attention families
(``kv_bits=8``: codes and per-row scales, ``nn/flash.py``; any other
``kv_bits`` is a float cache, and the SSM and hybrid caches ignore it,
as in the JAX package). The parameter tree is the JAX package's, layers
stacked on axis 0; llama4's ``moe_every = 2`` has the JAX package's
grouped layout, ``layers = {"dense": (G, moe_every - 1, ...), "moe":
(G, ...)}``, its cache one row a layer (layer ``g·moe_every + j`` at
row ``g·moe_every + j``). Where the JAX package scans over the layers,
the port loops over them in Python (eager PyTorch has no compile step
to spare).

Per layer, on the card: attention families, two RMSNorm launches
(``ln1``, ``ln2``; four more with ``post_norm``, two more with
``qk_norm``: ``qnorm`` and ``knorm``) and one attention launch (``mha``
in forward and prefill; ``decode_attention`` in a decode step, none
with ``kv_bits=8``, whose step attends through the tensor code of
``flash.decode_grouped_q8`` as the JAX package does); an encdec decoder
layer one more RMSNorm (``ln_x``) and one more attention launch
(cross-attention: ``mha`` in forward and prefill, ``decode_attention``
over the ``src_len`` encoder rows in a step), and in forward and
prefill each encoder layer two RMSNorm launches and one ``mha``, then
one more RMSNorm (``enc_norm``). An MoE layer's router and expert
contractions are ``torch.matmul``/``torch.bmm``. SSM, two RMSNorm
launches (``ln`` and the mixer's norm) and, in forward and prefill, one
``ssd_scan`` launch (a decode step runs the one-token recurrence as
plain tensor code, as the JAX package does); each call of zamba2's
shared block, two RMSNorm launches and one attention launch. The
projections are ``torch.matmul`` (``ops.qmatmul`` for a quantized
weight); one more RMSNorm for the final norm.

Training: :func:`loss_fn` (next-token cross-entropy, the JAX package's)
and ``cfg.remat`` in :func:`forward` where grad is enabled (the JAX
package's ``_remat``, ``_auto_group`` and group branch): ``none``;
``full``, ``torch.utils.checkpoint`` (non-reentrant) once a layer (a
group of ``moe_every`` layers in the grouped layout; the encoder's
layers and the Mamba layers too, not zamba2's shared block); ``dots``,
the same with a selective-checkpoint policy that saves the outputs of
the 2-D matmuls (the projections, ``aten.mm``) and recomputes the rest;
``group``, groups of g layers (``remat_group``, or the divisor of the
layer count nearest below its square root) checkpointed with each layer
checkpointed inside its group, for the attention families' plain stack
with ``scan_layers`` (elsewhere ``group`` is ``full``, as in the JAX
package). A recomputed layer launches its forward kernels again. Under
``torch.no_grad()`` and ``torch.inference_mode()`` the forward is the
same as without remat.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
from torch.utils import checkpoint as _ckpt

from ..configs.base import ModelCfg
from ..core.quant import QTensor
from ..device import resolve_device
from ..kernels import ops
from ..nn import attention as A
from ..nn import flash
from ..nn import layers as L
from ..nn import moe as M
from ..nn import ssm as S
from ..tree import leaves

# the families whose layers are transformer blocks with a KV cache
ATTN_FAMILIES = ("dense", "moe", "vlm", "encdec")


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


def _grouped(cfg: ModelCfg) -> bool:
    """The grouped layout: an MoE layer every ``moe_every`` layers."""
    return cfg.family == "moe" and cfg.moe_every > 1


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _auto_group(n_layers: int) -> int:
    """Largest divisor of n_layers closest to √n_layers."""
    root = max(int(math.isqrt(n_layers)), 1)
    for d in range(root, 0, -1):
        if n_layers % d == 0:
            return d
    return 1


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of the 2-D matmuls (the projections; the JAX package's
    ``checkpoint_dots_with_no_batch_dims``), recompute the rest."""
    return (_ckpt.CheckpointPolicy.MUST_SAVE
            if op is torch.ops.aten.mm.default
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return _ckpt.create_selective_checkpoint_contexts(_save_dots)


def _remat(fn: Callable, mode: str) -> Callable:
    """``fn`` checkpointed by ``mode``: as is for ``none``; once a call
    for ``full`` (and ``group``); with the ``dots`` policy."""
    if mode == "none":
        return fn
    context = _dots_context if mode == "dots" else _ckpt.noop_context_fn
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                             context_fn=context, preserve_rng_state=False)


def _remat_mode(cfg: ModelCfg) -> str:
    """``cfg.remat`` where grad is enabled, else ``none``."""
    if cfg.remat not in ("none", "full", "dots", "group"):
        raise ValueError(f"remat={cfg.remat!r}: expected none, full, dots "
                         f"or group")
    return cfg.remat if torch.is_grad_enabled() else "none"


def _run_stack(cfg: ModelCfg, steps: list, h, groupable: bool = False):
    """``h`` through ``steps`` (``step(h) → (h, aux)``, aux a tensor or
    None), each step checkpointed by ``cfg.remat`` where grad is
    enabled; with ``groupable`` and ``remat="group"``, groups of g steps
    checkpointed with each step checkpointed inside. Returns (h, the
    steps' auxes that are not None, in order)."""
    mode = _remat_mode(cfg)
    if mode == "group" and groupable:
        g = cfg.remat_group or _auto_group(len(steps))
        units = [_remat(functools.partial(_run_steps, [
            _remat(s, "full") for s in steps[i:i + g]]), "full")
            for i in range(0, len(steps), g)]
    else:
        units = [_remat(functools.partial(_run_steps, [s]),
                        "full" if mode == "group" else mode)
                 for s in steps]
    auxes = []
    for unit in units:
        h, a = unit(h)
        auxes += a
    return h, auxes


def _run_steps(steps: list, h):
    auxes = []
    for step in steps:
        h, a = step(h)
        if a is not None:
            auxes.append(a)
    return h, auxes


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


def layer(stacked, i: int, cfg: ModelCfg | None = None) -> dict:
    """Layer ``i`` of a layer-stacked tree (views, no copy), of the list
    :func:`split_layers` makes, or, given a ``cfg`` with the grouped
    layout, of the grouped tree: group ``i // moe_every``, its dense
    sublayer ``i % moe_every`` or, last in the group, its MoE layer."""
    if isinstance(stacked, list):
        return stacked[i]
    if cfg is not None and _grouped(cfg):
        g, j = divmod(i, cfg.moe_every)
        if j == cfg.moe_every - 1:
            return tree_map(lambda v: _layer_leaf(v, g), stacked["moe"])
        return tree_map(lambda v: _layer_leaf(_layer_leaf(v, g), j),
                        stacked["dense"])
    return tree_map(lambda v: _layer_leaf(v, i), stacked)


def split_layers(params: dict, cfg: ModelCfg) -> dict:
    """``params`` with ``layers`` as a list of per-layer trees (views of
    the stacked tensors, no copy): a caller that runs many steps, such
    as ``LmReplica``, slices once instead of once per layer per step."""
    return dict(params, layers=[layer(params["layers"], i, cfg)
                                for i in range(cfg.n_layers)])


def _init_dense_layers(gen, cfg: ModelCfg, lead: tuple, device,
                       dtype) -> dict:
    """Transformer blocks stacked on ``lead``: an MoE block for the moe
    family (its MLP the experts), cross-attention for encdec."""
    kw = dict(lead=lead, device=device, dtype=dtype)
    p = {"ln1": L.rmsnorm_init(cfg.d_model, **kw),
         "ln2": L.rmsnorm_init(cfg.d_model, **kw),
         "attn": A.init(gen, attn_cfg(cfg), **kw)}
    if cfg.post_norm:
        p["ln1p"] = L.rmsnorm_init(cfg.d_model, **kw)
        p["ln2p"] = L.rmsnorm_init(cfg.d_model, **kw)
    if cfg.family == "moe":
        p["moe"] = M.init(gen, cfg.moe, **kw)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff,
                              gated=cfg.mlp_gated, **kw)
    if cfg.is_encdec:
        p["ln_x"] = L.rmsnorm_init(cfg.d_model, **kw)
        p["xattn"] = A.init(gen, attn_cfg(cfg, causal=False,
                                          use_rope=False), **kw)
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
    device = resolve_device(device)
    p: dict[str, Any] = {"embed": L.embed_init(generator, cfg.vocab,
                                               cfg.d_model, device, dtype)}
    if _grouped(cfg):
        me = cfg.moe_every
        G = cfg.n_layers // me
        dense_cfg = dataclasses.replace(cfg, family="dense")
        p["layers"] = {
            "dense": _init_dense_layers(generator, dense_cfg, (G, me - 1),
                                        device, dtype),
            "moe": _init_dense_layers(generator, cfg, (G,), device, dtype)}
    elif cfg.family in ATTN_FAMILIES:
        p["layers"] = _init_dense_layers(generator, cfg, (cfg.n_layers,),
                                         device, dtype)
    else:
        p["layers"] = _init_ssm_layers(generator, cfg, device, dtype)
    p["final_norm"] = L.rmsnorm_init(cfg.d_model, device=device,
                                     dtype=dtype)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.linear_init(generator, cfg.d_model, cfg.vocab,
                                     device=device, dtype=dtype)
    if cfg.is_encdec:
        enc_cfg = dataclasses.replace(cfg, family="dense", n_enc_layers=0)
        p["enc_layers"] = _init_dense_layers(
            generator, enc_cfg, (cfg.n_enc_layers,), device, dtype)
        p["enc_norm"] = L.rmsnorm_init(cfg.d_model, device=device,
                                       dtype=dtype)
    if _shared_every(cfg):
        p["shared"] = _init_shared_block(generator, cfg, device, dtype)
    return p


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _mlp_block(cfg: ModelCfg, pl, h, lb: list | None = None):
    """``h`` plus the block's MLP, or its MoE layer where it has one
    (whose load-balance loss is appended to ``lb``)."""
    m_in = L.rmsnorm(pl["ln2"], h, cfg.norm_eps)
    if "moe" in pl:
        m, aux = M.forward_with_aux(pl["moe"], cfg.moe, m_in)
        if lb is not None:
            lb.append(aux["load_balance"])
    else:
        m = L.mlp(pl["mlp"], m_in, act=cfg.act)
    if cfg.post_norm:
        m = L.rmsnorm(pl["ln2p"], m, cfg.norm_eps)
    return h + m


def _attn_out(cfg: ModelCfg, pl, a):
    return L.rmsnorm(pl["ln1p"], a, cfg.norm_eps) if cfg.post_norm else a


def _dense_layer_fwd(cfg: ModelCfg, pl, h, pos, window, rope,
                     enc_out=None, lb: list | None = None):
    a = A.forward(pl["attn"], attn_cfg(cfg),
                  L.rmsnorm(pl["ln1"], h, cfg.norm_eps), positions=pos,
                  window=window, rope=rope)
    h = h + _attn_out(cfg, pl, a)
    if enc_out is not None:
        h = h + A.forward(pl["xattn"], attn_cfg(cfg, causal=False,
                                                use_rope=False),
                          L.rmsnorm(pl["ln_x"], h, cfg.norm_eps),
                          kv_x=enc_out, window=None)
    return _mlp_block(cfg, pl, h, lb)


def dense_layers(cfg: ModelCfg, layers, h, first: int = 0):
    """``h`` (B, T, d) through the layer-stacked dense ``layers`` (each
    leaf's leading axis counts them; layer ``first`` of ``cfg`` first, for
    its window): causal, no cache, positions 0..T-1 — the body of a
    pipeline stage (``core.pipeline``)."""
    pos = torch.arange(h.shape[1], device=h.device)[None, :]
    rope = _rope(cfg, pos)
    wins = layer_windows(cfg)
    n = leaves(layers)[0].shape[0]
    for i in range(n):
        h = _dense_layer_fwd(cfg, layer(layers, i), h, pos, wins[first + i],
                             rope)
    return h


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


def _embed_inputs(cfg: ModelCfg, params, batch: dict):
    """The tokens' embeddings, after a vlm's patch embeddings."""
    h = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.family == "vlm":
        h = torch.cat([batch["embeds"].to(h.dtype), h], dim=1)
    return h


def _readout(cfg: ModelCfg, params, h):
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = (L.unembed(params["embed"], h) if cfg.tie_embeddings
              else L.linear(params["lm_head"], h))
    if cfg.final_softcap is not None:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _run_encoder(cfg: ModelCfg, params, src_embeds):
    """An encdec model's encoder: bidirectional self-attention with RoPE
    over the source positions, no windows and no post norms, then
    ``enc_norm`` (the JAX package's ``_run_encoder``)."""
    acfg = attn_cfg(cfg, causal=False)
    rope = _rope(cfg, torch.arange(src_embeds.shape[1],
                                   device=src_embeds.device)[None, :])

    def step(pl, h):
        h = h + A.forward(pl["attn"], acfg,
                          L.rmsnorm(pl["ln1"], h, cfg.norm_eps),
                          window=None, rope=rope)
        h = h + L.mlp(pl["mlp"], L.rmsnorm(pl["ln2"], h, cfg.norm_eps),
                      act=cfg.act)
        return h, None

    h, _ = _run_stack(cfg, [functools.partial(
        step, layer(params["enc_layers"], i))
        for i in range(cfg.n_enc_layers)], src_embeds)
    return L.rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def forward(params: dict, cfg: ModelCfg, batch: dict) -> tuple:
    """Full-sequence forward. batch: {"tokens": (B, T) integer tensor},
    with "embeds" (B, F, d) for vlm and "src_embeds" (B, S, d) for
    encdec. Returns (logits (B, T_total, V), aux dict); a moe model's aux
    has "load_balance", the mean over its MoE layers."""
    h = _embed_inputs(cfg, params, batch)
    pos = torch.arange(h.shape[1], device=h.device)[None, :]
    rope = _rope(cfg, pos)
    aux: dict = {}
    if cfg.family in ATTN_FAMILIES:
        enc_out = _run_encoder(cfg, params, batch["src_embeds"]) \
            if cfg.is_encdec else None
        wins = layer_windows(cfg)
        # one step a layer; in the grouped layout one a group of
        # moe_every layers (the JAX package's scan body, remat'd whole)
        per = cfg.moe_every if _grouped(cfg) else 1

        def step(j, h):
            lb: list = []
            for i in range(j, j + per):
                h = _dense_layer_fwd(cfg, layer(params["layers"], i, cfg),
                                     h, pos, wins[i], rope, enc_out, lb)
            return h, (lb[0] if lb else None)

        h, lbs = _run_stack(cfg, [functools.partial(step, j) for j in
                                  range(0, cfg.n_layers, per)], h,
                            groupable=not _grouped(cfg) and cfg.scan_layers)
        if cfg.family == "moe":
            aux["load_balance"] = sum(lbs) / len(lbs)
    else:
        acfg = attn_cfg(cfg)
        h = _ssm_stack(
            params, cfg, h,
            lambda i, pm, x: S.forward(pm, cfg.ssm, x)[0],
            lambda call, a_in: A.forward(params["shared"]["attn"], acfg,
                                         a_in, positions=pos, window=None,
                                         rope=rope))
    return _readout(cfg, params, h), aux


def loss_fn(params: dict, cfg: ModelCfg, batch: dict):
    """Next-token cross-entropy; labels < 0 are masked. A vlm's logits
    cover [patches; text] and are sliced to the text; a moe model adds
    0.01 · its load-balance loss. Returns (loss, {"loss", "tokens"}),
    0-d float32 tensors."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    if cfg.family == "vlm":                    # logits cover [img; text]
        logits = logits[:, -labels.shape[1]:]
    lw = (labels >= 0).to(torch.float32)
    lab = torch.clamp(labels, min=0).long()
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, lab[..., None])[..., 0]
    nll = (lse - gold) * lw
    loss = torch.sum(nll) / torch.clamp(torch.sum(lw), min=1.0)
    if "load_balance" in aux:
        loss = loss + 0.01 * aux["load_balance"]
    return loss, {"loss": loss, "tokens": torch.sum(lw)}


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
    the current token's in a decode step (the same quantity). Each
    Mamba layer is checkpointed by ``cfg.remat`` where grad is enabled
    (the shared block is not, as in the JAX package)."""
    h0 = h
    every = _shared_every(cfg) or cfg.n_layers
    mode = _remat_mode(cfg)

    def step(i, h):
        pl = layer(params["layers"], i)
        return h + mix(i, pl["mixer"], L.rmsnorm(pl["ln"], h, cfg.norm_eps))

    for call, start in enumerate(range(0, cfg.n_layers, every)):
        if _shared_every(cfg):
            h = _shared_block(cfg, params["shared"], h, h0,
                              lambda a_in, call=call: attend(call, a_in))
        for i in range(start, min(start + every, cfg.n_layers)):
            h = _remat(functools.partial(step, i),
                       "full" if mode == "group" else mode)(h)
    return h


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelCfg, batch: int, cache_size: int,
               dtype=torch.float32, device=None, src_len: int = 0) -> dict:
    """Static-shape decode cache on ``device`` (default ``cuda:0``):
    ``len`` (B,) int32; attention families: ``k``/``v`` (L, B,
    cache_size, Hkv, Dh), int8 codes with ``k_s``/``v_s`` (L, B,
    cache_size, Hkv) float32 scales (filled with 1e-8) for
    ``kv_bits=8``; encdec: ``xk``/``xv`` (L, B, src_len, Hkv, Dh), the
    encoder's cross-attention keys and values; ssm and hybrid: ``conv``
    (L, B, K-1, conv_dim) and ``ssm`` (L, B, H, N, P) float32; hybrid:
    ``sk``/``sv`` (calls, B, cache_size, Hkv, Dh) for the
    ceil(L / shared_attn_every) calls of the shared block."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    kv = (batch, cache_size, cfg.n_kv_heads, cfg.head_dim)
    if cfg.family in ATTN_FAMILIES:
        shape = (cfg.n_layers,) + kv
        if cfg.kv_bits == 8:
            for name in ("k", "v"):
                cache[name] = torch.zeros(shape, dtype=torch.int8,
                                          device=device)
            for name in ("k_s", "v_s"):
                cache[name] = torch.full(shape[:-1], 1e-8,
                                         dtype=torch.float32, device=device)
        else:
            cache["k"] = torch.zeros(shape, **kw)
            cache["v"] = torch.zeros(shape, **kw)
        if cfg.is_encdec:
            xshape = (cfg.n_layers, batch, src_len, cfg.n_kv_heads,
                      cfg.head_dim)
            cache["xk"] = torch.zeros(xshape, **kw)
            cache["xv"] = torch.zeros(xshape, **kw)
        return cache
    st = S.init_state(cfg.ssm, batch, **kw)
    cache["conv"] = st["conv"][None].repeat(cfg.n_layers, 1, 1, 1)
    cache["ssm"] = st["ssm"][None].repeat(cfg.n_layers, 1, 1, 1, 1)
    if _shared_every(cfg):
        n_calls = -(-cfg.n_layers // cfg.shared_attn_every)
        cache["sk"] = torch.zeros((n_calls,) + kv, **kw)
        cache["sv"] = torch.zeros((n_calls,) + kv, **kw)
    return cache


def _kv_slices(cfg: ModelCfg, cache: dict, i: int) -> tuple:
    """Layer ``i``'s cache: (k, v), or (kq, ks, vq, vs) for
    ``kv_bits=8`` (views, written in place)."""
    if cfg.kv_bits == 8:
        return (cache["k"][i], cache["k_s"][i], cache["v"][i],
                cache["v_s"][i])
    return cache["k"][i], cache["v"][i]


def prefill(params: dict, cfg: ModelCfg, batch: dict, cache_size: int):
    """Process the prompt (after a vlm's ``embeds``; an encdec model also
    runs its encoder over ``src_embeds`` and caches every decoder layer's
    cross-attention keys and values); returns (last_logits (B, V),
    cache)."""
    h = _embed_inputs(cfg, params, batch)
    B, T = h.shape[:2]
    src_len = batch["src_embeds"].shape[1] if cfg.is_encdec else 0
    cache = init_cache(cfg, B, cache_size, h.dtype, device=h.device,
                       src_len=src_len)
    acfg = attn_cfg(cfg)
    rope = _rope(cfg, torch.arange(T, device=h.device)[None, :])
    if cfg.family in ATTN_FAMILIES:
        enc_out = _run_encoder(cfg, params, batch["src_embeds"]) \
            if cfg.is_encdec else None
        xcfg = attn_cfg(cfg, causal=False, use_rope=False)
        for i, w in enumerate(layer_windows(cfg)):
            pl = layer(params["layers"], i, cfg)
            a, (kc, vc) = A.prefill(pl["attn"], acfg,
                                    L.rmsnorm(pl["ln1"], h, cfg.norm_eps),
                                    cache_size, window=w, rope=rope)
            if cfg.kv_bits == 8:
                cache["k"][i], cache["k_s"][i] = flash.quantize_kv_rows(kc)
                cache["v"][i], cache["v_s"][i] = flash.quantize_kv_rows(vc)
            else:
                cache["k"][i] = kc
                cache["v"][i] = vc
            h = h + _attn_out(cfg, pl, a)
            if enc_out is not None:
                # the reference's prefill passes no softcap here
                q, xk, xv = A._project_qkv(
                    pl["xattn"], xcfg, L.rmsnorm(pl["ln_x"], h,
                                                 cfg.norm_eps), enc_out)
                o = ops.mha(q, xk, xv, causal=False, window=None,
                            softcap=None)
                h = h + L.linear(pl["xattn"]["wo"], o.reshape(B, T, -1))
                cache["xk"][i] = xk
                cache["xv"][i] = xv
            h = _mlp_block(cfg, pl, h)
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
    # the last position of each row: a strided view where B > 1, which
    # the RMSNorm kernel does not take
    logits = _readout(cfg, params, h[:, -1:].contiguous())[:, 0]
    return logits, cache


def decode_step(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                cache: dict):
    """One decode step. tokens: (B,) integer tensor → (logits (B, V),
    cache). The cache is updated IN PLACE (each row's k/v, or codes and
    scales, written at its ``len``, the SSM layers' conv ring and state
    overwritten, then ``len`` advanced) and returned; the JAX package
    returns a new one. An encdec step attends to all ``src_len`` cached
    encoder rows through ``ops.decode_attention``, its query ``wq``
    alone (no ``qnorm``), as the reference's."""
    h = _embed_tokens(cfg, params, tokens[:, None])
    B = h.shape[0]
    clen = cache["len"]
    acfg = attn_cfg(cfg)
    rope = _rope(cfg, clen[:, None])
    if cfg.family in ATTN_FAMILIES:
        if cfg.is_encdec:
            src_len = torch.full((B,), cache["xk"].shape[2],
                                 dtype=torch.int32, device=h.device)
        for i, w in enumerate(layer_windows(cfg)):
            pl = layer(params["layers"], i, cfg)
            a, _ = A.decode_step(pl["attn"], acfg,
                                 L.rmsnorm(pl["ln1"], h, cfg.norm_eps),
                                 _kv_slices(cfg, cache, i), clen, window=w,
                                 rope=rope)
            h = h + _attn_out(cfg, pl, a)
            if cfg.is_encdec:
                x_in = L.rmsnorm(pl["ln_x"], h, cfg.norm_eps)
                q = L.linear(pl["xattn"]["wq"], x_in).reshape(
                    B, cfg.n_heads, cfg.head_dim)
                o = ops.decode_attention(q, cache["xk"][i], cache["xv"][i],
                                         src_len)
                h = h + L.linear(pl["xattn"]["wo"], o.reshape(B, 1, -1))
            h = _mlp_block(cfg, pl, h)
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
