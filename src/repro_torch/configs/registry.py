"""Architecture registry: the 10 assigned archs + the paper's YOLO models.

``get(name)`` returns the full-size ModelCfg; ``reduced(name)`` returns a
CPU-smoke-sized config of the same family (small widths/layers/experts).
A copy of the JAX package's ``configs/registry.py``; the figures and
``reduced`` are unchanged, so both packages build the same configs.
"""
from __future__ import annotations

import dataclasses

from .base import ModelCfg
from ..nn.moe import MoeCfg
from ..nn.ssm import SsmCfg


# --------------------------------------------------------------------------
# Assigned architectures (exact figures from the assignment table)
# --------------------------------------------------------------------------

GRANITE_3_8B = ModelCfg(
    name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=12800, vocab=49155,
    act="silu", rope_theta=10_000.0, tie_embeddings=False,
    notes="GQA [hf:ibm-granite/granite-3.0-2b-base]")

GEMMA2_2B = ModelCfg(
    name="gemma2-2b", family="dense", n_layers=26, d_model=2304,
    n_heads=8, n_kv_heads=4, head_dim=256, d_ff=9216, vocab=256_000,
    act="gelu", window=4096, window_pattern="alternate",
    attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    embed_scale=True, tie_embeddings=True, subquadratic=True,
    notes="local+global alternating, logit softcap [arXiv:2408.00118]; "
          "long_500k runs: local layers window-bounded, global layers "
          "linear-cost at decode")

LLAMA3_405B = ModelCfg(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, head_dim=128, d_ff=53248, vocab=128_256,
    act="silu", rope_theta=500_000.0, tie_embeddings=False,
    remat="group",      # √L nested remat — fits 126 layers in HBM
    notes="GQA 128k vocab [arXiv:2407.21783]")

STARCODER2_7B = ModelCfg(
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv_heads=4, head_dim=128, d_ff=18432, vocab=49152,
    act="gelu", mlp_gated=False, rope_theta=1_000_000.0,
    tie_embeddings=True,
    notes="GQA, RoPE [arXiv:2402.19173]")

LLAVA_NEXT_34B = ModelCfg(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
    act="silu", tie_embeddings=False, frontend="vision",
    n_frontend_tokens=2880, remat="group",
    notes="anyres tiling [hf:llava-hf/llava-v1.6]; vision tower is a "
          "STUB — input_specs supplies 2880 precomputed patch embeddings")

LLAMA4_MAVERICK = ModelCfg(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
    vocab=202_048, act="silu", tie_embeddings=False, moe_every=2,
    moe=MoeCfg(d_model=5120, n_experts=128, top_k=1, d_ff=8192,
               n_shared=1, shared_d_ff=8192),
    notes="MoE 128e top-1 + shared expert every 2nd layer "
          "(interleave_moe_layer_step=2 per hf config — also what makes "
          "the total ≈400B / active ≈17B) [hf:meta-llama/Llama-4]")

QWEN3_MOE_30B = ModelCfg(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab=151_936,
    act="silu", qk_norm=True, tie_embeddings=False,
    moe=MoeCfg(d_model=2048, n_experts=128, top_k=8, d_ff=768),
    notes="128 experts top-8, fine-grained [hf:Qwen/Qwen3-30B-A3B]")

MAMBA2_130M = ModelCfg(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=1, n_kv_heads=1, head_dim=64, d_ff=0, vocab=50_280,
    ssm=SsmCfg(d_model=768, d_state=128, head_dim=64, expand=2,
               n_groups=1),
    tie_embeddings=True, subquadratic=True,
    notes="SSD (state-space duality) [arXiv:2405.21060]; attention-free")

ZAMBA2_1_2B = ModelCfg(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab=32000,
    act="gelu",
    ssm=SsmCfg(d_model=2048, d_state=64, head_dim=64, expand=2,
               n_groups=1),
    shared_attn_every=6, tie_embeddings=True, subquadratic=True,
    notes="Mamba2 backbone + shared attn block [arXiv:2411.15242]; the "
          "shared block is the SATAY long-skip analogue")

SEAMLESS_M4T_MEDIUM = ModelCfg(
    name="seamless-m4t-medium", family="encdec", n_layers=12,
    n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=256_206, act="gelu", tie_embeddings=True,
    frontend="audio",
    notes="enc-dec, multimodal [arXiv:2308.11596]; speech frontend is a "
          "STUB — input_specs supplies precomputed frame embeddings; "
          "src_len = min(seq_len, 4096) frames")

ARCHS: dict[str, ModelCfg] = {
    c.name: c for c in (
        GRANITE_3_8B, GEMMA2_2B, LLAMA3_405B, STARCODER2_7B, LLAVA_NEXT_34B,
        LLAMA4_MAVERICK, QWEN3_MOE_30B, MAMBA2_130M, ZAMBA2_1_2B,
        SEAMLESS_M4T_MEDIUM)
}


def get(name: str) -> ModelCfg:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(name: str) -> ModelCfg:
    """Smoke-test-sized config of the same family (CPU-runnable)."""
    cfg = get(name)
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4 if cfg.family == "hybrid" else 2),
        d_model=64,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab=512, n_frontend_tokens=min(cfg.n_frontend_tokens, 8),
        attn_chunk=64, remat="none",
    )
    if cfg.window is not None:
        kw["window"] = 8
    if cfg.moe is not None:
        # capacity_factor 8 → no token drops: smoke tests check exact
        # prefill/decode agreement (production keeps 1.25 and may drop)
        kw["moe"] = dataclasses.replace(
            cfg.moe, d_model=64, n_experts=8, top_k=min(cfg.moe.top_k, 2),
            d_ff=32, shared_d_ff=32 if cfg.moe.n_shared else 0,
            capacity_factor=8.0)
        kw["moe_every"] = cfg.moe_every
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_model=64, d_state=16, head_dim=16, chunk=16)
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 2
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2
    return dataclasses.replace(cfg, **kw)
