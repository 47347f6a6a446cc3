"""Roofline analysis: the one source of the port's bounds.

``kernel_roofline`` is the bound of one kernel call on one card: the
larger of its operations over the peak of the math it runs and its
bytes over the card's memory rate (``hw.H100_SXM``). The port's kernels
run fp32 outside the tensor cores, TF32 or int8 on them, and a TF32
route may take several passes over each product (a hi/lo split: three
TF32 MMAs a product on #1, #2, #11 and #13, two or four on #7): the
caller names the math and the passes, and the bound counts
``passes × flops`` at that math's peak. ``Roofline`` is the three-term
model of a whole step over ``chips`` cards:

    compute    = FLOPs / (compute chips · peak of ``math``)
    memory     = HBM bytes / (chips · hbm_bw)
    collective = collective bytes / (chips · one NVLink link's rate)

The ``analytic_*`` functions and ``model_flops`` are closed-form counts
from the model config, copied from the JAX package's
``roofline/analysis.py`` with their defaults (``param_bytes=2``), so
that the two packages count the same work; the port's own callers pass
``param_bytes=4``, as it runs float32. MODEL_FLOPS = 6·N·D (train) /
2·N·D (inference) is the work a model-FLOP share divides by.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..configs.base import ModelCfg, ShapeCell
from .hw import DEFAULT_CHIP, GpuChip


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    chip: GpuChip = DEFAULT_CHIP
    # chips that actually COMPUTE (an op that is not tensor-parallel
    # idles the model axis)
    compute_chips: int | None = None
    math: str = "fp32"              # the peak t_compute divides by

    @property
    def t_compute(self) -> float:
        eff = self.compute_chips or self.chips
        return self.flops / (eff * self.chip.peak(self.math))

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.chip.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * self.chip.nvlink_bw_per_link)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        # no-overlap upper bound; perfect-overlap lower bound is max()
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck, "step_time_s": self.step_time,
        }


def kernel_roofline(flops: float, hbm_bytes: float,
                    chip: GpuChip = DEFAULT_CHIP, math: str = "fp32",
                    passes: int = 1) -> dict[str, Any]:
    """Single-kernel roofline bound on one card.

    ``flops`` is the function's work; the route runs ``passes`` of
    ``math`` over it (``passes × flops`` at ``chip.peak(math)``). Returns
    the time lower bound (max of the compute and memory terms), the
    throughput ceilings, the limiting resource, and the arithmetic
    intensity (FLOP/byte) of the function. The JAX package's
    ``int8=True`` is ``math="int8"`` here.
    """
    t_compute = passes * flops / chip.peak(math)
    t_memory = hbm_bytes / chip.hbm_bw
    bound_s = max(t_compute, t_memory)
    return {
        "flops": float(flops),
        "hbm_bytes": float(hbm_bytes),
        "intensity": float(flops / max(hbm_bytes, 1.0)),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "bound_s": bound_s,
        "bound_gflops": flops / bound_s / 1e9 if bound_s else 0.0,
        "bound_gbps": hbm_bytes / bound_s / 1e9 if bound_s else 0.0,
        "bottleneck": "compute" if t_compute >= t_memory else "memory",
    }


# The math each hand-written kernel of the port runs, and the passes of
# that math its route makes over each product of the function
# (src/repro_torch/csrc): #1, #2, #11 and #13 split both operands into
# TF32 hi and lo and take three MMAs a product; #7 splits x in two exact
# TF32 terms (two passes), and int16 codes in two planes as well (four);
# #8, #9 and #10 run int8 MMAs; the rest run fp32 outside the tensor
# cores. ``qmatmul_int16`` is #7 on int16 codes.
KERNEL_ROUTES = {
    "conv2d": ("tf32", 3), "conv2d_double": ("tf32", 3),
    "mha": ("tf32", 3), "ssd_scan": ("tf32", 3),
    "qmatmul": ("tf32", 2), "qmatmul_int16": ("tf32", 4),
    "qmatmul_a8": ("int8", 1), "qmatmul_a8_double": ("int8", 1),
    "qmatmul_a8_grouped": ("int8", 1),
    "rmsnorm": ("fp32", 1), "decode_attention": ("fp32", 1),
    "pointwise": ("fp32", 1), "maxpool2d": ("fp32", 1),
    "resize_nearest": ("fp32", 1),
}


def kernel_bound(kernel: str, flops: float, hbm_bytes: float,
                 chip: GpuChip = DEFAULT_CHIP) -> dict[str, Any]:
    """``kernel_roofline`` of ``flops`` and ``hbm_bytes`` by ``kernel``'s
    route (``KERNEL_ROUTES``)."""
    math, passes = KERNEL_ROUTES[kernel]
    return kernel_roofline(flops, hbm_bytes, chip, math, passes)


def peak_share(flops: float, seconds: float, chip: GpuChip = DEFAULT_CHIP,
               math: str = "fp32", chips: int = 1) -> float:
    """The share of ``chips`` cards' ``math`` peak that ``flops`` of work
    done in ``seconds`` reaches (a model-FLOP share, with
    ``model_flops``)."""
    return flops / seconds / (chips * chip.peak(math))


# ---------------------------------------------------------------------------
# Analytic FLOP model (trip-count exact)
# ---------------------------------------------------------------------------

def _attn_weight_flops(cfg: ModelCfg, tokens: int) -> float:
    Dh = cfg.head_dim
    return 2.0 * tokens * cfg.d_model * Dh * (2 * cfg.n_heads
                                              + 2 * cfg.n_kv_heads)


def _attn_score_flops(cfg: ModelCfg, B: int, Tq: int, Tk: int,
                      layer: int) -> float:
    w = cfg.layer_window(layer)
    tk_eff = min(Tk, w) if w is not None else Tk
    if Tq == Tk:                                # causal prefill/train
        avg_k = (tk_eff + 1) / 2 if w is None else \
            min(tk_eff, (Tk + 1) / 2)
        return 4.0 * B * cfg.n_heads * cfg.head_dim * Tq * avg_k
    return 4.0 * B * cfg.n_heads * cfg.head_dim * Tq * tk_eff


def _mlp_flops(cfg: ModelCfg, tokens: int) -> float:
    if cfg.family == "moe" and cfg.moe:
        m = cfg.moe
        f = 2.0 * tokens * m.top_k * 3 * cfg.d_model * m.d_ff
        if m.n_shared:
            f += 2.0 * tokens * 3 * cfg.d_model \
                * (m.shared_d_ff or m.d_ff) * m.n_shared
        f += 2.0 * tokens * cfg.d_model * m.n_experts    # router
        return f
    if cfg.d_ff == 0:
        return 0.0
    n_mats = 3 if cfg.mlp_gated else 2
    return 2.0 * tokens * n_mats * cfg.d_model * cfg.d_ff


def _ssm_flops(cfg: ModelCfg, tokens: int, decode: bool = False) -> float:
    s = cfg.ssm
    di, G, N, H, P = s.d_inner, s.n_groups, s.d_state, s.n_heads, s.head_dim
    f = 2.0 * tokens * cfg.d_model * (2 * di + 2 * G * N + H)   # in_proj
    f += 2.0 * tokens * di * cfg.d_model                        # out_proj
    f += 2.0 * tokens * s.conv_kernel * (di + 2 * G * N)        # conv
    if decode:
        f += 4.0 * tokens * H * N * P                           # state upd+out
    else:
        c = s.chunk
        f += 2.0 * tokens * c * H * (N + P)                     # intra-chunk
        f += 6.0 * tokens * H * N * P                           # inter-chunk
    return f


def analytic_flops(cfg: ModelCfg, cell: ShapeCell) -> dict[str, float]:
    """Forward FLOPs of one step (global, all chips), decomposed."""
    B = cell.global_batch
    if cell.kind == "decode":
        Tq, Tk = 1, cell.seq_len
    else:
        Tq = Tk = cell.seq_len
    tokens = B * Tq
    if cfg.family == "vlm" and cell.kind != "decode":
        tokens += B * cfg.n_frontend_tokens
        Tq = Tk = Tq + cfg.n_frontend_tokens
    per_layer = 0.0
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        per_layer += _attn_weight_flops(cfg, tokens)
        score = sum(_attn_score_flops(cfg, B, Tq, Tk, l)
                    for l in range(cfg.n_layers)) / cfg.n_layers
        per_layer += score
        per_layer += _mlp_flops(cfg, tokens)
    elif cfg.family in ("ssm", "hybrid"):
        per_layer = _ssm_flops(cfg, tokens, decode=(cell.kind == "decode"))
    total = per_layer * cfg.n_layers
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        calls = -(-cfg.n_layers // cfg.shared_attn_every)
        blk = (_attn_weight_flops(cfg, tokens)
               + _attn_score_flops(cfg, B, Tq, Tk, 1)
               + _mlp_flops(dataclasses.replace(cfg, family="dense"), tokens)
               + 2.0 * tokens * 3 * cfg.d_model * cfg.d_model)
        total += calls * blk
    if cfg.is_encdec and cell.kind != "decode":
        src_tok = B * min(cell.seq_len, 4096)
        enc_layer = (_attn_weight_flops(cfg, src_tok)
                     + 4.0 * src_tok * cfg.n_heads * cfg.head_dim
                     * min(cell.seq_len, 4096)
                     + _mlp_flops(dataclasses.replace(cfg, family="dense"),
                                  src_tok))
        total += cfg.n_enc_layers * enc_layer
        # cross-attention in every decoder layer
        total += cfg.n_layers * (2.0 * tokens * cfg.d_model * cfg.head_dim
                                 * (cfg.n_heads + 2 * cfg.n_kv_heads)
                                 + 4.0 * B * cfg.n_heads * cfg.head_dim
                                 * Tq * min(cell.seq_len, 4096))
    # readout
    if cell.kind == "train":
        total += 2.0 * tokens * cfg.d_model * cfg.vocab
    else:
        total += 2.0 * B * cfg.d_model * cfg.vocab
    fwd = total
    if cell.kind == "train":
        total = 3.0 * fwd                       # bwd ≈ 2× fwd
        if cfg.remat == "full":
            total += fwd                        # recompute in bwd
    return {"fwd": fwd, "total": total}


def model_flops(cfg: ModelCfg, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    n = cfg.param_count(active_only=(cfg.family == "moe"))
    tokens = cell.global_batch * (1 if cell.kind == "decode"
                                  else cell.seq_len)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n * tokens


# ---------------------------------------------------------------------------
# Analytic HBM + collective byte models
# ---------------------------------------------------------------------------

def analytic_bytes(cfg: ModelCfg, cell: ShapeCell, n_microbatches: int = 1,
                   param_bytes: float = 2, kv_bytes: float | None = None)\
        -> float:
    """Dominant HBM traffic of one step (global)."""
    n = cfg.param_count()
    B = cell.global_batch
    d = cfg.d_model
    if cell.kind == "train":
        # fwd read + bwd read (remat re-read) + grad write/read + update RW
        traffic = n * param_bytes * (2 + 2) * n_microbatches / n_microbatches
        traffic = n * param_bytes * 2 * n_microbatches   # fwd+bwd reads / mb
        traffic += n * 4 * 3                             # grads + opt RW
        acts = B * cell.seq_len * d * cfg.n_layers * 2   # saved layer inputs
        traffic += 2 * acts
        return float(traffic)
    if cell.kind == "prefill":
        acts = B * cell.seq_len * d * cfg.n_layers * 2
        kv = (2 * cfg.n_layers * B * cell.seq_len
              * cfg.n_kv_heads * cfg.head_dim * param_bytes)
        return float(n * param_bytes + acts + kv)
    # decode: weights + full KV (or SSM state) read once per token
    kvb = param_bytes if kv_bytes is None else kv_bytes
    kv = 0.0
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        kv = 2 * cfg.n_layers * B * cell.seq_len \
            * cfg.n_kv_heads * cfg.head_dim * kvb
        for l in range(cfg.n_layers):
            w = cfg.layer_window(l)
            if w is not None:
                kv -= 2 * B * (cell.seq_len - min(w, cell.seq_len)) \
                    * cfg.n_kv_heads * cfg.head_dim * kvb
    if cfg.family in ("ssm", "hybrid") and cfg.ssm:
        s = cfg.ssm
        kv = cfg.n_layers * B * s.n_heads * s.d_state * s.head_dim * 4 * 2
        if cfg.family == "hybrid":
            calls = -(-cfg.n_layers // cfg.shared_attn_every)
            kv += 2 * calls * B * cell.seq_len * cfg.n_kv_heads \
                * cfg.head_dim * param_bytes
    n_active = cfg.param_count(active_only=(cfg.family == "moe"))
    return float(n_active * param_bytes + kv)


def analytic_memory_per_chip(cfg: ModelCfg, cell: ShapeCell, mesh_shape,
                             n_microbatches: int = 1,
                             optimizer: str = "adamw",
                             param_bytes: float = 2,
                             grad_bytes: float = 4) -> dict:
    """Per-chip device-memory residency under the FSDP×TP plan,
    decomposed (``mesh_shape``: axis sizes, e.g. ``{"data": 2,
    "model": 4}``)."""
    sizes = dict(mesh_shape)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    tp = sizes.get("model", 1)
    chips = dp * tp
    n = cfg.param_count()
    B, T = cell.global_batch, cell.seq_len
    d = cfg.d_model
    opt_bytes = {"adamw": 8.0, "int8_adamw": 2.06, "adafactor": 0.1,
                 "sgd": 4.0}[optimizer]
    out = {"params": n * param_bytes / chips}
    if cell.kind == "train":
        out["grads"] = n * grad_bytes / chips
        out["opt_state"] = n * opt_bytes / chips
        # saved activations: remat policy over the layer scan
        mb_tokens_chip = B * T / n_microbatches / dp
        act = mb_tokens_chip * d * 2
        L = cfg.n_layers
        if cfg.remat == "group":
            import math
            g = cfg.remat_group or max(
                (dd for dd in range(int(math.isqrt(L)), 0, -1)
                 if L % dd == 0), default=1)
            out["saved_acts"] = (L // g + g) * act
        else:
            out["saved_acts"] = L * act
        # transient: gathered layer weights (FSDP) + largest layer temp
        out["transient"] = 2 * (n / max(L, 1)) * param_bytes / tp \
            + 4 * act
        if cfg.family == "moe" and cfg.moe:
            out["transient"] += 3 * mb_tokens_chip * cfg.moe.top_k \
                * cfg.moe.d_ff * 2 / tp
    else:
        if cfg.family in ("dense", "moe", "vlm", "encdec"):
            kvb = 1.03 if cfg.kv_bits == 8 else param_bytes
            kv = 2 * cfg.n_layers * B * T * cfg.n_kv_heads \
                * cfg.head_dim * kvb
            out["kv_cache"] = kv / chips
        if cfg.family in ("ssm", "hybrid") and cfg.ssm:
            s = cfg.ssm
            out["ssm_state"] = cfg.n_layers * B * (
                s.n_heads * s.d_state * s.head_dim * 4
                + (s.conv_kernel - 1)
                * (s.d_inner + 2 * s.n_groups * s.d_state) * 2) / dp
            if cfg.family == "hybrid":
                calls = -(-cfg.n_layers // cfg.shared_attn_every)
                out["kv_cache"] = 2 * calls * B * T * cfg.n_kv_heads \
                    * cfg.head_dim * param_bytes / chips
        tok = B * (1 if cell.kind == "decode" else T)
        # inference keeps NO per-layer residuals — ~4 transient layer
        # activation buffers (h, attn out, mlp in, flash workspace) plus
        # the gathered layer weights
        out["transient"] = 2 * (n / max(cfg.n_layers, 1)) * param_bytes / tp \
            + 4 * tok * d * 2 / dp
    out["total"] = float(sum(out.values()))
    return out


def analytic_collective_bytes(cfg: ModelCfg, cell: ShapeCell, mesh_shape,
                              n_microbatches: int = 1,
                              param_bytes: float = 2,
                              shard_experts: bool = True,
                              tp_active: bool = True) -> float:
    """Interconnect bytes per step implied by the FSDP×TP×EP sharding
    rules (global, summed over chips)."""
    sizes = dict(mesh_shape)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    tp = sizes.get("model", 1) if tp_active else 1
    if not tp_active:
        dp *= sizes.get("model", 1)
    n = cfg.param_count()
    B = cell.global_batch
    d = cfg.d_model
    total = 0.0
    if cell.kind == "train":
        # FSDP all-gather params (fwd+bwd) per microbatch: each chip
        # receives (1-1/dp) of the layer params it lacks.
        total += 2 * n_microbatches * n * param_bytes * (dp - 1)
        # grad reduce-scatter + TP grad all-reduce (f32 grads)
        total += n * 4 * (dp - 1)
        # TP activation all-reduces: 2 per layer (attn out, mlp out) over
        # the GLOBAL token count (microbatching doesn't change totals);
        # ring all-reduce ≈ 2·bytes·(tp-1)/tp per chip.
        act = B * cell.seq_len * d * 2
        total += 2 * cfg.n_layers * act * 2 * (tp - 1) / tp
    else:
        tokens = B * (1 if cell.kind == "decode" else cell.seq_len)
        act = tokens * d * param_bytes
        total += 2 * cfg.n_layers * act * 2 * (tp - 1) / tp
        if cell.kind == "decode":
            # seq-sharded KV softmax all-reduces: O(B·H) scalars — small
            total += 2 * cfg.n_layers * B * cfg.n_heads * 8 * tp
    if cfg.family == "moe" and cfg.moe and shard_experts:
        tokens = B * (1 if cell.kind == "decode" else cell.seq_len)
        mult = 3 if cell.kind == "train" else 1   # fwd + bwd(2×)
        n_moe = cfg.n_layers // cfg.moe_every
        # EP all-to-all per MoE layer: dispatch + combine of top_k
        # token copies (independent of microbatching)
        total += n_moe * 2 * tokens * cfg.moe.top_k * d * param_bytes \
            * mult
    return float(total)
