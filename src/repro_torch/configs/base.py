"""Config schema: model architecture + shape cells + parallelism plan.

One ``ModelCfg`` per assigned architecture lives in its own module
(``configs/<id>.py``). A copy of the JAX package's ``configs/base.py``.
Shape cells (train_4k / prefill_32k / decode_32k / long_500k)
are shared across the LM family per the assignment.
"""
from __future__ import annotations

import dataclasses

from ..nn.moe import MoeCfg
from ..nn.ssm import SsmCfg


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                       # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"
    rope_theta: float = 10_000.0
    window: int | None = None         # sliding-window size
    window_pattern: str = "none"      # none|all|alternate (gemma2: local/global)
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    post_norm: bool = False           # gemma2 sandwich norms
    mlp_gated: bool = True            # GLU family (False: starcoder2)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    embed_scale: bool = False         # gemma-style sqrt(d) embed scaling
    # MoE
    moe: MoeCfg | None = None
    moe_every: int = 1                # llama4: MoE every 2nd layer
    # SSM / hybrid
    ssm: SsmCfg | None = None
    shared_attn_every: int = 0        # zamba2: shared block cadence
    # enc-dec
    n_enc_layers: int = 0
    # modality frontend (STUB: input_specs supplies embeddings)
    frontend: str = "none"            # none|vision|audio
    n_frontend_tokens: int = 0
    # execution
    remat: str = "full"               # none|full|dots|group (√L nested)
    remat_group: int = 0              # group size for remat="group" (0=auto)
    scan_layers: bool = True
    seq_shard: bool = False           # Megatron-SP residual sharding —
                                      # refuted for this flash impl, see
                                      # EXPERIMENTS.md §Perf hypothesis log
    attn_chunk: int = 2048            # flash chunk (XLA-native path)
    # serving quantization (§Perf hillclimb: SATAY W8/A16 applied to the
    # decode path — int8 KV cache with per-row blocked-FP scales)
    kv_bits: int = 16                 # 16 = bf16 cache, 8 = int8+scales
    # capability flags
    subquadratic: bool = False        # eligible for long_500k
    notes: str = ""

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def layer_window(self, layer: int) -> int | None:
        if self.window is None or self.window_pattern == "none":
            return None
        if self.window_pattern == "all":
            return self.window
        if self.window_pattern == "alternate":
            return self.window if layer % 2 == 0 else None
        raise ValueError(self.window_pattern)

    # Rough parameter count (for roofline MODEL_FLOPS = 6·N·D).
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            Dh = self.head_dim
            attn = d * self.n_heads * Dh * 2 + d * self.n_kv_heads * Dh * 2
            per_layer += attn
        if self.family in ("dense", "vlm", "encdec"):
            per_layer += (3 if self.mlp_gated else 2) * d * self.d_ff
        if self.family == "moe" and self.moe:
            e = self.moe.top_k if active_only else self.moe.n_experts
            moe_l = 3 * d * self.moe.d_ff * e
            if self.moe.n_shared:
                moe_l += 3 * d * (self.moe.shared_d_ff or self.moe.d_ff) \
                    * self.moe.n_shared
            moe_l += d * self.moe.n_experts            # router
            dense_l = 3 * d * self.d_ff                # non-MoE layers' FFN
            me = self.moe_every
            per_layer += moe_l / me + dense_l * (me - 1) / me
        if self.family in ("ssm", "hybrid") and self.ssm:
            s = self.ssm
            per_layer_ssm = d * (2 * s.d_inner + 2 * s.n_groups * s.d_state
                                 + s.n_heads) + s.d_inner * d
            if self.family == "hybrid":
                # mamba backbone + shared attn block amortised
                per_layer = per_layer_ssm
            else:
                per_layer = per_layer_ssm
        n += per_layer * L
        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            Dh = self.head_dim
            attn = d * self.n_heads * Dh * 2 + d * self.n_kv_heads * Dh * 2
            n += self.n_enc_layers * (attn + 3 * d * self.d_ff)
            n += L * attn                              # cross-attention
        if self.family == "hybrid" and self.shared_attn_every:
            Dh = self.head_dim
            attn = d * self.n_heads * Dh * 2 + d * self.n_kv_heads * Dh * 2
            n += attn + 3 * d * self.d_ff + 2 * d * d  # one shared block
        return n


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeCell("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeCell("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeCell("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeCell("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_cells_for(cfg: ModelCfg) -> list[ShapeCell]:
    """The assigned shape set, honouring the long_500k sub-quadratic rule."""
    cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        cells.append(LONG_500K)
    return cells


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Per-arch sharding knobs consumed by dist/sharding.py."""
    shard_heads: bool = True          # TP attention over 'model' if divisible
    shard_ff: bool = True             # TP MLP hidden over 'model'
    shard_experts: bool = True        # EP over 'model'
    shard_vocab: bool = True          # TP embedding/logits over 'model'
    fsdp: bool = True                 # params sharded over 'data' (+pod)
    dp_over_model: bool = False       # fold 'model' into DP (tiny archs)
    microbatches: int = 1             # grad-accumulation steps in train
    grad_dtype: str = "float32"       # accumulation dtype ("bfloat16"
                                      # halves the 405B-scale grad
                                      # residency; ≤16 microbatches lose
                                      # ≤3 mantissa bits on the mean)
