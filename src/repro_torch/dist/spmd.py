"""The LM steps over a ``(data, model)`` mesh, run in one process.

The port's counterpart of ``jax.jit(step, in_shardings=param_shardings(
...))``: where GSPMD partitions the JAX package's steps over the layout
of ``dist/sharding.plan_for``, this module runs a model's stack in
lockstep, layer by layer, over the positions of a ``launch.mesh.Mesh``.
Each position runs the port's ``nn/attention``, ``nn/layers``,
``nn/ssm`` and ``models/lm`` functions on its shard (the kernels #6,
#11, #12 and #13 on its heads or its data shard); this module adds only
the layout, the collectives and the gather of cut heads. Every transfer
between positions
is made and labelled through ``roofline.trace.transfer``, even where the
positions name one device. A sharded step computes the unsharded step's
function; only the order of floating-point sums differs. Every family
(dense, vlm, moe, ssm, hybrid, encdec), the int8 KV cache and every
optimizer run sharded.

Layout (parameters as ``launch.steps.place_params`` lays them out):

* **Batch.** Every mesh axis but ``model`` is a data axis; the batch is
  cut into contiguous blocks over them (row-major), on axis 1 of a
  microbatch-shaped train batch. Data group g holds block g at each of
  its ``model`` positions; an encdec model's ``src_embeds`` is cut as
  its tokens are.
* **Attention, tensor-parallel by heads.** ``wq``/``wk``/``wv`` are
  column shards and ``wo`` a row shard: a position runs
  ``nn/attention`` with its head counts (``H/tp`` q and ``Hkv/tp`` kv
  heads) on its shards, a partial sum all-reduced over ``model``.
  Where ``_guard`` left a projection sharded with columns that are not
  whole heads (``tp`` divides H·Dh but not H, or
  Hkv·Dh but not Hkv: every ``registry.reduced`` config at ``model =
  4``, starcoder2-7b at 8), that projection is all-gathered over
  ``model`` and the position attends over the whole heads that cover
  its rows of ``wo``. One helper (``_attention``, an ``Attend`` naming
  its cache leaves, their row, causality and whether it is
  cross-attention) serves the decoder's self-attention, the encoder's
  bidirectional attention, an encdec decoder's cross-attention (k and v
  from the encoder output, cached per layer in ``xk``/``xv``; a decode
  step reads them with ``wq`` alone, no ``qnorm``, over all ``src_len``
  rows) and zamba2's shared block (``sk``/``sv`` at its call index).
* **The int8 cache** (``kv_bits=8``): codes ``k``/``v`` and row scales
  ``k_s``/``v_s`` (L, B, S, Hkv), kv heads over ``model``. A row is one
  (position, head), so it lies whole in one shard: each position
  quantizes its rows (``flash.quantize_kv_rows``) and a decode step
  attends through ``flash.decode_grouped_q8``, the unsharded tensor
  code.
* **MLP.** ``up``/``gate`` column shards, ``down`` a row shard, its
  partial sum all-reduced. Gemma2's post-norms apply to the sum.
* **Embedding.** A vocab-sharded table (vocab divisible by ``model``)
  is looked up by block, out-of-block ids reading 0, and the blocks
  all-reduced; a tied or ``lm_head`` readout's logits are all-gathered
  over ``model``. A replicated head (granite's 49155 rows, seamless's
  256206 at ``model = 4``) is read once a data group, at its ``model``
  position 0.
* **MoE.** ``plan_for``'s ``['experts']`` rule matches no leaf, so the
  router and every expert stay replicated; attention and llama4's
  shared expert are cut over ``model`` (the shared expert's ``up`` and
  ``gate`` by columns, ``down`` by rows, its partial sum all-reduced).
  The layer keeps GSPMD's meaning of the unsharded call: its input rows
  are all-gathered over the data groups (on T over ``model`` first under
  ``seq_shard``), route → stable-sort pack → ``experts`` run on the
  whole batch with ``capacity(B·T)`` of the whole call, and each
  position keeps its own rows. The routed layer runs once a device (the
  positions of one device would repeat it on equal inputs); its
  gradient is autograd's through the rows each position keeps, so the
  replicated experts' and router's gradient is counted once, summed
  over their distinct tensors as any replicated leaf's. The
  load-balance aux of each MoE layer is position 0's, computed over the
  whole batch, and enters the loss once (``0.01 ×`` the mean over the
  MoE layers). llama4's grouped layout (``layers = {"dense", "moe"}``)
  runs its dense layers as the dense family's.
* **SSM and hybrid.** The mixer's weights match no rule and stay
  replicated: each ``model`` position runs the mixer on its data shard
  (the redundancy the JAX package's ``launch/dryrun.py:224-229`` notes).
  zamba2's shared block runs before each segment of
  ``shared_attn_every`` Mamba layers: ``in_proj`` (replicated) on the
  concatenation of the residual and the embedding ``h0`` (the current
  token's in a decode step), attention cut by heads and the MLP by
  columns, both partial sums all-reduced, ``out_proj`` replicated.
* **encdec.** The encoder runs in lockstep as the decoder does (heads
  cut, partial sums all-reduced, no windows, bidirectional), then
  ``enc_norm`` at each position, so every position holds its rows of
  the encoder output whole; each decoder layer's cross-attention
  projects them through its own ``wk``/``wv`` shard, and its ``wo``
  partial sum is all-reduced on its own, before the MLP.
* **Remat.** A train step checkpoints each layer of the lockstep stack
  (``cfg.remat`` ``full`` or ``dots``), the encoder's layers and the
  Mamba layers too but not zamba2's shared block, as the JAX package's
  ``_remat`` does; ``group`` checkpoints groups of ``remat_group`` (or
  ``_auto_group(L)``) decoder layers with each layer checkpointed
  inside (elsewhere ``group`` is ``full``). A recompute replays the
  whole layer, its collectives and kernels included.
* **seq_shard.** Where ``cfg.seq_shard`` is set, ``tp > 1``, and the
  sequence T > 1 divides by ``tp``, the decoder's residual between
  blocks is held sequence-sharded over ``model``: a reduce-scatter on T
  in place of each all-reduce, the norms on the T shard, an all-gather
  before the next column-parallel product (the JAX package's ``_sp``).
  Otherwise the residual stays whole, as ``_sp`` leaves it. The
  encoder, the SSM stack and zamba2's stack call no ``_sp`` in the
  JAX package and stay whole.

Training: the loss is the global batch's token-weighted mean (each data
group's summed NLL and token count, ``lm._nll_sums``, all-reduced over
the data groups), plus a moe model's load-balance term. ``launch.steps``
runs its own step over :class:`Distinct`, the flat tree of a sharded
tree's distinct tensors: parameters that positions share (one tensor for
every position whose device and block agree, ``sharding.shard_tensor``)
are one autograd leaf, so their gradient is the sum of those
positions' contributions; the gradient of a block is then the sum over
the distinct tensors that hold it (an all-reduce over ``data``, and
over ``model`` too for a replicated leaf), the global norm counts each
block once, and :func:`optimizer_step` updates each block once.

The optimizer state is laid out by ``tree_specs`` of its own tree under
``plan_for`` (the JAX dry run's layout). ``adamw``, ``sgd`` and the
leaves whose blocks need nothing of other blocks update one distinct
tensor at a time. An ``adafactor`` leaf cut over ``model``, or whose
factored statistics are laid out otherwise than its blocks read them
(a column-cut ``wq``'s ``vr`` is cut on d), and an ``int8_adamw`` leaf
whose quantization groups straddle its shards, update in lockstep: the
cross-block sums (adafactor's ``mean(g², -1)``, ``mean(g², -2)``,
``mean(vr, -1)`` and the leaf's ``rms(u)``) and maxima (int8_adamw's
group absmax) are all-reduced over ``model``, and a state leaf laid out
otherwise than its parameter's blocks is all-gathered on its way in or
out.

Transfers, each labelled once for the whole mesh with one position's
bytes (as HLO lists one collective in the per-device program): the
forward's collectives (again under remat, in the recompute), their
adjoints in the backward (an all-reduce's is an all-reduce, an
all-gather's a reduce-scatter, a reduce-scatter's an all-gather), the
loss's all-reduce, one gradient all-reduce a parameter leaf held by
more than one position, the global norm's all-reduce, and the
optimizer's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
from torch.utils import checkpoint

from ..configs.base import ModelCfg
from ..kernels import ops
from ..models import lm
from ..nn import attention as A
from ..nn import flash
from ..nn import layers as L
from ..nn import moe as M
from ..nn import ssm as S
from ..optim import optimizers as opt_lib
from ..roofline import trace
from ..tree import flatten_with_path, leaves, map_with_path, tree_map
from . import sharding as sh

F32 = torch.float32


def is_sharded(tree) -> bool:
    """Whether ``tree``'s leaves are ``ShardedTensor`` s."""
    return any(isinstance(x, sh.ShardedTensor) for x in leaves(tree))


def gather(tree, device=None):
    """Every ``ShardedTensor`` leaf of ``tree`` whole (on ``device``,
    default its position 0's); other leaves as they are."""
    return tree_map(lambda x: x.gather(device)
                    if isinstance(x, sh.ShardedTensor) else x, tree)


# ---------------------------------------------------------------------------
# the mesh's positions
# ---------------------------------------------------------------------------

def data_axes(mesh) -> tuple[str, ...]:
    """The data axes: every axis but ``model``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def data_spec(mesh):
    """The spec entry of a dimension cut over the data axes (None where
    the mesh has none)."""
    dp = data_axes(mesh)
    return None if not dp else (dp[0] if len(dp) == 1 else dp)


class Grid:
    """A mesh's positions: each one's device, data group ``g`` (row-major
    over the data axes) and ``model`` coordinate ``m``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.devs = mesh.device_list()
        self.n = len(self.devs)
        self.tp = int(mesh.shape.get("model", 1))
        axes = data_axes(mesh)
        self.dp = math.prod(int(mesh.shape[a]) for a in axes)
        self.g, self.m = [], []
        for p in range(self.n):
            c = mesh.coords(p)
            g = 0
            for a in axes:
                g = g * int(mesh.shape[a]) + c[a]
            self.g.append(g)
            self.m.append(c.get("model", 0))
        # each data group's positions in model order; their leaders
        self.model_groups = [
            sorted((p for p in range(self.n) if self.g[p] == g),
                   key=self.m.__getitem__) for g in range(self.dp)]
        self.leaders = [grp[0] for grp in self.model_groups]

    @property
    def positions(self) -> range:
        return range(self.n)


# ---------------------------------------------------------------------------
# collectives between positions (labelled, differentiable)
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_ADJOINT = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
            "reduce-scatter": "all-gather"}


class _Op:
    """One collective over ``groups`` (lists of positions, in order):
    its forward and its adjoint. An all-reduce or all-gather has one
    output a (group, device): positions of a group on one device share
    it; a reduce-scatter one a position (its chunk). An all-reduce sums,
    or with ``reduce="max"`` takes the elementwise maximum (no
    adjoint)."""

    def __init__(self, kind: str, groups: list, devs: list, dim: int,
                 reduce: str = "sum"):
        self.kind, self.groups, self.devs, self.dim = kind, groups, devs, dim
        self.reduce = reduce
        self.order = [p for grp in groups for p in grp]
        self.index = {p: i for i, p in enumerate(self.order)}
        self.slot_of: dict[int, int] = {}
        self.group_slots: list[list[int]] = []
        n = 0
        for grp in groups:
            slots: dict = {}
            for p in grp:
                key = p if kind == "reduce-scatter" else self.devs[p]
                if key not in slots:
                    slots[key] = n
                    n += 1
                self.slot_of[p] = slots[key]
            self.group_slots.append(list(slots.values()))
        self.sizes: list[list[int]] = []

    def _sum(self, ts: list, dev):
        total = ts[0].to(dev)
        for t in ts[1:]:
            total = torch.maximum(total, t.to(dev)) if self.reduce == "max" \
                else total + t.to(dev)
        return total

    def forward(self, xs: list) -> list:
        outs: dict[int, torch.Tensor] = {}
        for grp in self.groups:
            xg = [xs[self.index[p]] for p in grp]
            d0 = self.devs[grp[0]]
            self.sizes.append([x.shape[self.dim] if x.dim() else 1
                               for x in xg])
            if self.kind == "all-gather":
                full = torch.cat([x.to(d0) for x in xg], dim=self.dim)
            else:
                full = self._sum(xg, d0)
            if self.kind == "reduce-scatter":
                chunks = full.chunk(len(grp), dim=self.dim)
                for j, p in enumerate(grp):
                    outs[self.slot_of[p]] = chunks[j].to(
                        self.devs[p]).contiguous()
            else:
                for p in grp:
                    s = self.slot_of[p]
                    if s not in outs:
                        outs[s] = full.to(self.devs[p])
        return [outs[s] for s in range(len(outs))]

    def backward(self, gs: list) -> list:
        """The adjoint: each input's gradient, the transfer labelled with
        one position's result bytes."""
        if self.reduce != "sum":
            raise RuntimeError(f"an all-reduce of the {self.reduce} has no "
                               f"adjoint here")
        g0, size0 = gs[0], self.sizes[0]
        nbytes = {"all-reduce": _nbytes(g0),
                  "all-gather": _nbytes(g0) * size0[0] // sum(size0),
                  "reduce-scatter": _nbytes(g0) * len(size0)}[self.kind]
        gx: list = [None] * len(self.order)
        with trace.transfer(_ADJOINT[self.kind], nbytes):
            for grp, slots, sizes in zip(self.groups, self.group_slots,
                                         self.sizes):
                d0 = self.devs[grp[0]]
                if self.kind == "reduce-scatter":
                    full = torch.cat([gs[self.slot_of[p]].to(d0)
                                      for p in grp], dim=self.dim)
                    parts = [full] * len(grp)
                else:
                    total = self._sum([gs[s] for s in slots], d0)
                    parts = total.split(sizes, dim=self.dim) \
                        if self.kind == "all-gather" else [total] * len(grp)
                for p, part in zip(grp, parts):
                    gx[self.index[p]] = part.to(self.devs[p]).contiguous()
        return gx


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: _Op, *xs):
        ctx.op = op
        return tuple(op.forward(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(ctx.op.backward(list(gs)))


def collective(kind: str, xs: dict, groups: list, devs: list,
               dim: int = -1, reduce: str = "sum") -> dict:
    """``kind`` (``all-reduce`` by ``reduce``, ``sum`` or ``max``;
    ``all-gather`` along ``dim``, ``reduce-scatter`` along ``dim``) of
    ``xs`` (position → tensor) over ``groups``; position → result.
    Labelled once with one position's result bytes; groups of one
    position move nothing and are not labelled."""
    groups = [list(g) for g in groups]
    if all(len(g) == 1 for g in groups):
        return {p: xs[p] for g in groups for p in g}
    first = groups[0]
    x0 = xs[first[0]]
    nbytes = {"all-reduce": _nbytes(x0),
              "all-gather": sum(_nbytes(xs[p]) for p in first),
              "reduce-scatter": _nbytes(x0) // len(first)}[kind]
    op = _Op(kind, groups, devs, dim, reduce)
    with trace.transfer(kind, nbytes):
        outs = _Collective.apply(op, *[xs[p] for p in op.order])
    return {p: outs[op.slot_of[p]] for p in op.order}


# ---------------------------------------------------------------------------
# one call's view of the sharded parameters
# ---------------------------------------------------------------------------

def _cut_axis(spec) -> int | None:
    """The axis a spec cuts over ``model``, or None."""
    for i, ax in enumerate(spec):
        if ax is not None and "model" in sh._axes(ax):
            return i
    return None


def _on_model(st) -> bool:
    """Whether a ``ShardedTensor`` is cut over ``model``."""
    return _cut_axis(st.spec) is not None


@dataclasses.dataclass(frozen=True)
class _Heads:
    """How attention's projections lie over ``model``: ``*_split`` cut
    over it, ``*_whole`` in whole heads, ``gather_*`` all-gathered
    before attending; ``whole``: every position holds whole q heads and
    the kv heads they read (``nn/attention`` runs on them as they are)."""
    q_split: bool
    q_whole: bool
    kv_whole: bool
    gather_q: bool
    gather_kv: bool

    @property
    def whole(self) -> bool:
        return not (self.gather_q or self.gather_kv) and (
            self.kv_whole or not self.q_split)


class Run:
    """One sharded call: the grid, the config, each position's parameter
    tree (``P[p]``), and the layout read from the ``ShardedTensor`` s."""

    def __init__(self, params: dict, cfg: ModelCfg, local=None):
        first = leaves(params)[0]
        self.grid = Grid(first.mesh)
        self.cfg = cfg
        self.P = local if local is not None else [
            tree_map(lambda st, p=p: st.shard(p), params)
            for p in self.grid.positions]
        self.load_balance: list = []    # each MoE layer's, in order
        g = self.grid
        # the MoE input's all-gather over the data groups: the positions
        # of one model coordinate, in data-group order
        self.data_groups = [sorted((p for p in g.positions if g.m[p] == m),
                                   key=g.g.__getitem__)
                            for m in range(g.tp)]
        self.embed_split = g.tp > 1 and _on_model(params["embed"]["table"])
        head = params["embed"]["table"] if cfg.tie_embeddings \
            else params["lm_head"]["w"]
        self.head_split = g.tp > 1 and _on_model(head)
        self._rope: dict = {}
        if cfg.family in ("ssm", "hybrid"):
            for path, st in flatten_with_path(params["layers"]):
                if _on_model(st):
                    raise ValueError(
                        f"the mixer leaf ['layers']{sh.keystr(path)} is "
                        f"laid out {st.spec} over model: each position "
                        f"runs the whole mixer on its data shard, under a "
                        f"plan (such as plan_for's) that leaves every "
                        f"mixer weight replicated")
        if cfg.family == "ssm":
            self.heads = None
            self.mlp_split = self.shared_split = False
            return
        # the blocks' trees: llama4's grouped layout has two kinds, whose
        # attention is laid out alike; zamba2's one shared block
        if cfg.family == "hybrid":
            blocks = [params["shared"]]
        elif lm._grouped(cfg):
            blocks = [params["layers"][k] for k in ("dense", "moe")]
        else:
            blocks = [params["layers"]]
        at = blocks[-1]["attn"]
        H, Hkv, tp = cfg.n_heads, cfg.n_kv_heads, g.tp
        q_split = tp > 1 and _on_model(at["wq"]["w"])
        kv_split = tp > 1 and _on_model(at["wk"]["w"])
        q_whole = q_split and H % tp == 0
        kv_whole = kv_split and Hkv % tp == 0
        gather_kv = kv_split and not kv_whole
        if kv_whole:                # q heads that read another's kv heads
            gather_kv = any(
                self._kv_range(*self._q_range(m, q_split))
                != (m * Hkv // tp, (m + 1) * Hkv // tp) for m in range(tp))
        self.heads = _Heads(q_split, q_whole, kv_whole,
                            q_split and not q_whole, gather_kv)
        # a position's heads, where they are whole
        self.acfg = dataclasses.replace(
            lm.attn_cfg(cfg), n_heads=H // tp if q_whole else H,
            n_kv_heads=Hkv // tp if kv_whole else Hkv)
        mlp = [b["mlp"] for b in blocks if "mlp" in b]
        self.mlp_split = bool(mlp) and tp > 1 and _on_model(
            mlp[0]["down"]["w"])
        shared = [b["moe"]["shared"] for b in blocks
                  if "shared" in b.get("moe", {})]
        self.shared_split = bool(shared) and tp > 1 and _on_model(
            shared[0]["down"]["w"])

    # -- geometry ---------------------------------------------------------
    def _q_range(self, m: int, q_split: bool) -> tuple[int, int]:
        """The q heads position ``m`` attends over: those covering its
        rows of ``wo`` (all heads where ``wo`` is whole)."""
        H, Dh, tp = self.cfg.n_heads, self.cfg.head_dim, self.grid.tp
        if not q_split:
            return 0, H
        R = H * Dh // tp
        return m * R // Dh, -(-((m + 1) * R) // Dh)

    def _kv_range(self, qa: int, qb: int) -> tuple[int, int]:
        rep = self.cfg.n_heads // self.cfg.n_kv_heads
        return qa // rep, (qb - 1) // rep + 1

    def cache_range(self, m: int) -> tuple[int, int]:
        """The kv heads position ``m``'s cache holds."""
        Hkv, tp = self.cfg.n_kv_heads, self.grid.tp
        if self.heads.kv_whole:
            return m * Hkv // tp, (m + 1) * Hkv // tp
        return 0, Hkv

    # -- helpers ----------------------------------------------------------
    def layer(self, p: int, i: int, key: str = "layers") -> dict:
        return lm.layer(self.P[p][key], i,
                        self.cfg if key == "layers" else None)

    def moe_layer(self, i: int) -> bool:
        """Whether layer ``i`` is an MoE layer."""
        me = self.cfg.moe_every
        return self.cfg.family == "moe" and (me <= 1 or i % me == me - 1)

    def rope(self, pos: torch.Tensor):
        """RoPE tables of ``pos`` on its device, made once a call."""
        key = (pos.device, id(pos))
        if key not in self._rope:
            self._rope[key] = (pos, lm._rope(self.cfg, pos))
        return self._rope[key][1]

    def positions_of(self, T: int) -> dict:
        """Positions 0..T-1 (1, T) at every position, one tensor a
        device."""
        made: dict = {}
        for d in self.grid.devs:
            if d not in made:
                made[d] = torch.arange(T, device=d)[None, :]
        return {p: made[self.grid.devs[p]] for p in self.grid.positions}

    def over_model(self, kind: str, xs: dict, dim: int = -1) -> dict:
        return collective(kind, xs, self.grid.model_groups, self.grid.devs,
                          dim)

    def local_t(self, x: torch.Tensor, p: int) -> torch.Tensor:
        """Position ``p``'s chunk of ``x`` along T (dim 1)."""
        tc = x.shape[1] // self.grid.tp
        m = self.grid.m[p]
        return x[:, m * tc:(m + 1) * tc]

    def reduce(self, ys: dict, partial: bool, seq: bool) -> dict:
        """Block outputs onto the residual: partial sums all-reduced (or
        reduce-scattered on T where ``seq``); whole outputs as they are
        (their T chunk where ``seq``)."""
        if partial:
            return self.over_model("reduce-scatter" if seq else "all-reduce",
                                   ys, dim=1)
        if seq:
            return {p: self.local_t(y, p) for p, y in ys.items()}
        return ys


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Attend:
    """One attention of a block: its cache leaves (``names``, their row
    ``at``: a layer, or a shared-block call), ``causal``, ``window``,
    and ``cross``: cross-attention (k and v projected from the encoder
    output in forward and prefill, read from the cached rows in a decode
    step; no RoPE)."""
    names: tuple = ("k", "v")
    at: int = 0
    causal: bool = True
    window: int | None = None
    cross: bool = False


def _take(t: torch.Tensor, off: int, a: int, b: int,
          axis: int = -2) -> torch.Tensor:
    """Heads [a, b) of ``t`` (heads on ``axis``) whose first head is
    ``off``."""
    if (a - off, b - off) == (0, t.shape[axis]):
        return t
    return t.narrow(axis, a - off, b - a).contiguous()


def _kv_for(t: torch.Tensor, off: int, qa: int, qb: int, rep: int,
            axis: int = -2):
    """The kv heads q heads [qa, qb) read (heads on ``axis``), as a
    tensor the kernels map by ``q head // (nq / nkv)``: a range of whole
    groups, one kv head, or one kv head a q head."""
    ka, kb = qa // rep, (qb - 1) // rep + 1
    if (qa % rep == 0 and qb % rep == 0) or kb - ka == 1:
        return _take(t, off, ka, kb, axis)
    idx = torch.tensor([h // rep - off for h in range(qa, qb)],
                       device=t.device)
    return t.index_select(axis, idx)


def _int8(cache, att: Attend) -> bool:
    """Whether ``att``'s cache holds int8 codes with row scales."""
    return cache is not None and f"{att.names[0]}_s" in cache


def _slots(cache, att: Attend, p: int) -> tuple:
    """Position ``p``'s cache rows of ``att`` (views): (k, v), or (kq,
    ks, vq, vs) for the int8 cache."""
    kn, vn = att.names
    if _int8(cache, att):
        return tuple(cache[n].shard(p)[att.at]
                     for n in (kn, f"{kn}_s", vn, f"{vn}_s"))
    return cache[kn].shard(p)[att.at], cache[vn].shard(p)[att.at]


def _store(cache, att: Attend, p: int, k, v, index=None) -> None:
    """Write ``k`` and ``v`` (B, T, heads, Dh) into position ``p``'s
    cache rows of ``att``: at positions [0, T) (``index`` None) or at
    ``index`` (rows, at) of one token (B, heads, Dh); quantized where the
    cache is int8."""
    for name, t in zip(att.names, (k, v)):
        where = (slice(None), slice(0, t.shape[1])) if index is None \
            else index
        dst = cache[name].shard(p)[att.at]
        if _int8(cache, att):
            codes, scales = flash.quantize_kv_rows(t)
            dst[where] = codes
            cache[f"{name}_s"].shard(p)[att.at][where] = scales
        else:
            dst[where] = t.to(dst.dtype)


def _src_len(kc: torch.Tensor) -> torch.Tensor:
    """Every row's length over cached cross-attention rows (B, S, …)."""
    return torch.full((kc.shape[0],), kc.shape[1], dtype=torch.int32,
                      device=kc.device)


def _attention(run: Run, pa: dict, xs: dict, pos: dict, mode: str,
               att: Attend, cache=None, clen=None, kv_x=None) -> dict:
    """Each position's attention output: a partial sum over its rows of
    ``wo`` (``run.heads.q_split``) or the whole output. ``pa``: each
    position's attention parameters; ``kv_x``: each position's encoder
    rows (cross-attention in forward and prefill). ``mode``:
    ``forward``; ``prefill`` (the keys and values written into
    ``att``'s cache rows); ``decode`` (one token, written at ``clen``,
    attending over ``clen`` + 1 cached positions; a cross-attention step
    over every cached row). Whole heads run ``nn/attention`` with the
    position's head counts (``run.acfg``)."""
    if not run.heads.whole:
        return _cut_heads(run, pa, xs, pos, mode, att, cache, clen, kv_x)
    acfg = dataclasses.replace(run.acfg, causal=att.causal,
                               use_rope=not att.cross)
    out = {}
    for p, x in xs.items():
        tables = None if att.cross else run.rope(pos[p])
        B, T = x.shape[:2]
        if att.cross and mode == "decode":
            q = L.linear(pa[p]["wq"], x).reshape(B, -1, acfg.head_dim)
            kc, vc = _slots(cache, att, p)
            o = ops.decode_attention(q, kc, vc, _src_len(kc))
            out[p] = L.linear(pa[p]["wo"], o.reshape(B, 1, -1))
        elif att.cross and mode == "prefill":
            # the reference's prefill passes no softcap here
            q, k, v = A._project_qkv(pa[p], acfg, x, kv_x[p])
            o = ops.mha(q, k, v, causal=False, window=None, softcap=None)
            _store(cache, att, p, k, v)
            out[p] = L.linear(pa[p]["wo"], o.reshape(B, T, -1))
        elif mode == "decode":
            out[p], _ = A.decode_step(pa[p], acfg, x, _slots(cache, att, p),
                                      clen[p], window=att.window, rope=tables)
        elif mode == "prefill":
            S_ = cache[att.names[0]].shape[2]
            out[p], (kc, vc) = A.prefill(pa[p], acfg, x, S_,
                                         window=att.window, rope=tables)
            _store(cache, att, p, kc, vc)
        else:
            out[p] = A.forward(pa[p], acfg, x,
                               kv_x=kv_x[p] if att.cross else None,
                               window=att.window, rope=tables)
    return out


def _cut_heads(run: Run, pa: dict, xs: dict, pos: dict, mode: str,
               att: Attend, cache, clen, kv_x) -> dict:
    """``_attention`` where a projection's shard is not whole heads (or
    a position's q heads read another position's kv heads): that
    projection all-gathered over ``model``, each position attending over
    the whole q heads that cover its rows of ``wo`` and the kv heads they
    read, then taking its rows' columns of the output."""
    cfg, g, hd = run.cfg, run.grid, run.heads
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // Hkv
    acfg = dataclasses.replace(run.acfg, causal=att.causal,
                               use_rope=not att.cross)
    # a cross-attention decode step reads its k and v from the cache
    project = not (att.cross and mode == "decode")
    src = kv_x if att.cross else xs
    q = {p: L.linear(pa[p]["wq"], x) for p, x in xs.items()}
    if project:
        k = {p: L.linear(pa[p]["wk"], src[p]) for p in xs}
        v = {p: L.linear(pa[p]["wv"], src[p]) for p in xs}
    if hd.gather_q:
        q = run.over_model("all-gather", q)
    if project and hd.gather_kv:
        k = run.over_model("all-gather", k)
        v = run.over_model("all-gather", v)
    out = {}
    for p, x in xs.items():
        m = g.m[p]
        B, T = x.shape[:2]
        qo = m * H // g.tp if hd.q_whole else 0
        ko = m * Hkv // g.tp if hd.kv_whole and not hd.gather_kv else 0
        qa, qb = run._q_range(m, hd.q_split)
        ca, cb = run.cache_range(m)
        if project:
            qp, kp, vp = A._heads(pa[p], acfg, q[p], k[p], v[p])
        else:
            qp, kp = q[p].reshape(B, T, -1, Dh), None
        qp, kp = A._rope(acfg, _take(qp, qo, qa, qb), kp, None,
                         None if att.cross else run.rope(pos[p]))
        if mode == "decode" and att.cross:
            kc, vc = _slots(cache, att, p)
            o = ops.decode_attention(
                qp[:, 0].contiguous(), _kv_for(kc, ca, qa, qb, rep),
                _kv_for(vc, ca, qa, qb, rep), _src_len(kc))
        elif mode == "decode":
            _store(cache, att, p, _take(kp, ko, ca, cb)[:, 0],
                   _take(vp, ko, ca, cb)[:, 0],
                   (torch.arange(B, device=x.device), clen[p].to(torch.long)))
            c = _slots(cache, att, p)
            if len(c) == 4:
                o = flash.decode_grouped_q8(
                    qp[:, 0], *(_kv_for(t, ca, qa, qb, rep, axis)
                                for t, axis in zip(c, (-2, -1, -2, -1))),
                    clen[p] + 1, window=att.window, softcap=cfg.attn_softcap)
            else:
                o = ops.decode_attention(
                    qp[:, 0].contiguous(), _kv_for(c[0], ca, qa, qb, rep),
                    _kv_for(c[1], ca, qa, qb, rep), clen[p] + 1,
                    window=att.window, softcap=cfg.attn_softcap)
        else:
            if mode == "prefill":
                _store(cache, att, p, _take(kp, ko, ca, cb),
                       _take(vp, ko, ca, cb))
            # the reference's cross-attention prefill passes no softcap
            o = ops.mha(qp, _kv_for(kp, ko, qa, qb, rep),
                        _kv_for(vp, ko, qa, qb, rep),
                        causal=att.causal and not att.cross,
                        window=att.window,
                        softcap=None if att.cross and mode == "prefill"
                        else cfg.attn_softcap)
        o = o.reshape(B, T, -1)
        if hd.q_split:
            R = H * Dh // g.tp
            c0 = m * R - qa * Dh
            if (c0, R) != (0, o.shape[-1]):
                o = o[..., c0:c0 + R]
        out[p] = L.linear(pa[p]["wo"], o)
    return out


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _sub(trees: dict, key: str) -> dict:
    return {p: t[key] for p, t in trees.items()}


def _mlp(run: Run, pls: dict, x: dict, seq: bool) -> dict:
    """The MLP over every position (``x`` whole or its T chunk where
    ``seq``): column shards, the partial sum all-reduced (reduce-scattered
    on T)."""
    if seq and run.mlp_split:
        x = run.over_model("all-gather", x, dim=1)
    y = {p: L.mlp(pls[p]["mlp"], x[p], act=run.cfg.act) for p in x}
    if run.mlp_split:
        y = run.over_model("reduce-scatter" if seq else "all-reduce", y,
                           dim=1)
    return y


def _dense_layer(run: Run, i: int, pos: dict, mode: str, seq: bool,
                 cache, clen, enc, *hs):
    """Layer ``i`` over every position (``hs`` in position order): the
    residual whole, or its T chunk where ``seq``; an encdec decoder
    layer's cross-attention over ``enc``, each position's encoder rows.
    Returns the new residuals in position order (and an MoE layer's
    load-balance aux after them)."""
    cfg, g = run.cfg, run.grid
    eps = cfg.norm_eps
    P = range(g.n)
    pls = {p: run.layer(p, i) for p in P}
    h = dict(zip(P, hs))
    x = {p: L.rmsnorm(pls[p]["ln1"], h[p], eps) for p in P}
    if seq:
        x = run.over_model("all-gather", x, dim=1)
    a = run.reduce(_attention(run, _sub(pls, "attn"), x, pos, mode,
                              Attend(("k", "v"), i,
                                     window=cfg.layer_window(i)),
                              cache, clen), run.heads.q_split, seq)
    h = {p: h[p] + lm._attn_out(cfg, pls[p], a[p]) for p in P}
    if cfg.is_encdec:
        x = {p: L.rmsnorm(pls[p]["ln_x"], h[p], eps) for p in P}
        if seq:
            x = run.over_model("all-gather", x, dim=1)
        a = run.reduce(_attention(run, _sub(pls, "xattn"), x, pos, mode,
                                  Attend(("xk", "xv"), i, causal=False,
                                         cross=True), cache, clen, enc),
                       run.heads.q_split, seq)
        h = {p: h[p] + a[p] for p in P}
    x = {p: L.rmsnorm(pls[p]["ln2"], h[p], eps) for p in P}
    if run.moe_layer(i):
        y, lb = _moe(run, pls, x, seq)
        return tuple(h[p] + lm._mlp_out(cfg, pls[p], y[p]) for p in P) \
            + (lb,)
    y = _mlp(run, pls, x, seq)
    return tuple(h[p] + lm._mlp_out(cfg, pls[p], y[p]) for p in P)


def _enc_layer(run: Run, i: int, pos: dict, *hs):
    """Encoder layer ``i`` over every position: bidirectional attention
    (RoPE, no window) cut by heads and the MLP by columns, both partial
    sums all-reduced; the residual whole."""
    cfg = run.cfg
    P = run.grid.positions
    pls = {p: run.layer(p, i, "enc_layers") for p in P}
    h = dict(zip(P, hs))
    x = {p: L.rmsnorm(pls[p]["ln1"], h[p], cfg.norm_eps) for p in P}
    a = run.reduce(_attention(run, _sub(pls, "attn"), x, pos, "forward",
                              Attend(causal=False)),
                   run.heads.q_split, False)
    h = {p: h[p] + a[p] for p in P}
    x = {p: L.rmsnorm(pls[p]["ln2"], h[p], cfg.norm_eps) for p in P}
    y = _mlp(run, pls, x, False)
    return tuple(h[p] + y[p] for p in P)


def _shared_block(run: Run, call: int, h0: dict, pos: dict, mode: str,
                  cache, clen, *hs):
    """zamba2's shared block, call ``call``, over every position:
    ``in_proj`` (replicated) on [h, h0], attention cut by heads over the
    ``sk``/``sv`` rows of the call, the MLP by columns (both partial sums
    all-reduced), ``out_proj`` (replicated) added to the residual."""
    cfg = run.cfg
    P = run.grid.positions
    sp = {p: run.P[p]["shared"] for p in P}
    h = dict(zip(P, hs))
    x = {p: L.linear(sp[p]["in_proj"], torch.cat([h[p], h0[p]], dim=-1))
         for p in P}
    a = run.reduce(_attention(
        run, _sub(sp, "attn"),
        {p: L.rmsnorm(sp[p]["ln1"], x[p], cfg.norm_eps) for p in P}, pos,
        mode, Attend(("sk", "sv"), call), cache, clen),
        run.heads.q_split, False)
    x = {p: x[p] + a[p] for p in P}
    y = _mlp(run, sp, {p: L.rmsnorm(sp[p]["ln2"], x[p], cfg.norm_eps)
                       for p in P}, False)
    return tuple(h[p] + L.linear(sp[p]["out_proj"], x[p] + y[p]) for p in P)


def _moe(run: Run, pls: dict, x: dict, seq: bool) -> tuple[dict, torch.Tensor]:
    """The MoE layer over every position (``x``: its input, whole or the
    T chunk where ``seq``), with the unsharded call's meaning: the rows
    are all-gathered over the data groups (on T over ``model`` first where
    ``seq``), and the replicated router and experts run ``nn/moe``'s
    route → stable-sort pack → ``experts`` on the whole batch, so that
    capacity is ``capacity(B·T)`` of the whole call; each position keeps
    its data group's rows (its T chunk). The routed layer runs once a
    device, the first position's input standing for the others' (they
    are equal): work repeated on one device is done once, and positions
    on other devices each do it whole. Its gradient is then what autograd
    gives through the rows each position keeps, each contribution once.
    A shared expert (llama4) runs on each position's rows, cut over
    ``model`` where ``plan_for`` cuts it, its partial sum all-reduced (or
    reduce-scattered on T). Returns (each position's output, the
    load-balance aux of position 0's call)."""
    cfg, g = run.cfg, run.grid
    if seq:
        x = run.over_model("all-gather", x, dim=1)
    whole = collective("all-gather", x, run.data_groups, g.devs, dim=0)
    done: dict = {}
    for p in g.positions:
        if g.devs[p] not in done:
            routed = {k: v for k, v in pls[p]["moe"].items()
                      if k != "shared"}
            done[g.devs[p]] = M.forward_with_aux(routed, cfg.moe, whole[p])
    b = next(iter(x.values())).shape[0]
    y = {p: done[g.devs[p]][0][g.g[p] * b:(g.g[p] + 1) * b]
         for p in g.positions}
    if seq:
        y = {p: run.local_t(v, p) for p, v in y.items()}
    if "shared" in pls[0]["moe"]:
        ys = run.reduce({p: L.mlp(pls[p]["moe"]["shared"], x[p],
                                  act=cfg.act) for p in g.positions},
                        run.shared_split, seq)
        y = {p: y[p] + ys[p] for p in g.positions}
    return y, done[g.devs[0]][1]["load_balance"]


def _ssm_layer(run: Run, i: int, mode: str, cache, *hs):
    """Mamba-2 layer ``i`` at every position, on its data shard."""
    cfg = run.cfg
    out = []
    for p, h in enumerate(hs):
        pl = run.layer(p, i)
        x = L.rmsnorm(pl["ln"], h, cfg.norm_eps)
        if mode == "decode":
            y = S.decode_step(pl["mixer"], cfg.ssm, x, {
                "conv": cache["conv"].shard(p)[i],
                "ssm": cache["ssm"].shard(p)[i]})[0]
        else:
            y, st = S.forward(pl["mixer"], cfg.ssm, x)
            if mode == "prefill":
                cache["conv"].shard(p)[i].copy_(st["conv"])
                cache["ssm"].shard(p)[i].copy_(st["ssm"])
        out.append(h + y)
    return tuple(out)


def _embed(run: Run, toks: dict) -> dict:
    """Each position's embeddings of its tokens: a vocab-sharded table
    looked up by block (ids outside the block read 0) and all-reduced."""
    out = {}
    for p, t in toks.items():
        pp = run.P[p]
        if run.embed_split:
            n = pp["embed"]["table"].shape[0]
            local = t - run.grid.m[p] * n
            hit = (local >= 0) & (local < n)
            out[p] = lm._embed_tokens(run.cfg, pp, local.clamp(0, n - 1)) \
                * hit[..., None].to(pp["embed"]["table"].dtype)
        else:
            out[p] = lm._embed_tokens(run.cfg, pp, t)
    if run.embed_split:
        out = run.over_model("all-reduce", out)
    return out


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def _seq_sharded(run: Run, T: int) -> bool:
    return (run.cfg.seq_shard and run.cfg.family not in ("ssm", "hybrid")
            and run.grid.tp > 1 and T > 1 and T % run.grid.tp == 0)


def _in_turn(n: int, fns: list, *hs):
    """``hs`` (n residuals) through ``fns`` in turn; the residuals, then
    every MoE layer's load-balance aux."""
    aux: list = []
    for fn in fns:
        out = fn(*hs)
        hs, aux = out[:n], aux + list(out[n:])
    return tuple(hs) + tuple(aux)


def _run_blocks(run: Run, blocks: list, hs: tuple, mode: str,
                groupable: bool) -> tuple:
    """``hs`` through ``blocks`` ((fn, checkpointed) in order), each
    checkpointed one by ``cfg.remat`` in a forward with grad enabled;
    with ``groupable`` and ``remat="group"``, groups of ``remat_group``
    (or ``_auto_group``) blocks checkpointed with each block checkpointed
    inside (elsewhere ``group`` is ``full``). A recompute replays the
    whole block, its last collective included (early stopping would end
    it at the last tensor backward reads)."""
    cfg, n = run.cfg, run.grid.n
    rmode = lm._remat_mode(cfg) if mode == "forward" else "none"
    if rmode == "group" and groupable:
        size = cfg.remat_group or lm._auto_group(len(blocks))
        units = [lm._remat(functools.partial(_in_turn, n, [
            lm._remat(fn, "full") for fn, _ in blocks[i:i + size]]), "full")
            for i in range(0, len(blocks), size)]
    else:
        one = "full" if rmode == "group" else rmode
        units = [lm._remat(functools.partial(_in_turn, n, [fn]),
                           one if ck else "none") for fn, ck in blocks]
    with checkpoint.set_checkpoint_early_stop(False):
        for unit in units:
            out = unit(*hs)
            hs = out[:n]
            run.load_balance.extend(out[n:])
    return hs


def _stack(run: Run, h: dict, mode: str, cache=None, clen=None,
           pos: dict | None = None, enc: dict | None = None
           ) -> tuple[dict, bool]:
    """Every layer over every position (an encdec decoder's
    cross-attention over ``enc``). Returns (the residuals, whether they
    are T chunks)."""
    cfg, g = run.cfg, run.grid
    T = next(iter(h.values())).shape[1]
    pos = run.positions_of(T) if pos is None else pos
    seq = mode != "decode" and _seq_sharded(run, T)
    if seq:
        h = {p: run.local_t(x, p) for p, x in h.items()}
    if cfg.family in ("ssm", "hybrid"):
        every = lm._shared_every(cfg) or cfg.n_layers
        blocks = []
        for call, start in enumerate(range(0, cfg.n_layers, every)):
            if lm._shared_every(cfg):      # not checkpointed
                blocks.append((functools.partial(
                    _shared_block, run, call, h, pos, mode, cache, clen),
                    False))
            blocks += [(functools.partial(_ssm_layer, run, i, mode, cache),
                        True) for i in range(start, min(start + every,
                                                        cfg.n_layers))]
        groupable = False
    else:
        blocks = [(functools.partial(_dense_layer, run, i, pos, mode, seq,
                                     cache, clen, enc), True)
                  for i in range(cfg.n_layers)]
        groupable = not lm._grouped(cfg) and cfg.scan_layers
    hs = _run_blocks(run, blocks, tuple(h[p] for p in g.positions), mode,
                     groupable)
    return dict(zip(g.positions, hs)), seq


def _encode(run: Run, src: dict) -> dict:
    """An encdec model's encoder over each position's source rows, then
    ``enc_norm``: every position's rows of the encoder output, whole."""
    cfg, g = run.cfg, run.grid
    pos = run.positions_of(next(iter(src.values())).shape[1])
    blocks = [(functools.partial(_enc_layer, run, i, pos), True)
              for i in range(cfg.n_enc_layers)]
    hs = _run_blocks(run, blocks, tuple(src[p] for p in g.positions),
                     "forward", False)
    return {p: L.rmsnorm(run.P[p]["enc_norm"], hs[p], cfg.norm_eps)
            for p in g.positions}


def _readout(run: Run, h: dict, seq: bool, last: bool = False) -> dict:
    """Each data group's logits at its leader (``lm._readout``): a
    sequence-sharded residual all-gathered on T first; a vocab-sharded
    head read by block at every position and the blocks all-gathered
    over ``model``, a replicated one at the leader. ``last``: the last
    position only (B, 1, V)."""
    g = run.grid
    if seq:
        h = run.over_model("all-gather", h, dim=1)
    at = g.positions if run.head_split else g.leaders
    logits = {p: lm._readout(run.cfg, run.P[p], h[p][:, -1:].contiguous()
                             if last else h[p]) for p in at}
    if run.head_split:
        logits = run.over_model("all-gather", logits)
    return {p: logits[p] for p in g.leaders}


def _split_rows(grid: Grid, x: torch.Tensor, axis: int = 0) -> dict:
    """Data group g's block of ``x``'s rows (``axis``) at each position,
    on its device (one copy a device and group)."""
    n = x.shape[axis]
    if n % grid.dp:
        raise ValueError(f"a batch of {n} rows does not divide over "
                         f"{grid.dp} data groups")
    b = n // grid.dp
    made: dict = {}
    out = {}
    for p in grid.positions:
        key = (grid.g[p], grid.devs[p])
        if key not in made:
            made[key] = x.narrow(axis, grid.g[p] * b, b).to(grid.devs[p])
        out[p] = made[key]
    return out


def _inputs(run: Run, batch: dict) -> dict:
    """The embedded inputs at every position: tokens of its data block,
    after a vlm's patch embeddings."""
    h = _embed(run, _split_rows(run.grid, batch["tokens"]))
    if run.cfg.family == "vlm":
        emb = _split_rows(run.grid, batch["embeds"])
        h = {p: torch.cat([emb[p].to(x.dtype), x], dim=1)
             for p, x in h.items()}
    return h


def _encoded(run: Run, batch: dict) -> dict | None:
    """An encdec model's encoder output at every position (its data
    block of ``src_embeds``); None for other families."""
    if not run.cfg.is_encdec:
        return None
    return _encode(run, _split_rows(run.grid, batch["src_embeds"]))


def _to_position0(run: Run, per_leader: dict) -> torch.Tensor:
    """Leaders' row blocks all-gathered over the data groups; position
    0's copy."""
    g = run.grid
    return collective("all-gather", per_leader, [g.leaders], g.devs,
                      dim=0)[g.leaders[0]]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelCfg, batch: dict, run: Run | None = None
            ) -> torch.Tensor:
    """``lm.forward``'s logits (B, T_total, V) over sharded ``params``,
    whole on position 0's device."""
    run = run or Run(params, cfg)
    h, seq = _stack(run, _inputs(run, batch), "forward",
                    enc=_encoded(run, batch))
    return _to_position0(run, _readout(run, h, seq))


def loss_fn(params: dict, cfg: ModelCfg, batch: dict, run: Run | None = None):
    """``lm.loss_fn`` over sharded ``params``: (loss, {"loss",
    "tokens"}) on position 0's device, the global batch's token-weighted
    mean."""
    run = run or Run(params, cfg)
    g = run.grid
    h, seq = _stack(run, _inputs(run, batch), "forward",
                    enc=_encoded(run, batch))
    logits = _readout(run, h, seq)
    labels = _split_rows(g, batch["labels"])
    sums = {p: torch.stack(lm._nll_sums(cfg, lg, labels[p]))
            for p, lg in logits.items()}
    tot = collective("all-reduce", sums, [g.leaders], g.devs)[g.leaders[0]]
    loss = tot[0] / torch.clamp(tot[1], min=1.0)
    if run.load_balance:            # position 0's, counted once
        lb = run.load_balance
        loss = loss + 0.01 * (sum(lb) / len(lb)).to(loss.device)
    return loss, {"loss": loss, "tokens": tot[1]}


def _block_key(st, p: int) -> tuple:
    sl = sh._slices(tuple(st.shape), st.sharding, p)
    return tuple((s.start, s.stop) for s in sl)


def _blocks(st) -> dict:
    """block key → the distinct tensors holding it, in position order."""
    out: dict = {}
    for p, t in enumerate(st.shards):
        ts = out.setdefault(_block_key(st, p), [])
        if not any(t is u for u in ts):
            ts.append(t)
    return out


def _holders(st) -> int:
    """The most positions that hold one block of ``st``."""
    counts: dict = {}
    for p in range(len(st.shards)):
        k = _block_key(st, p)
        counts[k] = counts.get(k, 0) + 1
    return max(counts.values())


def sharded_like(st, make) -> sh.ShardedTensor:
    """A ``ShardedTensor`` with ``st``'s sharding whose tensor for each
    distinct shard of ``st`` is ``make(that shard)``: positions that share
    a shard share the result."""
    made: dict = {}
    shards = []
    for t in st.shards:
        if id(t) not in made:
            made[id(t)] = (t, make(t))
        shards.append(made[id(t)][1])
    s0 = shards[0]
    return sh.ShardedTensor(st.sharding, shards, st.shape, s0.dtype)


class Distinct:
    """A sharded tree's distinct tensors (positions that share one share
    its entry) as a flat tree ``{"0": tensor, ...}``, and the way back: a
    train step is ``launch.steps``' step over this flat tree."""

    def __init__(self, params: dict):
        self.params = params
        self.key: dict[int, str] = {}
        self.tensors: dict[str, torch.Tensor] = {}
        for st in leaves(params):
            for t in st.shards:
                if id(t) not in self.key:
                    self.key[id(t)] = str(len(self.key))
                    self.tensors[self.key[id(t)]] = t
        first = leaves(params)[0]
        self.mesh = first.mesh
        self.n, self.dev0 = len(first.shards), first.shards[0].device

    def _keys(self, st) -> list[str]:
        return [self.key[id(t)] for t in st.shards]

    def sharded(self, flat: dict) -> dict:
        """``flat`` as a tree of ``ShardedTensor`` s with the parameters'
        layouts."""
        def leaf(st):
            shards = [flat[k] for k in self._keys(st)]
            return sh.ShardedTensor(st.sharding, shards, st.shape,
                                    shards[0].dtype)
        return tree_map(leaf, self.params)

    def loss_fn(self, flat: dict, cfg: ModelCfg, batch: dict):
        """``loss_fn`` with each position's parameters read from
        ``flat``."""
        local = [tree_map(lambda st, p=p: flat[self.key[id(st.shards[p])]],
                          self.params) for p in range(self.n)]
        return loss_fn(self.params, cfg, batch,
                       Run(self.params, cfg, local=local))

    def sum_blocks(self, grads: dict) -> dict:
        """Each block's gradient: the sum over the distinct tensors that
        hold it (an all-reduce over ``data``, and over ``model`` for a
        replicated leaf), labelled once a leaf held by more than one
        position."""
        grads = dict(grads)
        for st in leaves(self.params):
            if _holders(st) == 1:
                continue
            with trace.transfer("all-reduce",
                                _nbytes(grads[self._keys(st)[0]])):
                for ts in _blocks(st).values():
                    if len(ts) > 1:
                        ks = [self.key[id(t)] for t in ts]
                        total = grads[ks[0]]
                        for k in ks[1:]:
                            total = total + grads[k].to(total.device)
                        for k, t in zip(ks, ts):
                            grads[k] = total.to(t.device)
        return grads

    def norm(self, grads: dict) -> torch.Tensor:
        """The global norm of ``sum_blocks``' gradients, each block
        counted once (its partial sums all-reduced)."""
        sq = [torch.sum(torch.square(grads[self.key[id(ts[0])]])).to(
            self.dev0) for st in leaves(self.params)
            for ts in _blocks(st).values()]
        with trace.transfer("all-reduce", 4) if self.n > 1 \
                else contextlib.nullcontext():
            return torch.sqrt(sum(sq))


def eval_loss(params: dict, cfg: ModelCfg, batch: dict) -> dict:
    """``make_eval_step``'s metrics over sharded ``params``."""
    with torch.no_grad():
        return loss_fn(params, cfg, batch)[1]


# ---------------------------------------------------------------------------
# the optimizer over sharded parameters
# ---------------------------------------------------------------------------

def init_opt_state(optimizer, params: dict, cfg: ModelCfg) -> dict:
    """``optimizer``'s initial state over sharded ``params``: laid out by
    ``tree_specs`` of its own tree under ``plan_for(cfg)`` (the JAX
    package's ``dryrun.py:118-119``), each distinct (device, block) made
    in place. Every optimizer's initial state is one value a leaf (zeros;
    int8_adamw's scales their floor), read from the state of a one-element
    stand-in of each parameter."""
    first = leaves(params)[0]
    shapes = optimizer.init(tree_map(
        lambda st: torch.empty(tuple(st.shape), dtype=st.dtype,
                               device="meta"), params))
    specs = sh.tree_specs(shapes, first.mesh, sh.plan_for(cfg))
    fills = optimizer.init(tree_map(
        lambda st: torch.zeros((1,) * st.ndim, dtype=st.dtype), params))
    return tree_map(lambda ns, s, f: sharded_full(
        tuple(s.shape), s.dtype, ns, f.reshape(-1)[0].item()),
        specs, shapes, fills)


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _spec(*axes) -> sh.PartitionSpec:
    """A spec in the canonical short form (trailing Nones dropped)."""
    axes = list(axes)
    while axes and axes[-1] is None:
        axes.pop()
    return sh.PartitionSpec(*axes)


def _adafactor_layout(st) -> dict:
    """The layout adafactor's update reads its statistics of ``st`` at:
    each block's rows of ``vr`` (the parameter's dims but the last) and
    of ``vc`` (all but the second to last), ``v`` as the parameter."""
    sp = tuple(st.spec) + (None,) * (st.ndim - len(st.spec))
    if st.ndim < 2:
        return {"v": _spec(*sp)}
    return {"vr": _spec(*sp[:-1]), "vc": _spec(*(sp[:-2] + sp[-1:]))}


def _straddles(st) -> bool:
    """Whether ``st``'s int8_adamw groups (``_qgroup`` of the whole
    shape, along the last axis) straddle its blocks."""
    if _cut_axis(st.spec) != st.ndim - 1:
        return False
    width = st.shards[0].shape[-1]
    return width % opt_lib._qgroup(tuple(st.shape)) != 0


def _leaf_step(optimizer, st, sub: dict) -> bool:
    """Whether a leaf's update needs more than each block's own gradient
    and state: a statistic across its blocks, or state laid out
    otherwise than its blocks read it."""
    if optimizer.name == "adafactor":
        want = _adafactor_layout(st)
        return _cut_axis(st.spec) is not None or any(
            sub["f"][k].spec != want[k] for k in want)
    if optimizer.name == "int8_adamw":
        return _straddles(st)
    return False


class _Leaf:
    """One parameter leaf's update in lockstep: the model groups holding
    its distinct tensors (a data group whose tensors are all an earlier
    group's computes nothing), and the positions (``units``) that compute
    a block: one a distinct tensor."""

    def __init__(self, grid: Grid, st, dt: Distinct, grads: dict):
        self.grid, self.st, self.dt = grid, st, dt
        seen: set = set()
        self.groups = []
        for grp in grid.model_groups:
            key = tuple(id(st.shards[p]) for p in grp)
            if key not in seen:
                seen.add(key)
                self.groups.append(grp)
        self.unit_of: dict[int, int] = {}
        self.ugroups = []
        for grp in self.groups:
            first: dict = {}
            for p in grp:
                self.unit_of[p] = first.setdefault(id(st.shards[p]), p)
            self.ugroups.append(list(first.values()))
        self.units = [p for grp in self.ugroups for p in grp]
        self.cut = _cut_axis(st.spec)
        self.g = {p: grads[dt.key[id(st.shards[p])]].to(F32)
                  for p in self.units}
        self.p = {p: st.shards[p] for p in self.units}

    def reduce(self, xs: dict, across: bool, how: str = "sum") -> dict:
        """``xs`` summed (or maxed) over the blocks where ``across`` (the
        leaf is cut over ``model``)."""
        if not across:
            return xs
        return collective("all-reduce", xs, self.ugroups, self.grid.devs,
                          reduce=how)

    def read(self, sst, spec) -> dict:
        """Each unit's block of state leaf ``sst`` at layout ``spec``:
        its own shard where ``sst`` is laid out so, else cut from the
        whole (all-gathered over ``model`` where ``sst`` is cut)."""
        if sst.spec == spec:
            return {p: sst.shards[p] for p in self.units}
        ax = _cut_axis(sst.spec)
        whole = {p: sst.shards[p] for grp in self.groups for p in grp}
        if ax is not None:
            whole = collective("all-gather", whole, self.groups,
                               self.grid.devs, dim=ax)
        ns = sh.NamedSharding(sst.mesh, spec)
        return {p: whole[p][sh._slices(tuple(sst.shape), ns, p)]
                for p in self.units}

    def write(self, sst, spec, new: dict) -> sh.ShardedTensor:
        """``new`` (each unit's block at layout ``spec``) laid out as
        ``sst``: all-gathered over ``model`` first where ``spec`` cuts it
        and ``sst`` is laid out otherwise."""
        got = {}
        if sst.spec == spec:
            for grp in self.groups:
                for p in grp:
                    got[p] = new[self.unit_of[p]]
        else:
            ax = _cut_axis(spec)
            if ax is not None:
                new = collective("all-gather", new, self.ugroups,
                                 self.grid.devs, dim=ax)
            for grp in self.groups:
                for p in grp:
                    sl = sh._slices(tuple(sst.shape), sst.sharding, p)
                    got[p] = new[self.unit_of[p]][sl].contiguous()
        by_key: dict = {}
        for p, t in got.items():
            by_key.setdefault((self.grid.devs[p], _block_key(sst, p)), t)
        shards = [by_key[(self.grid.devs[p], _block_key(sst, p))]
                  for p in self.grid.positions]
        return sh.ShardedTensor(sst.sharding, shards, sst.shape,
                                shards[0].dtype)

    def params(self, upd: dict) -> dict:
        """The new parameter of each distinct tensor (flat key)."""
        return {self.dt.key[id(self.st.shards[p])]:
                opt_lib.apply_update(self.p[p], upd[p]) for p in self.units}


def _adafactor_leaf(optimizer, leaf: _Leaf, sub: dict, step) -> tuple:
    """adafactor's update of one leaf in lockstep: the row and column
    means of g², the mean of ``vr`` and the rms of the update summed
    over the blocks where the leaf is cut."""
    hp, st, c = optimizer.hyper, leaf.st, leaf.cut
    eps, nd = hp["eps"], st.ndim
    lay = _adafactor_layout(st)
    old = {k: leaf.read(sub["f"][k], lay[k]) for k in lay}
    new: dict = {k: {} for k in lay}
    u: dict = {}
    g2 = {p: torch.square(g) + eps for p, g in leaf.g.items()}
    sc = {p: opt_lib.adafactor_scalars(step, g, hp)
          for p, g in leaf.g.items()}
    if nd >= 2:
        rs = leaf.reduce({p: x.sum(-1) for p, x in g2.items()}, c == nd - 1)
        cs = leaf.reduce({p: x.sum(-2) for p, x in g2.items()}, c == nd - 2)
        for p, (beta, _) in sc.items():
            new["vr"][p] = beta * old["vr"][p] + (1 - beta) * (
                rs[p] / st.shape[-1])
            new["vc"][p] = beta * old["vc"][p] + (1 - beta) * (
                cs[p] / st.shape[-2])
        vs = leaf.reduce({p: v.sum(-1, keepdim=True)
                          for p, v in new["vr"].items()}, c == nd - 2)
        for p, g in leaf.g.items():
            u[p] = opt_lib.factored_u(g, new["vr"][p], new["vc"][p],
                                      vs[p] / st.shape[-2], eps)
    else:
        for p, (beta, _) in sc.items():
            new["v"][p] = beta * old["v"][p] + (1 - beta) * g2[p]
            u[p] = leaf.g[p] / (torch.sqrt(new["v"][p]) + eps)
    sq = leaf.reduce({p: torch.sum(torch.square(x)) for p, x in u.items()},
                     c is not None)
    upd = {p: opt_lib.rms_clipped_update(
        x, torch.sqrt(sq[p] / math.prod(st.shape) + 1e-12), sc[p][1], hp,
        leaf.p[p].dtype) for p, x in u.items()}
    return leaf.params(upd), {"f": {k: leaf.write(sub["f"][k], lay[k],
                                                  new[k]) for k in lay}}


def _int8_adamw_leaf(optimizer, leaf: _Leaf, sub: dict, step) -> tuple:
    """int8_adamw's update of a leaf whose groups straddle its blocks
    (cut on the last axis): each block's columns dequantized by the
    scales of their groups, each group's absmax the maximum over the
    blocks."""
    hp, st = optimizer.hyper, leaf.st
    G = opt_lib._qgroup(tuple(st.shape))
    k = st.shape[-1] // G
    whole = _spec()
    scales = {n: leaf.read(sub[n]["s"], whole) for n in ("m", "v")}
    cols: dict = {}
    for p in leaf.units:
        sl = sh._slices(tuple(st.shape), st.sharding, p)[-1]
        cols[p] = torch.arange(sl.start, sl.stop, device=leaf.p[p].device)

    def per_col(s, p):          # each column's group's scale
        return s.index_select(-1, cols[p] // G)
    upd, moments = {}, {"m": {}, "v": {}}
    for p, g in leaf.g.items():
        msc, vsc = scales["m"][p], scales["v"][p]
        mq, vq = sub["m"]["q"].shards[p], sub["v"]["q"].shards[p]
        upd[p], moments["m"][p], moments["v"][p] = opt_lib.int8_moments(
            g, mq.to(F32) * per_col(msc, p), vq.to(F32) * per_col(vsc, p),
            per_col(vsc / 4.0, p), leaf.p[p], step, hp)
    state = {}
    for n, x in moments.items():
        part = {p: torch.zeros(x[p].shape[:-1] + (k,), dtype=F32,
                               device=x[p].device).scatter_reduce(
            -1, (cols[p] // G).expand(x[p].shape), x[p].abs(), "amax")
            for p in leaf.units}
        amax = leaf.reduce(part, True, "max")
        s = {p: torch.clamp(a / 127.0, min=1e-12) for p, a in amax.items()}
        q = {p: opt_lib.int8_codes(x[p], per_col(s[p], p))
             for p in leaf.units}
        state[n] = {"q": leaf.write(sub[n]["q"], sub[n]["q"].spec, q),
                    "s": leaf.write(sub[n]["s"], whole, s)}
    return leaf.params(upd), state


_LEAF_STEPS = {"adafactor": _adafactor_leaf, "int8_adamw": _int8_adamw_leaf}


def optimizer_step(optimizer, dt: Distinct, grads: dict, state: dict,
                   step) -> tuple[dict, dict]:
    """``optimizer`` once over sharded parameters (``dt``) with their
    block gradients (``dt``'s flat keys, clipped) and sharded state
    (``init_opt_state``'s layout): (new parameters, new state), sharded
    as they were. A leaf whose update needs other blocks (``_leaf_step``)
    runs in lockstep over its blocks; every other leaf's distinct tensors
    run through ``optimizer.update`` together, one call a device."""
    grid = Grid(dt.mesh)
    new_p: dict = {}
    new_s: dict = {}                # state path → ShardedTensor
    per_device: dict = {}
    rest = []                       # (param path, leaf) updated per tensor
    for path, st in flatten_with_path(dt.params):
        sub = {n: _at(state[n], path) for n in state}
        if _leaf_step(optimizer, st, sub):
            p_new, s_new = _LEAF_STEPS[optimizer.name](
                optimizer, _Leaf(grid, st, dt, grads), sub, step)
            new_p.update(p_new)
            for spath, sst in flatten_with_path(s_new):
                new_s[spath[:1] + path + spath[1:]] = sst
            continue
        rest.append((path, st))
        for p, t in enumerate(st.shards):
            per_device.setdefault(t.device, {}).setdefault(
                dt.key[id(t)], (path, p))
    new_sub: dict = {}
    for items in per_device.values():
        pf = {k: dt.tensors[k] for k in items}
        sf = {n: {k: tree_map(lambda s, p=p: s.shards[p],
                              _at(state[n], path))
                  for k, (path, p) in items.items()} for n in state}
        upd, ns = optimizer.update({k: grads[k] for k in items}, sf, pf,
                                   step)
        for k, t in pf.items():
            new_p[k] = opt_lib.apply_update(t, upd[k])
        for n in ns:
            for k in items:
                new_sub[(n, k)] = ns[n][k]
    for path, st in rest:
        keys = [dt.key[id(t)] for t in st.shards]
        for n in state:
            for spath, sst in flatten_with_path(_at(state[n], path)):
                shards = [_at(new_sub[(n, k)], spath) for k in keys]
                new_s[(n,) + path + spath] = sh.ShardedTensor(
                    sst.sharding, shards, sst.shape, shards[0].dtype)
    return dt.sharded(new_p), map_with_path(lambda path, _: new_s[path],
                                            state)


# -- inference --------------------------------------------------------------

def cache_rules(mesh) -> dict:
    """Each cache leaf's spec: kv heads over ``model``, the batch over
    the data axes (the int8 cache's scales, the encoder's cached
    cross-attention rows and zamba2's shared-block rows too)."""
    dpa = data_spec(mesh)
    kv = (None, dpa, None, "model", None)
    scales = (None, dpa, None, "model")
    return {"len": (dpa,), "k": kv, "v": kv, "k_s": scales, "v_s": scales,
            "xk": kv, "xv": kv, "sk": kv, "sv": kv, "conv": (None, dpa),
            "ssm": (None, dpa)}


def cache_shardings(cache_shapes: dict, mesh) -> dict:
    """``NamedSharding`` of each leaf of a cache (tensors or ``meta``
    stand-ins), ``cache_rules`` guarded by ``_guard``."""
    rules = cache_rules(mesh)
    return {k: sh.NamedSharding(mesh, sh._guard(tuple(v.shape), rules[k],
                                                mesh))
            for k, v in cache_shapes.items()}


def sharded_full(shape, dtype, sharding, fill,
                 own: bool = False) -> sh.ShardedTensor:
    """A ``ShardedTensor`` of ``fill``, each distinct (device, block)
    made in place on its device; with ``own``, one tensor a position."""
    made: dict = {}
    shards = []
    mesh = sharding.mesh
    for p, dev in enumerate(mesh.device_list()):
        sl = sh._slices(tuple(shape), sharding, p)
        key = p if own else (dev, tuple((s.start, s.stop) for s in sl))
        if key not in made:
            bs = tuple(len(range(*s.indices(n))) for s, n in zip(sl, shape))
            made[key] = torch.full(bs, fill, dtype=dtype, device=dev)
        shards.append(made[key])
    return sh.ShardedTensor(sharding, shards, shape, dtype)


# a decode step updates these IN PLACE by a recurrence, once at every
# position: each position holds its own copy
_RECURRENT = ("conv", "ssm")


def _new_cache(run: Run, B: int, cache_size: int, dtype,
               src_len: int = 0) -> dict:
    mesh = run.grid.mesh
    shapes = lm.init_cache(run.cfg, B, cache_size, dtype,
                           device=torch.device("meta"), src_len=src_len)
    specs = cache_shardings(shapes, mesh)
    fill = {"k_s": 1e-8, "v_s": 1e-8}       # lm.init_cache's
    return {k: sharded_full(tuple(v.shape), v.dtype, specs[k],
                            fill.get(k, 0), own=k in _RECURRENT)
            for k, v in shapes.items()}


def _owned(st: sh.ShardedTensor) -> sh.ShardedTensor:
    """``st`` with a tensor of its own at every position (copies where
    positions shared one)."""
    seen: set = set()
    shards = []
    for t in st.shards:
        shards.append(t.clone() if id(t) in seen else t)
        seen.add(id(t))
    return sh.ShardedTensor(st.sharding, shards, st.shape, st.dtype)


def prefill(params: dict, cfg: ModelCfg, batch: dict, cache_size: int):
    """``lm.prefill`` over sharded ``params``: (last logits (B, V) whole
    on position 0's device, the cache as ``ShardedTensor`` s)."""
    run = Run(params, cfg)
    h = _inputs(run, batch)
    B, T = batch["tokens"].shape[0], next(iter(h.values())).shape[1]
    src_len = batch["src_embeds"].shape[1] if cfg.is_encdec else 0
    cache = _new_cache(run, B, cache_size, next(iter(h.values())).dtype,
                       src_len)
    h, seq = _stack(run, h, "prefill", cache=cache,
                    enc=_encoded(run, batch))
    cache["len"] = sharded_like(cache["len"], lambda t: torch.full_like(t, T))
    logits = _readout(run, h, seq, last=True)
    return _to_position0(run, {p: x[:, 0] for p, x in logits.items()}), cache


def decode_step(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                cache: dict):
    """``lm.decode_step`` over sharded ``params`` and a sharded cache
    (``prefill``'s): (logits (B, V) whole on position 0's device, the
    cache, its k/v (codes and scales), sk/sv, conv and ssm shards
    updated IN PLACE and a new ``len``)."""
    run = Run(params, cfg)
    g = run.grid
    for k in _RECURRENT:
        if k in cache:
            cache[k] = _owned(cache[k])
    clen = {p: cache["len"].shard(p) for p in g.positions}
    h = _embed(run, {p: t[:, None] for p, t in
                     _split_rows(g, tokens).items()})
    pos = {p: c[:, None] for p, c in clen.items()}
    h, _ = _stack(run, h, "decode", cache=cache, clen=clen, pos=pos)
    cache["len"] = sharded_like(cache["len"], lambda t: t + 1)
    logits = _readout(run, h, False)
    return _to_position0(run, {p: x[:, 0] for p, x in logits.items()}), cache
