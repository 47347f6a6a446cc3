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
function; only the order of floating-point sums differs.

Layout (parameters as ``launch.steps.place_params`` lays them out):

* **Batch.** Every mesh axis but ``model`` is a data axis; the batch is
  cut into contiguous blocks over them (row-major), on axis 1 of a
  microbatch-shaped train batch. Data group g holds block g at each of
  its ``model`` positions.
* **Attention, tensor-parallel by heads.** ``wq``/``wk``/``wv`` are
  column shards and ``wo`` a row shard: a position runs
  ``nn/attention`` with its head counts (``H/tp`` q and ``Hkv/tp`` kv
  heads) on its shards, a partial sum all-reduced over ``model``. Where ``_guard`` left a projection sharded with
  columns that are not whole heads (``tp`` divides H·Dh but not H, or
  Hkv·Dh but not Hkv: every ``registry.reduced`` config at ``model =
  4``, starcoder2-7b at 8), that projection is all-gathered over
  ``model`` and the position attends over the whole heads that cover
  its rows of ``wo``.
* **MLP.** ``up``/``gate`` column shards, ``down`` a row shard, its
  partial sum all-reduced. Gemma2's post-norms apply to the sum.
* **Embedding.** A vocab-sharded table (vocab divisible by ``model``)
  is looked up by block, out-of-block ids reading 0, and the blocks
  all-reduced; a tied or ``lm_head`` readout's logits are all-gathered
  over ``model``. A replicated head (granite's 49155 rows) is read once
  a data group, at its ``model`` position 0.
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
* **SSM.** The mixer's weights match no rule and stay replicated: each
  ``model`` position runs the mixer on its data shard (the redundancy
  the JAX package's ``launch/dryrun.py:224-229`` notes).
* **Remat.** A train step checkpoints each layer of the lockstep stack
  (``cfg.remat``; ``group`` as ``full``), and its recompute replays the
  whole layer, its collectives and kernels included.
* **seq_shard.** Where ``cfg.seq_shard`` is set, ``tp > 1``, and the
  sequence T > 1 divides by ``tp``, the residual between blocks is held
  sequence-sharded over ``model``: a reduce-scatter on T in place of
  each all-reduce, the norms on the T shard, an all-gather before the
  next column-parallel product (the JAX package's ``_sp``). Otherwise
  the residual stays whole, as ``_sp`` leaves it.

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
block once, and the optimizer (elementwise: ``adamw``, ``sgd``) updates
each distinct tensor once.

Transfers, each labelled once for the whole mesh with one position's
bytes (as HLO lists one collective in the per-device program): the
forward's collectives (again under remat, in the recompute), their
adjoints in the backward (an all-reduce's is an all-reduce, an
all-gather's a reduce-scatter, a reduce-scatter's an all-gather), the
loss's all-reduce, one gradient all-reduce a parameter leaf held by
more than one position, and the global norm's all-reduce.

Not run sharded (``NotImplementedError``, each naming its ROADMAP.md
item): the encdec and hybrid families, ``kv_bits=8``, and the
``adafactor`` and ``int8_adamw`` optimizers, whose factored or grouped
statistics run across a sharded axis.
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
from ..nn import layers as L
from ..nn import moe as M
from ..nn import ssm as S
from ..roofline import trace
from ..tree import flatten_with_path, leaves, map_with_path, tree_map
from . import sharding as sh

REFUSED_FAMILIES = ("encdec", "hybrid")
REFUSED_OPTIMIZERS = ("adafactor", "int8_adamw")


def is_sharded(tree) -> bool:
    """Whether ``tree``'s leaves are ``ShardedTensor`` s."""
    return any(isinstance(x, sh.ShardedTensor) for x in leaves(tree))


def gather(tree, device=None):
    """Every ``ShardedTensor`` leaf of ``tree`` whole (on ``device``,
    default its position 0's); other leaves as they are."""
    return tree_map(lambda x: x.gather(device)
                    if isinstance(x, sh.ShardedTensor) else x, tree)


def check_supported(cfg: ModelCfg, optimizer=None) -> None:
    """Raise ``NotImplementedError`` for what does not run sharded."""
    if cfg.family in REFUSED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family over a sharded mesh waits for "
            f"ROADMAP.md §1, item 3d")
    if cfg.kv_bits == 8:
        raise NotImplementedError(
            "a kv_bits=8 cache over a sharded mesh waits for ROADMAP.md "
            "§1, item 3d")
    if optimizer is not None and optimizer.name in REFUSED_OPTIMIZERS:
        raise NotImplementedError(
            f"{optimizer.name} over sharded parameters waits for "
            f"ROADMAP.md §1, item 3e")


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
    it; a reduce-scatter one a position (its chunk)."""

    def __init__(self, kind: str, groups: list, devs: list, dim: int):
        self.kind, self.groups, self.devs, self.dim = kind, groups, devs, dim
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
            total = total + t.to(dev)
        return total

    def forward(self, xs: list) -> list:
        outs: dict[int, torch.Tensor] = {}
        for grp in self.groups:
            xg = [xs[self.index[p]] for p in grp]
            d0 = self.devs[grp[0]]
            self.sizes.append([x.shape[self.dim] for x in xg])
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
               dim: int = -1) -> dict:
    """``kind`` (``all-reduce``, ``all-gather`` along ``dim``,
    ``reduce-scatter`` along ``dim``) of ``xs`` (position → tensor) over
    ``groups``; position → result. Labelled once with one position's
    result bytes; groups of one position move nothing and are not
    labelled."""
    groups = [list(g) for g in groups]
    if all(len(g) == 1 for g in groups):
        return {p: xs[p] for g in groups for p in g}
    first = groups[0]
    x0 = xs[first[0]]
    nbytes = {"all-reduce": _nbytes(x0),
              "all-gather": sum(_nbytes(xs[p]) for p in first),
              "reduce-scatter": _nbytes(x0) // len(first)}[kind]
    op = _Op(kind, groups, devs, dim)
    with trace.transfer(kind, nbytes):
        outs = _Collective.apply(op, *[xs[p] for p in op.order])
    return {p: outs[op.slot_of[p]] for p in op.order}


# ---------------------------------------------------------------------------
# one call's view of the sharded parameters
# ---------------------------------------------------------------------------

def _on_model(st) -> bool:
    """Whether a ``ShardedTensor`` is cut over ``model``."""
    return any(ax is not None and "model" in sh._axes(ax)
               for ax in st.spec)


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
        check_supported(cfg)
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
        if cfg.family == "ssm":
            for path, st in flatten_with_path(params["layers"]):
                if _on_model(st):
                    raise NotImplementedError(
                        f"a mixer weight sharded over model "
                        f"({sh.keystr(path)}) waits for ROADMAP.md §1, "
                        f"item 3d")
            self.heads = None
            self.mlp_split = self.shared_split = False
            return
        # the blocks' trees: llama4's grouped layout has two kinds, whose
        # attention is laid out alike
        blocks = [params["layers"][k] for k in ("dense", "moe")] \
            if lm._grouped(cfg) else [params["layers"]]
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
    def layer(self, p: int, i: int) -> dict:
        return lm.layer(self.P[p]["layers"], i, self.cfg)

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
# the stack
# ---------------------------------------------------------------------------

def _take(t: torch.Tensor, off: int, a: int, b: int) -> torch.Tensor:
    """Heads [a, b) of ``t`` (…, heads, Dh) whose first head is ``off``."""
    if (a - off, b - off) == (0, t.shape[-2]):
        return t
    return t[..., a - off:b - off, :].contiguous()


def _kv_for(t: torch.Tensor, off: int, qa: int, qb: int, rep: int):
    """The kv heads q heads [qa, qb) read, as a tensor the kernels map
    by ``q head // (nq / nkv)``: a range of whole groups, one kv head,
    or one kv head a q head."""
    ka, kb = qa // rep, (qb - 1) // rep + 1
    if (qa % rep == 0 and qb % rep == 0) or kb - ka == 1:
        return _take(t, off, ka, kb)
    idx = torch.tensor([h // rep - off for h in range(qa, qb)],
                       device=t.device)
    return t.index_select(-2, idx)


def _attention(run: Run, pls: dict, xs: dict, window, pos: dict,
               mode: str, i: int, cache=None, clen=None) -> dict:
    """Each position's attention output: a partial sum over its rows of
    ``wo`` (``run.heads.q_split``) or the whole output. ``mode``:
    ``forward``; ``prefill`` (layer ``i``'s keys and values written into
    ``cache``'s k/v shards); ``decode`` (one token, written at ``clen``,
    attending over ``clen`` + 1 cached positions). Whole heads run
    ``nn/attention`` with the position's head counts (``run.acfg``)."""
    if not run.heads.whole:
        return _cut_heads(run, pls, xs, window, pos, mode, i, cache, clen)
    out = {}
    for p, x in xs.items():
        pa, tables = pls[p]["attn"], run.rope(pos[p])
        if mode == "decode":
            out[p], _ = A.decode_step(
                pa, run.acfg, x, (cache["k"].shard(p)[i],
                                  cache["v"].shard(p)[i]),
                clen[p], window=window, rope=tables)
        elif mode == "prefill":
            kc, vc = cache["k"].shard(p), cache["v"].shard(p)
            out[p], (kc[i], vc[i]) = A.prefill(pa, run.acfg, x, kc.shape[2],
                                               window=window, rope=tables)
        else:
            out[p] = A.forward(pa, run.acfg, x, window=window, rope=tables)
    return out


def _cut_heads(run: Run, pls: dict, xs: dict, window, pos: dict,
               mode: str, i: int, cache=None, clen=None) -> dict:
    """``_attention`` where a projection's shard is not whole heads (or
    a position's q heads read another position's kv heads): that
    projection all-gathered over ``model``, each position attending over
    the whole q heads that cover its rows of ``wo`` and the kv heads they
    read, then taking its rows' columns of the output."""
    cfg, g, hd = run.cfg, run.grid, run.heads
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // Hkv
    q = {p: L.linear(pls[p]["attn"]["wq"], x) for p, x in xs.items()}
    k = {p: L.linear(pls[p]["attn"]["wk"], x) for p, x in xs.items()}
    v = {p: L.linear(pls[p]["attn"]["wv"], x) for p, x in xs.items()}
    if hd.gather_q:
        q = run.over_model("all-gather", q)
    if hd.gather_kv:
        k = run.over_model("all-gather", k)
        v = run.over_model("all-gather", v)
    out = {}
    for p, x in xs.items():
        m = g.m[p]
        B, T = x.shape[:2]
        pa = pls[p]["attn"]
        qo = m * H // g.tp if hd.q_whole else 0
        ko = m * Hkv // g.tp if hd.kv_whole and not hd.gather_kv else 0
        qp, kp, vp = A._heads(pa, run.acfg, q[p], k[p], v[p])
        qa, qb = run._q_range(m, hd.q_split)
        qp, kp = A._rope(run.acfg, _take(qp, qo, qa, qb), kp, None,
                         run.rope(pos[p]))
        if mode == "decode":
            ca, cb = run.cache_range(m)
            kc, vc = cache["k"].shard(p)[i], cache["v"].shard(p)[i]
            rows = torch.arange(B, device=x.device)
            at = clen[p].to(torch.long)
            kc[rows, at] = _take(kp, ko, ca, cb)[:, 0].to(kc.dtype)
            vc[rows, at] = _take(vp, ko, ca, cb)[:, 0].to(vc.dtype)
            o = ops.decode_attention(
                qp[:, 0].contiguous(), _kv_for(kc, ca, qa, qb, rep),
                _kv_for(vc, ca, qa, qb, rep), clen[p] + 1, window=window,
                softcap=cfg.attn_softcap)
        else:
            if mode == "prefill":
                ca, cb = run.cache_range(m)
                cache["k"].shard(p)[i][:, :T] = _take(kp, ko, ca, cb)
                cache["v"].shard(p)[i][:, :T] = _take(vp, ko, ca, cb)
            o = ops.mha(qp, _kv_for(kp, ko, qa, qb, rep),
                        _kv_for(vp, ko, qa, qb, rep), causal=True,
                        window=window, softcap=cfg.attn_softcap)
        o = o.reshape(B, T, -1)
        if hd.q_split:
            R = H * Dh // g.tp
            c0 = m * R - qa * Dh
            if (c0, R) != (0, o.shape[-1]):
                o = o[..., c0:c0 + R]
        out[p] = L.linear(pa["wo"], o)
    return out


def _dense_layer(run: Run, i: int, window, pos: dict, mode: str, seq: bool,
                 cache, clen, *hs):
    """Layer ``i`` over every position (``hs`` in position order): the
    residual whole, or its T chunk where ``seq``. Returns the new
    residuals in position order."""
    cfg, g = run.cfg, run.grid
    eps = cfg.norm_eps
    P = range(g.n)
    pls = {p: run.layer(p, i) for p in P}
    h = dict(zip(P, hs))
    x = {p: L.rmsnorm(pls[p]["ln1"], h[p], eps) for p in P}
    if seq:
        x = run.over_model("all-gather", x, dim=1)
    a = run.reduce(_attention(run, pls, x, window, pos, mode, i, cache,
                              clen), run.heads.q_split, seq)
    h = {p: h[p] + lm._attn_out(cfg, pls[p], a[p]) for p in P}
    x = {p: L.rmsnorm(pls[p]["ln2"], h[p], eps) for p in P}
    if run.moe_layer(i):
        y, lb = _moe(run, pls, x, seq)
        return tuple(h[p] + lm._mlp_out(cfg, pls[p], y[p]) for p in P) \
            + (lb,)
    if seq and run.mlp_split:
        x = run.over_model("all-gather", x, dim=1)
    y = {p: L.mlp(pls[p]["mlp"], x[p], act=cfg.act) for p in P}
    if run.mlp_split:
        y = run.over_model("reduce-scatter" if seq else "all-reduce", y,
                           dim=1)
    return tuple(h[p] + lm._mlp_out(cfg, pls[p], y[p]) for p in P)


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


def _seq_sharded(run: Run, T: int) -> bool:
    return (run.cfg.seq_shard and run.cfg.family != "ssm"
            and run.grid.tp > 1 and T > 1 and T % run.grid.tp == 0)


def _stack(run: Run, h: dict, mode: str, cache=None, clen=None,
           pos: dict | None = None) -> tuple[dict, bool]:
    """Every layer over every position. Returns (the residuals, whether
    they are T chunks)."""
    cfg, g = run.cfg, run.grid
    T = next(iter(h.values())).shape[1]
    if pos is None:
        pos = {}
        for p in g.positions:
            d = g.devs[p]
            if d not in pos:
                pos[d] = torch.arange(T, device=d)[None, :]
        pos = {p: pos[g.devs[p]] for p in g.positions}
    seq = mode != "decode" and _seq_sharded(run, T)
    if seq:
        h = {p: run.local_t(x, p) for p, x in h.items()}
    hs = tuple(h[p] for p in g.positions)
    rmode = lm._remat_mode(cfg) if mode == "forward" else "none"
    rmode = "full" if rmode == "group" else rmode
    # a recomputed layer replays all of it, its last collective included
    # (early stopping would end it at the last tensor backward reads)
    with checkpoint.set_checkpoint_early_stop(False):
        for i in range(cfg.n_layers):
            if cfg.family == "ssm":
                fn = functools.partial(_ssm_layer, run, i, mode, cache)
            else:
                fn = functools.partial(_dense_layer, run, i,
                                       cfg.layer_window(i), pos, mode, seq,
                                       cache, clen)
            hs = lm._remat(fn, rmode)(*hs)
            if len(hs) > g.n:          # an MoE layer's load-balance aux
                run.load_balance.append(hs[-1])
                hs = hs[:-1]
    return dict(zip(g.positions, hs)), seq


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
    h, seq = _stack(run, _inputs(run, batch), "forward")
    return _to_position0(run, _readout(run, h, seq))


def loss_fn(params: dict, cfg: ModelCfg, batch: dict, run: Run | None = None):
    """``lm.loss_fn`` over sharded ``params``: (loss, {"loss",
    "tokens"}) on position 0's device, the global batch's token-weighted
    mean."""
    run = run or Run(params, cfg)
    g = run.grid
    h, seq = _stack(run, _inputs(run, batch), "forward")
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


def init_opt_state(optimizer, params: dict, cfg: ModelCfg) -> dict:
    """``optimizer``'s initial state over sharded ``params``: laid out by
    ``tree_specs`` of its own tree under ``plan_for(cfg)`` (the JAX
    package's ``dryrun.py:118-119``), each distinct block made in place
    by ``optimizer.init``. Elementwise optimizers only."""
    check_supported(cfg, optimizer)
    first = leaves(params)[0]
    meta = tree_map(lambda st: torch.empty(tuple(st.shape), dtype=st.dtype,
                                           device="meta"), params)
    specs = sh.tree_specs(optimizer.init(meta), first.mesh,
                          sh.plan_for(cfg))
    flat = dict(flatten_with_path(params))

    def leaf(path, ns):
        st = flat[path[1:]]
        if ns.spec != st.spec:
            raise ValueError(f"state {sh.keystr(path)} laid out {ns.spec}, "
                             f"its parameter {st.spec}")
        return sharded_like(st, lambda t: optimizer.init({"x": t})[
            path[0]]["x"])
    return map_with_path(leaf, specs)


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
        first = leaves(params)[0].shards
        self.n, self.dev0 = len(first), first[0].device

    def _keys(self, st) -> list[str]:
        return [self.key[id(t)] for t in st.shards]

    def flat(self, tree: dict) -> dict:
        """The flat tree of ``tree`` (laid out as the parameters, e.g. the
        optimizer state's ``m``): the shard at each distinct tensor's
        first position."""
        out: dict = {}
        for st, s in zip(leaves(self.params), leaves(tree)):
            for k, t in zip(self._keys(st), s.shards):
                out.setdefault(k, t)
        return out

    def sharded(self, flat: dict) -> dict:
        """``flat`` as a tree of ``ShardedTensor`` s with the parameters'
        layouts."""
        def leaf(st):
            shards = [flat[k] for k in self._keys(st)]
            return sh.ShardedTensor(st.sharding, shards, st.shape,
                                    shards[0].dtype)
        return tree_map(leaf, self.params)

    def by_device(self) -> list[list[str]]:
        """The flat keys grouped by their tensors' devices."""
        out: dict = {}
        for k, t in self.tensors.items():
            out.setdefault(t.device, []).append(k)
        return list(out.values())

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


# -- inference --------------------------------------------------------------

def cache_rules(mesh) -> dict:
    """Each cache leaf's spec: kv heads over ``model``, the batch over
    the data axes."""
    dpa = data_spec(mesh)
    kv = (None, dpa, None, "model", None)
    return {"len": (dpa,), "k": kv, "v": kv, "conv": (None, dpa),
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


def _new_cache(run: Run, B: int, cache_size: int, dtype) -> dict:
    mesh = run.grid.mesh
    shapes = lm.init_cache(run.cfg, B, cache_size, dtype,
                           device=torch.device("meta"))
    specs = cache_shardings(shapes, mesh)
    return {k: sharded_full(tuple(v.shape), v.dtype, specs[k], 0,
                            own=k in _RECURRENT)
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
    cache = _new_cache(run, B, cache_size, next(iter(h.values())).dtype)
    h, seq = _stack(run, h, "prefill", cache=cache)
    cache["len"] = sharded_like(cache["len"], lambda t: torch.full_like(t, T))
    logits = _readout(run, h, seq, last=True)
    return _to_position0(run, {p: x[:, 0] for p, x in logits.items()}), cache


def decode_step(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                cache: dict):
    """``lm.decode_step`` over sharded ``params`` and a sharded cache
    (``prefill``'s): (logits (B, V) whole on position 0's device, the
    cache, its k/v, conv and ssm shards updated IN PLACE and a new
    ``len``)."""
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
