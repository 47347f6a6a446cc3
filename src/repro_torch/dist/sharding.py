"""Parameter sharding plans: path-pattern rules → named shardings.

A port of the JAX package's ``dist/sharding.py`` for a program that runs
in one process over the positions of a ``launch.mesh.Mesh``.
Megatron-style tensor parallelism expressed as data, not code: a
``ShardingPlan`` is an ordered list of ``(path substring, right-aligned
axis spec)`` rules. ``tree_specs`` applies the first matching rule to
every leaf of a parameter tree (tensors, or shape stand-ins on the
``meta`` device) and guards each axis with a divisibility check — a
dimension that does not divide evenly over its mesh axes is left
unsharded (e.g. a 49155-row vocab table on a 4-way 'model' axis
replicates instead of erroring), which is what makes one plan serve
every mesh shape. Paths are built as ``jax.tree_util.keystr`` builds
them (``['layers']['attn']['wq']['w']``), so the JAX package's rules
match the same leaves.

Conventions (linear weights are (in, out), layer-stacked leaves carry a
leading layer axis — rules are right-aligned so both match):

* column-parallel (qkv / mlp up+gate): shard the OUT dim on 'model'
* row-parallel (attn out / mlp down):  shard the IN dim on 'model'
* embeddings: vocab-sharded when divisible, else replicated
* norms / biases / scalars: replicated

Placement (``place``, ``place_sharded``) lays a CONCRETE tree over a
mesh: every leaf becomes a ``ShardedTensor``, one shard for each
position on that position's device, which ``gather()`` reassembles.
Positions may name the same device (a mesh over one card, or the CPU),
which ``jax.device_put`` refuses: each position still holds its own
shard. ``place_replicated`` is the degenerate one-device mesh a serving
replica pins its parameters to; it returns plain tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.quant import QTensor
from ..launch.mesh import Mesh
from ..tree import map_with_path, tree_map


Axis = str | tuple[str, ...] | None


class PartitionSpec(tuple):
    """Per-dimension mesh axes (None: not sharded), in the canonical
    short form (trailing Nones dropped), as ``jax.sharding.
    PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the spec of one leaf over it."""
    mesh: Mesh
    spec: PartitionSpec


def keystr(path: tuple) -> str:
    """A tree path as ``jax.tree_util.keystr`` writes it."""
    return "".join(f"[{k!r}]" for k in path)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Ordered (pattern, spec) rules; first substring match wins.

    ``spec`` is right-aligned onto the leaf's shape: a 2-entry spec on a
    3-D layer-stacked leaf shards the trailing two dims and leaves the
    layer axis replicated.
    """
    rules: tuple[tuple[str, tuple[Axis, ...]], ...]

    def spec_for(self, path: str, ndim: int) -> tuple[Axis, ...]:
        for pattern, spec in self.rules:
            if pattern in path:
                spec = spec[-ndim:] if len(spec) > ndim else spec
                return (None,) * (ndim - len(spec)) + tuple(spec)
        return (None,) * ndim


def plan_for(cfg) -> ShardingPlan:
    """The transformer-family plan (dense / MoE / hybrid share it:
    mixer and expert weights follow the same in/out convention)."""
    col = (None, "model")           # shard OUT dim
    row = ("model", None)           # shard IN dim
    return ShardingPlan(rules=(
        ("['embed']", row),         # vocab-sharded when divisible
        ("['lm_head']", col),
        ("['wq']", col), ("['wk']", col), ("['wv']", col),
        ("['wo']", row),
        ("['up']", col), ("['gate']", col),
        ("['down']", row),
        ("['experts']", col),
    ))


def _axes(ax: Axis) -> tuple[str, ...]:
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _guard(shape: tuple[int, ...], spec: tuple[Axis, ...],
           mesh) -> PartitionSpec:
    """Drop any axis whose mesh extent does not divide the dim."""
    out: list[Axis] = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        n = math.prod(mesh.shape[a] for a in _axes(ax))
        out.append(ax if dim % n == 0 else None)
    while out and out[-1] is None:  # canonical short form
        out.pop()
    return PartitionSpec(*out)


def tree_specs(pshapes, mesh: Mesh, plan: ShardingPlan):
    """Map a tree of tensors (or ``meta`` stand-ins) to NamedShardings
    under ``plan``.

    Every returned spec is guaranteed realisable on ``mesh`` (each
    sharded dim divides its mesh-axis product).
    """
    def one(path, leaf):
        spec = plan.spec_for(keystr(path), len(leaf.shape))
        return NamedSharding(mesh, _guard(tuple(leaf.shape), spec, mesh))

    return map_with_path(one, pshapes)


# ---------------------------------------------------------------------------
# Placement over a mesh's positions
# ---------------------------------------------------------------------------

def _slices(shape: tuple, sharding: NamedSharding, position: int) -> tuple:
    """The index of ``position``'s shard: along each sharded dim, the
    block numbered by the position's coordinates on that dim's axes
    (row-major in the order the spec names them)."""
    mesh, coords = sharding.mesh, sharding.mesh.coords(position)
    out = []
    for i, dim in enumerate(shape):
        ax = sharding.spec[i] if i < len(sharding.spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        block, n = 0, 1
        for a in _axes(ax):
            block = block * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        size = dim // n
        out.append(slice(block * size, (block + 1) * size))
    return tuple(out)


class ShardedTensor:
    """A tensor laid over a mesh: ``shards[p]`` is position ``p``'s
    block (row-major positions), on that position's device. Positions
    whose block and device agree share one tensor. A ``QTensor`` leaf is
    sharded on its filter (last) axis only: each shard is the QTensor of
    that block of filters (served, not gathered)."""

    def __init__(self, sharding: NamedSharding, shards: list, shape,
                 dtype):
        self.sharding = sharding
        self.shards = list(shards)
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def shard(self, position: int):
        return self.shards[position]

    def gather(self, device=None):
        """The whole tensor on ``device`` (default position 0's)."""
        dev = torch.device(device) if device is not None \
            else self.mesh.device_list()[0]
        if not any(ax is not None for ax in self.spec):
            return self.shards[0].to(dev)
        if isinstance(self.shards[0], QTensor):
            raise NotImplementedError("a sharded QTensor is not gathered")
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for p, s in enumerate(self.shards):
            out[_slices(tuple(self.shape), self.sharding, p)] = s.to(dev)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.spec!r} over {self.mesh!r})")


def _qtensor_block(qt: QTensor, sl: slice) -> QTensor:
    """The QTensor of filters ``sl`` (the last axis) of ``qt``: its codes'
    columns (unpacked or nibble-packed), and its scale and zero where
    they run over the filters."""
    F = qt.shape[-1]
    if not qt.packed and tuple(qt.q.shape) != tuple(qt.shape):
        raise NotImplementedError("a per-group QTensor is not sharded")

    def cut(t):
        return t if t.ndim == 0 or t.shape[-1] != F \
            else t[..., sl].contiguous()
    return dataclasses.replace(
        qt, q=qt.q[..., sl].contiguous(), scale=cut(qt.scale),
        zero=cut(qt.zero), shape=tuple(qt.shape[:-1])
        + (sl.stop - sl.start,))


def shard_tensor(leaf, sharding: NamedSharding) -> ShardedTensor:
    """``leaf`` cut into one contiguous block for each position of the
    sharding's mesh, each on its position's device."""
    shape = tuple(leaf.shape)
    sharded = [i for i, ax in enumerate(sharding.spec) if ax is not None]
    is_q = isinstance(leaf, QTensor)
    if is_q and sharded and sharded != [len(shape) - 1]:
        raise NotImplementedError("a QTensor is sharded on its last axis "
                                  "only")
    made: dict = {}
    shards = []
    for p, dev in enumerate(sharding.mesh.device_list()):
        sl = _slices(shape, sharding, p)
        key = (dev, tuple((s.start, s.stop) for s in sl))
        if key not in made:
            if not sharded:
                made[key] = leaf.to(dev)
            elif is_q:
                made[key] = _qtensor_block(leaf, sl[-1]).to(dev)
            else:
                made[key] = leaf[sl].to(dev).contiguous()
        shards.append(made[key])
    dtype = leaf.q.dtype if is_q else leaf.dtype
    return ShardedTensor(sharding, shards, shape, dtype)


def place(params, specs):
    """A CONCRETE tree (tensor and ``QTensor`` leaves) laid over its
    shardings (``tree_specs``' output, the same structure): every leaf
    a ``ShardedTensor``."""
    def one(path, leaf):
        sh = specs
        for k in path:
            sh = sh[k]
        return shard_tensor(leaf, sh)

    return map_with_path(one, params)


# ---------------------------------------------------------------------------
# Serving-replica placement (the degenerate end of the plan machinery)
# ---------------------------------------------------------------------------

def replicated_plan() -> ShardingPlan:
    """The no-rules plan: every leaf replicated. A serving replica holds
    full parameters; ``conv_tp_plan`` is the sharded one."""
    return ShardingPlan(rules=())


def replica_mesh(device) -> Mesh:
    """A one-position mesh — the degenerate mesh a serving replica pins
    its parameters to, through the SAME tree_specs path the launchers
    use (so placement logic is exercised, not bypassed)."""
    return Mesh([device], ("replica",))


def place_replicated(params, device, plan: ShardingPlan | None = None):
    """A copy of a CONCRETE parameter tree on ONE device, placed via
    ``tree_specs`` on ``replica_mesh`` (``plan`` defaults to
    all-replicated): plain tensors, as a one-position mesh holds one
    whole copy. Works on any tree whose leaves expose ``shape`` and
    ``to`` — including ``QTensor`` leaves."""
    mesh = replica_mesh(device)
    tree_specs(params, mesh, plan or replicated_plan())
    dev = mesh.device_list()[0]
    return tree_map(lambda leaf: leaf.to(dev), params)


# ---------------------------------------------------------------------------
# Tensor-parallel serving replicas: one replica spans a device group
# ---------------------------------------------------------------------------

def conv_tp_plan() -> ShardingPlan:
    """The convolution tensor-parallel plan: every conv kernel ``w``
    (HWIO — trailing dim is the output-channel FILTER axis) shards its
    out-channels over the ``model`` axis, and the per-channel bias
    ``b`` shards the same way, so each position computes a filter
    slice of every layer. Right-aligned rules + the ``_guard``
    divisibility check mean layers whose channel count does not divide
    the mesh replicate instead of erroring — the same contract as the
    transformer plan. Inputs stay replicated; the executor's
    tensor-parallel table (``core.codegen.TensorParallel``) gathers the
    slices after each sharded conv (an all-gather)."""
    col = (None, "model")           # shard trailing (filter) dim
    return ShardingPlan(rules=(
        ("['w']", col),
        ("['b']", ("model",)),
    ))


def tp_mesh(devices) -> Mesh:
    """A 1-D ``model``-axis mesh over a serving replica's device group
    — the tensor-parallel sibling of ``replica_mesh``."""
    return Mesh(list(devices), ("model",))


def place_sharded(params, devices, plan: ShardingPlan | None = None):
    """A CONCRETE parameter tree laid across a device GROUP under
    ``plan`` (default ``conv_tp_plan``): ``ShardedTensor`` leaves. One
    device degrades to ``place_replicated``."""
    devices = list(devices)
    if len(devices) <= 1:
        return place_replicated(params, devices[0])
    mesh = tp_mesh(devices)
    return place(params, tree_specs(params, mesh, plan or conv_tp_plan()))


def input_sharding(mesh: Mesh) -> NamedSharding:
    """Replicate activations over a tensor-parallel replica's mesh
    (batch stays whole; only weights are sharded)."""
    return NamedSharding(mesh, PartitionSpec())
