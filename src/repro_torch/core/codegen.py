"""Executable-graph codegen — the toolflow's "Generate" stage (paper §IV).

A torch port of the JAX package's ``core/codegen.py`` (float half). The
same stage generates an eager PyTorch executor **directly from
``graph.topo_order()``**: node ``attrs`` carry everything execution needs,
so any pass-transformed graph executes without a parallel bookkeeping
structure, and what the DSE analysed is exactly what runs. Every
executing node is ONE kernel launch; a ``fused`` node is a stream alias.

Lowering rules (op → streaming kernel, ``kernels/ops.py``), verbatim
from the JAX package:

* ``conv``      → ``ops.conv2d`` with the node's ``act`` fused into the
  epilogue; a conv tagged ``fuse_add`` feeds its LAST input to ``res=``.
* activations   → ``ops.pointwise``; a ``fused`` activation is an alias.
* ``add``       → ``torch.add``; a ``fused`` add is an alias of its
  through path.
* ``maxpool`` / ``resize`` → their kernels (a maxpool's ``act`` attr is
  its epilogue).
* ``concat`` / ``split`` → one materialising launch each; ``fused`` ones
  lower to nothing: consumers read channel windows resolved statically
  at generation time (``_window_table``).

Backends: ``KernelBackend`` over the ``kernels/ops.py`` dispatch, under
the names ``ref`` (plain PyTorch), ``cuda`` (the hand-written kernels)
and ``auto`` (kernels on CUDA tensors, plain versions on CPU tensors).
Quantized weights are dequantized before the float kernel runs —
quantized storage, float compute. ``QuantBackend`` (``quant``) is
quantized execution (paper §IV-A, Fig. 8): every dense conv is ONE
quantized matmul launch on the raw integer codes, selected per node from
its ``w_bits``/``a_bits`` annotations (``ops.qconv2d`` for float
activations, ``ops.qconv2d_a8`` for calibrated A≤8 nodes), with dequant,
bias, activation and residual in the epilogue.
``calibrate_activation_ranges``/``calibrate_activation_scales`` measure
the A≤8 activation scales on a calibration batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Protocol, runtime_checkable

import numpy as np
import torch

from .ir import Graph, Node
from .quant import QTensor, QuantConfig, dequantize, quantize
from ..kernels import ops
from ..roofline import trace

# activation node ops (subset of POINTWISE_OPS that are unary funcs);
# ``sigmoid`` is admitted here but has no ref.ACTIVATIONS entry, so a
# sigmoid node raises ValueError at execution, as it does in the JAX
# package's ref path.
_ACT_OPS = ("hardswish", "leaky_relu", "silu", "relu", "sigmoid",
            "identity")


# --------------------------------------------------------------------------
# Backend protocol + registry
# --------------------------------------------------------------------------

@runtime_checkable
class Backend(Protocol):
    """Per-op lowering table: how one streaming node becomes one kernel
    launch. ``x``/``res`` follow the kernels/ops.py operand contract
    (tensor or channel-window list). ``conv``'s ``pool`` kwarg is only
    passed when the backend's ``fuses_pool(node)`` returned True for the
    node, so backends without pool fusion never see it."""
    name: str

    def conv(self, x, p: dict, node: Node, res=None): ...
    def maxpool(self, x, node: Node): ...
    def pointwise(self, x, op: str): ...
    def resize(self, x, node: Node): ...
    def concat(self, parts): ...
    def split(self, x, sizes): ...
    def add(self, a, b): ...


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """Lowering table over the kernels/ops.py dispatch — each method is
    one launch on the ``dispatch`` path (``ref`` plain versions, ``cuda``
    kernels, ``auto``)."""
    name: str
    dispatch: str | None = None     # ops.py dispatch string; default: name

    @property
    def _be(self) -> str:
        return self.dispatch or self.name

    def fuses_pool(self, node: Node) -> bool:
        """Whether this backend runs ``node``'s annotated ``fuse_pool``
        maxpool as the conv's epilogue. The float kernel backends keep
        the two-launch lowering: the pool stays its own streaming
        block."""
        return False

    def conv(self, x, p, node, res=None, pool=None):
        w, b = p["w"], p["b"]
        if isinstance(w, QTensor):
            w = dequantize(w)       # quantized storage, float compute
        return ops.conv2d(x, w, b, stride=node.geom("stride"),
                          act=node.attrs.get("act", "identity"), res=res,
                          pool=pool, backend=self._be)

    def maxpool(self, x, node):
        return ops.maxpool2d(x, k=node.geom("K"),
                             stride=node.geom("stride"),
                             act=node.attrs.get("act", "identity"),
                             backend=self._be)

    def pointwise(self, x, op):
        return ops.pointwise(x, op, backend=self._be)

    def resize(self, x, node):
        return ops.resize_nearest(x, scale=node.geom("scale"),
                                  backend=self._be)

    def concat(self, parts):
        return ops.channel_concat(parts)

    def split(self, x, sizes):
        return ops.channel_split(x, sizes)

    def add(self, a, b):
        return torch.add(a, b)


# Default conv-weight scheme when a graph reaches the quant backend
# without a wordlength annotation: W8, per-output-channel scales (the
# layout whose rowsum-dequant epilogue is exact).
_QCFG_DEFAULT = QuantConfig(bits=8, granularity="per_channel", axis=-1)


@dataclasses.dataclass(frozen=True)
class QuantBackend(KernelBackend):
    """Quantized execution (paper §IV-A / Fig. 8): convs run as quantized
    matmul launches on the raw integer codes; everything else inherits
    the kernel dispatch. Float weights are quantized on the fly per the
    node's ``wq`` annotation (AssignWordlengths pass), so the backend
    also works on unannotated graphs — at W8 per channel, on every
    forward.

    The lowering is selected PER NODE from its wordlength annotations
    (``select_lowering`` — overridable, so tests can observe which path
    each node takes):

    * ``"int8-wa"`` — ``a_bits ≤ 8`` with a calibrated ``a_scale``
      (per-tensor float or per-channel tuple) and int8-storage weight
      codes: the activation itself is quantized and the contraction runs
      int8×int8 (ops.qconv2d_a8).
    * ``"int8-w"``  — quantized weight codes (int8, int16 or packed
      int4), float activations (ops.qconv2d).
    * ``"float"``   — grouped convs, per-group code layouts, or scale
      layouts the rowsum epilogue is not exact for.

    A conv annotated ``fuse_pool`` (FuseConvMaxpool) runs its maxpool in
    the same backend call (``fuses_pool``) on every lowering.
    """
    name: str = "quant"
    dispatch: str | None = "auto"

    def fuses_pool(self, node: Node) -> bool:
        return bool(node.attrs.get("fuse_pool")) \
            and node.geom("groups") == 1

    def select_lowering(self, node: Node, w) -> str:
        """Which conv path ``node`` takes, given its (possibly
        quantized) weight ``w`` — see class docstring."""
        if node.geom("groups") != 1:
            return "float"
        F = w.shape[-1]
        packed = bool(getattr(w, "packed", False))
        if (not packed and tuple(w.q.shape) != tuple(w.shape)) \
                or w.scale.numel() not in (1, F):
            # per-group codes / non-output-channel scales: the rowsum
            # epilogue is not exact there — fall back to float compute.
            # (A packed QTensor's byte matrix differs from w.shape by
            # construction; quantize() only packs rowsum-exact layouts.)
            return "float"
        if int(node.attrs.get("a_bits", 16)) <= 8 \
                and node.attrs.get("a_scale") is not None \
                and w.q.dtype == torch.int8:
            return "int8-wa"
        return "int8-w"

    def conv(self, x, p, node, res=None, pool=None):
        w, b = p["w"], p["b"]
        if not isinstance(w, QTensor):
            if node.geom("groups") != 1:
                return super().conv(x, p, node, res, pool=pool)
            w = quantize(w, node.attrs.get("wq", _QCFG_DEFAULT))
        lowering = self.select_lowering(node, w)
        if lowering == "float":
            return super().conv(x, p, node, res, pool=pool)
        w_packed = bool(getattr(w, "packed", False))
        if lowering == "int8-wa":
            return ops.qconv2d_a8(
                x, w.q, w.scale, w.zero, b,
                x_scale=node.attrs["a_scale"],
                a_bits=int(node.attrs.get("a_bits", 8)),
                K=node.geom("K"), stride=node.geom("stride"),
                act=node.attrs.get("act", "identity"), res=res,
                w_packed=w_packed, pool=pool, backend=self._be)
        return ops.qconv2d(x, w.q, w.scale, w.zero, b, K=node.geom("K"),
                           stride=node.geom("stride"),
                           act=node.attrs.get("act", "identity"), res=res,
                           w_packed=w_packed, pool=pool, backend=self._be)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The lowering table of a tensor-parallel replica: ``inner`` (a
    float ``KernelBackend``) over parameters laid out by
    ``dist.sharding.place_sharded`` under ``conv_tp_plan``.

    A conv whose filters are sharded (its ``w`` split on the trailing
    axis over the positions of a ``model`` mesh) runs ``inner.conv``
    once per position, on that position's device, with the filter slice,
    the bias slice and the matching channel slice of ``res``; the input
    is replicated (position 0's stream copied to every other device).
    The slices are then gathered onto position 0 in position order, one
    ``all-gather`` labelled for ``roofline.trace`` with the gathered
    tensor's bytes. Every other node — and a conv whose out-channels do
    not divide the mesh, so its weights stayed whole — runs once on the
    replicated activations on position 0. The quantized backends are
    not served this way (``NotImplementedError`` at the replica)."""
    inner: KernelBackend

    @property
    def name(self) -> str:
        return f"tp:{self.inner.name}"

    def fuses_pool(self, node: Node) -> bool:
        return False

    def conv(self, x, p, node, res=None, pool=None):
        w, b = p["w"], p["b"]
        spec = w.spec
        if len(spec) < w.ndim or spec[-1] is None:
            return self.inner.conv(x, {"w": w.shard(0), "b": b.shard(0)},
                                   node, res)
        devs = w.mesh.device_list()
        xd = ops.channel_concat(x).contiguous()
        rd = None if res is None else ops.channel_concat(res)
        local = {xd.device: xd}
        fs = w.shape[-1] // len(devs)
        parts = []
        for i, dev in enumerate(devs):
            if dev not in local:
                local[dev] = xd.to(dev)
            ri = None if rd is None else \
                rd[..., i * fs:(i + 1) * fs].to(dev).contiguous()
            parts.append(self.inner.conv(
                local[dev], {"w": w.shard(i), "b": b.shard(i)}, node, ri))
        shape = parts[0].shape[:-1] + (w.shape[-1],)
        nbytes = math.prod(shape) * parts[0].element_size()
        with trace.transfer("all-gather", nbytes):
            return torch.cat([y.to(xd.device) for y in parts], dim=-1)

    def maxpool(self, x, node):
        return self.inner.maxpool(x, node)

    def pointwise(self, x, op):
        return self.inner.pointwise(x, op)

    def resize(self, x, node):
        return self.inner.resize(x, node)

    def concat(self, parts):
        return self.inner.concat(parts)

    def split(self, x, sizes):
        return self.inner.split(x, sizes)

    def add(self, a, b):
        return self.inner.add(a, b)


BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend) -> None:
    BACKENDS[backend.name] = backend


def get_backend(name) -> Backend:
    """Resolve a backend name (or pass through a Backend instance).
    ``None`` means ``auto``."""
    if name is None:
        name = "auto"
    if isinstance(name, str):
        try:
            return BACKENDS[name]
        except KeyError:
            raise KeyError(f"unknown backend {name!r}; registered: "
                           f"{sorted(BACKENDS)}") from None
    return name


for _n in ("ref", "cuda", "auto"):
    register_backend(KernelBackend(_n))
register_backend(QuantBackend())


def init_params(graph: Graph, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """He-style init for every conv in the graph, keyed by node name:
    truncated normal in [-2, 2]·std, std = 1/sqrt(K·K·C), zero bias.
    Draws on the CPU from ``generator``, then moves to ``device``."""
    params: dict[str, dict] = {}
    for node in graph.topo_order():
        if node.op != "conv":
            continue
        K, C, F = node.geom("K"), node.geom("C"), node.geom("F")
        std = 1.0 / math.sqrt(K * K * C)
        w = torch.empty((K, K, C, F), dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        params[node.name] = {
            "w": (w * std).to(dtype=dtype, device=device),
            "b": torch.zeros((F,), dtype=dtype, device=device),
        }
    return params


def _window_table(graph: Graph, order=None) -> dict[str, tuple]:
    """stream → ((source_stream, ch_off, ch_len), ...) for every stream
    produced by a ``fused`` concat/split node (ConcatElimination).
    Resolved statically at generation time; chains of eliminated
    plumbing nodes compose."""
    table: dict[str, tuple] = {}

    def base(s: str):
        return table.get(s, ((s, 0, graph.streams[s].shape[-1]),))

    def coalesce(parts: list) -> tuple:
        """Merge adjacent windows of the same source stream."""
        out: list = []
        for p in parts:
            if out and out[-1][0] == p[0] \
                    and out[-1][1] + out[-1][2] == p[1]:
                out[-1] = (p[0], out[-1][1], out[-1][2] + p[2])
            else:
                out.append(tuple(p))
        return tuple(out)

    for node in (order if order is not None else graph.topo_order()):
        if not node.attrs.get("fused"):
            continue
        if node.op == "concat":
            parts: list = []
            for s in node.inputs:
                parts.extend(base(s))
            table[node.outputs[0]] = coalesce(parts)
        elif node.op == "split":
            src_parts = base(node.inputs[0])
            off = 0
            for o in node.outputs:
                ln = graph.streams[o].shape[-1]
                sel, cur = [], 0
                for bs, bo, bl in src_parts:
                    lo, hi = max(off, cur), min(off + ln, cur + bl)
                    if lo < hi:
                        sel.append((bs, bo + lo - cur, hi - lo))
                    cur += bl
                table[o] = coalesce(sel)
                off += ln
    return table


def window_table(graph: Graph) -> dict[str, tuple]:
    """Public wrapper over the generation-time channel-window resolution
    (what the design-rule checker's SAT015 validates)."""
    return _window_table(graph)


def calibrate_activation_ranges(graph: Graph, params: dict, x,
                                backend="auto", per_channel: bool = False
                                ) -> dict:
    """Measured per-conv input absmax on a calibration batch — the
    probe the A≤8 lowering's activation scale comes from (paper §IV-A:
    wordlength selection is calibrated offline, baked into the design).
    Runs the float executor once behind a recording backend wrapper;
    returns ``{conv_node: absmax}`` — a float per node, or a (C,)
    per-input-channel float32 array with ``per_channel`` (the per-group
    calibration's probe)."""
    ranges: dict = {}
    inner = get_backend(backend)

    class _Recorder:
        name = "calibrate"

        def conv(self, xx, p, node, res=None, **kw):
            v = ops.channel_concat(xx) if isinstance(xx, list) else xx
            if per_channel:
                cur = v.abs().amax(dim=tuple(range(v.ndim - 1))).to(
                    torch.float32).cpu().numpy()
                prev = ranges.get(node.name)
                ranges[node.name] = cur if prev is None \
                    else np.maximum(prev, cur)
            else:
                amax = float(v.abs().max())
                ranges[node.name] = max(ranges.get(node.name, 0.0), amax)
            return inner.conv(xx, p, node, res, **kw)

        def __getattr__(self, item):
            return getattr(inner, item)

    with torch.inference_mode():
        generate(graph, backend=_Recorder())(params, x)
    return ranges


def calibrate_activation_scales(graph: Graph, params: dict, x, *,
                                backend="auto", margin: float = 1.0,
                                ranges: dict | None = None,
                                granularity: str = "per_tensor",
                                group_size: int = 16) -> dict:
    """Attach ``a_scale`` (symmetric activation scale,
    ``margin · absmax / (2^(a_bits−1) − 1)``) to every conv annotated
    ``a_bits ≤ 8`` by AssignWordlengths, measuring ``ranges`` on the
    calibration batch unless given. Returns the scales written.

    ``granularity="per_tensor"`` writes one float per node;
    ``"per_group"`` writes a per-CHANNEL tuple (channels share a scale
    within ``group_size``-wide groups). The quant lowerings accept
    either."""
    assert granularity in ("per_tensor", "per_group"), granularity
    per_group = granularity == "per_group"
    if ranges is None:
        ranges = calibrate_activation_ranges(graph, params, x,
                                             backend=backend,
                                             per_channel=per_group)
    out: dict = {}
    for node in graph.nodes.values():
        a_bits = int(node.attrs.get("a_bits", 16))
        if node.op != "conv" or a_bits > 8:
            continue
        amax = ranges.get(node.name)
        if amax is None:
            continue
        qmax = 2 ** (a_bits - 1) - 1
        if per_group:
            av = np.atleast_1d(np.asarray(amax, np.float32)).copy()
            if not float(av.max()):
                continue
            g = max(1, int(group_size))
            for i in range(0, av.size, g):          # group-shared absmax
                av[i:i + g] = max(float(av[i:i + g].max()), 1e-12)
            s = tuple(float(margin * m / qmax) for m in av)
        else:
            if not amax:
                continue
            s = float(margin * float(amax) / qmax)
        node.attrs["a_scale"] = out[node.name] = s
    return out


def launch_nodes(graph: Graph) -> list[str]:
    """Names of nodes that produce a kernel launch in the generated
    executor (everything except ``fused`` stream aliases)."""
    return [n.name for n in graph.topo_order() if not n.attrs.get("fused")]


def generate(graph: Graph, outputs: list[str] | None = None,
             backend=None) -> Callable:
    """Generate ``forward(params, x, backend=None) -> list[Tensor]`` from
    the graph's topological order. ``backend`` (a registered name or a
    ``Backend`` instance) set here is the default, overridable per call.
    The executor runs eagerly; callers wrap it in
    ``torch.inference_mode()``."""
    out_streams = list(outputs if outputs is not None else graph.outputs)
    order = graph.topo_order()          # fixed at generation time
    windows = _window_table(graph, order)   # zero-copy channel reads
    default_backend = backend

    def forward(params: dict, x: torch.Tensor,
                backend=None) -> list[torch.Tensor]:
        be = get_backend(backend if backend is not None
                         else default_backend)
        env: dict[str, torch.Tensor] = {}
        for name in graph.inputs:
            env[name] = x               # single-input CNN graphs

        def resolve(s: str):
            """Concrete tensor, or channel-window list for an eliminated
            concat/split output (kernels/ops.py contract)."""
            if s in windows:
                return [(env[bs], bo, bl) for bs, bo, bl in windows[s]]
            return env[s]

        def materialize(s: str):
            v = resolve(s)
            return be.concat(v) if isinstance(v, list) else v

        def _fuses_pool(conv_node) -> bool:
            fp = getattr(be, "fuses_pool", None)
            return fp(conv_node) if fp is not None else False

        for node in order:
            op = node.op
            if op == "conv":
                res = resolve(node.inputs[-1]) \
                    if node.attrs.get("fuse_add") else None
                if node.attrs.get("fuse_pool") and _fuses_pool(node):
                    # FuseConvMaxpool launch fusion: the hosted pool
                    # runs as this kernel's epilogue — one launch.
                    pnode = graph.nodes[node.attrs["fuse_pool"]]
                    pool = (pnode.geom("K"), pnode.geom("stride"),
                            pnode.attrs.get("act", "identity"))
                    env[node.outputs[0]] = be.conv(
                        resolve(node.inputs[0]), params[node.name], node,
                        res, pool=pool)
                else:
                    env[node.outputs[0]] = be.conv(
                        resolve(node.inputs[0]), params[node.name], node,
                        res)
            elif op in _ACT_OPS:
                if node.attrs.get("fused"):
                    env[node.outputs[0]] = materialize(node.inputs[0])
                else:
                    env[node.outputs[0]] = be.pointwise(
                        resolve(node.inputs[0]), op)
            elif op == "maxpool":
                host = node.attrs.get("pool_fused_host")
                if host and _fuses_pool(graph.nodes[host]):
                    # The host conv's epilogue already pooled the
                    # stream — this node is a launch-free alias.
                    env[node.outputs[0]] = materialize(node.inputs[0])
                else:
                    env[node.outputs[0]] = be.maxpool(
                        resolve(node.inputs[0]), node)
            elif op == "resize":
                env[node.outputs[0]] = be.resize(
                    resolve(node.inputs[0]), node)
            elif op == "concat":
                if node.attrs.get("fused"):
                    continue            # consumers read channel windows
                parts: list = []
                for s in node.inputs:
                    v = resolve(s)
                    parts.extend(v) if isinstance(v, list) \
                        else parts.append((v, 0, v.shape[-1]))
                env[node.outputs[0]] = be.concat(parts)
            elif op == "split":
                if node.attrs.get("fused"):
                    continue            # consumers read channel windows
                sizes = node.attrs["sizes"]
                parts = be.split(materialize(node.inputs[0]), sizes)
                for dst, part in zip(node.outputs, parts):
                    env[dst] = part
            elif op == "add":
                if node.attrs.get("fused"):
                    # FuseConvAdd: inputs[0] is the through path whose
                    # conv epilogue already added the skip stream.
                    env[node.outputs[0]] = materialize(node.inputs[0])
                else:
                    env[node.outputs[0]] = be.add(
                        materialize(node.inputs[0]),
                        materialize(node.inputs[1]))
            else:
                raise ValueError(
                    f"codegen: no lowering for op {op!r} (node {node.name})")
        return [materialize(o) for o in out_streams]

    return forward
