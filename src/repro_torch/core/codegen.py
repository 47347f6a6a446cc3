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
quantized storage, float compute. ``QuantBackend`` and the activation
calibration wait for the quant slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Protocol, runtime_checkable

import torch

from .ir import Graph, Node
from .quant import QTensor, dequantize
from ..kernels import ops

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
    (tensor or channel-window list)."""
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
    one launch on the ops backend named ``name``."""
    name: str

    def fuses_pool(self, node: Node) -> bool:
        """The float backends keep the two-launch conv/pool lowering."""
        return False

    def conv(self, x, p, node, res=None):
        w, b = p["w"], p["b"]
        if isinstance(w, QTensor):
            w = dequantize(w)       # quantized storage, float compute
        return ops.conv2d(x, w, b, stride=node.geom("stride"),
                          act=node.attrs.get("act", "identity"), res=res,
                          backend=self.name)

    def maxpool(self, x, node):
        return ops.maxpool2d(x, k=node.geom("K"),
                             stride=node.geom("stride"),
                             act=node.attrs.get("act", "identity"),
                             backend=self.name)

    def pointwise(self, x, op):
        return ops.pointwise(x, op, backend=self.name)

    def resize(self, x, node):
        return ops.resize_nearest(x, scale=node.geom("scale"),
                                  backend=self.name)

    def concat(self, parts):
        return ops.channel_concat(parts)

    def split(self, x, sizes):
        return ops.channel_split(x, sizes)

    def add(self, a, b):
        return torch.add(a, b)


BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend) -> None:
    BACKENDS[backend.name] = backend


def get_backend(name) -> Backend:
    """Resolve a backend name (or pass through a Backend instance).
    ``None`` means ``auto``."""
    if name is None:
        name = "auto"
    if isinstance(name, str):
        if name == "quant":
            raise NotImplementedError(
                "backend 'quant' is not ported yet (ROADMAP.md, "
                "modules to port: the quant backend)")
        try:
            return BACKENDS[name]
        except KeyError:
            raise KeyError(f"unknown backend {name!r}; registered: "
                           f"{sorted(BACKENDS)}") from None
    return name


for _n in ("ref", "cuda", "auto"):
    register_backend(KernelBackend(_n))


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
