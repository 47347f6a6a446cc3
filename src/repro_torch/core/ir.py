"""Dataflow-graph internal representation (IR).

This is the toolflow's equivalent of SATAY's parsed-ONNX IR (paper
§IV step 1): a DAG of streaming nodes connected by typed streams. Every
node carries the workload/geometry annotations the DSE latency and
resource models (paper §IV-B) read, and every edge carries the feature
map geometry the buffer-allocation pass (paper §IV-C) reads.

Model builders in ``repro_torch.models.yolo`` emit this IR directly (no ONNX
runtime exists offline; the IR is isomorphic to the paper's).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Iterable


# Op types understood by the latency / resource models and the generator.
CONV_OPS = ("conv",)
POINTWISE_OPS = ("hardswish", "leaky_relu", "silu", "add", "mul", "sigmoid",
                 "relu", "identity", "quant", "dequant")
WINDOW_OPS = ("maxpool",)
SHAPE_OPS = ("resize", "split", "concat", "flatten", "detect")
ALL_OPS = CONV_OPS + POINTWISE_OPS + WINDOW_OPS + SHAPE_OPS + ("input", "output", "matmul")


@dataclasses.dataclass
class Stream:
    """An edge in the dataflow graph — a feature-map stream.

    Geometry follows the paper's NHWC streaming order. ``src`` is the
    producing node ("" for graph inputs); ``dsts`` lists every consumer
    (fan-out implies stream duplication hardware in SATAY, so a stream
    may feed several nodes).
    """
    name: str
    shape: tuple[int, ...]        # (H, W, C) for CNN streams, (T, C) for LM
    src: str = ""
    dsts: list[str] = dataclasses.field(default_factory=list)

    @property
    def size(self) -> int:
        """S_{n,m} = H*W*C words (paper Eq. 4 context)."""
        return int(math.prod(self.shape))


@dataclasses.dataclass
class Node:
    """A streaming compute node (one dedicated hardware block in SATAY)."""
    name: str
    op: str
    inputs: list[str]                   # stream names
    outputs: list[str]                  # stream names
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    # --- geometry (populated by builders) -------------------------------
    # For convs: H,W are *output* spatial dims, C in-channels, F filters,
    # K kernel size, stride, groups. For pointwise: H,W,C of the stream.
    def geom(self, key: str, default: int = 1) -> int:
        return int(self.attrs.get(key, default))

    @property
    def workload(self) -> int:
        """Cycles at parallelism 1 (paper latency model numerator)."""
        H, W, C, F = (self.geom(k) for k in ("H", "W", "C", "F"))
        if self.op == "conv":
            g = self.geom("groups")
            return H * W * (C // g) * F
        if self.op == "matmul":
            return self.geom("M") * self.geom("K") * self.geom("N")
        return H * W * C

    @property
    def macs(self) -> int:
        """Multiply-accumulate count (for GOP/s reporting, paper Table III)."""
        if self.op == "conv":
            K = self.geom("K")
            return self.geom("H") * self.geom("W") * self.geom("F") \
                * (self.geom("C") // self.geom("groups")) * K * K
        if self.op == "matmul":
            return self.geom("M") * self.geom("K") * self.geom("N")
        return 0

    @property
    def n_weights(self) -> int:
        if self.op == "conv":
            K = self.geom("K")
            return self.geom("F") * (self.geom("C") // self.geom("groups")) * K * K \
                + self.geom("F")  # + bias
        if self.op == "matmul":
            return self.geom("K") * self.geom("N")
        return 0

    @property
    def pipeline_depth(self) -> int:
        """d(n): cycles for one word to traverse the node (paper §IV-B).

        Sliding-window ops must buffer (K-1) rows plus K words before the
        first output — exactly the paper's line-buffer occupancy
        (K-1)·W·C. Pointwise ops have O(1) depth. A node ``absorbed``
        into another engine's epilogue (fused residual adds, eliminated
        concat/split plumbing — core/passes.py) adds NO depth: it is
        in-register wiring, not a pipeline stage.
        """
        if self.attrs.get("absorbed"):
            return 0
        if self.op in ("conv", "maxpool"):
            K = self.geom("K")
            return (K - 1) * self.geom("W_in", self.geom("W")) * self.geom("C") + K
        if self.op == "resize":
            return self.geom("W") * self.geom("C")
        if self.op in ("concat", "split"):
            return self.geom("C")
        return 1


@dataclasses.dataclass
class Graph:
    """The dataflow graph: SATAY's IR."""
    name: str
    nodes: dict[str, Node] = dataclasses.field(default_factory=dict)
    streams: dict[str, Stream] = dataclasses.field(default_factory=dict)
    inputs: list[str] = dataclasses.field(default_factory=list)    # stream names
    outputs: list[str] = dataclasses.field(default_factory=list)   # stream names

    # ----------------------------------------------------------------- build
    def add_stream(self, name: str, shape: tuple[int, ...]) -> Stream:
        if name in self.streams:
            raise ValueError(f"duplicate stream {name}")
        s = Stream(name=name, shape=tuple(int(x) for x in shape))
        self.streams[name] = s
        return s

    def add_node(self, name: str, op: str, inputs: Iterable[str],
                 outputs: Iterable[str], **attrs: Any) -> Node:
        if name in self.nodes:
            raise ValueError(f"duplicate node {name}")
        n = Node(name=name, op=op, inputs=list(inputs), outputs=list(outputs),
                 attrs=dict(attrs))
        for s in n.inputs:
            self.streams[s].dsts.append(name)
        for s in n.outputs:
            self.streams[s].src = name
        self.nodes[name] = n
        return n

    # ------------------------------------------------------------- analysis
    def topo_order(self) -> list[Node]:
        indeg = {n: 0 for n in self.nodes}
        for node in self.nodes.values():
            for s in node.inputs:
                if self.streams[s].src:
                    indeg[node.name] += 1
        q = deque(sorted(n for n, d in indeg.items() if d == 0))
        order: list[Node] = []
        while q:
            name = q.popleft()
            node = self.nodes[name]
            order.append(node)
            for s in node.outputs:
                for dst in self.streams[s].dsts:
                    indeg[dst] -= 1
                    if indeg[dst] == 0:
                        q.append(dst)
        if len(order) != len(self.nodes):
            raise ValueError(f"{self.name}: graph has a cycle "
                             f"({len(order)}/{len(self.nodes)} ordered)")
        return order

    def validate(self) -> None:
        """Structural well-formedness: dangling streams (the residue an
        eliminating pass would leave without its dead-stream sweep —
        see passes.PassManager), registry/link incoherence, duplicate
        producers, and cycles. Delegates to the structure family of the
        design-rule checker (core/check.py) and raises its
        ``CheckError`` (a ValueError) carrying the findings; the full
        multi-family DRC is ``check.check_graph``."""
        from . import check as check_lib
        findings = check_lib.check_structure(self)
        errs = [f for f in findings if f.severity == check_lib.ERROR]
        if errs:
            raise check_lib.CheckError(
                f"{self.name}: " + "; ".join(str(e) for e in errs[:4]),
                findings=errs)

    # Path depth from graph input to each node, in cycles — used for the
    # skip-buffer depth model q(n, m) (paper §IV-C, "buffer depth analysis
    # during simulation"): a buffer on edge (n→m) must absorb the
    # pipeline-depth difference between the reconvergent paths.
    def path_depths(self) -> dict[str, int]:
        depth: dict[str, int] = {}
        for node in self.topo_order():
            in_d = [depth[self.streams[s].src] for s in node.inputs
                    if self.streams[s].src]
            depth[node.name] = max(in_d, default=0) + node.pipeline_depth
        return depth

    def skip_buffers(self) -> list["SkipBuffer"]:
        """Every (stream, consumer) edge whose reconvergent path depths
        diverge. Sorted by required depth, largest first — the order
        Algorithm 2 consumes them in.
        """
        depth = self.path_depths()
        out: list[SkipBuffer] = []
        for s in self.streams.values():
            if not s.src:
                continue
            for dst_name in s.dsts:
                dst = self.nodes[dst_name]
                if dst.attrs.get("fused") and dst.op not in ("concat",
                                                             "split"):
                    # A fused alias (absorbed residual add) never reads
                    # the stream — its host engine does, via its own
                    # edge, which carries the FIFO. Counting this edge
                    # too would double-buffer every fused residual.
                    # Eliminated concat/split plumbing keeps its edges:
                    # the stream-assembly buffering is still physical.
                    continue
                in_depths = []
                for e in dst.inputs:
                    src2 = self.streams[e].src
                    in_depths.append(depth[src2] if src2 else 0)
                if len(in_depths) < 2:
                    continue
                lag = max(in_depths) - depth[s.src]
                if lag <= 0:
                    continue
                q = min(lag, s.size)   # FIFO ≤ the full feature map
                out.append(SkipBuffer(edge=f"{s.name}->{dst_name}",
                                      src=s.src, dst=dst_name,
                                      depth_words=int(q),
                                      stream_size=s.size))
        out.sort(key=lambda b: -b.depth_words)
        return out

    def alias_groups(self) -> dict[str, str]:
        """``alias → host`` for every ``fused`` node whose value is
        materialised by a SINGLE upstream engine (fused activations,
        absorbed residual adds — their through path is ``inputs[0]``).

        This is the fusion-group relation the wordlength passes share
        bits across (paper §IV-A: a fused group is ONE hardware engine,
        so it has ONE wordlength): an alias never launches a kernel, so
        annotating it independently of its host would be meaningless.
        Eliminated concat/split plumbing is multi-producer wiring, not a
        single engine's epilogue, and is excluded.
        """
        out: dict[str, str] = {}
        for node in self.topo_order():
            if not node.attrs.get("fused") or node.op in ("concat", "split"):
                continue
            src = self.streams[node.inputs[0]].src
            if not src:
                continue
            out[node.name] = out.get(src, src)   # chains compose
        return out

    # Totals -------------------------------------------------------------
    def total_macs(self) -> int:
        return sum(n.macs for n in self.nodes.values())

    def total_weights(self) -> int:
        return sum(n.n_weights for n in self.nodes.values())

    def conv_nodes(self) -> list[Node]:
        return [n for n in self.topo_order() if n.op in ("conv", "matmul")]


@dataclasses.dataclass
class SkipBuffer:
    """A FIFO required on a skip connection (paper Fig. 2 dashed edges)."""
    edge: str
    src: str
    dst: str
    depth_words: int
    stream_size: int

    def bytes_at(self, wordlength_bits: int) -> int:
        return self.depth_words * wordlength_bits // 8
