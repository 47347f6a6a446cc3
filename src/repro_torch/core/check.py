"""Compile-time design-rule checker (DRC) for streaming designs.

SATAY's streaming architecture only works if every design is
*statically correct before it runs*: skip-connection FIFOs must be deep
enough that reconvergent dataflow paths cannot stall (paper §IV-C — the
off-chip buffering exists precisely because under-sized on-chip FIFOs
deadlock the pipeline), and per-layer wordlength assignments must stay
coherent across fusion groups (§IV-A: one engine, one wordlength). This
module turns those scattered conventions into a diagnostics framework:
structured :class:`Finding`\\ s with stable ``SAT0xx`` codes, severities
(error / warn / info), and node/stream anchors, over three families:

* **Graph DRC** (``SAT01x``) — cycles, registry/link incoherence,
  orphan streams, stream-geometry coherence per op, fusion-alias
  consistency (``Graph.alias_groups`` members share their host's
  bits and never carry their own launch backing), channel-window
  tiling (the offsets ``ConcatElimination`` wrote must tile the
  producers exactly — codegen's window table used to just trust the
  pass), packed-int4 layout rules, and wordlength annotation coherence.
* **Streaming deadlock analysis** (``SAT03x``) — compute the
  *required* FIFO depth of every reconvergent edge from the
  pipeline-depth imbalance between fork and join
  (:func:`required_fifo_depths`, interval-weighted via the DSE model)
  and compare it against what ``buffers.allocate_buffers`` actually
  allocated. A design whose allocated depth could stall is an error,
  not a costing convention.
* **Pass contracts** (``SAT05x``) — every pass declares
  ``preserves``/``establishes`` invariant families;
  ``PassManager(verify_each=True)`` (core/passes.py) runs the relevant
  checkers after each pass so a regression is attributed to the pass
  that introduced it.

Entry points: :func:`check_graph` (graph-level families),
:func:`check_design` (graph + buffer plan + quantized params) and
:func:`check_accelerator` (a compiled ``Accelerator``). A copy of the
JAX package's checker; only the QTensor dtype test and the selftest's
parameter init are torch. ``compile()`` runs :func:`check_design` on
every design it emits (``CompileConfig.check`` knob, default
``"error"``). :func:`selftest` is the mutation self-test: it perturbs a
known-good yolov8n design once per diagnostic code and asserts every
code fires where expected — zero escapes (the ``gate --selftest``
idiom, applied to the checker itself).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable

import torch

from .ir import Graph, POINTWISE_OPS

ERROR, WARN, INFO = "error", "warn", "info"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One stable diagnostic code: what it means and how to fix it."""
    code: str
    severity: str
    title: str
    hint: str


_D = Diagnostic
DIAGNOSTICS: dict[str, Diagnostic] = {d.code: d for d in (
    # --- graph DRC (SAT01x) ------------------------------------------------
    _D("SAT010", ERROR, "graph has a cycle",
       "A streaming pipeline is a DAG; remove the back-edge (a rewrite "
       "pass that rewires inputs must never point a node at its own "
       "downstream streams)."),
    _D("SAT011", ERROR, "node/stream registry incoherence",
       "Registry keys must equal .name, every src/dst/input/output "
       "reference must resolve, links must be bidirectional, and a "
       "stream has exactly one producer. Use Graph.add_node/add_stream "
       "instead of mutating the dicts."),
    _D("SAT012", ERROR, "dangling stream",
       "Every stream needs a producer (or be a graph input) and a "
       "consumer (or be a graph output). Run DeadStreamElimination "
       "after eliminating rewrites."),
    _D("SAT013", ERROR, "stream geometry mismatch",
       "Node geometry attrs (H/W/C/F/stride/groups/W_in) must agree "
       "with the shapes of the streams it reads and writes; fix the "
       "builder or the rewriting pass."),
    _D("SAT014", ERROR, "fusion alias diverges from host",
       "A fused alias is the same hardware engine as its host: it must "
       "inherit the host's w_bits/a_bits and never carry its own "
       "wq/a_scale backing. Re-run AssignWordlengths after fusing."),
    _D("SAT015", ERROR, "channel-window tiling violation",
       "Eliminated concat/split offsets must tile the producer streams "
       "exactly (no overlap, no gap) and resolved windows must stay in "
       "bounds and cover every channel. Re-run ConcatElimination."),
    _D("SAT016", ERROR, "packed-int4 layout violation",
       "A packed QTensor stores two codes per int8 byte over the "
       "(ceil(R/2), shape[-1]) matrix view at bits<=4, and its bits "
       "must match the node's w_bits. Re-quantize with quant.quantize "
       "rather than editing code arrays."),
    _D("SAT017", ERROR, "wordlength annotation incoherence",
       "w_bits and a_bits come in pairs from the supported ladder "
       "(W in {4,8,16}, A in {8,16}), and a wq scheme's bits must "
       "equal w_bits. Annotate through AssignWordlengths."),
    _D("SAT018", WARN, "narrow weights stored unpacked",
       "W<=4 codes in int8 storage stream 2x the packed size; use a "
       "pack=True per-tensor or last-axis per-channel scheme so "
       "quantize() nibble-packs."),
    _D("SAT019", WARN, "A<=8 conv without calibrated a_scale",
       "Without a measured a_scale the int8-wa lowering silently falls "
       "back to float activations; run "
       "codegen.calibrate_activation_scales."),
    # --- streaming deadlock / buffer plan (SAT03x) -------------------------
    _D("SAT030", ERROR, "reconvergent edge missing from buffer plan",
       "Every edge whose fork/join path depths diverge needs a FIFO "
       "entry (ON or OFF) in the plan; re-run "
       "buffers.allocate_buffers on the final graph."),
    _D("SAT031", ERROR, "allocated FIFO depth below required depth",
       "The on-chip FIFO cannot absorb the reconvergent path imbalance "
       "and the pipeline can stall; deepen the FIFO or spill the edge "
       "off-chip."),
    _D("SAT032", ERROR, "buffer plan byte accounting broken",
       "onchip_bytes must equal the sum of ON depths at their priced "
       "wordlengths and fit the available budget; rebuild the plan "
       "instead of editing it."),
    _D("SAT033", INFO, "FIFO capped at the full feature map",
       "The path imbalance exceeds the stream size, so the FIFO holds "
       "the whole map (the paper's full-buffer fallback); consider "
       "spilling this edge off-chip."),
    _D("SAT034", INFO, "FIFO priced below the stream's travel wordlength",
       "The plan prices this FIFO at its consumer's a_bits, below the "
       "max over all consumers (the stream-travel rule); the capacity "
       "check is optimistic for this edge."),
    # --- pass contracts (SAT05x) -------------------------------------------
    _D("SAT050", ERROR, "pass broke a preserved invariant",
       "The pass declares it preserves this family but the checker "
       "fails after it ran (and passed before); fix the rewrite."),
    _D("SAT051", ERROR, "pass failed to establish a declared invariant",
       "The pass declares it establishes this family but the checker "
       "still fails after it ran; fix the rewrite or the declaration."),
    _D("SAT052", WARN, "pass declares an unknown invariant",
       "preserves/establishes entries must name registered checker "
       "families; fix the declaration (see check.CHECKERS)."),
)}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic occurrence, anchored to a node and/or stream."""
    code: str
    message: str
    node: str = ""
    stream: str = ""
    invariant: str = ""

    @property
    def severity(self) -> str:
        return DIAGNOSTICS[self.code].severity

    def as_dict(self) -> dict:
        return {"code": self.code, "severity": self.severity,
                "message": self.message, "node": self.node,
                "stream": self.stream, "invariant": self.invariant}

    def __str__(self) -> str:
        anchor = "".join(
            f" [{k}={v}]" for k, v in (("node", self.node),
                                       ("stream", self.stream),
                                       ("invariant", self.invariant)) if v)
        return f"{self.code} {self.severity}: {self.message}{anchor}"


class CheckError(ValueError):
    """Raised when error-severity findings block compilation/validation.

    Subclasses ValueError so pre-checker callers catching the old
    ``Graph.validate()`` errors keep working. ``findings`` carries the
    structured diagnostics."""

    def __init__(self, message: str, findings=()):
        super().__init__(message)
        self.findings: list[Finding] = list(findings)


@dataclasses.dataclass
class CheckResult:
    """All findings of one checker run over one graph/design."""
    graph: str
    findings: list[Finding] = dataclasses.field(default_factory=list)

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == WARN]

    def infos(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == INFO]

    def codes(self) -> set[str]:
        return {f.code for f in self.findings}

    def by_code(self, code: str) -> list[Finding]:
        return [f for f in self.findings if f.code == code]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def summary(self) -> dict:
        """Deterministic JSON-serializable roll-up (stored in the
        design report, so it must be equal across equal designs)."""
        counts: dict[str, int] = {}
        for f in self.findings:
            counts[f.code] = counts.get(f.code, 0) + 1
        return {"errors": len(self.errors()),
                "warnings": len(self.warnings()),
                "infos": len(self.infos()),
                "codes": {c: counts[c] for c in sorted(counts)}}

    def format(self) -> str:
        head = (f"{self.graph}: {len(self.errors())} error(s), "
                f"{len(self.warnings())} warning(s), "
                f"{len(self.infos())} info(s)")
        return "\n".join([head] + [f"  {f}" for f in self.findings])

    def raise_on_error(self) -> "CheckResult":
        errs = self.errors()
        if errs:
            raise CheckError(
                f"{self.graph}: {len(errs)} design-rule error(s): "
                + "; ".join(str(e) for e in errs[:4]), findings=errs)
        return self


@dataclasses.dataclass
class DesignContext:
    """Design-level artifacts the graph alone does not carry."""
    plan: object | None = None          # buffers.BufferPlan
    alloc: object | None = None         # dse.Allocation
    params: dict | None = None          # quantized parameter dict
    avail_onchip_bytes: int | None = None
    default_a_bits: int = 16


# --------------------------------------------------------------------------
# family 1: graph DRC
# --------------------------------------------------------------------------

def _tolerant_topo(graph: Graph) -> list:
    """Kahn's ordering that never raises (skips unresolvable refs);
    the structure checker compares its length against the node count to
    report SAT010 instead of throwing."""
    indeg = {n: 0 for n in graph.nodes}
    for node in graph.nodes.values():
        for s in node.inputs:
            st = graph.streams.get(s)
            if st is not None and st.src and st.src in graph.nodes:
                indeg[node.name] += 1
    q = deque(sorted(n for n, d in indeg.items() if d == 0))
    order = []
    while q:
        name = q.popleft()
        order.append(graph.nodes[name])
        for s in graph.nodes[name].outputs:
            st = graph.streams.get(s)
            for dst in (st.dsts if st is not None else ()):
                if dst in indeg:
                    indeg[dst] -= 1
                    if indeg[dst] == 0:
                        q.append(dst)
    return order


def check_structure(graph: Graph, ctx: DesignContext | None = None
                    ) -> list[Finding]:
    """SAT010/011/012: registry coherence, link bidirectionality,
    single-producer streams, dangling streams, cycles."""
    out: list[Finding] = []

    for key, node in graph.nodes.items():
        if node.name != key:
            out.append(Finding(
                "SAT011", f"node registry key {key!r} != node.name "
                f"{node.name!r}", node=key))
    for key, s in graph.streams.items():
        if s.name != key:
            out.append(Finding(
                "SAT011", f"stream registry key {key!r} != stream.name "
                f"{s.name!r}", stream=key))
    for names, kind in ((graph.inputs, "input"), (graph.outputs, "output")):
        for s in names:
            if s not in graph.streams:
                out.append(Finding(
                    "SAT011", f"graph {kind} {s!r} is not a registered "
                    f"stream", stream=s))

    producers: dict[str, list[str]] = {}
    for node in graph.nodes.values():
        for s in node.inputs:
            st = graph.streams.get(s)
            if st is None:
                out.append(Finding(
                    "SAT011", f"node {node.name} reads unregistered "
                    f"stream {s!r}", node=node.name, stream=s))
            elif st.dsts.count(node.name) != node.inputs.count(s):
                out.append(Finding(
                    "SAT011", f"link {s}->{node.name} is not "
                    f"bidirectional (stream.dsts lists the consumer "
                    f"{st.dsts.count(node.name)}x, node.inputs "
                    f"{node.inputs.count(s)}x)",
                    node=node.name, stream=s))
        for s in node.outputs:
            st = graph.streams.get(s)
            producers.setdefault(s, []).append(node.name)
            if st is None:
                out.append(Finding(
                    "SAT011", f"node {node.name} writes unregistered "
                    f"stream {s!r}", node=node.name, stream=s))
            elif st.src != node.name:
                out.append(Finding(
                    "SAT011", f"node {node.name} lists output {s} but "
                    f"stream.src is {st.src!r}", node=node.name,
                    stream=s))
    for s, prods in producers.items():
        if len(prods) > 1:
            out.append(Finding(
                "SAT011", f"stream {s} has multiple producers "
                f"{sorted(prods)}", stream=s))
    for s in graph.streams.values():
        if s.src and s.src not in graph.nodes:
            out.append(Finding(
                "SAT011", f"stream {s.name}.src names unregistered "
                f"node {s.src!r}", stream=s.name))
        elif s.src and s.name not in graph.nodes[s.src].outputs:
            out.append(Finding(
                "SAT011", f"stream {s.name}.src {s.src!r} does not "
                f"list it as an output", stream=s.name, node=s.src))
        for d in set(s.dsts):
            if d not in graph.nodes:
                out.append(Finding(
                    "SAT011", f"stream {s.name} feeds unregistered "
                    f"node {d!r}", stream=s.name))

    for s in graph.streams.values():
        if not s.src and not s.dsts:
            out.append(Finding(
                "SAT012", f"stream {s.name} has no producer and no "
                f"consumer", stream=s.name))
        elif not s.src and s.name not in graph.inputs:
            out.append(Finding(
                "SAT012", f"stream {s.name} has no producer and is not "
                f"a graph input", stream=s.name))
        elif not s.dsts and s.name not in graph.outputs:
            out.append(Finding(
                "SAT012", f"stream {s.name} has no consumer and is not "
                f"a graph output", stream=s.name))

    if not any(f.code == "SAT011" for f in out):
        order = _tolerant_topo(graph)
        if len(order) != len(graph.nodes):
            stuck = sorted(set(graph.nodes) - {n.name for n in order})
            out.append(Finding(
                "SAT010", f"graph has a cycle ({len(order)}/"
                f"{len(graph.nodes)} nodes ordered; stuck: "
                f"{', '.join(stuck[:6])})", node=stuck[0]))
    return out


def check_shapes(graph: Graph, ctx: DesignContext | None = None
                 ) -> list[Finding]:
    """SAT013: per-op coherence between node geometry attrs and the
    shapes of the streams it reads/writes. Compares STREAM shapes, not
    attrs-vs-attrs: pool-reordered aliases legitimately carry post-pool
    H/W attrs while their streams keep pre-pool dims."""
    out: list[Finding] = []

    def shp(s: str):
        st = graph.streams.get(s)
        return tuple(st.shape) if st is not None else None

    def bad(node, msg):
        out.append(Finding("SAT013", msg, node=node.name,
                           stream=node.outputs[0] if node.outputs else ""))

    for node in graph.nodes.values():
        ins = [shp(s) for s in node.inputs]
        outs = [shp(s) for s in node.outputs]
        if any(x is None for x in ins + outs):
            continue                      # SAT011 territory
        op = node.op
        if op == "conv":
            if not ins or not outs or len(ins[0]) != 3 or len(outs[0]) != 3:
                continue
            H, W, F = node.geom("H"), node.geom("W"), node.geom("F")
            C, stride = node.geom("C"), node.geom("stride")
            groups = node.geom("groups")
            hi, wi, ci = ins[0]
            if outs[0] != (H, W, F):
                bad(node, f"conv output stream is {outs[0]}, attrs say "
                    f"(H, W, F) = {(H, W, F)}")
            if ci != C:
                bad(node, f"conv reads {ci} channels, attrs say C={C}")
            if groups <= 0 or C % max(groups, 1) or F % max(groups, 1):
                bad(node, f"groups={groups} does not divide C={C} / F={F}")
            if (outs[0][0], outs[0][1]) != (-(-hi // stride),
                                            -(-wi // stride)):
                bad(node, f"stride-{stride} conv maps input {ins[0][:2]} "
                    f"to {outs[0][:2]}, expected "
                    f"{(-(-hi // stride), -(-wi // stride))}")
            w_in = node.attrs.get("W_in")
            if w_in is not None and int(w_in) != wi:
                bad(node, f"W_in attr {w_in} != input stream width {wi}")
            if node.attrs.get("fuse_add") and (
                    len(ins) < 2 or ins[-1] != outs[0]):
                bad(node, f"fuse_add residual operand shape "
                    f"{ins[-1] if len(ins) > 1 else None} != output "
                    f"{outs[0]}")
        elif op == "maxpool":
            if len(ins[0]) != 3 or len(outs[0]) != 3:
                continue
            stride = node.geom("stride")
            hi, wi, ci = ins[0]
            if outs[0][2] != ci:
                bad(node, f"maxpool changes channels {ci} -> {outs[0][2]}")
            if (outs[0][0], outs[0][1]) != (-(-hi // stride),
                                            -(-wi // stride)):
                bad(node, f"stride-{stride} maxpool maps {ins[0][:2]} to "
                    f"{outs[0][:2]}")
        elif op == "resize":
            if len(ins[0]) != 3 or len(outs[0]) != 3:
                continue
            sc = node.geom("scale")
            hi, wi, ci = ins[0]
            if outs[0] != (hi * sc, wi * sc, ci):
                bad(node, f"scale-{sc} resize maps {ins[0]} to {outs[0]}")
        elif op == "concat":
            if any(len(x) != 3 for x in ins + outs):
                continue
            if outs[0][2] != sum(x[2] for x in ins):
                bad(node, f"concat output has {outs[0][2]} channels, "
                    f"inputs sum to {sum(x[2] for x in ins)}")
            if any(x[:2] != outs[0][:2] for x in ins):
                bad(node, "concat inputs disagree on spatial dims "
                    f"{[x[:2] for x in ins]} vs output {outs[0][:2]}")
        elif op == "split":
            if any(len(x) != 3 for x in ins + outs):
                continue
            if ins[0][2] != sum(x[2] for x in outs):
                bad(node, f"split input has {ins[0][2]} channels, "
                    f"outputs sum to {sum(x[2] for x in outs)}")
            if any(x[:2] != ins[0][:2] for x in outs):
                bad(node, "split outputs disagree on spatial dims")
        elif op in POINTWISE_OPS:
            for i, xin in enumerate(ins):
                if xin != outs[0]:
                    bad(node, f"pointwise {op} input "
                        f"{node.inputs[i]} shape {xin} != output "
                        f"{outs[0]}")
    return out


def check_alias(graph: Graph, ctx: DesignContext | None = None
                ) -> list[Finding]:
    """SAT014: every fusion alias shares its host engine's wordlengths
    and carries no launch backing of its own."""
    try:
        groups = graph.alias_groups()
    except (ValueError, KeyError):
        return []                         # structure checker owns this
    out: list[Finding] = []
    for alias, host in groups.items():
        a = graph.nodes[alias].attrs
        h = graph.nodes[host].attrs
        if ("w_bits" in a) != ("w_bits" in h):
            where = alias if "w_bits" in a else host
            out.append(Finding(
                "SAT014", f"fusion alias {alias} and host {host} "
                f"disagree on wordlength annotation (only {where} is "
                f"annotated)", node=alias))
        elif "w_bits" in h and (
                (int(a.get("w_bits", -1)), int(a.get("a_bits", -1)))
                != (int(h["w_bits"]), int(h.get("a_bits", -1)))):
            out.append(Finding(
                "SAT014", f"fusion alias {alias} carries "
                f"(W{a.get('w_bits')}, A{a.get('a_bits')}) but its host "
                f"{host} is (W{h['w_bits']}, A{h.get('a_bits')}) — one "
                f"engine, one wordlength", node=alias))
        for k in ("wq", "a_scale"):
            if k in a:
                out.append(Finding(
                    "SAT014", f"fusion alias {alias} carries its own "
                    f"{k!r} backing; aliases never launch (host "
                    f"{host} owns it)", node=alias))
    return out


def check_windows(graph: Graph, ctx: DesignContext | None = None
                  ) -> list[Finding]:
    """SAT015: the channel offsets ConcatElimination wrote tile the
    operand streams exactly, the producer-side mirrors agree, and the
    resolved window table stays in bounds and covers every channel."""
    out: list[Finding] = []
    for node in graph.nodes.values():
        if not node.attrs.get("fused") or node.op not in ("concat",
                                                          "split"):
            continue
        names = node.inputs if node.op == "concat" else node.outputs
        widths = []
        for s in names:
            st = graph.streams.get(s)
            if st is None or len(st.shape) != 3:
                widths = None
                break
            widths.append(int(st.shape[-1]))
        if widths is None:
            continue
        exp, off = [], 0
        for w in widths:
            exp.append(off)
            off += w
        key = "concat_offsets" if node.op == "concat" else "split_offsets"
        got = node.attrs.get(key)
        if got is None:
            out.append(Finding(
                "SAT015", f"eliminated {node.op} {node.name} lacks "
                f"{key}", node=node.name))
        elif tuple(int(x) for x in got) != tuple(exp):
            out.append(Finding(
                "SAT015", f"{key} {tuple(got)} do not tile the "
                f"operand streams (cumulative widths {tuple(exp)})",
                node=node.name))
        if node.op == "concat":
            for s, o in zip(node.inputs, exp):
                src = graph.streams[s].src
                if not src or src not in graph.nodes:
                    continue
                mirror = graph.nodes[src].attrs.get("concat_offset", {})
                edge = f"{s}->{node.name}"
                if mirror.get(edge) != o:
                    out.append(Finding(
                        "SAT015", f"producer {src} channel-offset "
                        f"mirror for {edge} is {mirror.get(edge)!r}, "
                        f"expected {o}", node=src, stream=s))

    try:
        from . import codegen
        table = codegen.window_table(graph)
    except (ValueError, KeyError):
        return out                        # structure checker owns this
    for stream, parts in table.items():
        st = graph.streams.get(stream)
        if st is None or len(st.shape) != 3:
            continue
        covered = 0
        for src, off, ln in parts:
            sst = graph.streams.get(src)
            if sst is None:
                out.append(Finding(
                    "SAT015", f"window for {stream} reads missing "
                    f"source stream {src!r}", stream=stream))
                continue
            if off < 0 or ln <= 0 or off + ln > sst.shape[-1]:
                out.append(Finding(
                    "SAT015", f"window for {stream} reads "
                    f"{src}[{off}:{off + ln}] out of the source's "
                    f"{sst.shape[-1]} channels", stream=stream))
            covered += ln
        if covered != st.shape[-1]:
            out.append(Finding(
                "SAT015", f"windows cover {covered} of "
                f"{st.shape[-1]} channels of {stream}", stream=stream))
    return out


_VALID_W_BITS = (4, 8, 16)
_VALID_A_BITS = (8, 16)


def check_wordlengths(graph: Graph, ctx: DesignContext | None = None
                      ) -> list[Finding]:
    """SAT016/017/018/019: annotation pairing and ladder membership,
    wq-scheme coherence, packed-int4 layout rules (against the
    quantized params when the context carries them), and calibration
    presence for A<=8 lowerings."""
    out: list[Finding] = []
    params = ctx.params if ctx is not None else None
    for node in graph.nodes.values():
        a = node.attrs
        has_w, has_a = "w_bits" in a, "a_bits" in a
        if has_w != has_a:
            out.append(Finding(
                "SAT017", f"{node.name} annotates "
                f"{'w_bits' if has_w else 'a_bits'} without the other "
                f"(wordlengths come in (w, a) pairs)", node=node.name))
        if has_w and int(a["w_bits"]) not in _VALID_W_BITS:
            out.append(Finding(
                "SAT017", f"{node.name} w_bits={a['w_bits']} outside "
                f"the supported ladder {_VALID_W_BITS}", node=node.name))
        if has_a and int(a["a_bits"]) not in _VALID_A_BITS:
            out.append(Finding(
                "SAT017", f"{node.name} a_bits={a['a_bits']} outside "
                f"the supported ladder {_VALID_A_BITS}", node=node.name))
        wq = a.get("wq")
        if wq is not None:
            if not has_w:
                out.append(Finding(
                    "SAT017", f"{node.name} carries a wq scheme but no "
                    f"w_bits annotation", node=node.name))
            elif int(wq.bits) != int(a["w_bits"]):
                out.append(Finding(
                    "SAT017", f"{node.name} wq.bits={wq.bits} != "
                    f"w_bits={a['w_bits']}", node=node.name))
            if int(wq.bits) <= 4:
                ndim = 4 if node.op == "conv" else 2
                if not getattr(wq, "pack", False):
                    out.append(Finding(
                        "SAT018", f"W{wq.bits} scheme on {node.name} "
                        f"has pack=False — codes stream 2x the packed "
                        f"size", node=node.name))
                elif not wq.packs_layout(ndim):
                    out.append(Finding(
                        "SAT018", f"W{wq.bits} scheme on {node.name} "
                        f"sets pack=True but the {wq.granularity}/axis="
                        f"{wq.axis} layout stores unpacked",
                        node=node.name))
        if (node.op == "conv" and node.geom("groups") == 1 and has_a
                and int(a["a_bits"]) <= 8 and not a.get("fused")
                and a.get("a_scale") is None):
            out.append(Finding(
                "SAT019", f"A{a['a_bits']} conv {node.name} has no "
                f"calibrated a_scale — the int8-wa lowering falls back "
                f"to float activations", node=node.name))
        if params is not None and node.name in params and wq is not None:
            out.extend(_check_qtensor(node, params[node.name].get("w")))
    return out


def _check_qtensor(node, w) -> list[Finding]:
    """SAT016/018 against one quantized weight tensor."""
    from .quant import QTensor
    if not isinstance(w, QTensor):
        return []
    out: list[Finding] = []
    w_bits = int(node.attrs.get("w_bits", w.bits))
    if int(w.bits) != w_bits:
        out.append(Finding(
            "SAT016", f"{node.name} weight codes quantized at "
            f"{w.bits} bits but annotated w_bits={w_bits}",
            node=node.name))
    if w.packed:
        R = int(math.prod(w.shape[:-1]))
        exp = ((R + 1) // 2, int(w.shape[-1]))
        qshape = tuple(int(x) for x in w.q.shape)
        if qshape != exp:
            out.append(Finding(
                "SAT016", f"{node.name} packed-int4 code matrix is "
                f"{qshape}, expected {exp} (two codes per byte over "
                f"the (R, shape[-1]) view)", node=node.name))
        if w.q.dtype != torch.int8:
            out.append(Finding(
                "SAT016", f"{node.name} packed codes use "
                f"{w.q.dtype} storage, expected int8", node=node.name))
        if int(w.bits) > 4:
            out.append(Finding(
                "SAT016", f"{node.name} packed layout at "
                f"{w.bits} bits — packing is an int4 storage mode",
                node=node.name))
    elif int(w.bits) <= 4:
        out.append(Finding(
            "SAT018", f"{node.name} W{w.bits} codes stored unpacked "
            f"({w.q.dtype}) — 2x the packed weight stream",
            node=node.name))
    return out


# --------------------------------------------------------------------------
# family 2: streaming deadlock analysis
# --------------------------------------------------------------------------

def required_fifo_depths(graph: Graph,
                         interval_cycles: float | None = None
                         ) -> dict[str, dict]:
    """Per-edge REQUIRED FIFO depth from reconvergent-path imbalance.

    For every (stream, consumer) edge at a join whose input path depths
    diverge, the early branch produces ``lag`` cycles of output before
    the late branch's first word arrives (paper §IV-C). At a
    steady-state initiation interval ``I`` the producer emits
    ``size / I`` words per cycle, so the words in flight during the lag
    are ``lag · min(1, size / I)`` — the interval weighting from the
    DSE model (``interval_cycles=None`` assumes the worst case of one
    word per cycle). The FIFO never needs more than the full feature
    map: ``required = min(ceil(lag · rate), size)``.

    This is provably ≤ the costing model's ``min(lag, size)``
    (``Graph.skip_buffers``), which is what makes the deadlock analysis
    CONSISTENT with ``buffers.allocate_buffers`` — the property the
    hypothesis suite pins. Edge keys use the plan's
    ``"{stream}->{dst}"`` format. Tolerant: returns ``{}`` on graphs
    the structure checker rejects (cycles, dangling refs)."""
    try:
        depth = graph.path_depths()
    except (ValueError, KeyError):
        return {}
    interval = max(float(interval_cycles), 1.0) if interval_cycles \
        else None
    out: dict[str, dict] = {}
    for s in graph.streams.values():
        if not s.src or s.src not in depth:
            continue
        for dst_name in s.dsts:
            dst = graph.nodes.get(dst_name)
            if dst is None:
                continue
            if dst.attrs.get("fused") and dst.op not in ("concat",
                                                         "split"):
                continue              # the host engine's edge carries it
            in_depths = [depth.get(graph.streams[e].src, 0)
                         if graph.streams.get(e) is not None
                         and graph.streams[e].src else 0
                         for e in dst.inputs
                         if graph.streams.get(e) is not None]
            if len(in_depths) < 2:
                continue
            lag = max(in_depths) - depth[s.src]
            if lag <= 0:
                continue
            rate = min(1.0, s.size / interval) if interval else 1.0
            required = min(int(math.ceil(lag * rate)), s.size)
            out[f"{s.name}->{dst_name}"] = {
                "required": max(required, 1), "lag": int(lag),
                "size": int(s.size), "rate": rate}
    return out


def check_buffers(graph: Graph, ctx: DesignContext | None = None
                  ) -> list[Finding]:
    """SAT030–SAT034: the allocated buffer plan against the deadlock
    analysis — every reconvergent edge planned, every ON depth at least
    the required depth, byte accounting intact, plus the full-map cap
    and below-travel-pricing advisories."""
    if ctx is None or ctx.plan is None:
        return []
    from . import dse as dse_lib
    plan = ctx.plan
    interval = float(ctx.alloc.latency_cycles) if ctx.alloc is not None \
        else None
    req = required_fifo_depths(graph, interval)
    depths = dict(getattr(plan, "depths", None) or {})
    bits = dict(getattr(plan, "bits", None) or {})
    if not depths:                        # legacy plans: recompute
        try:
            depths = {b.edge: b.depth_words for b in graph.skip_buffers()}
        except (ValueError, KeyError):
            depths = {}
    out: list[Finding] = []
    for edge, info in sorted(req.items()):
        stream = edge.split("->", 1)[0]
        dst = edge.split("->", 1)[1]
        if edge not in plan.assignment:
            out.append(Finding(
                "SAT030", f"reconvergent edge {edge} needs a "
                f"{info['required']}-word FIFO but has no entry in the "
                f"buffer plan", node=dst, stream=stream))
            continue
        if info["lag"] > info["size"]:
            out.append(Finding(
                "SAT033", f"FIFO on {edge} capped at the full feature "
                f"map ({info['size']} words; path imbalance "
                f"{info['lag']} cycles)", node=dst, stream=stream))
        if plan.is_on(edge):
            alloc_depth = depths.get(edge)
            if alloc_depth is not None and alloc_depth < info["required"]:
                out.append(Finding(
                    "SAT031", f"on-chip FIFO on {edge} holds "
                    f"{alloc_depth} words but the reconvergent paths "
                    f"require {info['required']} — the pipeline can "
                    f"stall", node=dst, stream=stream))
        edge_bits = bits.get(edge)
        if edge_bits is not None and stream in graph.streams:
            travel = dse_lib.stream_a_bits(graph, graph.streams[stream],
                                           ctx.default_a_bits)
            if edge_bits < travel:
                out.append(Finding(
                    "SAT034", f"FIFO on {edge} priced at {edge_bits}-bit "
                    f"words; the stream travels at {travel} bits",
                    node=dst, stream=stream))
    if bits and depths:
        acc = sum(depths[e] * int(bits.get(e, ctx.default_a_bits)) // 8
                  for e, v in plan.assignment.items()
                  if v == "ON" and e in depths)
        if acc != plan.onchip_bytes:
            out.append(Finding(
                "SAT032", f"buffer plan claims {plan.onchip_bytes} "
                f"on-chip bytes but its ON depths sum to {acc}"))
    if (ctx.avail_onchip_bytes is not None
            and plan.onchip_bytes > ctx.avail_onchip_bytes):
        out.append(Finding(
            "SAT032", f"on-chip FIFO bytes {plan.onchip_bytes} exceed "
            f"the available budget {ctx.avail_onchip_bytes}"))
    return out


# --------------------------------------------------------------------------
# checker registry + entry points
# --------------------------------------------------------------------------

CHECKERS: dict[str, Callable] = {
    "structure": check_structure,
    "shapes": check_shapes,
    "alias": check_alias,
    "windows": check_windows,
    "wordlengths": check_wordlengths,
    "buffers": check_buffers,
}

# The families a graph alone can satisfy (pass contracts range over
# these); "buffers" is design-level — it needs an allocated plan.
GRAPH_INVARIANTS = ("structure", "shapes", "alias", "windows",
                    "wordlengths")


def run_checkers(graph: Graph, families, ctx: DesignContext | None = None
                 ) -> CheckResult:
    findings: list[Finding] = []
    for fam in families:
        findings.extend(CHECKERS[fam](graph, ctx))
    return CheckResult(graph=graph.name, findings=findings)


def check_graph(graph: Graph, ctx: DesignContext | None = None
                ) -> CheckResult:
    """All graph-level families (no buffer plan required)."""
    return run_checkers(graph, GRAPH_INVARIANTS, ctx)


def check_design(graph: Graph, *, plan=None, alloc=None, params=None,
                 avail_onchip_bytes=None, default_a_bits: int = 16
                 ) -> CheckResult:
    """Full DRC over a design: the graph families plus the streaming
    deadlock analysis against the allocated buffer plan."""
    ctx = DesignContext(plan=plan, alloc=alloc, params=params,
                        avail_onchip_bytes=avail_onchip_bytes,
                        default_a_bits=default_a_bits)
    return run_checkers(graph, (*GRAPH_INVARIANTS, "buffers"), ctx)


def check_accelerator(acc) -> CheckResult:
    """Full DRC over a compiled ``Accelerator`` artifact."""
    rep = getattr(acc, "report", {}) or {}
    avail = None
    if "onchip_capacity_bytes" in rep:
        avail = max(int(rep["onchip_capacity_bytes"])
                    - int(rep.get("weights_bytes", 0))
                    - int(rep.get("sliding_window_bytes", 0)), 0)
    return check_design(acc.graph, plan=acc.buffer_plan,
                        alloc=acc.allocation, params=acc.params,
                        avail_onchip_bytes=avail,
                        default_a_bits=int(getattr(acc, "a_bits", 16)))


# --------------------------------------------------------------------------
# mutation self-test: every diagnostic code must fire — zero escapes
# --------------------------------------------------------------------------

def _selftest_design():
    """A known-good mixed-precision yolov8n design: graph through the
    default pipeline, one conv at (4, 8) packed + one at (8, 16), a
    hand-set a_scale (the selftest never executes kernels), quantized
    params, and an all-ON buffer plan."""
    from . import buffers as buf_lib
    from . import codegen
    from . import passes as passes_lib
    from ..models import yolo

    m = yolo.build("yolov8n", 64)
    g = passes_lib.PassManager(passes_lib.default_pipeline()).run(m.graph)
    dense = [n.name for n in g.topo_order()
             if n.op == "conv" and n.geom("groups") == 1]
    hosts = set(g.alias_groups().values())
    hosted = [n for n in dense if n in hosts]    # convs with an alias
    conv_a = hosted[0] if hosted else dense[0]   # (4, 8) packed + a_scale
    conv_b = (hosted[1] if len(hosted) > 1 else dense[1])  # (8, 16)
    wl = passes_lib.AssignWordlengths(
        bits={conv_a: (4, 8), conv_b: (8, 16)}, default=None)
    wl.run(g)
    g.nodes[conv_a].attrs["a_scale"] = 0.05
    params = codegen.init_params(g, torch.Generator().manual_seed(0))
    qparams = passes_lib.AssignWordlengths.quantize_params(g, params)
    node_bits = {n.name: int(n.attrs["a_bits"])
                 for n in g.nodes.values() if "a_bits" in n.attrs}
    plan = buf_lib.allocate_buffers(g, 10 ** 9, node_bits=node_bits)
    return g, qparams, plan, conv_a, conv_b


def selftest(verbose: bool = False) -> list[dict]:
    """Perturb the known-good design once per diagnostic code and
    assert the code fires where expected. Raises :class:`CheckError`
    listing every escape (a code that failed to fire) — and also when a
    documented code has no perturbation case (a new diagnostic must
    ship with its mutation)."""
    import copy

    from . import buffers as buf_lib
    from . import passes as passes_lib
    from .quant import QTensor

    g0, qparams0, plan0, conv_a, conv_b = _selftest_design()
    base = check_design(graph=g0, plan=plan0, params=qparams0)
    if base.errors():
        raise CheckError("selftest baseline is not clean:\n"
                         + base.format(), findings=base.errors())

    alias_of_b = next(a for a, h in g0.alias_groups().items()
                      if h == conv_b)
    fused_concat = next(n.name for n in g0.nodes.values()
                        if n.op == "concat" and n.attrs.get("fused")
                        and len(n.inputs) >= 2)
    edge0 = max(plan0.depths, key=plan0.depths.get)
    edge16 = next(e for e, b in plan0.bits.items() if b == 16)

    def graph_case(mutate):
        def run():
            g = copy.deepcopy(g0)
            mutate(g)
            return check_design(graph=g, plan=plan0, params=qparams0)
        return run

    def plan_case(mutate):
        def run():
            plan = copy.deepcopy(plan0)
            mutate(plan)
            return check_design(graph=g0, plan=plan, params=qparams0)
        return run

    def sat010(g):                        # back-edge: node reads its
        node = g.nodes[conv_a]            # own output stream's consumer
        out_s = node.outputs[0]
        dst = g.streams[out_s].dsts[0]
        late = g.nodes[dst].outputs[0] if g.nodes[dst].outputs else out_s
        node.inputs.append(late)
        g.streams[late].dsts.append(node.name)

    def sat011(g):
        g.nodes["__evil__"] = g.nodes.pop(conv_b)

    def sat012(g):
        g.add_stream("__orphan__", (4, 4, 4))

    def sat013(g):
        s = g.streams[g.nodes[conv_a].outputs[0]]
        s.shape = (s.shape[0], s.shape[1], s.shape[2] + 1)

    def sat014(g):
        g.nodes[alias_of_b].attrs["a_bits"] = 8

    def sat015(g):
        offs = list(g.nodes[fused_concat].attrs["concat_offsets"])
        offs[1] -= 1                      # overlap the first window
        g.nodes[fused_concat].attrs["concat_offsets"] = tuple(offs)

    def sat016():
        qp = dict(qparams0)
        qt = qp[conv_a]["w"]
        qp[conv_a] = {**qp[conv_a],
                      "w": QTensor(q=qt.q[:-1], scale=qt.scale,
                                   zero=qt.zero, bits=qt.bits,
                                   shape=qt.shape, packed=qt.packed)}
        return check_design(graph=g0, plan=plan0, params=qp)

    def sat017(g):
        del g.nodes[conv_b].attrs["a_bits"]

    def sat018(g):
        wq = g.nodes[conv_a].attrs["wq"]
        g.nodes[conv_a].attrs["wq"] = dataclasses.replace(wq, pack=False)

    def sat019(g):
        del g.nodes[conv_a].attrs["a_scale"]

    def sat030(plan):
        del plan.assignment[edge0]

    def sat031(plan):
        plan.depths[edge0] -= 1           # drop a FIFO word

    def sat032(plan):
        plan.onchip_bytes += 1

    def sat033():
        g = copy.deepcopy(g0)             # inflate one pool's line
        pool = next(n for n in g.nodes.values() if n.op == "maxpool")
        pool.attrs["K"] = 10 ** 6         # buffer: lag >> stream size
        node_bits = {n.name: int(n.attrs["a_bits"])
                     for n in g.nodes.values() if "a_bits" in n.attrs}
        plan = buf_lib.allocate_buffers(g, 10 ** 12, node_bits=node_bits)
        return check_design(graph=g, plan=plan, params=qparams0)

    def sat034(plan):
        plan.bits[edge16] = 8             # price below the travel bits

    def contract_case(pazz):
        def run():
            pm = passes_lib.PassManager([pazz], verify_each=True)
            try:
                pm.run(copy.deepcopy(g0))
            except CheckError as e:
                return CheckResult(graph=g0.name, findings=e.findings)
            return CheckResult(graph=g0.name, findings=pm.check_log)
        return run

    class _BreaksStructure:
        name = "selftest-breaks-structure"
        preserves = GRAPH_INVARIANTS

        def run(self, graph):
            s = graph.nodes[conv_a].outputs[0]
            graph.streams[s].dsts.clear()        # sever the links
            return graph

    class _FailsToEstablish:
        name = "selftest-fails-establish"
        establishes = ("wordlengths",)

        def run(self, graph):
            graph.nodes[conv_b].attrs.pop("a_bits")  # half a pair
            return graph

    class _UnknownInvariant:
        name = "selftest-unknown-invariant"
        preserves = ("no-such-family",)

        def run(self, graph):
            return graph

    cases: dict[str, Callable[[], CheckResult]] = {
        "SAT010": graph_case(sat010), "SAT011": graph_case(sat011),
        "SAT012": graph_case(sat012), "SAT013": graph_case(sat013),
        "SAT014": graph_case(sat014), "SAT015": graph_case(sat015),
        "SAT016": sat016, "SAT017": graph_case(sat017),
        "SAT018": graph_case(sat018), "SAT019": graph_case(sat019),
        "SAT030": plan_case(sat030), "SAT031": plan_case(sat031),
        "SAT032": plan_case(sat032), "SAT033": sat033,
        "SAT034": plan_case(sat034),
        "SAT050": contract_case(_BreaksStructure()),
        "SAT051": contract_case(_FailsToEstablish()),
        "SAT052": contract_case(_UnknownInvariant()),
    }

    results: list[dict] = []
    escapes: list[str] = []
    for code in sorted(DIAGNOSTICS):
        case = cases.get(code)
        if case is None:
            escapes.append(f"{code}: no selftest perturbation")
            results.append({"code": code, "fired": False,
                            "co_fired": [], "note": "no case"})
            continue
        res = case()
        fired = code in res.codes()
        co = sorted(res.codes() - {code})
        if not fired:
            escapes.append(f"{code}: perturbation did not fire it "
                           f"(got {co or 'nothing'})")
        results.append({"code": code, "fired": fired, "co_fired": co,
                        "note": DIAGNOSTICS[code].title})
        if verbose:
            mark = "ok " if fired else "ESC"
            print(f"  {mark} {code} {DIAGNOSTICS[code].title}"
                  + (f"  (co-fired: {', '.join(co)})" if co else ""))
    if escapes:
        raise CheckError("checker selftest ESCAPES:\n  "
                         + "\n  ".join(escapes))
    return results
