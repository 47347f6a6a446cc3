"""Rewrite passes over the dataflow IR — the toolflow's middle end.

SATAY's toolflow is staged (paper §IV): Parse → DSE → Generate. This
module is the substrate between parsing and DSE: a small pass framework
that transforms ONE mutable ``ir.Graph`` which every later stage — the
DSE latency/resource models, the buffer allocator, and the executable
codegen (core/codegen.py) — then reads. There is no second bookkeeping
structure: what a pass rewrites is what executes.

Passes mirror the paper's own graph-level optimisations:

* ``SubstituteActivation`` — the SiLU→HardSwish substitution (paper
  §VI / Fig. 7): HardSwish costs 2·p DSPs where SiLU's exp/div does not
  map to DSPs at all, with negligible accuracy impact.
* ``FuseConvAct`` — mark a conv's single downstream activation as fused
  into the conv engine's epilogue for *execution* (the conv kernel
  applies bias+activation in-register). The activation node stays in
  the graph so the DSE keeps costing it as its own hardware block
  (conv K²·p, HardSwish 2·p — the paper costs them separately).
* ``FuseConvAdd`` — absorb a residual ``add`` into the producing conv's
  epilogue: the skip stream becomes an extra conv operand
  (``fuse_add`` attr + appended input; kernels take ``res=``) and the
  add node becomes an ``absorbed`` stream alias — zero HBM round-trip
  and zero pipeline stage.
* ``ConcatElimination`` — rewrite ``concat`` (and, dually, ``split``)
  into zero-copy channel-offset stream plumbing: the node is tagged
  ``fused``/``absorbed`` and annotated with channel offsets
  (``concat_offsets`` on the node, ``concat_offset`` on producers);
  codegen lowers consumers to read producer streams directly at those
  offsets, so the concatenated tensor is never materialised. On SATAY's
  hardware this is the producers writing the consumer's stream at
  channel offsets; in the XLA executor it is the consumer gathering at
  channel offsets inside its own kernel — the same contract, the
  concat/split block disappears either way.
* ``FuseConvMaxpool`` — reorder a monotone activation past a following
  maxpool (max commutes with non-decreasing maps, so
  ``pool(act(x)) == act(pool(x))`` exactly): the activation runs on the
  POOLED stream (1/stride² of the elements) as the pool's epilogue.
  Legal for relu / leaky_relu (α>0); SiLU/HardSwish are not monotone
  and are skipped.
* ``DeadStreamElimination`` — drop nodes/streams no graph output
  depends on (fan-out pruning after rewrites). Any pass that declares
  ``eliminates = True`` gets a dead-stream sweep run automatically by
  the ``PassManager`` right after it.
* ``Verify`` — run the full graph design-rule check (core/check.py) as
  a pass so pipelines can assert well-formedness at any point; passes
  additionally declare ``preserves``/``establishes`` contracts that
  ``PassManager(verify_each=True)`` enforces after every pass.

Attr vocabulary the later stages read (set here, consumed by
core/codegen.py and core/dse.py):

* ``fused``      — the node is a stream alias at execution time (its
  value is produced by another node's epilogue / by zero-copy reads).
* ``absorbed``   — additionally, the node is NOT a hardware pipeline
  stage: the DSE excludes it from the interval and its
  ``pipeline_depth`` is 0 (ir.Node). FuseConvAct deliberately sets only
  ``fused`` (the paper's resource model costs activations separately);
  FuseConvAdd / ConcatElimination set both.
* ``fuse_add``   — on a conv: its LAST input is a residual stream fed
  to the kernel's ``res=`` epilogue operand.
* ``concat_offsets`` / ``split_offsets`` — channel offsets of an
  eliminated node's inputs/outputs; ``concat_offset`` mirrors the
  offset onto each producer node (the paper's channel-offset write).
* ``wq`` / ``w_bits`` / ``a_bits`` — set by ``AssignWordlengths`` (and
  its uniform ``QuantizeWeights`` shim): the conv's weight quantization
  scheme (QuantConfig), weight wordlength, and activation wordlength,
  assignable PER NODE (paper Fig. 8 mixed precision). The ``quant``
  backend lowers W≤8 convs to int8 qmatmul launches — int8×int8 when
  ``a_bits ≤ 8`` and a measured ``a_scale`` is attached
  (codegen.calibrate_activation_scales) — and the DSE prices the
  weight/activation streams at each node's own bits. Fused/absorbed
  aliases inherit their host engine's bits (one wordlength per engine).

``PassManager`` deep-copies the input graph before running, so the
parsed source IR is never mutated — compiling a model twice with
different pipelines is safe.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, Protocol, runtime_checkable

from . import check as check_lib
from .ir import Graph, Node
from .quant import QTensor, QuantConfig, quantize

# Activation ops a conv epilogue can absorb (kernels/conv2d.py `_act`).
FUSABLE_ACTS = ("hardswish", "leaky_relu", "silu", "relu", "identity")
# Monotone (non-decreasing) activations: max-pool commutes with these,
# so FuseConvMaxpool may reorder them past the pool bit-exactly.
MONOTONE_ACTS = ("relu", "leaky_relu", "identity")


@runtime_checkable
class Pass(Protocol):
    """A graph-to-graph rewrite. ``run`` may mutate ``graph`` in place
    and must return it; ``stats`` reports what changed (for the
    PassManager log). A pass that can strand nodes/streams should set a
    class attr ``eliminates = True`` — the PassManager then runs
    ``DeadStreamElimination`` automatically right after it.

    Contract attrs (``PassManager(verify_each=True)``): ``preserves``
    names the checker families (``check.CHECKERS`` keys) the pass must
    leave intact — an undeclared pass defaults to ``("structure",)`` —
    and ``establishes`` the families it guarantees clean afterwards.
    The relevant checkers run after each pass, so a regression is
    attributed to the pass that introduced it (SAT050/SAT051) instead
    of surfacing at the end of the pipeline."""
    name: str

    def run(self, graph: Graph) -> Graph: ...


@dataclasses.dataclass
class SubstituteActivation:
    """Rewrite every ``frm`` activation node (and fused conv epilogue)
    to ``to`` — paper §VI's SiLU→HardSwish resource optimisation."""
    frm: str = "silu"
    to: str = "hardswish"
    name: str = "substitute-activation"
    preserves = check_lib.GRAPH_INVARIANTS

    def run(self, graph: Graph) -> Graph:
        n = 0
        for node in graph.nodes.values():
            if node.op == self.frm:
                node.op = self.to
                n += 1
            if node.op == "conv" and node.attrs.get("act") == self.frm:
                node.attrs["act"] = self.to
                n += 1
        self.stats = {"substituted": n}
        return graph


@dataclasses.dataclass
class FuseConvAct:
    """Fuse each conv's single downstream activation into the conv's
    ``act`` attr for execution.

    The activation node is NOT removed: it is tagged ``fused=True`` and
    codegen lowers it to a stream alias, while the DSE continues to cost
    it as a separate hardware block (the paper's resource model).
    """
    name: str = "fuse-conv-act"
    preserves = check_lib.GRAPH_INVARIANTS

    def run(self, graph: Graph) -> Graph:
        n = 0
        for node in graph.nodes.values():
            if node.op != "conv" or node.attrs.get("act", "identity") != "identity":
                continue
            out = graph.streams[node.outputs[0]]
            if len(out.dsts) != 1 or out.name in graph.outputs:
                continue
            consumer = graph.nodes[out.dsts[0]]
            if consumer.op not in FUSABLE_ACTS or consumer.op == "identity":
                continue
            if len(consumer.inputs) != 1 or consumer.attrs.get("fused"):
                continue
            node.attrs["act"] = consumer.op
            consumer.attrs["fused"] = True
            n += 1
        self.stats = {"fused": n}
        return graph


def _single_consumer(graph: Graph, stream: str) -> bool:
    s = graph.streams[stream]
    return len(s.dsts) == 1 and stream not in graph.outputs


def _host_conv(graph: Graph, stream: str) -> Node | None:
    """The conv that materialises ``stream`` through a single-consumer
    chain of fused-activation aliases, or None. Used by FuseConvAdd to
    find the residual add's host engine."""
    if not _single_consumer(graph, stream):
        return None
    src = graph.streams[stream].src
    while src:
        node = graph.nodes[src]
        if node.op == "conv":
            return node
        if not (node.attrs.get("fused") and len(node.inputs) == 1):
            return None
        if not _single_consumer(graph, node.inputs[0]):
            return None
        src = graph.streams[node.inputs[0]].src
    return None


@dataclasses.dataclass
class FuseConvAdd:
    """Absorb a residual ``add`` into the conv that produces one of its
    operands (paper §IV fusion: the skip stream feeds the conv engine's
    epilogue instead of a separate adder block).

    Pattern: ``add(through, skip)`` where ``through`` is produced — via
    a single-consumer chain of fused-activation aliases — by a conv not
    already hosting a residual. Rewrite: the conv gains
    ``fuse_add=True`` and the skip stream as an extra (last) input
    (lowered to the kernels' ``res=`` operand; epilogue order is
    ``act(conv + b) + res``, matching ``add(act(conv), skip)``); the
    add node becomes a ``fused``+``absorbed`` alias of the through
    path — no kernel launch, no pipeline stage, no HBM round-trip.

    Run AFTER FuseConvAct so activation chains are already epilogues.
    """
    name: str = "fuse-conv-add"
    preserves = check_lib.GRAPH_INVARIANTS

    def run(self, graph: Graph) -> Graph:
        n = 0
        for node in graph.nodes.values():
            if node.op != "add" or node.attrs.get("fused"):
                continue
            if len(node.inputs) != 2 or node.inputs[0] == node.inputs[1]:
                continue
            host, through = None, None
            for idx, s in enumerate(node.inputs):
                cand = _host_conv(graph, s)
                if cand is not None and not cand.attrs.get("fuse_add"):
                    host, through = cand, idx
                    break
            if host is None:
                continue
            skip = node.inputs[1 - through]
            host.attrs["fuse_add"] = True
            host.inputs.append(skip)
            graph.streams[skip].dsts.append(host.name)
            if through == 1:                 # normalise: inputs[0] = through
                node.inputs.reverse()
            node.attrs["fused"] = True
            node.attrs["absorbed"] = True
            n += 1
        self.stats = {"fused": n}
        return graph


@dataclasses.dataclass
class ConcatElimination:
    """Eliminate ``concat`` (and optionally ``split``) nodes whose
    consumers can read their operands zero-copy at channel offsets.

    A node qualifies when none of its outputs is a graph output and
    every consumer of every output is either a dense conv (which
    gathers channel windows inside its own kernel — kernels/ops.py) or
    another eliminated plumbing node (nested concat/split chains
    compose). Qualifying nodes are tagged ``fused`` + ``absorbed`` and
    annotated with channel offsets; nothing is removed from the graph,
    so the DSE sees the elimination as absorbed (zero-stage) nodes and
    the buffer allocator sees zero pipeline depth.

    ``split`` is the inverse wiring of ``concat`` and is eliminated by
    the same rule (``include_splits=False`` restricts to concats).
    Declares ``eliminates=True``: the PassManager sweeps dead streams
    right after (a fully-aliased subgraph can strand fan-out copies).
    """
    include_splits: bool = True
    name: str = "concat-elim"
    eliminates = True
    preserves = check_lib.GRAPH_INVARIANTS
    establishes = ("windows",)

    def run(self, graph: Graph) -> Graph:
        kinds = ("concat", "split") if self.include_splits else ("concat",)
        elim: set[str] = set()
        changed = True
        while changed:                       # fixpoint: chains compose
            changed = False
            for node in graph.nodes.values():
                if (node.op not in kinds or node.name in elim
                        or node.attrs.get("fused")):
                    continue
                if any(s in graph.outputs for s in node.outputs):
                    continue
                ok = True
                for s in node.outputs:
                    for d in graph.streams[s].dsts:
                        dst = graph.nodes[d]
                        if dst.op == "conv" and dst.geom("groups") == 1:
                            continue
                        if dst.name in elim:
                            continue
                        if dst.op == "add" and dst.attrs.get("absorbed"):
                            # an absorbed add is a pure alias of its
                            # through path; the stream can only be its
                            # SKIP operand, which the host conv reads
                            # as a channel window (res=)
                            continue
                        ok = False
                if ok:
                    elim.add(node.name)
                    changed = True
        n_cat = n_split = 0
        for name in elim:
            node = graph.nodes[name]
            node.attrs["fused"] = True
            node.attrs["absorbed"] = True
            if node.op == "concat":
                offs, off = [], 0
                for s in node.inputs:
                    offs.append(off)
                    prod = graph.streams[s].src
                    if prod:                 # paper: channel-offset write,
                        # keyed by edge — a producer can feed several
                        # eliminated concats (or one concat through
                        # several of its output streams, e.g. a split's
                        # two halves) at different offsets
                        graph.nodes[prod].attrs.setdefault(
                            "concat_offset", {})[f"{s}->{node.name}"] = off
                    off += graph.streams[s].shape[-1]
                node.attrs["concat_offsets"] = tuple(offs)
                n_cat += 1
            else:
                offs, off = [], 0
                for s in node.outputs:
                    offs.append(off)
                    off += graph.streams[s].shape[-1]
                node.attrs["split_offsets"] = tuple(offs)
                n_split += 1
        self.stats = {"concats": n_cat, "splits": n_split}
        return graph


@dataclasses.dataclass
class FuseConvMaxpool:
    """Reorder a monotone activation past a following maxpool — the
    activation becomes the pool's epilogue and runs on the POOLED
    stream (1/stride² of the elements). ``pool(act(x)) == act(pool(x))``
    bit-exactly for non-decreasing ``act`` (relu / leaky_relu α>0);
    SiLU / HardSwish are not monotone and are skipped.

    Handles both shapes of the chain (run AFTER FuseConvAct):

    * conv with a fused monotone epilogue feeding the pool: the conv
      epilogue reverts to identity and the pool gains the ``act`` attr;
    * a standalone monotone activation node feeding the pool: the node
      becomes a ``fused`` alias and the pool gains the ``act`` attr.

    Either way the (alias) activation node's DSE geometry (H, W) is
    updated to the pool's output dims — the reorder is exactly what the
    paper's resource/latency models should cost.

    A second sweep stamps LAUNCH fusion: every pool reachable from a
    conv through a single-consumer chain of fused aliases gets
    ``pool_fused_host = <conv>`` and the conv ``fuse_pool = <pool>``.
    A backend whose ``fuses_pool(conv_node)`` returns True (the quant
    backend, for dense convs) then runs the pool as the conv kernel's
    epilogue — ONE launch — and codegen lowers the pool node to a
    stream alias. Exact for the monotone epilogue acts this pass
    installs. The pool keeps its own DSE pipeline stage (the FPGA block
    still exists; only the kernel-launch boundary disappears), so
    design_report costing is unchanged.
    """
    name: str = "fuse-conv-maxpool"
    preserves = check_lib.GRAPH_INVARIANTS

    def run(self, graph: Graph) -> Graph:
        n = 0
        for node in graph.nodes.values():
            if node.op != "maxpool" or node.attrs.get("act"):
                continue
            s = graph.streams[node.inputs[0]]
            if len(s.dsts) != 1 or s.name in graph.outputs or not s.src:
                continue
            prod = graph.nodes[s.src]
            act_node = None
            if prod.op in MONOTONE_ACTS and prod.op != "identity" \
                    and len(prod.inputs) == 1 and not prod.attrs.get("fused"):
                act_node, act = prod, prod.op        # standalone act
            elif prod.attrs.get("fused") and prod.op in MONOTONE_ACTS \
                    and prod.op != "identity":
                conv = _host_conv(graph, node.inputs[0])
                if conv is None or conv.attrs.get("fuse_add"):
                    continue                         # res is added post-act;
                                                     # reorder would reorder it
                act_node, act = prod, prod.op
                conv.attrs["act"] = "identity"
            else:
                continue
            act_node.attrs["fused"] = True
            act_node.attrs["pool_reordered"] = True
            # DSE geometry: the activation block now runs post-pool.
            act_node.attrs["H"] = node.geom("H")
            act_node.attrs["W"] = node.geom("W")
            node.attrs["act"] = act
            n += 1
        n_launch = 0
        for node in graph.nodes.values():
            if node.op != "maxpool" or node.attrs.get("pool_fused_host"):
                continue
            conv = _host_conv(graph, node.inputs[0])
            if conv is None or conv.attrs.get("fuse_pool"):
                continue                 # one hosted pool per conv engine
            conv.attrs["fuse_pool"] = node.name
            node.attrs["pool_fused_host"] = conv.name
            n_launch += 1
        self.stats = {"reordered": n, "launch_fused": n_launch}
        return graph


@dataclasses.dataclass
class AssignWordlengths:
    """Annotate every dense conv with its PER-NODE wordlengths
    (paper §IV-A / Fig. 8: wordlength selection is a per-layer design
    axis, not one global W/A pair).

    ``bits`` maps LAUNCH-node names (the nodes codegen actually lowers
    — keying a fused alias or an unknown node is an error) to a
    ``(w_bits, a_bits)`` pair; unlisted dense convs fall back to
    ``default`` (``None`` default = leave them unannotated/float). The
    pass writes, per annotated conv:

    * ``wq`` — the weight-quantization scheme (a
      :class:`~repro_torch.core.quant.QuantConfig` at ``w_bits``, derived
      from ``wq_template``; per-output-channel scales by default — the
      blocked-FP layout whose rowsum-dequant epilogue is exact);
    * ``w_bits`` — the weight wordlength the DSE bandwidth model prices
      (4-bit codes ride int8 storage; 16-bit ride int16);
    * ``a_bits`` — the ACTIVATION wordlength: 16 keeps the float
      (A16-simulated) kernel path, ≤8 selects the int8-activation
      qmatmul lowering once a measured ``a_scale`` is attached
      (``codegen.calibrate_activation_scales`` — calibration is a
      separate, measured step because it needs parameters, which no
      graph pass has).

    Fusion-group sharing rule: a fused/absorbed alias
    (``Graph.alias_groups``) is the same hardware engine as its host,
    so it inherits the host's ``w_bits``/``a_bits`` — one wordlength
    per engine, never one per alias. Grouped convs are skipped (the
    quant backend runs them in float).
    """
    bits: dict | None = None                 # node → (w_bits, a_bits)
    default: tuple[int, int] | None = (8, 16)
    wq_template: QuantConfig = QuantConfig(bits=8,
                                           granularity="per_channel",
                                           axis=-1)
    name: str = "assign-wordlengths"
    preserves = ("structure", "shapes", "windows")
    establishes = ("wordlengths", "alias")

    def run(self, graph: Graph) -> Graph:
        groups = graph.alias_groups()
        targets = {n.name for n in graph.nodes.values()
                   if n.op == "conv" and n.geom("groups") == 1}
        for key in (self.bits or {}):
            if key not in graph.nodes:
                raise ValueError(f"{self.name}: unknown node {key!r}")
            if key not in targets:
                host = groups.get(key)
                raise ValueError(
                    f"{self.name}: {key!r} is not a dense-conv launch "
                    f"node; key the fusion group's host"
                    + (f" ({host!r})" if host else ""))
        n, pairs = 0, set()
        for name in targets:
            node = graph.nodes[name]
            wa = (self.bits or {}).get(name, self.default)
            if wa is None:
                continue
            w_bits, a_bits = int(wa[0]), int(wa[1])
            # W≤4 codes pack two-per-byte (paper Fig. 8's 0.25x weight
            # stream is a STORAGE claim — quant.pack_int4 makes it real).
            node.attrs["wq"] = dataclasses.replace(self.wq_template,
                                                   bits=w_bits,
                                                   pack=(w_bits <= 4))
            node.attrs["w_bits"] = w_bits
            node.attrs["a_bits"] = a_bits
            pairs.add((w_bits, a_bits))
            n += 1
        for alias, host in groups.items():     # one wordlength per engine
            h = graph.nodes[host].attrs
            if "w_bits" in h:
                graph.nodes[alias].attrs["w_bits"] = h["w_bits"]
                graph.nodes[alias].attrs["a_bits"] = h["a_bits"]
        self.stats = {"annotated": n, "mixed": len(pairs) > 1,
                      "wordlengths": sorted(pairs)}
        return graph

    @staticmethod
    def quantize_params(graph: Graph, params: dict) -> dict:
        """Rewrite ``params`` per the graph's ``wq`` annotations:
        annotated convs get integer-code QTensor weights at THEIR bits
        (biases stay float — the paper's W quantization covers filter
        weights only)."""
        out: dict = {}
        for name, p in params.items():
            node = graph.nodes.get(name)
            cfg = node.attrs.get("wq") if node is not None else None
            if cfg is not None and not isinstance(p["w"], QTensor):
                out[name] = {**p, "w": quantize(p["w"], cfg)}
            else:
                out[name] = p
        return out


class QuantizeWeights(AssignWordlengths):
    """Deprecated spelling of :class:`AssignWordlengths`: one uniform
    weight scheme for every dense conv (the pre-mixed-precision
    contract). ``cfg`` becomes the template AND the uniform
    ``(cfg.bits, 16)`` default — same code path, uniform map."""

    def __init__(self, cfg: QuantConfig = QuantConfig(
            bits=8, granularity="per_channel", axis=-1)):
        super().__init__(default=(cfg.bits, 16), wq_template=cfg,
                         name="quantize-weights")
        self.cfg = cfg


@dataclasses.dataclass
class DeadStreamElimination:
    """Remove nodes whose outputs nothing consumes (transitively) and
    the streams they produced."""
    name: str = "dead-stream-elim"
    preserves = check_lib.GRAPH_INVARIANTS

    def run(self, graph: Graph) -> Graph:
        removed = 0
        while True:
            dead = [n for n in graph.nodes.values()
                    if n.outputs and all(
                        not graph.streams[s].dsts and s not in graph.outputs
                        for s in n.outputs)]
            if not dead:
                break
            for node in dead:
                for s in node.inputs:
                    graph.streams[s].dsts.remove(node.name)
                for s in node.outputs:
                    del graph.streams[s]
                del graph.nodes[node.name]
                removed += 1
        # orphan streams: no producer, no consumer, not a graph boundary
        for s in [s for s in graph.streams.values()
                  if not s.src and not s.dsts
                  and s.name not in graph.inputs
                  and s.name not in graph.outputs]:
            del graph.streams[s.name]
            removed += 1
        self.stats = {"removed": removed}
        return graph


@dataclasses.dataclass
class Verify:
    """Full graph design-rule check (``check.check_graph``) as a pass —
    every graph-level family, not just the structural subset
    ``Graph.validate()`` used to assert. Error-severity findings raise
    :class:`~repro_torch.core.check.CheckError` (a ValueError); warnings and
    infos are counted in ``stats`` and left for the design report."""
    name: str = "verify"
    establishes = check_lib.GRAPH_INVARIANTS

    def run(self, graph: Graph) -> Graph:
        res = check_lib.check_graph(graph)
        self.stats = {"findings": len(res.findings),
                      "warnings": len(res.warnings())}
        errs = res.errors()
        if errs:
            raise check_lib.CheckError(
                f"{graph.name}: {len(errs)} design-rule error(s): "
                + "; ".join(str(e) for e in errs[:4]), findings=errs)
        return graph


class PassManager:
    """Run a pass pipeline over a deep copy of the source graph.

    ``history`` records, per pass, the stats it reported — the toolflow
    stores this on the generated ``Accelerator`` for inspection. After
    any pass declaring ``eliminates = True`` a ``DeadStreamElimination``
    sweep runs automatically (logged as ``<pass>:auto-dead-stream-elim``)
    so eliminating rewrites can never leave dangling streams behind —
    ``Graph.validate()`` rejects those outright.

    ``verify_each=True`` turns on pass-contract verification: after
    each pass (and its auto-sweep) the checkers for the families the
    pass declares in ``preserves``/``establishes`` run on the rewritten
    graph. A preserved family that was clean going in and errors coming
    out raises :class:`~repro_torch.core.check.CheckError` with a ``SAT050``
    finding naming the pass; a declared-established family that still
    errors raises with ``SAT051``; a declaration naming an unknown
    family logs a ``SAT052`` warning. Non-fatal contract findings
    accumulate in ``check_log``. Families already broken on the INPUT
    graph are "dirty" and exempt from preservation blame until some
    pass establishes them clean.
    """

    def __init__(self, passes: Iterable[Pass], verify_each: bool = False):
        self.passes: list[Pass] = list(passes)
        self.verify_each = verify_each
        self.history: list[dict] = []
        self.check_log: list[check_lib.Finding] = []

    def run(self, graph: Graph) -> Graph:
        g = copy.deepcopy(graph)
        self.history = []
        self.check_log = []
        self._dirty: set[str] = set()
        if self.verify_each:
            self._dirty = {
                fam for fam in check_lib.GRAPH_INVARIANTS
                if check_lib.run_checkers(g, (fam,)).errors()}
        for p in self.passes:
            g = p.run(g)
            self.history.append({"pass": p.name,
                                 **getattr(p, "stats", {})})
            if getattr(p, "eliminates", False) \
                    and not isinstance(p, DeadStreamElimination):
                sweep = DeadStreamElimination()
                g = sweep.run(g)
                self.history.append(
                    {"pass": f"{p.name}:auto-dead-stream-elim",
                     **sweep.stats})
            if self.verify_each:
                self._verify_contract(p, g)
        return g

    def _verify_contract(self, p: Pass, g: Graph) -> None:
        preserves = tuple(getattr(p, "preserves", ("structure",)))
        establishes = tuple(getattr(p, "establishes", ()))
        for fam in dict.fromkeys((*preserves, *establishes)):
            if fam not in check_lib.CHECKERS:
                self.check_log.append(check_lib.Finding(
                    "SAT052", f"pass {p.name!r} declares unknown "
                    f"invariant family {fam!r}", invariant=fam))
        known_e = [f for f in establishes if f in check_lib.CHECKERS]
        known_p = [f for f in preserves
                   if f in check_lib.CHECKERS and f not in known_e]
        bad: list[check_lib.Finding] = []
        for fam in (*known_e, *known_p):
            errs = check_lib.run_checkers(g, (fam,)).errors()
            if fam in known_e:
                if errs:
                    bad.append(check_lib.Finding(
                        "SAT051", f"pass {p.name!r} declares it "
                        f"establishes {fam!r} but {len(errs)} error(s) "
                        f"remain (first: {errs[0]})", invariant=fam))
                    bad.extend(errs)
                else:
                    self._dirty.discard(fam)
            elif errs and fam not in self._dirty:
                bad.append(check_lib.Finding(
                    "SAT050", f"pass {p.name!r} broke preserved "
                    f"invariant {fam!r} (first: {errs[0]})",
                    invariant=fam))
                bad.extend(errs)
        if bad:
            self.check_log.extend(bad)
            raise check_lib.CheckError(
                f"pass contract violation after {p.name!r}: "
                + "; ".join(str(f) for f in bad
                            if f.code in ("SAT050", "SAT051")),
                findings=bad)


def fusion_pipeline() -> list[Pass]:
    """The hardware-paying fusion passes alone (no activation
    substitution): epilogue fusion, monotone act/pool reorder, residual
    absorption, and zero-copy concat/split plumbing. Semantics
    preserving — the executor output is bit-for-bit comparable (up to
    float reassociation) with the unfused graph's."""
    return [FuseConvAct(), FuseConvMaxpool(), FuseConvAdd(),
            ConcatElimination()]


def default_pipeline(act_substitution: tuple[str, str] | None =
                     ("silu", "hardswish")) -> list[Pass]:
    """The toolflow's standard middle end: the paper's activation
    substitution, then the full fusion pipeline (conv epilogues,
    residual absorption, concat/split elimination, act/pool reorder),
    dead-code cleanup, and a final verification."""
    passes: list[Pass] = []
    if act_substitution is not None:
        passes.append(SubstituteActivation(*act_substitution))
    passes.extend(fusion_pipeline())
    passes.extend([DeadStreamElimination(), Verify()])
    return passes
