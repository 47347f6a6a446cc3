"""Design-space exploration (paper §IV-B).

Implements the paper's analytic latency/resource models and the greedy
DSP-allocation loop (Algorithm 1).

A copy of the JAX package's ``core/dse.py`` (the mixed-precision
search's accuracy metric ``quant_accuracy_delta`` is computed with
torch). Its stage partitioner for the streaming pipeline
(``partition_stages``) is copied verbatim; ``stage_latency`` is the
counterpart of its ``tpu_stage_latency``, on a GPU's peaks.

The DSE is fusion- and batch-aware: nodes ``absorbed`` into a host
engine's epilogue by the fusion passes (core/passes.py — residual adds,
eliminated concat/split plumbing) are not pipeline stages, so a fused
group is costed as ONE stage and contributes no fill depth; and the
steady-state interval is separated from the one-off pipeline fill, so a
``CompileConfig.batch_size``-frame admission batch amortises the fill
(``fill + B·interval`` — paper §IV-B interval vs fill).

Note on Algorithm 1 as printed: the paper's pseudocode updates
``Δ_prev`` under ``if Δ_m < Δ_prev`` and increments ``p_n`` (not
``p_m``) — read literally it never selects the argmax node. The intended
(and here implemented) semantics, per the prose, are: *increase the
parallelism of the node whose increment yields the largest latency
improvement*, stopping when the DSP budget is exhausted or no increment
helps. We also snap conv parallelism to divisors of the channel
dimension, matching a realisable folding.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable

from .ir import Graph, Node
from ..roofline.hw import H100_SXM, FpgaDevice, GpuChip


# --------------------------------------------------------------------------
# Paper-faithful models (FPGA: cycles @ f_clk, DSPs)
# --------------------------------------------------------------------------

def node_latency_cycles(node: Node, p: int) -> float:
    """l(n, p) — paper §IV-B latency model, in cycles."""
    return node.workload / max(p, 1)


def node_dsp(node: Node, p: int) -> int:
    """r_DSP(n, p) — paper §IV-B resource model."""
    if node.op == "conv":
        return node.geom("K") ** 2 * p
    if node.op == "matmul":
        return p
    if node.op == "hardswish":
        return 2 * p
    if node.op in ("leaky_relu", "silu"):
        return p
    return 0


def _stage_nodes(nodes) -> list[Node]:
    """Nodes that ARE a hardware pipeline stage: everything except
    ``absorbed`` aliases (fused residual adds, eliminated concat/split
    plumbing — core/passes.py). Fused activations (FuseConvAct) keep a
    stage/resource entry: the paper's model costs them separately."""
    return [n for n in nodes if not n.attrs.get("absorbed")]


@dataclasses.dataclass
class Allocation:
    """Result of Algorithm 1.

    ``latency_cycles`` is the steady-state initiation INTERVAL (the
    slowest stage: one new frame enters / leaves every interval);
    ``pipeline_depth_cycles`` is the FILL latency (Σ d(n)). A batch of
    B frames streams through in ``fill + B·interval`` cycles — the fill
    is paid once and amortised over the batch (paper §IV-B interval vs
    fill)."""
    parallelism: dict[str, int]
    latency_cycles: float
    pipeline_depth_cycles: int
    dsp_used: int
    trace: list[dict]                       # per-iteration log

    def latency_s(self, f_clk: float) -> float:
        return (self.latency_cycles + self.pipeline_depth_cycles) / f_clk

    def batched_latency_s(self, f_clk: float, batch: int = 1) -> float:
        """Wall-clock for B frames streamed back-to-back: the pipeline
        fills once, then yields one frame per interval."""
        return (self.pipeline_depth_cycles
                + batch * self.latency_cycles) / f_clk


def total_latency_cycles(graph: Graph, p: dict[str, int]) -> float:
    """L(p) = max_n l(n,p) + Σ d(n) (paper §IV-B), over pipeline
    stages (absorbed alias nodes are wiring, not stages)."""
    stages = _stage_nodes(graph.nodes.values())
    worst = max(node_latency_cycles(n, p[n.name]) for n in stages)
    depth = sum(n.pipeline_depth for n in graph.nodes.values())
    return worst + depth


def _candidate_steps(node: Node, p: int) -> int:
    """Next realisable parallelism: divisors of the folding dimension.

    Convs fold over (C, F); window/pointwise/stream ops fold over channel
    AND row (the paper's streaming blocks process multiple words per
    cycle — capping them at C strands the DSP budget on a non-conv
    straggler and was the root cause of an 11–50× latency gap vs the
    paper's Table III in the first implementation)."""
    if node.op in ("conv", "matmul"):
        cmax = node.geom("C") * node.geom("F") if node.op == "conv" else \
            node.geom("N") * node.geom("K")
    else:
        cmax = node.geom("C") * node.geom("W")
    q = p + 1
    while q <= cmax and cmax % q != 0:
        q += 1
    return min(q, cmax)


def allocate_dsp(graph: Graph, budget: int,
                 resource_fn: Callable[[Node, int], int] = node_dsp,
                 max_iters: int = 100_000) -> Allocation:
    """Algorithm 1 — greedy resource allocation.

    Fusion-aware: ``absorbed`` nodes (fused residual adds, eliminated
    concat/split — core/passes.py) are not pipeline stages, so they are
    excluded from the interval max and never widened; a fused group
    costs as ONE stage (its host engine)."""
    p = {n: 1 for n in graph.nodes}
    all_nodes = list(graph.nodes.values())
    nodes = _stage_nodes(all_nodes)
    used = sum(resource_fn(n, p[n.name]) for n in all_nodes)
    depth = sum(n.pipeline_depth for n in all_nodes)
    trace: list[dict] = []
    for it in range(max_iters):
        base = max(node_latency_cycles(n, p[n.name]) for n in nodes)
        best_node, best_delta, best_p, best_cost = None, 0.0, None, 0
        for n in nodes:
            q = _candidate_steps(n, p[n.name])
            if q <= p[n.name]:
                continue
            extra = resource_fn(n, q) - resource_fn(n, p[n.name])
            if used + extra > budget:
                continue
            trial = dict(p)
            trial[n.name] = q
            new = max(node_latency_cycles(m, trial[m.name]) for m in nodes)
            delta = base - new
            # Tie-break on resource cost so cheap nodes are widened first.
            if delta > best_delta or (delta == best_delta and best_node is not None
                                      and extra < best_cost and delta > 0):
                best_node, best_delta, best_p, best_cost = n, delta, q, extra
        if best_node is None or best_delta <= 0:
            # Plateau: several nodes tie at the max, so no SINGLE
            # increment lowers it — but the paper's loop runs "until all
            # DSPs are utilised". Bump the slowest still-improvable node
            # (monotone: latency never increases) and continue.
            tied = sorted(nodes, key=lambda n: -node_latency_cycles(
                n, p[n.name]))
            best_node = None
            for n in tied:
                q = _candidate_steps(n, p[n.name])
                extra = resource_fn(n, q) - resource_fn(n, p[n.name])
                if q > p[n.name] and used + extra <= budget:
                    best_node, best_p, best_delta = n, q, 0.0
                    break
            if best_node is None:
                break                       # budget or folding exhausted
        used += resource_fn(best_node, best_p) - resource_fn(best_node, p[best_node.name])
        p[best_node.name] = best_p
        trace.append({"iter": it, "node": best_node.name, "p": best_p,
                      "latency_cycles": base - best_delta, "dsp_used": used})
    lat = max(node_latency_cycles(n, p[n.name]) for n in nodes)
    return Allocation(parallelism=p, latency_cycles=lat,
                      pipeline_depth_cycles=depth, dsp_used=used, trace=trace)


def stream_a_bits(graph: Graph, stream, default_a_bits: int = 16) -> int:
    """The wordlength a stream travels at: the MAX over its consumers'
    annotated ``a_bits`` (each consumer reads/quantizes its input at
    its own bits; the stream must carry the most demanding one),
    falling back to the design default when no consumer is
    annotated."""
    bits = [int(graph.nodes[d].attrs["a_bits"]) for d in stream.dsts
            if "a_bits" in graph.nodes[d].attrs]
    return max(bits) if bits else default_a_bits


def graph_weight_bytes(graph: Graph, default_w_bits: int = 8) -> int:
    """Packed weight bytes at each node's ANNOTATED wordlength
    (``w_bits`` attr, set by passes.QuantizeWeights), falling back to
    ``default_w_bits`` — the wordlength-aware weight-stream size."""
    bits = sum(n.n_weights * int(n.attrs.get("w_bits", default_w_bits))
               for n in graph.nodes.values())
    return bits // 8


def design_report(graph: Graph, device: FpgaDevice, alloc: Allocation,
                  w_bits: int = 8, a_bits: int = 16,
                  batch_size: int = 1, replicas: int = 1,
                  accuracy_fn: Callable[[], dict] | None = None,
                  params: dict | None = None) -> dict:
    """Throughput/energy style report (paper Table III columns), plus
    the batch-aware streaming terms (paper §IV-B interval vs fill): a
    batch of ``batch_size`` frames pays the pipeline fill once and then
    one interval per frame, so batched fps approaches
    ``f_clk / interval`` as the batch grows.

    Wordlength-aware terms (paper §IV-A: backend/wordlength selection
    is a compilation axis): the weight-stream bandwidth a non-resident
    design would draw per steady-state interval, at the graph's
    annotated ``w_bits`` vs a 16-bit float stream — W8 halves it
    (``weight_bw_vs_w16 = 0.5``) — and the off-chip roofline fps cap
    were weights streamed from DDR every frame. ``accuracy_fn`` is the
    measured-vs-float accuracy delta hook: when given (the toolflow
    wires one up for quantized execution), its dict is merged into the
    report.

    ``params`` (the quantized parameter dict) adds the MEASURED
    weight-stream terms ``weight_stream_bytes_measured`` /
    ``weight_bw_vs_w16_measured``: actual code-storage bytes per conv
    (``QTensor.code_nbytes`` — packed-int4 W4 stores 0.25x the W16
    stream for real, not just analytically), float weights priced at
    their dtype size. The analytic keys are left untouched (they are
    ratchet-pinned).

    ``replicas`` adds the sharded-serving terms: N placed copies of the
    design each drain one admission batch per ``batched_latency``, so
    aggregate throughput scales linearly until the host-side scheduler
    (serve/deployment.py) or the shared DDR runs out — ``sharded_fps``
    is the linear-scaling ceiling the serving benchmark measures
    against.
    """
    lat_s = alloc.latency_s(device.f_clk)
    batched_s = alloc.batched_latency_s(device.f_clk, batch_size)
    interval_s = alloc.latency_cycles / device.f_clk
    gmacs = graph.total_macs()
    weights_bytes = graph_weight_bytes(graph, w_bits)
    weights_bytes_w16 = graph.total_weights() * 2    # 16-bit float stream
    # Per-stream activation pricing: a node's a_bits is the wordlength
    # it READS its input at (the A≤8 lowering quantizes the incoming
    # tile), so a stream travels at the widest of its consumers'
    # annotated bits — mixed assignments price every edge at its own
    # wordlength, not one global pair. The same consumer rule prices
    # the line buffers and skip FIFOs (toolflow), so the capacity check
    # and these bandwidth terms agree.
    act_bytes = sum(
        s.size * stream_a_bits(graph, s, a_bits) // 8
        for s in graph.streams.values())
    wordlengths = {n.name: (int(n.attrs["w_bits"]),
                            int(n.attrs.get("a_bits", a_bits)))
                   for n in graph.nodes.values() if "w_bits" in n.attrs
                   and not n.attrs.get("fused")}
    n_absorbed = sum(1 for n in graph.nodes.values()
                     if n.attrs.get("absorbed"))
    report = {
        "latency_ms": lat_s * 1e3,
        "gops": 2 * gmacs / lat_s / 1e9,
        "gops_per_dsp": 2 * gmacs / lat_s / 1e9 / max(alloc.dsp_used, 1),
        "dsp_used": alloc.dsp_used,
        "dsp_budget": device.dsp,
        "weights_mb": weights_bytes / 2**20,
        "fps": 1.0 / lat_s,
        # --- streaming pipeline terms (batch-aware DSE) -----------------
        "interval_ms": interval_s * 1e3,
        "fill_ms": alloc.pipeline_depth_cycles / device.f_clk * 1e3,
        "batch_size": batch_size,
        "batched_latency_ms": batched_s * 1e3,
        "batched_fps": batch_size / batched_s,
        "nodes_hw": len(graph.nodes) - n_absorbed,
        "nodes_absorbed": n_absorbed,
        # --- sharded serving terms (N placed replicas, data parallel) ---
        "replicas": replicas,
        "sharded_fps": replicas * batch_size / batched_s,
        # --- wordlength-aware bandwidth terms (W8A16 execution) ---------
        "w_bits": w_bits,
        "a_bits": a_bits,
        "wordlengths": wordlengths,
        "weight_stream_bytes": weights_bytes,
        "weight_stream_bytes_w16": weights_bytes_w16,
        "weight_bw_gbps": weights_bytes / interval_s / 1e9,
        "weight_bw_gbps_w16": weights_bytes_w16 / interval_s / 1e9,
        "weight_bw_vs_w16": weights_bytes / max(weights_bytes_w16, 1),
        "act_bw_gbps": act_bytes / interval_s / 1e9,
        "weight_stream_bound_fps": device.ddr_bw / max(weights_bytes, 1),
    }
    if params is not None:
        measured = 0
        for p in params.values():
            w = p.get("w")
            if w is None:
                continue
            measured += int(getattr(w, "code_nbytes", None)
                            or w.numel() * w.element_size())
        report["weight_stream_bytes_measured"] = measured
        report["weight_bw_vs_w16_measured"] = \
            measured / max(weights_bytes_w16, 1)
    if accuracy_fn is not None:
        report.update(accuracy_fn())
    return report


# --------------------------------------------------------------------------
# Mixed-precision DSE (paper §VI Fig. 8): per-layer wordlength search
# --------------------------------------------------------------------------

# The per-node lowering ladder the greedy search walks, most→least
# precise. Each step strictly shrinks the weight stream and/or switches
# the activation contract to int8: (16,16) int16 codes ≈ lossless,
# (8,16) the paper's W8A16 operating point, (8,8) fully int8×int8,
# (4,8) 4-bit codes in int8 storage.
WORDLENGTH_LADDER = ((16, 16), (8, 16), (8, 8), (4, 8))


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One measured design on the accuracy-vs-weight-stream trade
    (one dot of Fig. 8). ``assignment`` maps launch-node names to
    ``(w_bits, a_bits)``; empty = the float design."""
    assignment: dict
    weight_stream_bytes: int
    accuracy_delta: float
    label: str = ""

    def summary(self) -> dict:
        counts: dict[str, int] = {}
        for wa in self.assignment.values():
            key = f"W{wa[0]}A{wa[1]}"
            counts[key] = counts.get(key, 0) + 1
        return {"weight_stream_bytes": self.weight_stream_bytes,
                "accuracy_delta": self.accuracy_delta,
                "label": self.label, "wordlengths": counts}


@dataclasses.dataclass
class MixedPrecisionResult:
    """Output of :func:`mixed_precision_search`: the measured Pareto
    front (bytes strictly decreasing, delta strictly increasing —
    baseline float design first), the full measured trajectory, the
    per-node sensitivities that ordered the walk, the calibration
    ranges, and the executor-eval count."""
    front: list[ParetoPoint]
    trajectory: list[ParetoPoint]
    sensitivity: dict[str, float]
    ranges: dict[str, float]
    evals: int

    def select(self, accuracy_budget: float) -> ParetoPoint:
        """Cheapest front point whose MEASURED delta fits the budget.

        Selection from a fixed front is monotone by construction: a
        tighter budget admits a subset of points, so the chosen design
        can only get more expensive — never cheaper (the property
        tests pin this). The baseline (delta 0) is always eligible for
        any budget ≥ 0."""
        ok = [p for p in self.front if p.accuracy_delta <= accuracy_budget]
        if not ok:
            return self.front[0]         # most-precise fallback
        return min(ok, key=lambda p: p.weight_stream_bytes)


def quant_accuracy_delta(got, want) -> float:
    """The search's default accuracy metric — the same mean-relative
    output delta the toolflow's accuracy probe reports
    (``quant_mean_rel_delta``), max'd over the detect heads."""
    return max(float((a - b).abs().mean() / (b.abs().mean() + 1e-12))
               for a, b in zip(got, want))


def _assignment_bytes(graph: Graph, assignment: dict) -> int:
    """Weight-stream bytes of a candidate assignment; unassigned nodes
    stream 16-bit float words."""
    bits = sum(n.n_weights * int(assignment.get(n.name, (16, 16))[0])
               for n in graph.nodes.values())
    return bits // 8


def _pareto_prune(points: list[ParetoPoint]) -> list[ParetoPoint]:
    front: list[ParetoPoint] = []
    best = float("inf")
    for p in sorted(points, key=lambda p: (p.weight_stream_bytes,
                                           p.accuracy_delta)):
        if p.accuracy_delta < best:
            front.append(p)
            best = p.accuracy_delta
    front.sort(key=lambda p: -p.weight_stream_bytes)
    return front


def mixed_precision_search(graph: Graph, params: dict, calib_x, *,
                           ladder=WORDLENGTH_LADDER,
                           max_evals: int | None = None,
                           backend="quant",
                           metric: Callable = quant_accuracy_delta,
                           ) -> MixedPrecisionResult:
    """Greedy per-layer wordlength search (paper Fig. 8).

    Walks the accuracy-vs-weight-stream trade the way the paper's DSE
    walks its Pareto front: measure each layer's SENSITIVITY (the
    accuracy probe's output delta when only that layer is lowered one
    ladder step, against an all-W16 background), then lower layers one
    ladder step at a time in ascending-sensitivity order, measuring the
    REAL combined delta of every visited design on the calibration
    batch. The search itself is budget-free — it charts the whole
    front (every measured point lands in ``trajectory``; the
    Pareto-pruned subset in ``front``) and ``select(budget)`` picks the
    knee afterwards, which is what makes selection monotone in the
    budget.

    ``max_evals`` caps executor evaluations for big graphs (the walk
    simply stops early — already-measured points stand). Activation
    scales come from one calibration pass (the probe's ranges), so
    every A≤8 trial executes the REAL int8×int8 path, not a simulation.

    ``backend`` is the table the trials run on; the float reference
    outputs and the calibration ranges run on its dispatch (``"auto"``
    for ``"quant"``, the kernels on the card; ``"ref"`` for
    ``QuantBackend(dispatch="ref")``, a search no kernel takes part in).
    """
    import torch

    from . import codegen
    from . import passes as passes_lib

    from .quant import quantize

    work = copy.deepcopy(graph)
    float_table = getattr(codegen.get_backend(backend), "dispatch",
                          None) or "auto"
    with torch.inference_mode():
        ref_out = codegen.generate(work, backend=float_table)(params,
                                                              calib_x)
    ranges = codegen.calibrate_activation_ranges(work, params, calib_x,
                                                 backend=float_table)
    quant_fwd = codegen.generate(work, backend=backend)
    candidates = [n.name for n in work.topo_order()
                  if n.op == "conv" and n.geom("groups") == 1]
    evals = 0
    qcache: dict[tuple, object] = {}     # (node, w_bits) → QTensor: a
    # node revisits each ladder level many times across the walk, and
    # re-quantizing multi-MB filters dominates the search otherwise

    def measure(assignment: dict) -> float:
        nonlocal evals
        for n in work.nodes.values():        # clear stale annotations
            for k in ("wq", "w_bits", "a_bits", "a_scale"):
                n.attrs.pop(k, None)
        passes_lib.AssignWordlengths(bits=dict(assignment),
                                     default=None).run(work)
        codegen.calibrate_activation_scales(work, params, calib_x,
                                            ranges=ranges)
        qparams = {}
        for name, p in params.items():
            node = work.nodes.get(name)
            wq = node.attrs.get("wq") if node is not None else None
            if wq is None:
                qparams[name] = p
                continue
            ck = (name, wq.bits)
            if ck not in qcache:
                qcache[ck] = quantize(p["w"], wq)
            qparams[name] = {**p, "w": qcache[ck]}
        evals += 1
        with torch.inference_mode():
            return metric(quant_fwd(qparams, calib_x), ref_out)

    def budget_left() -> bool:
        return max_evals is None or evals < max_evals

    # --- per-layer sensitivity: one lowering step against W16 ------------
    # At most half of a capped eval budget goes to sensitivity — the
    # walk (which actually charts the front) must always get the rest.
    sens_cap = max_evals // 2 if max_evals is not None else None
    sens: dict[str, float] = {}
    for name in candidates:
        if not budget_left() or (sens_cap is not None
                                 and evals >= sens_cap):
            sens[name] = float("inf")        # unmeasured: walk last
            continue
        trial = {n: ladder[0] for n in candidates}
        trial[name] = ladder[1]
        sens[name] = measure(trial)
    order = sorted(candidates, key=lambda n: (sens[n], n))

    # --- greedy walk: least-sensitive layers drop first ------------------
    trajectory = [ParetoPoint({}, _assignment_bytes(work, {}), 0.0,
                              "float")]
    level = {n: 0 for n in candidates}

    def snapshot(label: str) -> None:
        amap = {n: ladder[i] for n, i in level.items()}
        trajectory.append(ParetoPoint(
            amap, _assignment_bytes(work, amap), measure(amap), label))

    if budget_left():
        snapshot("uniform-W16")
    for step in range(1, len(ladder)):
        for name in order:
            if not budget_left():
                break
            level[name] = step
            snapshot(f"{name}→W{ladder[step][0]}A{ladder[step][1]}")

    return MixedPrecisionResult(front=_pareto_prune(trajectory),
                                trajectory=trajectory,
                                sensitivity=sens, ranges=ranges,
                                evals=evals)


# --------------------------------------------------------------------------
# Stage partitioning for the streaming pipeline
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StagePlan:
    """Assignment of graph nodes to pipeline stages (mesh positions)."""
    boundaries: list[list[str]]      # node names per stage, topo order
    stage_flops: list[int]
    imbalance: float                 # max/mean stage flops

    @property
    def num_stages(self) -> int:
        return len(self.boundaries)


def partition_stages(graph: Graph, num_stages: int,
                     cost: Callable[[Node], float] | None = None) -> StagePlan:
    """Split the (topologically ordered) graph into ``num_stages`` with
    min-max stage cost — the paper's "slowest node dictates latency"
    objective lifted to stage granularity. Exact DP over prefix sums.
    """
    cost = cost or (lambda n: 0.0 if n.attrs.get("absorbed")
                    else float(max(n.macs, n.workload)))
    order = graph.topo_order()
    w = [cost(n) for n in order]
    N = len(order)
    num_stages = min(num_stages, N)
    prefix = [0.0]
    for x in w:
        prefix.append(prefix[-1] + x)

    # dp[k][i] = minimal max-stage-cost splitting first i nodes into k stages
    INF = float("inf")
    dp = [[INF] * (N + 1) for _ in range(num_stages + 1)]
    cut = [[0] * (N + 1) for _ in range(num_stages + 1)]
    dp[0][0] = 0.0
    for k in range(1, num_stages + 1):
        for i in range(k, N + 1):
            # last stage covers (j, i]
            for j in range(k - 1, i):
                c = max(dp[k - 1][j], prefix[i] - prefix[j])
                if c < dp[k][i]:
                    dp[k][i] = c
                    cut[k][i] = j
    bounds: list[list[str]] = []
    i = N
    for k in range(num_stages, 0, -1):
        j = cut[k][i]
        bounds.append([n.name for n in order[j:i]])
        i = j
    bounds.reverse()
    flops = [int(sum(cost(graph.nodes[n]) for n in names)) for names in bounds]
    mean = sum(flops) / max(len(flops), 1)
    return StagePlan(boundaries=bounds, stage_flops=flops,
                     imbalance=max(flops) / max(mean, 1e-9))


def stage_latency(plan: StagePlan, chip: GpuChip = H100_SXM,
                  bytes_per_stage: list[int] | None = None,
                  math: str = "fp32") -> dict:
    """Roofline-term latency of the pipelined design on a GPU (the
    counterpart of the JAX package's ``tpu_stage_latency``).

    The paper's f_clk-cycle model becomes a two-term max(compute, memory)
    per stage; steady-state interval = slowest stage. ``stage_flops``
    counts multiply-accumulates, so a stage does 2× that many FLOPs.
    The default peak is fp32 (67 TFLOP/s on the H100) because the port
    computes every layer to float32 precision: its plain layers are
    float32 GEMMs with TF32 off, which run on the fp32 units, so the
    fp32 peak holds for any stage whatever route its kernels take. A
    caller modelling a tensor-core route names its ``math`` (and counts
    its passes into ``stage_flops``).
    """
    per_stage = []
    for i, f in enumerate(plan.stage_flops):
        t_c = 2 * f / chip.peak(math)
        t_m = (bytes_per_stage[i] / chip.hbm_bw) if bytes_per_stage else 0.0
        per_stage.append(max(t_c, t_m))
    return {
        "interval_s": max(per_stage) if per_stage else 0.0,
        "fill_s": sum(per_stage),
        "stage_s": per_stage,
    }
