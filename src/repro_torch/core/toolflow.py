"""The SATAY toolflow (paper §IV) as a pass-based compiler — torch port of
the JAX package's ``core/toolflow.py``.

``compile(model_or_graph, cfg, torch_device=...)`` runs the same stages
on the same IR: rewrite passes (plus ``AssignWordlengths`` for a
quantized design) → wordlength assignment, mixed-precision search and
A≤8 activation calibration → weight quantization → DSE (Algorithm 1) →
buffer plan (Algorithm 2) → design report (with the measured
quantized-vs-float accuracy probe) → design-rule check →
``codegen.generate``. The executor runs eagerly under
``torch.inference_mode()`` on ``torch_device`` (the card unless the
caller names the CPU). ``CompileConfig.device`` stays the FPGA the DSE
targets.

The calibration batch (``_calib_batch``) and the probe's input are drawn
from ``torch.Generator`` seeds 1 and 0, as the JAX package draws them
from ``PRNGKey(1)`` and ``PRNGKey(0)``; the two generators give other
numbers, so the measured scales, deltas and the mixed search's choice
differ from the JAX package's by design (the parity tests hand both
sides the same numpy batch instead).

``compile_model(...)`` survives as the deprecated shim over
:func:`compile`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Sequence

import torch

from . import buffers as buf_lib
from . import check as check_lib
from . import codegen
from . import dse as dse_lib
from . import passes as passes_lib
from .ir import Graph
from .quant import QTensor, QuantConfig, quantize_tree
from ..device import resolve_device
from ..roofline.hw import FpgaDevice, ZCU104


@dataclasses.dataclass(frozen=True)
class CompileConfig:
    """Everything the toolflow needs beyond the model itself: the same
    fields as the JAX package's ``CompileConfig``. ``device`` is the FPGA
    the DSE targets; the torch device is ``compile``'s ``torch_device``.

    ``passes=None`` selects the default pipeline; ``batch_size`` is the
    fixed admission batch the serving layer runs the design at;
    ``replicas``/``slo_ms``/``autoscale``/``min_replicas``/
    ``max_replicas`` are the deployment defaults ``serve.Deployment``
    reads; ``check`` gates the design-rule checker (``"error"`` fails
    compilation, ``"warn"`` records, ``"off"`` skips).
    ``backend="quant"`` runs every dense conv as a quantized matmul at
    the uniform ``(w_bits, a_bits)``; ``bits`` is ``"mixed"`` (the
    per-layer wordlength search under ``accuracy_budget``) or a per-node
    ``{name: (w_bits, a_bits)}`` map, and either selects the quant
    backend."""
    device: FpgaDevice = ZCU104
    w_bits: int = 8
    a_bits: int = 16
    backend: str | None = None
    lam: float = 0.0
    batch_size: int = 1
    act_substitution: tuple[str, str] | None = ("silu", "hardswish")
    passes: Sequence[passes_lib.Pass] | None = None
    weight_bits: int | None = None          # alias for w_bits
    accuracy_probe: bool = True             # quant backend only
    replicas: int = 1                       # serving fan-out default
    slo_ms: float | None = None             # latency SLO for admission
    autoscale: bool = False                 # elastic fleet: queue-driven
    min_replicas: int = 1                   # autoscale lower bound
    max_replicas: int | None = None         # autoscale upper bound
    bits: Any = None                        # None | "mixed" | per-node map
    accuracy_budget: float = 0.02           # mixed: mean-rel delta budget
    calib_frames: int = 2                   # calibration batch size
    search_evals: int | None = None         # mixed: executor-eval cap
    check: str = "error"                    # design-rule check: error/warn/off

    def __post_init__(self):
        if self.weight_bits is not None:
            object.__setattr__(self, "w_bits", self.weight_bits)
        if self.bits is not None and not (
                self.bits == "mixed" or isinstance(self.bits, dict)):
            raise ValueError(f"bits={self.bits!r}: expected 'mixed' or a "
                             f"per-node {{name: (w_bits, a_bits)}} map")
        if self.check not in ("error", "warn", "off"):
            raise ValueError(f"check={self.check!r}: expected 'error' "
                             f"(fail compilation on error findings), "
                             f"'warn' (record only), or 'off'")
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas={self.min_replicas}: "
                             f"an elastic fleet keeps at least one replica")
        if self.max_replicas is not None \
                and self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas={self.max_replicas} < "
                f"min_replicas={self.min_replicas}")

    def execution_backend(self) -> str | None:
        """The executor backend compile() generates for: any wordlength
        request (uniform shim, per-node map, or mixed search) defaults
        to the quantized executor."""
        if self.backend is None and self.bits is not None:
            return "quant"
        return self.backend

    def pipeline(self) -> list[passes_lib.Pass]:
        ps = list(self.passes) if self.passes is not None \
            else passes_lib.default_pipeline(self.act_substitution)
        if any(isinstance(p, passes_lib.AssignWordlengths) for p in ps):
            return ps
        if isinstance(self.bits, dict):
            # explicit per-node map; unlisted convs stay float
            ps.append(passes_lib.AssignWordlengths(bits=dict(self.bits),
                                                   default=None))
        elif self.bits is None and self.execution_backend() == "quant":
            # the uniform shim: ONE (w_bits, a_bits) pair for every
            # dense conv, through the same per-node assignment pass
            ps.append(passes_lib.AssignWordlengths(
                default=(self.w_bits, self.a_bits)))
        return ps


@dataclasses.dataclass
class Accelerator:
    """A generated 'accelerator design' — the toolflow's output artifact.
    ``params`` and the executor live on ``torch_device``."""
    name: str
    graph: Graph                            # rewritten IR (what executes)
    params: dict                            # quantized parameters
    allocation: dse_lib.Allocation          # Algorithm 1 result
    buffer_plan: buf_lib.BufferPlan         # Algorithm 2 result
    device: FpgaDevice
    w_bits: int
    a_bits: int
    report: dict
    forward: Callable                       # eager executor
    torch_device: torch.device
    cfg: CompileConfig | None = None
    pass_log: list = dataclasses.field(default_factory=list)
    model: Any = None                       # source model, if compiled from one
    executor_backend: Any = None            # forward's default lowering table

    def summary(self) -> dict:
        """The design report in the paper's Table III form."""
        return {
            "name": self.name,
            "device": self.device.name,
            "w_bits": self.w_bits, "a_bits": self.a_bits,
            **{k: round(v, 4) if isinstance(v, float) else v
               for k, v in self.report.items()},
            "buffers_offchip": self.buffer_plan.n_offchip,
            "offchip_buffer_bw_gbps":
                round(self.buffer_plan.offchip_bw * 8 / 1e9, 3),
        }


def place(params: dict, device) -> dict:
    """A copy of ``params`` (tensors and QTensors) on ``device``."""
    def move(v):
        if isinstance(v, (torch.Tensor, QTensor)):
            return v.to(device)
        return v
    return {name: {k: move(v) for k, v in p.items()}
            for name, p in params.items()}


def weights_bytes(graph: Graph, w_bits: int) -> int:
    """Packed weight bytes; per-node ``w_bits`` annotations win."""
    return dse_lib.graph_weight_bytes(graph, w_bits)


def sliding_window_bytes(graph: Graph, a_bits: int) -> int:
    """Line-buffer memory: (K−1)·W·C words per window op (paper §III-B),
    each at the node's annotated activation wordlength."""
    total = 0
    for n in graph.nodes.values():
        if n.op in ("conv", "maxpool"):
            K = n.geom("K")
            ab = int(n.attrs.get("a_bits", a_bits))
            total += (K - 1) * n.geom("W_in", n.geom("W")) * n.geom("C") \
                * ab // 8
    return total


def _calib_batch(graph: Graph, frames: int, device) -> torch.Tensor:
    """Deterministic calibration batch matching the graph's input
    geometry — what the activation-range calibration and the
    mixed-precision search measure on. Drawn on the CPU from
    ``torch.Generator`` seed 1, then moved to ``device`` (the JAX
    package draws from ``PRNGKey(1)``: other numbers)."""
    shp = tuple(graph.streams[graph.inputs[0]].shape)
    gen = torch.Generator().manual_seed(1)
    return torch.randn((max(int(frames), 1),) + shp, generator=gen,
                       dtype=torch.float32).to(device)


def compile(model_or_graph, cfg: CompileConfig | None = None, *,
            generator: torch.Generator | None = None,
            params: dict | None = None, torch_device=None) -> Accelerator:
    """Run the toolflow: parse → rewrite passes → DSE → generate.

    ``params`` are unquantized parameters keyed by conv node name (e.g.
    ``convert.params_from_numpy`` of the JAX package's); when omitted
    they are initialised from ``generator`` (seed 0 by default).
    ``torch_device`` defaults to ``cuda:0`` and raises without CUDA."""
    cfg = cfg or CompileConfig()
    dev = resolve_device(torch_device)
    if isinstance(model_or_graph, Graph):
        model, src_graph = None, model_or_graph
    else:
        model, src_graph = model_or_graph, model_or_graph.graph

    # --- rewrite passes (on a copy; the source IR is never mutated) ------
    pm = passes_lib.PassManager(cfg.pipeline(),
                                verify_each=(cfg.check == "error"))
    graph = pm.run(src_graph)

    # --- quantization / wordlength assignment (§IV-A, Fig. 8) ------------
    if params is None:
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        params = codegen.init_params(graph, gen)
    backend = cfg.execution_backend()
    needs_calib = cfg.bits == "mixed" or any(
        int(n.attrs.get("a_bits", 16)) <= 8 for n in graph.nodes.values())
    # the float parameters on the torch device: what calibration, the
    # mixed search and the accuracy probe run, and what gets quantized
    float_params = place(params, dev)
    mixed = chosen = None
    if cfg.bits == "mixed":
        # Greedy per-layer Pareto search on a calibration batch; the
        # chosen assignment is applied to THE graph the DSE and codegen
        # read — what the search measured is exactly what ships.
        calib_x = _calib_batch(graph, cfg.calib_frames, dev)
        mixed = dse_lib.mixed_precision_search(
            graph, float_params, calib_x, max_evals=cfg.search_evals)
        chosen = mixed.select(cfg.accuracy_budget)
        wl = passes_lib.AssignWordlengths(bits=dict(chosen.assignment),
                                          default=None)
        wl.run(graph)
        codegen.calibrate_activation_scales(graph, float_params, calib_x,
                                            ranges=mixed.ranges)
        pm.history.append({"pass": wl.name, **wl.stats})
        if not chosen.assignment:       # budget forced the float design
            # "auto": the kernels on the card, the plain versions only for
            # CPU tensors ("ref" would run them on the card too)
            backend = cfg.backend or "auto"
    elif needs_calib:
        # uniform/explicit A≤8 annotations need measured scales too
        codegen.calibrate_activation_scales(
            graph, float_params,
            _calib_batch(graph, cfg.calib_frames, dev))
    quantized = any("wq" in n.attrs for n in graph.nodes.values())
    if quantized:
        # AssignWordlengths annotated the graph; each node's scheme
        # (per-output-channel scales at ITS bits) is what the quantized
        # matmul's epilogue consumes.
        qparams = passes_lib.AssignWordlengths.quantize_params(
            graph, float_params)
    elif cfg.bits == "mixed":
        # The budget forced the FLOAT baseline: the search measured it
        # on the raw float params (delta 0.0), so ship exactly those.
        qparams = float_params
    else:
        qcfg = QuantConfig(bits=cfg.w_bits, granularity="per_tensor")
        qparams = quantize_tree(float_params, qcfg)

    # --- Algorithm 1: compute allocation (§IV-B) --------------------------
    alloc = dse_lib.allocate_dsp(graph, cfg.device.dsp)
    latency_s = alloc.latency_s(cfg.device.f_clk)

    # Unannotated nodes in a mixed design stream 16-bit float words;
    # uniform designs keep the config default.
    default_w, default_a = (16, 16) if cfg.bits is not None \
        else (cfg.w_bits, cfg.a_bits)

    # --- Algorithm 2: buffer allocation (§IV-C) ---------------------------
    wb = weights_bytes(graph, default_w)
    sw = sliding_window_bytes(graph, default_a)
    avail = max(cfg.device.onchip_bytes - wb - sw, 0)
    node_a_bits = {n.name: int(n.attrs["a_bits"])
                   for n in graph.nodes.values() if "a_bits" in n.attrs}
    plan = buf_lib.allocate_buffers(graph, avail, a_bits=default_a,
                                    latency_s=latency_s, lam=cfg.lam,
                                    node_bits=node_a_bits)

    # --- generation: executor straight from the rewritten IR --------------
    executor = codegen.generate(graph, backend=backend)

    def forward(x: torch.Tensor, backend=None) -> list[torch.Tensor]:
        with torch.inference_mode():
            return executor(qparams, x, backend)

    # --- measured-vs-float accuracy delta (quantized execution) -----------
    accuracy_fn = None
    if quantized and backend == "quant" and cfg.accuracy_probe:
        float_exec = codegen.generate(graph, backend="auto")

        def accuracy_fn() -> dict:
            # probe input from torch.Generator seed 0 (the JAX package:
            # PRNGKey(0), other numbers)
            shp = tuple(graph.streams[graph.inputs[0]].shape)
            gen = torch.Generator().manual_seed(0)
            x = torch.randn((1,) + shp, generator=gen,
                            dtype=torch.float32).to(dev)
            with torch.inference_mode():
                qo = executor(qparams, x)
                fo = float_exec(float_params, x)
            return {
                "quant_max_abs_delta": max(
                    float((a - b).abs().max()) for a, b in zip(qo, fo)),
                # ONE metric implementation: the probe's mean-rel delta
                # IS the mixed-precision search's budget metric.
                "quant_mean_rel_delta": dse_lib.quant_accuracy_delta(
                    qo, fo),
            }

    report = dse_lib.design_report(graph, cfg.device, alloc,
                                   default_w, default_a,
                                   batch_size=cfg.batch_size,
                                   replicas=cfg.replicas,
                                   accuracy_fn=accuracy_fn,
                                   params=qparams)
    if mixed is not None:
        report.update({
            "bits": "mixed",
            "accuracy_budget": cfg.accuracy_budget,
            "mixed_accuracy_delta": chosen.accuracy_delta,
            "mixed_assignment": {n: list(wa) for n, wa in
                                 sorted(chosen.assignment.items())},
            "pareto_front": [p.summary() for p in mixed.front],
            "search_evals": mixed.evals,
        })
    if cfg.slo_ms is not None:
        report["slo_ms"] = cfg.slo_ms
        report["slo_feasible"] = report["batched_latency_ms"] <= cfg.slo_ms
    if cfg.autoscale:
        report["autoscale"] = {
            "min_replicas": cfg.min_replicas,
            "max_replicas": cfg.max_replicas or max(cfg.replicas,
                                                    cfg.min_replicas),
        }
    report.update({
        "weights_bytes": wb,
        "sliding_window_bytes": sw,
        "skip_buffer_onchip_bytes": plan.onchip_bytes,
        "skip_buffer_offchip_bytes": plan.offchip_bytes,
        "onchip_total_bytes": wb + sw + plan.onchip_bytes,
        "onchip_capacity_bytes": cfg.device.onchip_bytes,
        "fits_onchip": wb + sw + plan.onchip_bytes <= cfg.device.onchip_bytes,
    })
    # --- design-rule check: what ships is what was verified ---------------
    if cfg.check != "off":
        check_res = check_lib.check_design(
            graph, plan=plan, alloc=alloc, params=qparams,
            avail_onchip_bytes=avail, default_a_bits=default_a)
        report["check"] = check_res.summary()
        if cfg.check == "error":
            check_res.raise_on_error()
    return Accelerator(
        name=f"{graph.name}@{cfg.device.name}", graph=graph, params=qparams,
        allocation=alloc, buffer_plan=plan, device=cfg.device,
        w_bits=default_w, a_bits=default_a, report=report,
        forward=forward, torch_device=dev, cfg=cfg,
        pass_log=pm.history, model=model, executor_backend=backend)


def compile_model(model, generator: torch.Generator | None = None, *,
                  device: FpgaDevice = ZCU104, w_bits: int = 8,
                  a_bits: int = 16, params: dict | None = None,
                  backend: str | None = None, lam: float = 0.0,
                  torch_device=None) -> Accelerator:
    """Deprecated shim over :func:`compile`, running the DEFAULT
    pipeline (SiLU→HardSwish substitution included)."""
    warnings.warn("compile_model() is deprecated; use "
                  "repro_torch.core.compile(model, CompileConfig(...))",
                  DeprecationWarning, stacklevel=2)
    cfg = CompileConfig(device=device, w_bits=w_bits, a_bits=a_bits,
                        backend=backend, lam=lam)
    return compile(model, cfg, generator=generator, params=params,
                   torch_device=torch_device)
