"""The SATAY toolflow (paper §IV) as a pass-based compiler — torch port of
the JAX package's ``core/toolflow.py`` for the float path.

``compile(model_or_graph, cfg, torch_device=...)`` runs the same stages
on the same IR: rewrite passes → W8 storage quantization → DSE
(Algorithm 1) → buffer plan (Algorithm 2) → design report → design-rule
check → ``codegen.generate``. The executor runs eagerly under
``torch.inference_mode()`` on ``torch_device`` (the card unless the
caller names the CPU). ``CompileConfig.device`` stays the FPGA the DSE
targets.

Not ported yet, and so raising ``NotImplementedError``: the quant
backend (``backend="quant"``, ``bits=``, A<=8 activation calibration)
— the quant slice in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
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

_QUANT_SLICE = ("is not ported yet (ROADMAP.md, modules to port: the "
                "quant backend)")


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
    compilation, ``"warn"`` records, ``"off"`` skips). The quantized
    execution knobs (``backend="quant"``, ``bits``) raise
    ``NotImplementedError`` until the quant slice lands."""
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
        if self.backend == "quant":
            raise NotImplementedError(f"backend='quant' {_QUANT_SLICE}")
        if self.bits is not None:
            raise NotImplementedError(f"bits={self.bits!r} {_QUANT_SLICE}")
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

    def pipeline(self) -> list[passes_lib.Pass]:
        return list(self.passes) if self.passes is not None \
            else passes_lib.default_pipeline(self.act_substitution)


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

    # --- weight quantization (§IV-A): W8 storage, float compute ----------
    if params is None:
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        params = codegen.init_params(graph, gen)
    if any(int(n.attrs.get("a_bits", 16)) <= 8
           for n in graph.nodes.values()):
        raise NotImplementedError(f"A<=8 activation calibration "
                                  f"{_QUANT_SLICE}")
    if any("wq" in n.attrs for n in graph.nodes.values()):
        qparams = passes_lib.AssignWordlengths.quantize_params(graph,
                                                               params)
    else:
        qcfg = QuantConfig(bits=cfg.w_bits, granularity="per_tensor")
        qparams = quantize_tree(params, qcfg)
    qparams = place(qparams, dev)

    # --- Algorithm 1: compute allocation (§IV-B) --------------------------
    alloc = dse_lib.allocate_dsp(graph, cfg.device.dsp)
    latency_s = alloc.latency_s(cfg.device.f_clk)
    default_w, default_a = cfg.w_bits, cfg.a_bits

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
    executor = codegen.generate(graph, backend=cfg.backend)

    def forward(x: torch.Tensor, backend=None) -> list[torch.Tensor]:
        with torch.inference_mode():
            return executor(qparams, x, backend)

    report = dse_lib.design_report(graph, cfg.device, alloc,
                                   default_w, default_a,
                                   batch_size=cfg.batch_size,
                                   replicas=cfg.replicas,
                                   params=qparams)
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
        pass_log=pm.history, model=model)
