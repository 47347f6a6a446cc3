"""Skip-connection buffer allocation — paper §IV-C, Algorithm 2.

SATAY's insight: YOLO's long multi-scale skip connections need FIFOs
deep enough to absorb the pipeline-depth mismatch between reconvergent
paths; the *largest* ones should live in the big-but-slower memory tier
(FPGA: DDR via a DMA-chunked "software FIFO"). The allocation objective
(paper Eq. 4–5 + objective) is: minimise off-chip bandwidth plus
λ·(number of off-chip buffers) subject to the on-chip memory budget.

A copy of the JAX package's ``core/buffers.py`` planner. Its
``SoftwareFifo`` (a JAX pytree used by the training path) is not part
of this package yet.
"""
from __future__ import annotations

import dataclasses

from .ir import Graph, SkipBuffer


ON, OFF = "ON", "OFF"


@dataclasses.dataclass
class BufferPlan:
    assignment: dict[str, str]          # edge name -> ON / OFF
    onchip_bytes: int
    offchip_bytes: int
    offchip_bw: float                   # bytes/s, paper Eq. 4 summed
    n_offchip: int
    trace: list[dict]
    depths: dict[str, int] = dataclasses.field(default_factory=dict)
    bits: dict[str, int] = dataclasses.field(default_factory=dict)

    def is_on(self, edge: str) -> bool:
        return self.assignment.get(edge, ON) == ON


def buffer_bandwidth(buf: SkipBuffer, a_bits: int, latency_s: float) -> float:
    """Paper Eq. 4: b = 2 · S_{n,m} · w_a / L (read + write per frame)."""
    return 2.0 * buf.stream_size * (a_bits / 8) / max(latency_s, 1e-12)


def allocate_buffers(graph: Graph, avail_bytes: int, a_bits: int = 16,
                     latency_s: float = 1e-2, lam: float = 0.0,
                     max_offchip: int | None = None,
                     node_bits: dict[str, int] | None = None) -> BufferPlan:
    """Algorithm 2 — largest-first spill until the budget is met.

    ``lam`` implements the paper's λ regulariser: with λ>0 we stop
    spilling as soon as the budget is met (fewer DMAs); the sort order
    (largest first) already minimises the count for a given byte target.

    ``node_bits`` prices each FIFO at its CONSUMER's activation
    wordlength (``{node: a_bits}`` from the per-layer assignment —
    a buffer feeding an A8 engine holds 8-bit words), falling back to
    the design-wide ``a_bits``; the toolflow passes the graph's
    annotations so the capacity check agrees with the DSE report.
    """
    node_bits = node_bits or {}

    def bits_of(b: SkipBuffer) -> int:
        return int(node_bits.get(b.dst, a_bits))

    bufs = graph.skip_buffers()           # sorted largest-first
    assignment = {b.edge: ON for b in bufs}
    trace: list[dict] = []

    def onchip_total() -> int:
        return sum(b.bytes_at(bits_of(b)) for b in bufs
                   if assignment[b.edge] == ON)

    n_off = 0
    for b in bufs:
        if onchip_total() <= avail_bytes:
            break                           # Allocation complete (paper)
        if max_offchip is not None and n_off >= max_offchip:
            break
        assignment[b.edge] = OFF
        n_off += 1
        trace.append({
            "edge": b.edge, "depth_words": b.depth_words,
            "onchip_after": onchip_total(),
            "bw_added": buffer_bandwidth(b, bits_of(b), latency_s),
        })

    on_bytes = onchip_total()
    off_bytes = sum(b.bytes_at(bits_of(b)) for b in bufs
                    if assignment[b.edge] == OFF)
    off_bw = sum(buffer_bandwidth(b, bits_of(b), latency_s)
                 for b in bufs if assignment[b.edge] == OFF)
    return BufferPlan(assignment=assignment, onchip_bytes=on_bytes,
                      offchip_bytes=off_bytes, offchip_bw=off_bw,
                      n_offchip=n_off, trace=trace,
                      depths={b.edge: b.depth_words for b in bufs},
                      bits={b.edge: bits_of(b) for b in bufs})
