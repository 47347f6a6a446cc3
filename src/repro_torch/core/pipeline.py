"""Streaming pipeline executor — SATAY's architecture over a mesh's
positions.

The paper's accelerator is a chain of dedicated per-node hardware blocks
with data streamed through (§III-A). The equivalent here, a port of the
JAX package's ``core/pipeline.py``: the model's layer stack is
partitioned into S stages (boundaries from the DSE stage partitioner,
core/dse.partition_stages), stage s pinned to position s of a mesh's
``stage`` axis, and microbatches streamed stage to stage — the
ready/valid handshake becomes the JAX package's static GPipe schedule
(n_micro + S − 1 ticks; on tick t stage 0 takes microbatch t, every
other stage the buffer its predecessor sent on tick t − 1, and the last
stage banks microbatch t − S + 1).

The JAX package runs every stage on every tick (garbage during fill and
drain) under ``shard_map``. This port runs one process over the
positions and SKIPS a stage on a tick where it holds no microbatch: each
stage runs exactly n_micro times, so a pipelined call launches the same
kernels as the sequential layer loop. Each stage-to-stage send is one
``collective-permute`` labelled for ``roofline.trace`` with the buffer's
bytes; the banked outputs reach position 0 in one transfer labelled
``all-reduce`` with their bytes, the counterpart of the JAX package's
closing ``psum`` over the stage axis. Positions may name one device.

Latency follows the paper's model exactly: steady-state interval =
slowest stage; fill latency = Σ stage times (the "pipeline depth" term
d(n)). Correctness is pinned by tests/test_torch_pipeline.py: pipelined
execution ≡ sequential layer stack.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..launch.mesh import Mesh
from ..roofline import trace
from ..tree import tree_map


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def stage_devices(mesh: Mesh, axis: str = "stage") -> list[torch.device]:
    """The device of each stage: the positions along ``axis`` whose
    coordinate on every other axis is 0."""
    k = mesh.axis_names.index(axis)
    return list(np.moveaxis(mesh.devices, k, 0).reshape(
        mesh.shape[axis], -1)[:, 0])


def pipeline_infer(stage_fn: Callable, params_stacked, x_micro,
                   mesh: Mesh, axis: str = "stage"):
    """Run microbatches through a pipelined layer stack.

    stage_fn(stage_params, x) -> y   (same shape in/out)
    params_stacked: tree with leading axis == n_stages
    x_micro: (n_micro, mb, ...) microbatched inputs
    Returns (n_micro, mb, ...) outputs on position 0's device.
    """
    devs = stage_devices(mesh, axis)
    n_stages, n_micro = len(devs), x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    # stage s's parameters on its position (views where already there)
    params = [tree_map(lambda a, s=s: a[s].to(devs[s]), params_stacked)
              for s in range(n_stages)]
    outs = None
    held: list = [None] * n_stages     # the microbatch each stage holds
    for t in range(ticks):
        if t < n_micro:                 # stage 0 injects microbatch t
            held[0] = x_micro[t].to(devs[0])
        sent: list = [None] * n_stages
        for s in range(n_stages):
            if held[s] is None:
                continue                # idle during fill and drain
            y = stage_fn(params[s], held[s])
            if s == n_stages - 1:       # banks microbatch t - S + 1
                if outs is None:
                    outs = torch.empty((n_micro,) + tuple(y.shape),
                                       dtype=y.dtype, device=y.device)
                outs[t - n_stages + 1] = y
            else:                       # stream to the next stage
                with trace.transfer("collective-permute", _nbytes(y)):
                    sent[s + 1] = y.to(devs[s + 1])
        held = sent
    with trace.transfer("all-reduce", _nbytes(outs)):
        return outs.to(devs[0])


def stack_stages(layer_params, boundaries: list[list[str]] | int,
                 n_layers: int):
    """Regroup stacked per-layer params (L, ...) into (S, L/S, ...).

    With DSE boundaries, homogeneous-cost layers give equal splits; the
    function asserts the plan is uniform (transformer stacks are)."""
    if isinstance(boundaries, int):
        n_stages = boundaries
    else:
        sizes = {len(b) for b in boundaries}
        assert len(sizes) == 1, f"non-uniform stage plan {sizes}"
        n_stages = len(boundaries)
    per = n_layers // n_stages
    assert per * n_stages == n_layers, (n_layers, n_stages)
    return tree_map(
        lambda a: a.reshape((n_stages, per) + tuple(a.shape[1:])),
        layer_params)


def pipeline_latency_model(stage_costs_s: list[float],
                           n_micro: int) -> dict:
    """Paper §IV-B latency model at stage granularity."""
    interval = max(stage_costs_s)
    fill = sum(stage_costs_s)
    return {
        "interval_s": interval,
        "fill_s": fill,
        "total_s": fill + (n_micro - 1) * interval,
        "bubble_frac": (len(stage_costs_s) - 1)
        / (n_micro + len(stage_costs_s) - 1),
    }
