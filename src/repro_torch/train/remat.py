"""Algorithm 2 → a selective-checkpoint policy (the port of the JAX
package's ``train/remat.py``, SATAY §IV-C under training).

SATAY decides per skip-connection whether its FIFO lives on-chip or is
spilled to the big/slow tier. Under training the same decision is "is
this edge's activation SAVED for backward (device-resident) or
RECOMPUTED (spilled)": Algorithm 2's ON/OFF assignment compiles into a
``torch.utils.checkpoint`` selective-checkpoint policy over tagged
tensors.

Usage::

    h = checkpoint_name(h, "resid")          # tag edges in the model
    plan = allocate_buffers(graph, budget)   # Algorithm 2
    policy = policy_from_buffer_plan(plan, edge_to_name)
    y = torch.utils.checkpoint.checkpoint(
        f, x, use_reentrant=False, context_fn=context_fn(policy))
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from ..core.buffers import ON, BufferPlan


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` tagged ``name``: an identity on values (a copy, as a custom
    op may not return its input), visible to a selective-checkpoint
    policy as ``torch.ops.repro_torch.checkpoint_name`` with the name
    in its arguments."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(
    lambda ctx, grad: (grad, None),
    setup_context=lambda ctx, inputs, output: None)


def policy_from_buffer_plan(plan: BufferPlan,
                            edge_to_name: dict[str, str]) -> Callable:
    """Selective-checkpoint policy: a tagged activation is saved iff
    Algorithm 2 kept its buffer ON-chip; everything else, OFF tags
    included, is recomputed in backward."""
    saved = frozenset(edge_to_name[e] for e, st in plan.assignment.items()
                      if st == ON and e in edge_to_name)

    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.repro_torch.checkpoint_name.default \
                and args[1] in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    policy.saved = saved
    return policy


def context_fn(policy: Callable) -> Callable:
    """``policy`` as the ``context_fn`` of a non-reentrant
    ``torch.utils.checkpoint.checkpoint``."""
    return functools.partial(create_selective_checkpoint_contexts, policy)


def spill_fraction(plan: BufferPlan) -> float:
    total = plan.onchip_bytes + plan.offchip_bytes
    return plan.offchip_bytes / total if total else 0.0
