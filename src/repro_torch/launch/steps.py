"""Step builders: ``make_train_step`` and ``make_eval_step`` (a port of
the JAX package's ``launch/steps.py:113-177``).

The JAX package's ``input_specs``, ``param_specs``,
``param_shardings``, ``place_params`` and the cache specs serve its
sharded launchers; they wait for tensor-parallel and sharded training
(ROADMAP.md §1, item 3). The steps here run eagerly on one device.

A train step's batch leaves are microbatch-shaped (n_mb, mb, ...), as
``data.synthetic.TokenStream`` makes them: each microbatch's gradients
come from ``torch.autograd.grad`` of ``models.lm.loss_fn`` and are
summed in ``accum_dtype`` (float32), then divided by n_mb; the global
norm is clipped to ``clip_norm``; the optimizer runs once; the
parameters are updated in float32 and cast back. Metrics are the means
over the microbatches, plus ``grad_norm`` (before clipping).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelCfg
from ..models import lm
from ..optim import optimizers as opt_lib
from ..tree import leaves, tree_map, unflatten

F32 = torch.float32


def grads_of(params: dict, cfg: ModelCfg, mb: dict):
    """(grads, metrics) of ``lm.loss_fn`` on one microbatch; a parameter
    the loss does not reach has a zero gradient, as under JAX."""
    pg = tree_map(lambda p: p.detach().requires_grad_(True), params)
    _, metrics = lm.loss_fn(pg, cfg, mb)
    flat = leaves(pg)
    got = torch.autograd.grad(metrics["loss"], flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, got)]
    return unflatten(pg, grads), {k: v.detach() for k, v in metrics.items()}


def accumulate_grads(params: dict, cfg: ModelCfg, batch: dict,
                     n_microbatches: int = 1, accum_dtype=F32):
    """The float32 gradients and the metrics of a microbatch-shaped
    ``batch``: one microbatch's as they are; over several, the sum in
    ``accum_dtype`` divided by their count, and the metrics' means."""
    if n_microbatches == 1:
        grads, metrics = grads_of(params, cfg,
                                  {k: v[0] for k, v in batch.items()})
        return tree_map(lambda g: g.to(F32), grads), metrics
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                         device=p.device), params)
    ms = []
    for i in range(n_microbatches):
        g, m = grads_of(params, cfg, {k: v[i] for k, v in batch.items()})
        tree_map(lambda a, b: a.add_(b.to(accum_dtype)), acc, g)
        del g
        ms.append(m)
    grads = tree_map(lambda a: a.to(F32) / n_microbatches, acc)
    metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
               for k in ms[0]}
    return grads, metrics


def apply_optimizer(optimizer: opt_lib.Optimizer, grads, opt_state,
                    params, step, clip_norm: float):
    """Clip ``grads`` to ``clip_norm``, run ``optimizer`` once and add its
    updates to ``params`` in float32. Returns (new params, new state,
    the global norm before clipping)."""
    grads, gnorm = opt_lib.clip_by_global_norm(grads, clip_norm)
    updates, new_state = optimizer.update(grads, opt_state, params, step)
    del grads
    new_params = tree_map(
        lambda p, u: (p.to(F32) + u.to(F32)).to(p.dtype), params, updates)
    return new_params, new_state, gnorm


def make_train_step(cfg: ModelCfg, optimizer: opt_lib.Optimizer,
                    n_microbatches: int = 1, clip_norm: float = 1.0,
                    accum_dtype=F32):
    """(params, opt_state, step, batch) → (params, opt_state, metrics),
    new trees; the arguments are left as they were (so a failed step can
    be retried from them)."""
    def train_step(params, opt_state, step, batch):
        grads, metrics = accumulate_grads(params, cfg, batch,
                                          n_microbatches, accum_dtype)
        new_params, new_state, gnorm = apply_optimizer(
            optimizer, grads, opt_state, params, step, clip_norm)
        return new_params, new_state, dict(metrics, grad_norm=gnorm)

    return train_step


def make_eval_step(cfg: ModelCfg):
    """(params, batch) → metrics of ``lm.loss_fn``, without grad."""
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = lm.loss_fn(params, cfg, batch)
        return metrics
    return eval_step
