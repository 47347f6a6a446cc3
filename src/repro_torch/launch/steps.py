"""Step builders and the shape/sharding stand-ins of every shape cell
(a port of the JAX package's ``launch/steps.py``).

``input_specs(cfg, cell)``, ``param_specs(cfg)`` and
``cache_specs_shapes(cfg, cell)`` return stand-ins on the ``meta``
device — tensors with a shape and a dtype and no storage, the port's
``jax.ShapeDtypeStruct`` — in the port's dtypes (float32 activations
and parameters, int32 tokens). ``param_shardings`` maps them onto a
mesh under a sharding plan (``dist/sharding.py``), ``place_params`` lays
a concrete tree over a mesh's positions. The ``make_*_step`` builders
return the functions a launcher runs; they run eagerly.

A train step's batch leaves are microbatch-shaped (n_mb, mb, ...), as
``data.synthetic.TokenStream`` makes them: each microbatch's gradients
come from ``torch.autograd.grad`` of ``models.lm.loss_fn`` and are
summed in ``accum_dtype`` (float32), then divided by n_mb; the global
norm is clipped to ``clip_norm``; the optimizer runs once; the
parameters are updated in float32 and cast back. Metrics are the means
over the microbatches, plus ``grad_norm`` (before clipping). A train
step over sharded parameters waits for the multi-process slice
(ROADMAP.md §1).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelCfg, ShapeCell
from ..dist import sharding as sharding_lib
from ..models import lm
from ..optim import optimizers as opt_lib
from ..tree import leaves, tree_map, unflatten

F32 = torch.float32
ACT_DTYPE = F32
META = torch.device("meta")


def src_len_for(cfg: ModelCfg, cell: ShapeCell) -> int:
    """Encoder frame count for enc-dec cells (stub frontend)."""
    return min(cell.seq_len, 4096)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelCfg, cell: ShapeCell, param_dtype=ACT_DTYPE,
                n_microbatches: int = 1) -> dict[str, torch.Tensor]:
    """Stand-ins for a shape cell's model inputs (``meta`` tensors).

    Train batches arrive MICROBATCH-SHAPED — (n_mb, B/n_mb, T) — as the
    train step takes them.
    """
    B, T = cell.global_batch, cell.seq_len

    def tr(shape, dtype):       # prepend microbatch dim for train
        return _spec((n_microbatches, shape[0] // n_microbatches)
                     + tuple(shape[1:]), dtype)

    if cell.kind == "train":
        spec = {"tokens": tr((B, T), torch.int32),
                "labels": tr((B, T), torch.int32)}
        if cfg.family == "vlm":
            spec["embeds"] = tr((B, cfg.n_frontend_tokens, cfg.d_model),
                                param_dtype)
        if cfg.is_encdec:
            spec["src_embeds"] = tr((B, src_len_for(cfg, cell),
                                     cfg.d_model), param_dtype)
        return spec
    if cell.kind == "prefill":
        spec = {"tokens": _spec((B, T), torch.int32)}
    else:  # decode: one new token against a seq_len-deep cache
        spec = {"tokens": _spec((B,), torch.int32)}
    if cfg.family == "vlm" and cell.kind != "decode":
        spec["embeds"] = _spec((B, cfg.n_frontend_tokens, cfg.d_model),
                               param_dtype)
    if cfg.is_encdec and cell.kind != "decode":
        spec["src_embeds"] = _spec((B, src_len_for(cfg, cell),
                                    cfg.d_model), param_dtype)
    return spec


def param_specs(cfg: ModelCfg, param_dtype=ACT_DTYPE) -> dict:
    """The parameter tree of ``cfg`` on the ``meta`` device (no
    allocation)."""
    return lm.init_params(cfg, torch.Generator(), device=META,
                          dtype=param_dtype)


def param_shardings(cfg: ModelCfg, mesh, plan=None, param_dtype=ACT_DTYPE):
    """NamedSharding for every parameter leaf under ``plan``.

    The launcher-side wiring of ``dist/sharding.tree_specs``: shapes
    come from ``param_specs`` (no allocation), the plan defaults to the
    family plan (``sharding.plan_for``), and every returned spec is
    divisibility-guarded for ``mesh``.
    """
    plan = plan if plan is not None else sharding_lib.plan_for(cfg)
    return sharding_lib.tree_specs(param_specs(cfg, param_dtype), mesh, plan)


def place_params(params, mesh, plan=None, cfg: ModelCfg | None = None):
    """Lay a CONCRETE parameter tree over ``mesh``'s positions under
    ``plan`` (defaults to ``sharding.plan_for(cfg)``): ``ShardedTensor``
    leaves, one shard for each position."""
    if plan is None:
        if cfg is None:
            raise ValueError("place_params needs a plan or a cfg")
        plan = sharding_lib.plan_for(cfg)
    return sharding_lib.place(params,
                              sharding_lib.tree_specs(params, mesh, plan))


def cache_size_for(cfg: ModelCfg, cell: ShapeCell) -> int:
    """Decode cache depth; prefill must also hold the frontend tokens."""
    extra = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    return cell.seq_len + extra


def cache_specs_shapes(cfg: ModelCfg, cell: ShapeCell, dtype=ACT_DTYPE):
    """The decode cache of a shape cell on the ``meta`` device."""
    src = src_len_for(cfg, cell) if cfg.is_encdec else 0
    return lm.init_cache(cfg, cell.global_batch, cache_size_for(cfg, cell),
                         dtype, device=META, src_len=src)


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


def make_prefill_step(cfg: ModelCfg, cache_size: int):
    """(params, batch) → ``lm.prefill``'s (logits, cache), without grad."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return lm.prefill(params, cfg, batch, cache_size)
    return prefill_step


def make_decode_step(cfg: ModelCfg):
    """(params, tokens, cache) → ``lm.decode_step``'s (logits, cache),
    without grad; the cache is updated in place."""
    def decode_step(params, tokens, cache):
        with torch.no_grad():
            return lm.decode_step(params, cfg, tokens, cache)
    return decode_step
