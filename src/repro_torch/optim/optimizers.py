"""Optimizers, from scratch (a port of the JAX package's
``optim/optimizers.py``).

``int8_adamw`` is the beyond-paper extension of SATAY's blocked-FP
quantization (core/quant.py) applied to optimizer state: both Adam
moments are stored as int8 codes + per-block f32 scales (block = last
axis, group 128), cutting optimizer memory from 8 to ~2.06 bytes/param.

States are nested dicts of plain tensors with the JAX package's layout
and leaf names (sgd ``{"mu"}``, adamw ``{"m", "v"}``, adafactor
``{"f": {... {"vr", "vc"} | {"v"}}}``, int8_adamw ``{"m", "v"}`` of
per-leaf ``{"q", "s"}``), so a checkpoint crosses between the packages.
Updates are pure functions: they return new tensors and leave their
arguments as they were. The arithmetic is the JAX package's, in float32:
``step`` becomes a float32 tensor, and so does ``b1 ** t``; it runs one
parameter leaf at a time (the same operations on each element as the
JAX package's whole-tree maps, with one leaf's temporaries alive at a
time). This is elementwise tensor code, XLA code in the JAX package, and
no kernel port.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..tree import leaves, tree_map

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    name: str = "opt"


def _step_f32(step, like: torch.Tensor) -> torch.Tensor:
    """``step`` (int or tensor) as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(step, device=like.device).to(F32)


def _first(tree) -> torch.Tensor:
    return leaves(tree)[0]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), n


# ---------------------------------------------------------------- schedules

def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


# --------------------------------------------------------------------- sgd

def sgd(lr=1e-2, momentum: float = 0.9) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        lr_t = lr_fn(_step_f32(step, _first(params)))
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        upd = tree_map(lambda m: -lr_t * m, mu)
        return upd, {"mu": mu}

    return Optimizer(init, update, "sgd")


# ------------------------------------------------------------------- adamw

def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                    device=p.device),
                              params),
                "v": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                    device=p.device),
                              params)}

    def update(grads, state, params, step):
        step = _step_f32(step, _first(params))
        t = step + 1.0
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        lr_t = lr_fn(step)

        def per_leaf(g, m_, v_, p):
            g = g.to(F32)
            m = b1 * m_ + (1 - b1) * g
            v = b2 * v_ + (1 - b2) * torch.square(g)
            u = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay \
                * p.to(F32)
            return (-lr_t * u).to(p.dtype), m, v

        outs = tree_map(per_leaf, grads, state["m"], state["v"], params)
        return _split3(outs, grads)

    return Optimizer(init, update, "adamw")


def _split3(outs, like):
    """A tree of 3-tuples (shaped as ``like``) → (updates, {"m", "v"})."""
    def part(i):
        return tree_map(lambda _, o: o[i], like, outs)
    return part(0), {"m": part(1), "v": part(2)}


# --------------------------------------------------------------- adafactor

def adafactor(lr=1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moment (Shazeer & Stern) — O(n+m) state for (n,m)
    matrices; the frugal choice for 100B+ dense stacks."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def per_leaf(p):
            kw = dict(dtype=F32, device=p.device)
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **kw),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **kw)}
            return {"v": torch.zeros(p.shape, **kw)}
        return {"f": tree_map(per_leaf, params)}

    def update(grads, state, params, step):
        step = _step_f32(step, _first(params))
        t = step + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def per_leaf(g, s, p):
            g = g.to(F32)
            g2 = torch.square(g) + eps
            if p.ndim >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                     min=eps)
                u = g / (torch.sqrt(r)[..., None]
                         * torch.sqrt(vc)[..., None, :] + eps)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / (torch.sqrt(v) + eps)
                ns = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (-lr_t * u).to(p.dtype), ns

        # a state leaf is a dict below the parameter's place in the tree
        outs = tree_map(lambda g, p, s: per_leaf(g, s, p), grads, params,
                        state["f"])
        return (tree_map(lambda _, o: o[0], grads, outs),
                {"f": tree_map(lambda _, o: o[1], grads, outs)})

    return Optimizer(init, update, "adafactor")


# ------------------------------------------------------------- int8 adamw

_QBLOCK = 128


def _qgroup(shape) -> int:
    last = shape[-1] if shape else 1
    return _QBLOCK if last % _QBLOCK == 0 else last


def _q8(x: torch.Tensor):
    """Blocked symmetric int8 quantization of a moment tensor (SATAY
    Eq. 2, symmetric, groups along the last axis). SHAPE-PRESERVING:
    codes keep the param's shape. ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    x = x.to(F32)
    g = _qgroup(x.shape)
    lead = tuple(x.shape[:-1]) + (x.shape[-1] // g, g)
    xg = x.reshape(lead)
    amax = torch.amax(torch.abs(xg), dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xg / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale[..., 0].to(F32)


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape, n: int = 0):
    shape = tuple(shape)
    g = _qgroup(shape)
    lead = shape[:-1] + (shape[-1] // g, g)
    return (q.reshape(lead).to(F32) * scale[..., None]).reshape(shape)


def int8_adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
               weight_decay=0.1) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def z(p):
            q, s = _q8(torch.zeros(p.shape, dtype=F32, device=p.device))
            return {"q": q, "s": s}
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        step = _step_f32(step, _first(params))
        t = step + 1.0
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        lr_t = lr_fn(step)

        def _slice_math(g, mq, msc, vq, vsc, p):
            g = g.to(F32)
            m = b1 * _dq8(mq, msc, p.shape) + (1 - b1) * g
            # v floor: a second-moment coordinate quantized to code 0
            # really lies in [0, scale/2); treating it as 0 makes
            # m/√v explode (m decays slowly, v forgets instantly).
            # Reconstruct zero-codes at scale/4 — bounds the step
            # inflation at ~2× instead of 1/eps.
            vdq = _dq8(vq, vsc, p.shape)
            g_ = _qgroup(p.shape)
            floor = torch.repeat_interleave(vsc / 4.0, g_,
                                            dim=-1).reshape(p.shape)
            vdq = torch.where(vdq <= 0.0, floor, vdq)
            v = b2 * vdq + (1 - b2) * torch.square(g)
            mh = m / c1
            vh = v / c2
            u = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(F32)
            mq2, ms2 = _q8(m)
            vq2, vs2 = _q8(v)
            return (-lr_t * u).to(p.dtype), mq2, ms2, vq2, vs2

        def per_leaf(g, p, ms, vs):
            args = (g, ms["q"], ms["s"], vs["q"], vs["s"], p)
            if p.ndim >= 3 and p.shape[0] >= 8:
                # one layer slice at a time bounds the f32 dequant
                # temporaries (the JAX package's lax.map)
                outs = [_slice_math(*(a[i] for a in args))
                        for i in range(p.shape[0])]
                upd, mq2, ms2, vq2, vs2 = (torch.stack(c)
                                           for c in zip(*outs))
            else:
                upd, mq2, ms2, vq2, vs2 = _slice_math(*args)
            return upd, {"q": mq2, "s": ms2}, {"q": vq2, "s": vs2}

        outs = tree_map(per_leaf, grads, params, state["m"], state["v"])
        return _split3(outs, grads)

    return Optimizer(init, update, "int8_adamw")


OPTIMIZERS = {"sgd": sgd, "adamw": adamw, "adafactor": adafactor,
              "int8_adamw": int8_adamw}


def get(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)
