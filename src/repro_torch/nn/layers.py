"""Neural-net building blocks over plain nested dicts of tensors.

A torch port of the JAX package's ``nn/layers.py``: modules are
(init, apply) function pairs over nested dicts, so a parameter tree has
the JAX package's paths and a quantized weight (``core.quant.QTensor``)
swaps into any weight leaf. Every init takes an explicit
``torch.Generator`` and a ``lead`` shape: ``lead=(L,)`` makes the
leaves of L layers at once, stacked on axis 0 as the JAX package's
``vmap``-ed init lays them out, with each layer's fan-in that of one
layer. The distributions are the JAX package's (truncated normals at
±2 standard deviations); the numbers are not, as the two generators
differ.

:func:`rmsnorm` runs ``ops.rmsnorm`` on the default backend, so the
RMSNorm kernel (``csrc/rmsnorm.cu``) runs on a CUDA tensor; the JAX
package pins its RMSNorm to the plain version (``backend="ref"``),
which computes the same function.
"""
from __future__ import annotations

import math

import torch

from ..core.quant import QTensor
from ..kernels import ops, ref

Params = dict


# ---------------------------------------------------------------- init utils

def trunc_normal(gen: torch.Generator, shape, std: float = 0.02,
                 device=None, dtype=torch.float32) -> torch.Tensor:
    """Normal(0, std²) truncated to ±2·std, made in place on ``device``
    (``gen`` must be a generator of that device)."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def fan_in_init(gen: torch.Generator, shape, lead=(), device=None,
                dtype=torch.float32) -> torch.Tensor:
    """std = 1/sqrt(fan-in) of ONE ``shape`` (its first axis), made with
    ``lead`` axes in front."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) >= 2 else 1
    return trunc_normal(gen, tuple(lead) + shape,
                        std=1.0 / math.sqrt(max(fan_in, 1)), device=device,
                        dtype=dtype)


# ------------------------------------------------------------------- linear

def linear_init(gen, d_in: int, d_out: int, bias: bool = False, lead=(),
                device=None, dtype=torch.float32) -> Params:
    p = {"w": fan_in_init(gen, (d_in, d_out), lead, device, dtype)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype,
                             device=device)
    return p


def linear(p: Params, x: torch.Tensor, act: str = "identity") -> torch.Tensor:
    """Dense (or quantized) matmul over the last axis. A QTensor weight
    runs ``ops.qmatmul`` (kernel #7 on the card)."""
    w = p["w"]
    b = p.get("b")
    if isinstance(w, QTensor):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        y = ops.qmatmul(x2, w.q, w.scale.reshape(-1), w.zero.reshape(-1),
                        b, act=act)
        return y.reshape(*lead, -1)
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return ref.activation(act)(y) if act != "identity" else y


# ------------------------------------------------------------------- norms

def rmsnorm_init(d: int, lead=(), device=None,
                 dtype=torch.float32) -> Params:
    return {"g": torch.zeros(tuple(lead) + (d,), dtype=dtype,
                             device=device)}        # (1+g) convention


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return ops.rmsnorm(x, p["g"], eps=eps)


def layernorm_init(d: int, lead=(), device=None,
                   dtype=torch.float32) -> Params:
    return {"g": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device),
            "b": torch.zeros(tuple(lead) + (d,), dtype=dtype,
                             device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].to(torch.float32)
            + p["b"].to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------- embeddings

def embed_init(gen, vocab: int, d: int, device=None,
               dtype=torch.float32) -> Params:
    return {"table": trunc_normal(gen, (vocab, d), std=0.02, device=device,
                                  dtype=dtype)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    t = p["table"]
    if isinstance(t, QTensor):
        # int8-resident table: gather codes, dequantize the rows touched
        rows = t.q[ids].to(torch.float32)
        return (rows + t.zero) * t.scale
    return t[ids]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied readout: logits = x @ table.T."""
    t = p["table"]
    if isinstance(t, QTensor):
        xf = x.to(torch.float32)
        y = torch.matmul(xf, t.q.to(torch.float32).T)
        xs = xf.sum(dim=-1, keepdim=True)
        return (y + xs * t.zero) * t.scale
    return torch.matmul(x, t.to(x.dtype).T)


# --------------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float = 10_000.0,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10_000.0) -> tuple:
    """(cos, sin) of the rotary angles, each (..., T, 1, D/2): what
    :func:`apply_rope` multiplies by. The same for every layer and for q
    and k, so a model computes them once per call (eager PyTorch would
    otherwise launch their dozen small kernels twice per layer)."""
    inv = rope_freqs(head_dim, theta, positions.device)        # (D/2,)
    ang = positions[..., None].to(torch.float32) * inv         # (..., T, D/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor | None,
               theta: float = 10_000.0, tables: tuple | None = None
               ) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T), or
    ``tables`` from :func:`rope_tables` for them."""
    cos, sin = tables if tables is not None \
        else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- MLP

def mlp_init(gen, d: int, d_ff: int, gated: bool = True, lead=(),
             device=None, dtype=torch.float32) -> Params:
    p = {"up": linear_init(gen, d, d_ff, lead=lead, device=device,
                           dtype=dtype),
         "down": linear_init(gen, d_ff, d, lead=lead, device=device,
                             dtype=dtype)}
    if gated:
        p["gate"] = linear_init(gen, d, d_ff, lead=lead, device=device,
                                dtype=dtype)
    return p


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU-family if 'gate' present; plain otherwise (``act`` of the
    up projection)."""
    up = linear(p["up"], x)
    fn = ref.activation(act)
    if "gate" in p:
        h = fn(linear(p["gate"], x)) * up
    else:
        h = fn(up)
    return linear(p["down"], h)
