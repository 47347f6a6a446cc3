"""Plain PyTorch versions of the port's CNN kernels.

The semantic ground truth the CUDA kernels are held against, on the CPU
in the tests and on the card in ``chip_smoke.py``. A port of the CNN
half of the JAX package's ``kernels/ref.py``: NHWC activations, HWIO
``(K, K, C, F)`` weights, float32 arithmetic.

SAME padding is asymmetric, as ``lax`` computes it: the total pad is
``max((out - 1)·s + K - in, 0)``, ``total // 2`` before and the rest
after. ``F.conv2d(padding=...)`` pads symmetrically, so the pads are
applied explicitly with ``F.pad``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# Activations (paper Fig. 7)
# --------------------------------------------------------------------------

def hardswish(x: torch.Tensor) -> torch.Tensor:
    """x · ReLU6(x + 3) / 6 — the paper's SiLU substitute."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def leaky_relu(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form, which ``jax.nn.gelu`` computes by default."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "hardswish": hardswish,
    "leaky_relu": leaky_relu,
    "silu": silu,
    "relu": torch.relu,
    "gelu": gelu,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def activation(name: str):
    """The activation function named ``name``; ``ValueError`` for any
    name outside ``ACTIVATIONS`` (``sigmoid`` included)."""
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; expected one of "
                         f"{sorted(ACTIVATIONS)}") from None


def same_pads(size: int, k: int, stride: int) -> tuple[int, int, int]:
    """(out, pad_before, pad_after) of a SAME-padded window op."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


# --------------------------------------------------------------------------
# Convolution (paper Fig. 3)
# --------------------------------------------------------------------------

def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, act: str = "identity",
           res: torch.Tensor | None = None) -> torch.Tensor:
    """SAME-padded NHWC conv with the fused epilogue
    ``act(conv(x) + b) + res``. x: (N, H, W, C); w: (K, K, C, F)."""
    fn = activation(act)
    K = w.shape[0]
    _, H, W, _ = x.shape
    _, pt, pb = same_pads(H, K, stride)
    _, pl, pr = same_pads(W, K, stride)
    xn = F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (pl, pr, pt, pb))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1).to(torch.float32),
                 stride=stride).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.to(torch.float32)
    y = fn(y)
    if res is not None:
        y = y + res.to(torch.float32)
    return y.to(x.dtype).contiguous()


# --------------------------------------------------------------------------
# Max pooling (paper Fig. 4)
# --------------------------------------------------------------------------

def maxpool2d(x: torch.Tensor, k: int = 2, stride: int | None = None,
              act: str = "identity") -> torch.Tensor:
    """SAME-padded K×K max pool, padding with ``finfo.min``; ``act`` is
    an optional epilogue applied to the pooled value (exact for the
    monotone activations FuseConvMaxpool reorders past the pool)."""
    fn = activation(act)
    stride = stride or k
    _, H, W, _ = x.shape
    _, pt, pb = same_pads(H, k, stride)
    _, pl, pr = same_pads(W, k, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb),
               value=torch.finfo(x.dtype).min)
    y = F.max_pool2d(xn, k, stride).permute(0, 2, 3, 1)
    return fn(y).contiguous()


# --------------------------------------------------------------------------
# Resize (paper Fig. 5)
# --------------------------------------------------------------------------

def resize_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """(N, H, W, C) → (N, sH, sW, C) by row/col duplication."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def pointwise(x: torch.Tensor, act: str) -> torch.Tensor:
    return activation(act)(x)

