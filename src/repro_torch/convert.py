"""Parameters from numpy: the bridge that lets one set of weights drive
both the JAX package and the port.

The JAX and torch generators give different numbers from one seed, so
the parity tests make parameters once (with numpy, or with the JAX
package's ``init_params``), hand them over as numpy arrays, and convert
them here. A quantized weight is read by duck typing on
``q/scale/zero/bits/shape/packed``; the JAX class is never imported.
Like the port's other entry points, both functions put the tensors on
the card unless ``device`` names another (``device="cpu"`` on a machine
without one), and raise without CUDA (``device.resolve_device``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.quant import QTensor
from .device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _is_qtensor(v) -> bool:
    return all(hasattr(v, k) for k in ("q", "scale", "zero", "bits",
                                       "shape", "packed"))


def _leaf(v, device):
    if _is_qtensor(v):
        return QTensor(q=_tensor(v.q, device), scale=_tensor(v.scale, device),
                       zero=_tensor(v.zero, device), bits=int(v.bits),
                       shape=tuple(int(d) for d in v.shape),
                       packed=bool(v.packed))
    return _tensor(v, device)


def _lm_tree(params, device: torch.device):
    if isinstance(params, dict):
        return {k: _lm_tree(v, device) for k, v in params.items()}
    return _leaf(params, device)


def lm_params_from_numpy(params: dict, device=None) -> dict:
    """A JAX LM parameter tree (nested dicts of arrays and QTensor-likes,
    layers stacked on axis 0) → the same tree of tensors and
    :class:`~repro_torch.core.quant.QTensor`\\ s on ``device`` (``None``:
    ``cuda:0``, raising without CUDA)."""
    return _lm_tree(params, resolve_device(device))


def params_from_numpy(params: dict, device=None) -> dict:
    """``{node: {"w": ndarray | QTensor-like, "b": ndarray}}`` → the
    port's params on ``device`` (``None``: ``cuda:0``, raising without
    CUDA): arrays become tensors of the same dtype and QTensor-likes
    become :class:`~repro_torch.core.quant.QTensor`\\ s with the same
    codes, scales and layout."""
    device = resolve_device(device)
    return {name: {k: _leaf(v, device) for k, v in p.items()}
            for name, p in params.items()}
