"""Parameters from numpy: the bridge that lets one set of weights drive
both the JAX package and the port.

The JAX and torch generators give different numbers from one seed, so
the parity tests make parameters once (with numpy, or with the JAX
package's ``init_params``), hand them over as numpy arrays, and convert
them here. A quantized weight is read by duck typing on
``q/scale/zero/bits/shape/packed``; the JAX class is never imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.quant import QTensor


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _is_qtensor(v) -> bool:
    return all(hasattr(v, k) for k in ("q", "scale", "zero", "bits",
                                       "shape", "packed"))


def params_from_numpy(params: dict, device="cpu") -> dict:
    """``{node: {"w": ndarray | QTensor-like, "b": ndarray}}`` → the
    port's params on ``device``: arrays become tensors of the same dtype
    and QTensor-likes become :class:`~repro_torch.core.quant.QTensor`\\ s
    with the same codes, scales and layout."""
    out: dict = {}
    for name, p in params.items():
        conv: dict = {}
        for k, v in p.items():
            if _is_qtensor(v):
                conv[k] = QTensor(q=_tensor(v.q, device),
                                  scale=_tensor(v.scale, device),
                                  zero=_tensor(v.zero, device),
                                  bits=int(v.bits),
                                  shape=tuple(int(d) for d in v.shape),
                                  packed=bool(v.packed))
            else:
                conv[k] = _tensor(v, device)
        out[name] = conv
    return out
