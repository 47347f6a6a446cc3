"""Public kernel entry points with backend dispatch (float half of the JAX
package's ``kernels/ops.py``).

Backends (per-call ``backend=``; ``None`` means ``"auto"``):

* ``"ref"``  — the plain PyTorch versions (``kernels/ref.py``) on any
  device: the reference executor the kernels are checked against.
* ``"cuda"`` — the hand-written CUDA kernels; a tensor that is not on a
  CUDA device raises.
* ``"auto"`` — the kernel wrappers, which launch the CUDA kernel on a
  CUDA tensor and run the plain version on a CPU tensor.

Channel windows (the zero-copy operand of an eliminated concat/split,
``core/passes.py:ConcatElimination``): ``x``/``res`` may be a list
``[(tensor, ch_offset, ch_len), ...]`` meaning the channel-wise
concatenation of ``tensor[..., off:off+len]`` slices. As on the JAX
package's Pallas path, the window list is materialised (one
``torch.cat``) before the kernel launches; reading windows inside the
conv kernel is later work. A split output is a view along the last dim
and so not contiguous: it is made contiguous here, never read with the
wrong strides.
"""
from __future__ import annotations

import torch

from . import conv2d as _conv
from . import maxpool as _pool
from . import pointwise as _pw
from . import ref
from . import resize as _resize

_BACKENDS = ("auto", "cuda", "ref")


def _resolve(backend: str | None, x: torch.Tensor) -> str:
    be = backend or "auto"
    if be not in _BACKENDS:
        raise ValueError(f"backend {be!r}: expected one of {_BACKENDS}")
    if be == "cuda" and not x.is_cuda:
        raise ValueError(f"backend 'cuda' given a tensor on {x.device}")
    return be


# --------------------------------------------------------------------------
# channel windows: [(tensor, ch_offset, ch_len), ...] → one stream
# --------------------------------------------------------------------------

def _norm_windows(x) -> list[tuple[torch.Tensor, int, int]]:
    if isinstance(x, (list, tuple)):
        return [(p[0], int(p[1]), int(p[2])) for p in x]
    return [(x, 0, int(x.shape[-1]))]


def _gather(windows) -> torch.Tensor:
    xs = [a if off == 0 and ln == a.shape[-1] else a[..., off:off + ln]
          for a, off, ln in windows]
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)


def channel_concat(x) -> torch.Tensor:
    """Materialise a channel-window list (or a plain list of tensors)."""
    if isinstance(x, (list, tuple)) and x and not isinstance(
            x[0], (list, tuple)):
        x = [(a, 0, a.shape[-1]) for a in x]       # plain tensor list
    return _gather(_norm_windows(x))


def channel_split(x: torch.Tensor, sizes) -> tuple:
    """Split the trailing channel dim into ``sizes`` parts (views)."""
    return torch.split(x, [int(s) for s in sizes], dim=-1)


def _dense(x) -> torch.Tensor:
    """A stream as one contiguous tensor, as the kernels read it."""
    return channel_concat(x).contiguous()


def _first(x) -> torch.Tensor:
    return x[0][0] if isinstance(x, (list, tuple)) else x


# --------------------------------------------------------------------------
# streaming-block entry points
# --------------------------------------------------------------------------

def conv2d(x, w, b=None, *, stride=1, act="identity", res=None,
           backend=None) -> torch.Tensor:
    """``x``/``res``: tensor or channel-window list (module docstring)."""
    be = _resolve(backend, _first(x))
    xd = _dense(x)
    rd = _dense(res) if res is not None else None
    if be == "ref":
        return ref.conv2d(xd, w, b, stride=stride, act=act, res=rd)
    return _conv.conv2d(xd, w, b, stride=stride, act=act, res=rd)


def maxpool2d(x, *, k=2, stride=None, act="identity",
              backend=None) -> torch.Tensor:
    be = _resolve(backend, _first(x))
    xd = _dense(x)
    if be == "ref":
        return ref.maxpool2d(xd, k=k, stride=stride, act=act)
    return _pool.maxpool2d(xd, k=k, stride=stride, act=act)


def resize_nearest(x, *, scale=2, backend=None) -> torch.Tensor:
    be = _resolve(backend, _first(x))
    xd = _dense(x)
    if be == "ref":
        return ref.resize_nearest(xd, scale=scale)
    return _resize.resize_nearest(xd, scale=scale)


def pointwise(x, act="hardswish", *, backend=None) -> torch.Tensor:
    be = _resolve(backend, _first(x))
    xd = _dense(x)
    if be == "ref":
        return ref.pointwise(xd, act)
    return _pw.pointwise(xd, act)
