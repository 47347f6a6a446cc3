"""Public kernel entry points with backend dispatch (a port of the JAX
package's ``kernels/ops.py``: the CNN, quantized and LM kernels).

Backends (per-call ``backend=``; ``None`` means the default,
``"auto"`` unless :func:`set_default_backend` says otherwise):

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

Quantized convs (``qconv2d``, ``qconv2d_a8``) are ONE quantized matmul
launch each over an im2col of the input (``_im2col``, plain PyTorch, as
the JAX package computes it outside any Pallas kernel), with dequant,
bias, ``act`` and ``res`` in the kernel's epilogue; a fused maxpool
(``pool=``) launches the maxpool kernel right after, as the Pallas path
does (``ops.py:318-331``).

``ssd_scan`` returns ``(y, final_state)`` on every backend. The JAX
package's ``ops.ssd_scan(backend="ref")`` returns ``(y, None)``
(``src/repro/kernels/ops.py:511-518``); the port's prefill needs the
state, and its plain version (``ref.ssd_chunked``) computes it. This is
an interface difference, not a difference of result.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import attention as _attn
from . import autograd as _grad
from . import conv2d as _conv
from . import decode_attention as _dec
from . import maxpool as _pool
from . import pointwise as _pw
from . import qmatmul as _qmm
from . import ref
from . import resize as _resize
from . import ssd_scan as _ssd

_BACKENDS = ("auto", "cuda", "ref")
_DEFAULT = "auto"


def set_default_backend(name: str) -> None:
    """The backend a call takes when it names none (``backend=None``),
    as the JAX package's ``ops.set_default_backend``; ``"auto"`` at
    import. The LM stack names none, so ``"ref"`` runs it on the plain
    versions, on any device."""
    global _DEFAULT
    if name not in _BACKENDS:
        raise ValueError(f"backend {name!r}: expected one of {_BACKENDS}")
    _DEFAULT = name


def _resolve(backend: str | None, x: torch.Tensor) -> str:
    be = backend or _DEFAULT
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

def conv2d(x, w, b=None, *, stride=1, act="identity", res=None, pool=None,
           backend=None) -> torch.Tensor:
    """``x``/``res``: tensor or channel-window list (module docstring).
    ``pool``: optional static ``(k, stride, act)`` fused maxpool, run by
    the maxpool kernel right after the conv."""
    be = _resolve(backend, _first(x))
    xd = _dense(x)
    rd = _dense(res) if res is not None else None
    if be == "ref":
        y = ref.conv2d(xd, w, b, stride=stride, act=act, res=rd)
    else:
        y = _conv.conv2d(xd, w, b, stride=stride, act=act, res=rd)
    return _pool_epilogue(y, pool, be)


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


# --------------------------------------------------------------------------
# quantized matmuls and convs (quant backend)
# --------------------------------------------------------------------------

def qmatmul(x, q, scale, zero, b=None, *, act="identity", res=None,
            w_packed=False, backend=None) -> torch.Tensor:
    """Float x × integer codes, dequant + bias + ``act`` + ``res`` in the
    epilogue. ``q`` is (K, N) codes, or packed-int4 bytes with
    ``w_packed``."""
    be = _resolve(backend, x)
    if be == "ref":
        K = int(x.shape[-1])
        return ref.qmatmul(x, _qmm._codes(q, K, w_packed),
                           _qmm._row(scale, x.device),
                           _qmm._row(zero, x.device), b, act=act, res=res)
    return _qmm.qmatmul(x, q, scale, zero, b, act=act, res=res,
                        w_packed=w_packed)


def qmatmul_a8(x, q, scale, zero, b=None, *, x_scale, a_bits=8,
               act="identity", res=None, w_packed=False,
               backend=None) -> torch.Tensor:
    """Fully quantized matmul: ``x`` (float, quantized here at the static
    calibrated ``x_scale``, or already int8 codes) contracted int8×int8
    with int32 accumulation, the affine correction + bias + ``act`` +
    ``res`` in the epilogue. ``x_scale``: float (per tensor) or
    per-K-feature tuple (per-group calibration)."""
    be = _resolve(backend, x)
    per_k = not isinstance(x_scale, (int, float))
    if per_k:
        xs = tuple(float(s) for s in x_scale)
        qs = _qmm._device_f32(xs, x.device)
    else:
        xs = float(x_scale)
        qs = _qmm._device_f32((xs,), x.device)
    xq = x if not x.is_floating_point() \
        else ref.quantize_activation(x, qs, bits=a_bits)
    if be == "ref":
        K = int(xq.shape[-1])
        return ref.qmatmul_a8(xq, _qmm._codes(q, K, w_packed),
                              _qmm._row(scale, x.device),
                              _qmm._row(zero, x.device), qs, b, act=act,
                              res=res)
    return _qmm.qmatmul_a8(xq, q, scale, zero, b, x_scale=xs, act=act,
                           res=res, w_packed=w_packed)


def _im2col(x: torch.Tensor, K: int, stride: int):
    """SAME-padded im2col: (N, H, W, C) → ((N·Ho·Wo, K·K·C), (N, Ho, Wo)).

    Patch features are ordered (kh, kw, c) row-major, matching
    ``w.reshape(K*K*C, F)`` of an HWIO filter, so the quantized codes
    need only a reshape. The pads are the asymmetric SAME split
    (``total // 2`` before); on int8 activation codes they are code 0.
    1x1/stride-1 convs skip the windowing (a reshape)."""
    N, H, W, C = x.shape
    if K == 1 and stride == 1:
        return x.reshape(N * H * W, C), (N, H, W)
    Ho, pt, pb = ref.same_pads(H, K, stride)
    Wo, pl, pr = ref.same_pads(W, K, stride)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    cols = [xp[:, kh:kh + (Ho - 1) * stride + 1:stride,
               kw:kw + (Wo - 1) * stride + 1:stride, :]
            for kh in range(K) for kw in range(K)]
    patches = torch.cat(cols, dim=-1)
    return patches.reshape(N * Ho * Wo, K * K * C), (N, Ho, Wo)


@functools.lru_cache(maxsize=1024)
def _expand_a_scale(x_scale, C: int, K: int, device: torch.device):
    """Normalise a static activation scale for a conv node.

    ``x_scale`` is a float (per tensor) or a length-C tuple (per-group
    calibration expanded to per channel by codegen). Returns
    ``(quant_scale, mm_scale)``: the scale to quantize the NHWC stream
    with (a float, or a (C,) tensor on ``device``) and the per-K-feature
    scale for the im2col matmul — the C-tuple repeated K² times, in the
    (kh, kw, c) patch-feature order of ``_im2col``. Cached: the scales
    are compile-time constants (callers pass a tuple, not a list)."""
    if isinstance(x_scale, (int, float)):
        return float(x_scale), float(x_scale)
    sv = tuple(float(s) for s in x_scale)
    if len(sv) != C:
        raise ValueError(f"a_scale has {len(sv)} values; the conv has "
                         f"C={C} input channels")
    return _qmm._device_f32(sv, device), sv * (K * K)


def _pool_epilogue(y: torch.Tensor, pool, be: str) -> torch.Tensor:
    """A fused maxpool ``(k, stride, act)`` after a conv: the maxpool
    kernel (its plain version on ``backend="ref"``)."""
    if pool is None:
        return y
    pk, ps, pact = int(pool[0]), int(pool[1]), pool[2]
    if be == "ref":
        return ref.maxpool2d(y, k=pk, stride=ps, act=pact)
    return _pool.maxpool2d(y, k=pk, stride=ps, act=pact)


def qconv2d(x, q, scale, zero, b=None, *, K=1, stride=1, act="identity",
            res=None, w_packed=False, pool=None,
            backend=None) -> torch.Tensor:
    """Quantized conv executed as ONE ``qmatmul`` launch.

    ``q``: (K, K, C, F) integer codes (a ``QTensor.q``), or
    (ceil(K·K·C/2), F) packed-int4 bytes with ``w_packed``;
    ``scale``/``zero``: per tensor or per output channel. The input is
    im2col-windowed (1x1-direct when K=1, stride=1) and contracted
    against the raw codes; dequant + bias + ``act`` + ``res`` run in the
    epilogue. ``x``/``res`` accept channel-window lists. ``pool``:
    optional static ``(k, stride, act)`` fused maxpool."""
    be = _resolve(backend, _first(x))
    xd = _dense(x)
    patches, (N, Ho, Wo) = _im2col(xd, K, stride)
    Fo = int(q.shape[-1])
    res2 = _dense(res).reshape(N * Ho * Wo, Fo) if res is not None else None
    if be == "ref":
        y = ref.qmatmul(patches, _qmm._codes(q, K * K * xd.shape[-1],
                                             w_packed),
                        _qmm._row(scale, xd.device), _qmm._row(zero, xd.device),
                        b, act=act, res=res2)
    else:
        y = _qmm.qmatmul(patches, q if w_packed else q.reshape(-1, Fo),
                         scale, zero, b, act=act, res=res2,
                         w_packed=w_packed)
    return _pool_epilogue(y.reshape(N, Ho, Wo, Fo), pool, be)


def qconv2d_a8(x, q, scale, zero, b=None, *, x_scale, a_bits=8, K=1,
               stride=1, act="identity", res=None, w_packed=False,
               pool=None, pipeline="grid", backend=None) -> torch.Tensor:
    """Fully quantized conv (paper Fig. 8, A≤8): the input is quantized
    to int8 at the node's calibrated ``x_scale`` (float per tensor, or
    per-channel tuple), im2col-windowed in the code domain (padding is
    code 0), and contracted int8×int8 with int32 accumulation; dequant +
    bias + ``act`` + ``res`` run in the epilogue. ``a_bits < 8``
    narrows the code range inside int8 storage. ``pipeline``: the K
    sweep of the kernel backend, ``"grid"`` (#8) or ``"double"`` (#10,
    double-buffered by ``cp.async``), passed to
    :func:`repro_torch.kernels.qmatmul.qmatmul_a8` (a per-channel scale
    takes the grouped or float kernel whatever it says, and an unknown
    value raises there); ``backend="ref"`` does not read it, as in the
    JAX package."""
    be = _resolve(backend, _first(x))
    xd = _dense(x)
    C = int(xd.shape[-1])
    qscale, mscale = _expand_a_scale(
        x_scale if isinstance(x_scale, (int, float)) else tuple(x_scale),
        C, int(K), xd.device)
    if isinstance(qscale, float):       # a cached one-element tensor
        qscale = _qmm._device_f32((qscale,), xd.device)
    xq = ref.quantize_activation(xd, qscale, bits=a_bits)
    patches, (N, Ho, Wo) = _im2col(xq, K, stride)
    Fo = int(q.shape[-1])
    res2 = _dense(res).reshape(N * Ho * Wo, Fo) if res is not None else None
    if be == "ref":                     # the plain version has no K sweep
        xs = mscale if isinstance(mscale, float) \
            else _qmm._device_f32(mscale, xd.device)
        y = ref.qmatmul_a8(patches, _qmm._codes(q, K * K * C, w_packed),
                           _qmm._row(scale, xd.device),
                           _qmm._row(zero, xd.device), xs, b, act=act,
                           res=res2)
    else:
        y = _qmm.qmatmul_a8(patches, q if w_packed else q.reshape(-1, Fo),
                            scale, zero, b, x_scale=mscale, act=act,
                            res=res2, w_packed=w_packed, pipeline=pipeline)
    return _pool_epilogue(y.reshape(N, Ho, Wo, Fo), pool, be)


# --------------------------------------------------------------------------
# LM kernels: attention, decode attention, RMSNorm, the SSD scan
# --------------------------------------------------------------------------

def mha(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
        backend=None) -> torch.Tensor:
    """Full-sequence attention. q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv,
    D). ``window=None`` is full attention."""
    be = _resolve(backend, q)
    if be == "ref":
        return ref.mha(q, k, v, causal=causal, window=window,
                       softcap=softcap, scale=scale)
    if q.is_cuda and _grad.wants_grad(q, k, v):
        return _grad.Mha.apply(q, k, v, causal, window, softcap, scale)
    return _attn.mha(q, k, v, causal=causal, window=window,
                     softcap=softcap, scale=scale)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     softcap=None, scale=None, backend=None) -> torch.Tensor:
    """One query row per (row, q head) over a KV cache. q: (B, Hq, D);
    caches: (B, S, Hkv, D); cache_len: (B,) int32 valid positions."""
    be = _resolve(backend, q)
    if be == "ref":
        return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                    window=window, softcap=softcap,
                                    scale=scale)
    return _dec.decode_attention(q, k_cache, v_cache, cache_len,
                                 window=window, softcap=softcap, scale=scale)


def rmsnorm(x, g, *, eps=1e-6, backend=None) -> torch.Tensor:
    """``x·rsqrt(mean(x²) + eps)·(1 + g)`` over the last axis."""
    be = _resolve(backend, x)
    if be == "ref":
        return ref.rmsnorm(x, g, eps)
    if x.is_cuda and _grad.wants_grad(x, g):
        return _grad.RmsNorm.apply(x, g, eps)
    return _pw.rmsnorm(x, g, eps)


def ssd_scan(x, dt, A, B, C, *, h0=None, backend=None) -> tuple:
    """Mamba-2 chunked SSD scan. x: (Bt, T, H, P); dt: (Bt, T, H); A:
    (H,); B, C: (Bt, T, G, N) per group (head h reads group
    h // (H / G)); h0: optional initial state (Bt, H, N, P). Any T.
    Returns (y (Bt, T, H, P), final state (Bt, H, N, P) float32). Split
    views (the mixer's x, B and C) are made contiguous here."""
    be = _resolve(backend, x)
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    h0 = h0.contiguous() if h0 is not None else None
    if be == "ref":
        return ref.ssd_chunked(x, dt, A, B, C, h0=h0)
    if x.is_cuda and _grad.wants_grad(x, dt, A, B, C, h0):
        return _grad.SsdScan.apply(x, dt, A, B, C, h0)
    return _ssd.ssd_scan(x, dt, A, B, C, h0=h0)
