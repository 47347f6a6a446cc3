"""Plain PyTorch versions of the port's CNN, quantized and LM kernels.

The semantic ground truth the CUDA kernels are held against, on the CPU
in the tests and on the card in ``chip_smoke.py``. A port of the JAX
package's ``kernels/ref.py`` (CNN, quantized matmuls, attention,
RMSNorm and the Mamba-2 SSD scan), plus :func:`ssd_chunked`, the
batched chunked form of ``nn/ssm.py:ssd_chunked`` that the SSD kernel
is held against: NHWC activations, HWIO ``(K, K, C, F)`` weights,
float32 arithmetic, integer accumulators exact.

SAME padding is asymmetric, as ``lax`` computes it: the total pad is
``max((out - 1)·s + K - in, 0)``, ``total // 2`` before and the rest
after. ``F.conv2d(padding=...)`` pads symmetrically, so the pads are
applied explicitly with ``F.pad``.
"""
from __future__ import annotations

import math

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



# --------------------------------------------------------------------------
# Quantized matmul (paper §IV-A: W8A16 with dequant-in-epilogue)
# --------------------------------------------------------------------------

def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Packed-int4 bytes (R, N) int8 → (2R, N) codes: byte ``r`` holds
    row ``2r`` in its low nibble and ``2r + 1`` in its high nibble, both
    sign-extended with arithmetic shifts (bit-exact with
    ``core.quant.unpack_int4``). For an odd logical row count the last
    high nibble is padding; callers slice it off."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    r, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * r, n)


def qmatmul(x: torch.Tensor, wq: torch.Tensor, scale, zero,
            b: torch.Tensor | None = None, act: str = "identity",
            res: torch.Tensor | None = None) -> torch.Tensor:
    """x: (M, K) float; wq: (K, N) integer codes; scale/zero broadcast to
    (K, N) or per-column (1, N). ``w ≈ (wq + zero)·scale``; the epilogue
    order is ``act(xw + b) + res``, as in the fused conv engine."""
    fn = activation(act)
    w = (wq.to(torch.float32) + zero) * scale
    y = x.to(torch.float32) @ w
    if b is not None:
        y = y + b.to(torch.float32)
    y = fn(y)
    if res is not None:
        y = y + res.to(torch.float32)
    return y.to(x.dtype)


def quantize_activation(x: torch.Tensor, x_scale, bits: int = 8
                        ) -> torch.Tensor:
    """Symmetric activation quantization at a static calibrated scale:
    ``round(x / s)`` (true float32 division, half-to-even rounding as
    ``jnp.round``), saturated to ``[-qmax - 1, qmax]``, as int8 codes.

    ``x_scale`` is a per-tensor float or a tensor broadcastable over
    ``x``'s trailing axis (the per-group calibration's per-channel
    vector). A float is divided as a one-element tensor on ``x``'s
    device: on a CUDA tensor, PyTorch divides by a Python scalar as a
    product with its reciprocal, which rounds differently."""
    qmax = 2 ** (bits - 1) - 1
    if isinstance(x_scale, (int, float)):
        s = torch.full((1,), float(x_scale), dtype=torch.float32,
                       device=x.device)
    else:
        s = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    q = torch.round(x.to(torch.float32) / s)
    return torch.clamp(q, -qmax - 1, qmax).to(torch.int8)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of two integer-code matrices. PyTorch has no
    integer matmul on CUDA, so the product runs in float64, where every
    partial sum of int8 × int8 products (|p| ≤ 2^14) is exact below
    2^53, and is cast back."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def qmatmul_a8(x: torch.Tensor, wq: torch.Tensor, scale, zero, x_scale,
               b: torch.Tensor | None = None, act: str = "identity",
               res: torch.Tensor | None = None) -> torch.Tensor:
    """Fully quantized matmul: int8 activation codes × integer weight
    codes, int32 accumulation, affine correction once per output:

        x @ w ≈ x_scale·scale·(xq @ wq) + x_scale·(zero·scale)·rowsum(xq)

    ``x`` is float (quantized here at ``x_scale``) or already codes.
    ``x_scale`` is a per-tensor float, or a (K,) per-input-feature vector
    (per-group calibration expanded per feature), which folds into the
    reduction in float32 instead:

        x @ w ≈ scale·((xq·s_k) @ wq) + (zero·scale)·Σ_k xq_k·s_k

    Both sums over k run in float64, where every product xq_k·s_k·wq_k
    is exact and the sum's error is far below a float32 ulp, and are
    rounded to float32 once: the exact sums' float32 value, which the
    grouped kernel's float32 fold of exact int32 block sums lands within
    a few ulps of. (A float32 GEMM over the K products rounds K
    times and lands further off, so codes that the next layer quantizes
    would round the other way because of this version, not the kernel.)
    The affine correction is float32, as above.

    Returns float32 (the caller owns the cast)."""
    fn = activation(act)
    if isinstance(x_scale, (int, float)):
        per_k = False
    else:
        sk = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
        per_k = sk.ndim >= 1 and sk.numel() > 1
        if not per_k:
            x_scale = float(sk.reshape(()))
    xq = x if not x.is_floating_point() else quantize_activation(
        x, sk if per_k else x_scale)
    if per_k:
        xs = xq.to(torch.float64) * sk.to(torch.float64).reshape(1, -1)
        acc = (xs @ wq.to(torch.float64)).to(torch.float32)
        xsum = xs.sum(dim=1, keepdim=True).to(torch.float32)
        y = acc * scale + xsum * (zero * scale)
    else:
        acc = int_matmul(xq, wq)
        xsum = xq.to(torch.int32).sum(dim=1, keepdim=True)
        y = acc.to(torch.float32) * (x_scale * scale) \
            + xsum.to(torch.float32) * (x_scale * (zero * scale))
    if b is not None:
        y = y + b.to(torch.float32)
    y = fn(y)
    if res is not None:
        y = y + res.to(torch.float32)
    return y


# --------------------------------------------------------------------------
# LM kernels: attention, decode attention, RMSNorm (copies of the JAX
# package's ref.mha, ref.decode_attention and ref.rmsnorm)
# --------------------------------------------------------------------------

def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None,
        softcap: float | None = None,
        scale: float | None = None) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, D). GQA by head repetition.

    ``window``: sliding-window size (query i attends to keys in
    (i + off - window, i + off], off = Tk - Tq). ``softcap``:
    ``cap·tanh(s/cap)`` on the scores. A query row with no visible key
    is NaN (its softmax is over -inf only)."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, _ = k.shape
    rep = Hq // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    off = Tk - Tq  # queries are the last Tq positions of the kv stream
    qi = torch.arange(Tq, device=q.device)[:, None] + off
    ki = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return o.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int | None = None,
                     softcap: float | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token decode. q: (B, Hq, D); caches: (B, S, Hkv, D).

    ``cache_len``: number of valid cache positions (int or (B,) tensor);
    position ``pos`` is visible when ``pos < len`` (and
    ``pos >= len - window`` with a window)."""
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    rep = Hq // Hkv
    kc = k_cache.repeat_interleave(rep, dim=2) if rep > 1 else k_cache
    vc = v_cache.repeat_interleave(rep, dim=2) if rep > 1 else v_cache
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhd,bshd->bhs", q.to(torch.float32),
                     kc.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device)
    clen = clen[:, None] if clen.ndim == 1 else clen.reshape(1, 1)
    valid = pos < clen
    if window is not None:
        valid &= pos >= clen - window
    s = torch.where(valid[:, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p,
                        vc.to(torch.float32)).to(q.dtype)


def rmsnorm(x: torch.Tensor, g: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²) + eps)·(1 + g)`` over the last axis, in
    float32 (the (1+g) convention: a zero ``g`` is the identity
    scale)."""
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * (1.0 + g.to(torch.float32))).to(x.dtype)


# --------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality): the sequential oracle and one decode
# step (copies of the JAX package's ref.ssd_scan and ref.ssd_decode_step),
# and the batched chunked form the SSD kernel computes
# --------------------------------------------------------------------------

def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, h0: torch.Tensor | None = None,
             return_state: bool = False):
    """Mamba-2 selective state-space recurrence, one sequence, one step
    at a time.

    x: (T, H, P); dt: (T, H) softplus'd timestep (> 0); A: (H,) negative
    decay; B, C: (T, G, N), head h reading group h // (H / G) (the
    ``repeat`` layout). Per head:

        S_t = exp(dt_t · A_h) · S_{t-1} + dt_t · B_t ⊗ x_t
        y_t = C_t · S_t

    Returns y: (T, H, P), and the final state (H, N, P) with
    ``return_state``."""
    T, H, P = x.shape
    G, N = B.shape[1], B.shape[2]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=1) if rep > 1 else B   # (T, H, N)
    Ch = C.repeat_interleave(rep, dim=1) if rep > 1 else C
    decay = torch.exp(dt.to(torch.float32) * A[None, :].to(torch.float32))
    xb = dt[..., None].to(torch.float32) * x.to(torch.float32)
    S = torch.zeros((H, N, P), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.to(torch.float32)
    Bh, Ch = Bh.to(torch.float32), Ch.to(torch.float32)
    ys = []
    for t in range(T):
        S = decay[t][:, None, None] * S + Bh[t][:, :, None] * xb[t][:, None, :]
        ys.append(torch.einsum("hn,hnp->hp", Ch[t], S))
    y = torch.stack(ys).to(x.dtype) if T else x.new_zeros((0, H, P))
    return (y, S) if return_state else y


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, state: torch.Tensor):
    """One recurrent step. x: (H, P), dt: (H,), B/C: (G, N), state:
    (H, N, P). Returns (y (H, P), new state)."""
    H, P = x.shape
    G, N = B.shape
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=0) if rep > 1 else B
    Ch = C.repeat_interleave(rep, dim=0) if rep > 1 else C
    d = torch.exp(dt.to(torch.float32) * A.to(torch.float32))
    S = d[:, None, None] * state.to(torch.float32) \
        + Bh[:, :, None] * (dt[:, None] * x.to(torch.float32))[:, None, :]
    y = torch.einsum("hn,hnp->hp", Ch.to(torch.float32), S)
    return y.to(x.dtype), S


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor,
                h0: torch.Tensor | None = None, chunk: int = 64):
    """Batched chunked SSD: the function of ``nn/ssm.py:ssd_chunked``
    (and of the Pallas kernel ``kernels/ssd_scan.py``), in the kernel's
    chunk of 64 tokens by default; any chunk gives the same math.

    x: (Bt, T, H, P); dt: (Bt, T, H); A: (H,); B, C: (Bt, T, G, N) per
    GROUP, head h reading group h // (H / G) (no repeat is made); h0:
    optional initial state (Bt, H, N, P). Any T: a ragged last chunk is
    padded with dt = 0 (decay 1, no input), which leaves y and the state
    unchanged. Per chunk, with cs the cumulative sum of dt·A in it:

        y  = (C Bᵀ ⊙ exp(cs_t − cs_s) · dt_s, s ≤ t) · x + (C ⊙ exp(cs)) · S
        S ← exp(cs_last) · S + Σ_s exp(cs_last − cs_s) · dt_s · B_s ⊗ x_s

    the exponent masked to -inf before ``exp`` where s > t (there it is
    positive and would overflow). Returns (y (Bt, T, H, P) in x's dtype,
    final state (Bt, H, N, P) float32)."""
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    c = max(1, min(chunk, T))
    pad = (-T) % c
    f32 = torch.float32
    xf, dtf, Bf, Cf = (t.to(f32) for t in (x, dt, B, C))
    if pad:
        xf, Bf, Cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bf, Cf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    Af = A.to(f32)
    S = torch.zeros((Bt, G, rep, N, P), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32).reshape(Bt, G, rep, N, P).clone()
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    ys = []
    for j in range(0, T + pad, c):
        xc = xf[:, j:j + c].reshape(Bt, c, G, rep, P)
        dtc, Bc, Cc = dtf[:, j:j + c], Bf[:, j:j + c], Cf[:, j:j + c]
        cs = torch.cumsum(dtc * Af, dim=1)                       # (Bt,c,H)
        diff = cs[:, :, None, :] - cs[:, None, :, :]             # (Bt,t,s,H)
        diff = torch.where(tri[None, :, :, None], diff, float("-inf"))
        Wd = (torch.exp(diff) * dtc[:, None, :, :]).reshape(
            Bt, c, c, G, rep)
        CB = torch.einsum("btgn,bsgn->btsg", Cc, Bc)             # per group
        W = CB[..., None] * Wd                                   # (Bt,t,s,G,r)
        y = torch.einsum("btsgr,bsgrp->btgrp", W, xc)
        y = y + torch.einsum("btgn,bgrnp->btgrp", Cc, S) \
            * torch.exp(cs).reshape(Bt, c, G, rep)[..., None]
        ys.append(y.reshape(Bt, c, H, P))
        w_s = (torch.exp(cs[:, -1:, :] - cs) * dtc).reshape(Bt, c, G, rep)
        S = torch.exp(cs[:, -1]).reshape(Bt, G, rep)[..., None, None] * S \
            + torch.einsum("bsgn,bsgrp->bgrnp", Bc, xc * w_s[..., None])
    y = torch.cat(ys, dim=1)[:, :T] if ys else xf
    return y.to(x.dtype), S.reshape(Bt, H, N, P)
