"""Blocked floating-point post-training quantization (paper §IV-A).

A torch port of the JAX package's ``core/quant.py`` (Eqs. 1–3):

    w' = round(w / S - Z)                                   (Eq. 1)
    S  = (w_max - w_min) / (2^L - 1)                        (Eq. 2)
    Z  = round(w_min / S) + 2^(L-1)                         (Eq. 3)

(The paper's Eq. 3 prints ``round(w_min * S)``; the corrected ``w_min /
S`` is implemented and the printed form stays behind ``paper_typo``.)

Codes are bit-exact with the JAX package: every step is the same f32
operation in the same order, ``torch.round`` rounds half to even as
``jnp.round`` does, and dequantization is ``(q + Z) · S`` in that order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 8
    granularity: str = "per_tensor"   # per_tensor | per_channel | per_group
    axis: int = -1                    # channel axis for per_channel/per_group
    group_size: int = 128             # for per_group
    symmetric: bool = False
    paper_typo: bool = False          # use the paper's printed (buggy) Eq. 3
    pack: bool = False                # bits ≤ 4: two codes per int8 byte

    def storage_dtype(self) -> torch.dtype:
        if self.bits <= 8:
            return torch.int8
        if self.bits <= 16:
            return torch.int16
        raise ValueError(f"unsupported wordlength {self.bits}")

    def packs_layout(self, ndim: int) -> bool:
        """Whether :func:`quantize` stores a ``ndim``-dim weight's codes
        nibble-packed under this scheme (pack=True, bits <= 4, and a
        rowsum-exact layout: per-tensor, or per-channel over the LAST
        axis). The design-rule checker (SAT018) uses the same
        predicate."""
        return bool(self.pack) and self.bits <= 4 and (
            self.granularity == "per_tensor"
            or (self.granularity == "per_channel"
                and self.axis % ndim == ndim - 1))


@dataclasses.dataclass
class QTensor:
    """A quantized tensor: integer codes + block-FP metadata.

    ``scale``/``zero`` broadcast against ``q`` along the quantization
    blocks. ``packed=True`` is the int4 storage mode: ``q`` holds two
    codes per int8 byte over the matrix view ``(R, shape[-1])`` with
    ``R = prod(shape[:-1])`` — byte ``r`` packs codes ``2r`` (low
    nibble) and ``2r+1`` (high nibble)."""
    q: torch.Tensor         # integer codes, storage dtype
    scale: torch.Tensor     # f32
    zero: torch.Tensor      # f32 (already includes the 2^(L-1) offset)
    bits: int
    shape: tuple[int, ...]
    packed: bool = False

    @property
    def code_nbytes(self) -> int:
        """Measured storage of the code array as laid out (excludes
        scale/zero metadata)."""
        return self.q.numel() * self.q.element_size()

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, q=self.q.to(device),
                                   scale=self.scale.to(device),
                                   zero=self.zero.to(device))

    def unpacked(self) -> torch.Tensor:
        """The code array in logical matrix layout ``(R, shape[-1])``."""
        if not self.packed:
            return self.q.reshape(-1, self.shape[-1]) \
                if tuple(self.q.shape) != self.shape else self.q
        R = 1
        for d in self.shape[:-1]:
            R *= int(d)
        return unpack_int4(self.q, R)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        if self.packed:
            q = self.unpacked().reshape(self.shape)
            nd = len(self.shape)
            scale = self.scale.reshape((1,) * (nd - 1) + (-1,)) \
                if self.scale.ndim not in (0, nd) else self.scale
            zero = self.zero.reshape((1,) * (nd - 1) + (-1,)) \
                if self.zero.ndim not in (0, nd) else self.zero
            return ((q.to(torch.float32) + zero) * scale).to(dtype)
        w = (self.q.to(torch.float32) + self.zero) * self.scale
        return w.reshape(self.shape).to(dtype)


def cuts_by_filter(qt: QTensor) -> bool:
    """Whether ``qt`` cuts into filter blocks (its last axis) that
    dequantize to the same filters: codes with a filter axis (unpacked
    or nibble-packed; a per-group layout has none), and a scale and zero
    that run over the filters or are broadcast along them (per tensor,
    or per channel over another axis)."""
    if not qt.packed and tuple(qt.q.shape) != tuple(qt.shape):
        return False
    F = qt.shape[-1]
    return all(t.ndim == 0 or t.shape[-1] in (1, F)
               for t in (qt.scale, qt.zero))


def filter_block(qt: QTensor, sl: slice) -> QTensor:
    """The QTensor of filters ``sl`` of ``qt`` (``cuts_by_filter``): its
    codes' columns, and its scale and zero where they run over the
    filters. A per-tensor scale stays the whole tensor's."""
    if not cuts_by_filter(qt):
        raise ValueError("this QTensor layout has no filter blocks")
    F = qt.shape[-1]

    def cut(t):
        return t if t.ndim == 0 or t.shape[-1] != F \
            else t[..., sl].contiguous()
    return dataclasses.replace(
        qt, q=qt.q[..., sl].contiguous(), scale=cut(qt.scale),
        zero=cut(qt.zero),
        shape=tuple(qt.shape[:-1]) + (len(range(F)[sl]),))


def join_filter_blocks(blocks: list) -> QTensor:
    """The inverse of :func:`filter_block` over consecutive blocks in
    filter order: codes joined by column, a scale and zero that run over
    the filters joined too (a per-tensor one kept)."""
    first = blocks[0]

    def join(ts):
        if ts[0].ndim == 0 or ts[0].shape[-1] != first.shape[-1]:
            return ts[0]
        return torch.cat(ts, dim=-1)
    F = sum(b.shape[-1] for b in blocks)
    return dataclasses.replace(
        first, q=torch.cat([b.q for b in blocks], dim=-1),
        scale=join([b.scale for b in blocks]),
        zero=join([b.zero for b in blocks]),
        shape=tuple(first.shape[:-1]) + (F,))


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (int8 storage, values in [-8, 7]) two per byte:
    (R, N) → (ceil(R/2), N) int8, code ``2r`` in the low nibble and
    ``2r+1`` in the high one. An odd R is padded with a zero code."""
    R, N = q.shape
    if R % 2:
        q = torch.cat([q, q.new_zeros((1, N))], dim=0)
    u = q.to(torch.uint8) & 0x0F
    return (u[0::2] | (u[1::2] << 4)).to(torch.int8)


def unpack_int4(qp: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (P, N) packed bytes → (rows, N)
    int8 codes, sign-extended with arithmetic shifts."""
    lo = (qp << 4) >> 4
    hi = qp >> 4
    full = torch.stack([lo, hi], dim=1).reshape(2 * qp.shape[0],
                                                qp.shape[1])
    return full[:rows]


def _block_reduce(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Reshape ``w`` to (blocks, block_elems) per the granularity."""
    if cfg.granularity == "per_tensor":
        return w.reshape(1, -1)
    axis = cfg.axis % w.ndim
    wm = torch.movedim(w, axis, 0)
    if cfg.granularity == "per_channel":
        return wm.reshape(wm.shape[0], -1)
    if cfg.granularity == "per_group":
        flat = wm.reshape(wm.shape[0], -1)
        g = cfg.group_size
        pad = (-flat.shape[1]) % g
        flat = torch.nn.functional.pad(flat, (0, pad))
        return flat.reshape(-1, g)
    raise ValueError(cfg.granularity)


def quantize(w: torch.Tensor, cfg: QuantConfig = QuantConfig()) -> QTensor:
    """Paper Eqs. 1–3, vectorised over quantization blocks."""
    L = cfg.bits
    orig_shape = tuple(int(d) for d in w.shape)
    blocks = _block_reduce(w.to(torch.float32), cfg)
    wmax = blocks.amax(dim=1, keepdim=True)
    wmin = blocks.amin(dim=1, keepdim=True)

    def levels(n: int) -> torch.Tensor:
        # a divisor tensor: on a CUDA tensor PyTorch divides by a Python
        # scalar as a product with its reciprocal, which rounds otherwise
        return torch.full((1, 1), float(n), dtype=torch.float32,
                          device=blocks.device)

    if cfg.symmetric:
        amax = torch.maximum(wmax.abs(), wmin.abs())
        scale = torch.clamp(amax / levels(2 ** (L - 1) - 1), min=1e-12)
        zero = torch.zeros_like(scale)
    else:
        scale = torch.clamp((wmax - wmin) / levels(2 ** L - 1), min=1e-12)
        if cfg.paper_typo:
            zero = torch.round(wmin * scale) + 2 ** (L - 1)
        else:
            zero = torch.round(wmin / scale) + 2 ** (L - 1)
    qmin, qmax = -(2 ** (L - 1)), 2 ** (L - 1) - 1
    q = torch.clamp(torch.round(blocks / scale - zero), qmin, qmax)
    q = q.to(cfg.storage_dtype())

    if cfg.granularity == "per_tensor":
        qs = q.reshape(orig_shape)
        scale_s, zero_s = scale.reshape(()), zero.reshape(())
    elif cfg.granularity == "per_channel":
        axis = cfg.axis % w.ndim
        ch = orig_shape[axis]
        moved = orig_shape[:axis] + orig_shape[axis + 1:]
        qs = torch.movedim(q.reshape((ch,) + moved), 0, axis)
        bshape = [1] * w.ndim
        bshape[axis] = ch
        scale_s, zero_s = scale.reshape(bshape), zero.reshape(bshape)
        qs = qs.reshape(orig_shape)
    else:           # per_group: codes stay in (blocks, g) layout
        qs, scale_s, zero_s = q, scale, zero
    packed = cfg.packs_layout(w.ndim)
    if packed:
        qs = pack_int4(qs.reshape(-1, orig_shape[-1]))
        scale_s = scale_s.reshape(-1)
        zero_s = zero_s.reshape(-1)
    return QTensor(q=qs.contiguous(), scale=scale_s.to(torch.float32),
                   zero=zero_s.to(torch.float32), bits=L,
                   shape=orig_shape, packed=packed)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize` for per_tensor/per_channel layouts."""
    if qt.packed:
        return qt.dequantize(dtype)
    w = (qt.q.to(torch.float32) + qt.zero) * qt.scale
    if tuple(qt.q.shape) == qt.shape:
        return w.to(dtype)
    n = 1
    for d in qt.shape:
        n *= int(d)
    # per_group layout, axis-0 only: (blocks, g) → flat → shape
    return w.reshape(-1)[:n].reshape(qt.shape).to(dtype)


def fake_quant(x: torch.Tensor, bits: int = 16,
               symmetric: bool = True) -> torch.Tensor:
    """Simulated activation quantization (paper fixes A16): a per-tensor
    dynamic range and a straight-through estimator for gradients, so
    QAT-style fine-tuning also works (beyond-paper)."""
    amax = torch.clamp(x.abs().max(), min=1e-12)
    scale = amax / (2 ** (bits - 1) - 1)
    q = torch.clamp(torch.round(x / scale), -(2 ** (bits - 1)),
                    2 ** (bits - 1) - 1)
    y = q * scale
    return x + (y - x).detach()


def quantize_tree(
        params: Any, cfg: QuantConfig = QuantConfig(),
        predicate: Callable[[tuple, torch.Tensor], bool] | None = None,
        cfg_fn: Callable[[tuple, torch.Tensor], QuantConfig] | None = None
) -> Any:
    """Quantize every tensor in a nested dict for which ``predicate``
    holds. Defaults match the JAX package: matrices/filters (ndim >= 2)
    are quantized, vectors (biases) stay float, and leaves with ndim >= 3
    get per_channel scales over axis 0."""
    if predicate is None:
        predicate = lambda path, x: x.ndim >= 2             # noqa: E731
    if cfg_fn is None:
        def cfg_fn(path, x):
            if x.ndim >= 3:
                return dataclasses.replace(cfg, granularity="per_channel",
                                           axis=0)
            return cfg

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, torch.Tensor) and predicate(path, node):
            return quantize(node, cfg_fn(path, node))
        return node

    return walk(params, ())


def dequantize_tree(params: Any, dtype=torch.float32) -> Any:
    """Every QTensor of a nested dict dequantized; other leaves kept."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return dequantize(node, dtype) if isinstance(node, QTensor) \
            else node
    return walk(params)


def quant_error(w: torch.Tensor, cfg: QuantConfig) -> dict[str, float]:
    """Round-trip error metrics for the Fig. 8 sweep benchmark."""
    wq = dequantize(quantize(w, cfg))
    err = (wq - w).abs()
    denom = torch.clamp(w.abs(), min=1e-12)
    p_sig = (w ** 2).mean()
    p_noise = torch.clamp(((wq - w) ** 2).mean(), min=1e-30)
    return {
        "max_abs_err": float(err.max()),
        "mean_rel_err": float((err / denom).mean()),
        "sqnr_db": float(10 * torch.log10(p_sig / p_noise)),
    }
