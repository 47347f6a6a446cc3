"""Quantized-weight matmuls with the dequantization in the epilogue
(paper §IV-A: W8A16, and the A≤8 wordlengths of Fig. 8).

Replaces the Pallas kernels of ``src/repro/kernels/qmatmul.py``:

* :func:`qmatmul` (``qmatmul``, ``_qmm_kernel``, prologue ``_unpack4``):
  float x × integer codes — int8, int16, or packed int4 — with a float32
  accumulator and the row sum of x; epilogue
  ``acc·scale + xsum·(zero·scale) + b → act → + res``.
* :func:`qmatmul_a8` (``qmatmul_a8``, ``_qmm_a8_kernel``): int8 activation
  codes × int8 or packed-int4 codes, int32 accumulator and row sum, the
  static activation scale folded into the weight scale
  (``scale = wscale·x_scale``, then ``zero = wzero·scale``, as
  ``qmatmul.py:382-383`` does; the CUDA epilogue computes these two
  products per column, in that order).
* ``qmatmul_a8(pipeline="double")`` (``_qmm_a8_dma_kernel``): the same
  contraction with the K slices of x and of the codes copied into three
  shared-memory stages by ``cp.async``, counted on
  ``qmatmul_a8.launches_double``.
* :func:`qmatmul_a8_grouped` (``_qmm_a8_grouped_kernel``,
  ``_group_tile``): one activation scale per K run, int32 sums within a
  block of ``tk`` features scaled into float32 accumulators.

:func:`qmatmul` runs on the tensor cores (TF32 with each x split into
two TF32 terms, exact for int8 and int4 codes, int16 codes split in two
more), its tile and split of K planned by :func:`_plan`. #8 and #10 run
on the int8 tensor cores with int32 sums, their tile and split of K
planned by :func:`_plan_a8`; they take x and the codes as the caller
gives them, any K and any byte offset (no padded copy), and differ only
in how a K slice reaches shared memory. #9 runs on their tile with f32
accumulators beside the int32 ones, its tile and split of K (at block
boundaries) planned by :func:`_plan_a8g`.

On a CUDA tensor each wrapper launches its kernel of ``csrc/qmatmul.cu``
and counts the launch on its own ``launches`` attribute; on a CPU tensor
it runs the plain version (``ref.qmatmul`` / ``ref.qmatmul_a8``).
:func:`qmatmul_a8` with a per-K scale tuple launches the grouped kernel
when the scale runs align to a usable K tile, and otherwise — the JAX
package's own semantics (``qmatmul.py:369-377``) — the float kernel on
``xq·s_k``, whatever ``pipeline`` says; with a float scale,
``pipeline="double"`` launches the double-buffered kernel. Bound on the
H100: see the source's note.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import ref
from ._build import H100_SMS as _H100_SMS
from ._build import RESIDENT as _RESIDENT
from ._build import (LaunchCounter, act_code, check_operand, check_pipeline,
                     launch, pick_tile, sm_count, split_k)

_CODE_KIND = {torch.int8: 0, torch.int16: 1}
_PACKED = 2

# Kernel #7's tiles: the (BM, BN) for large M, widest first, and the one
# for M <= _SMALL_M (a decode step); TILES is what csrc/qmatmul.cu
# compiles (kernels/_build.py writes it, with the K stage _BK, into the
# header the source includes). Every tile runs _RESIDENT blocks an SM
# (csrc TC_RESIDENT; the rule _build.split_k sizes a split of K to).
_LARGE_M_TILES = ((128, 64), (128, 32), (256, 16))
_SMALL_M_TILE = (16, 128)
TILES = _LARGE_M_TILES + (_SMALL_M_TILE,)
_SMALL_M = 64
_BK = 32


@functools.lru_cache(maxsize=1024)
def _plan(M: int, K: int, N: int, kind: int,
          sms: int = _H100_SMS) -> tuple[int, int, int, int]:
    """(BM, BN, BK, splits) of kernel #7 for an (M, K) x (K, N) product
    with codes of ``kind`` (0 int8, 1 int16, 2 packed int4) on a card of
    ``sms`` streaming multiprocessors.

    BN is the widest compiled tile whose columns exceed N by at most 25%
    (the narrowest where none does, N < 16 or N = 20); M <= 64 takes the
    16 x 128 tile. Where the tiles number fewer than the 2 x ``sms``
    blocks the card holds at once, K is split into ``splits`` chunks of
    ceil(ceil(K / BK) / splits) stages of BK features (even, so a packed
    byte row never straddles two), none empty: at least enough
    chunks to fill the slots, at most twice that, and of those the split
    whose busiest block is shortest (its items times their stages plus
    two, for an item's epilogue and pipeline fill). The same inputs give
    the same plan, so the same bits."""
    if kind not in (0, 1, _PACKED):
        raise ValueError(f"unknown code kind {kind}")
    if M <= _SMALL_M:
        bm, bn = _SMALL_M_TILE
    else:
        bm, bn = next(((bm, bn) for bm, bn in _LARGE_M_TILES
                       if -(-N // bn) * bn <= 1.25 * N), _LARGE_M_TILES[-1])
    splits = split_k(-(-M // bm) * -(-N // bn), -(-K // _BK),
                     _RESIDENT * sms)
    return bm, bn, _BK, splits


# Kernels #8 and #10 (int8 x int8 on the tensor cores): the (BM, BN) tiles
# csrc/qmatmul.cu compiles for both (written, with the K slice _A8_BK,
# into the same header as TILES), each of 256 threads in 16-column
# groups, so any multiple of 16 is a width; both kernels run at least
# _RESIDENT blocks an SM, so the split of K fills the same slots as #7's.
A8_TILES = ((256, 16), (256, 32), (128, 64), (128, 80), (64, 128))
_A8_BK = 64


@functools.lru_cache(maxsize=1024)
def _plan_a8(M: int, K: int, N: int,
             sms: int = _H100_SMS) -> tuple[int, int, int]:
    """(BM, BN, splits) of kernels #8 and #10 for an (M, K) x (K, N)
    int8 product on a card of ``sms`` streaming multiprocessors.

    The tile is :func:`repro_torch.kernels._build.pick_tile`'s of the
    compiled ones (within 25% of N, fewest column tiles, each reading x
    once more). K is split into chunks of whole slices of ``_A8_BK``
    features (even, so a packed byte row never straddles two) by
    :func:`repro_torch.kernels._build.split_k`, none empty, and at most
    K / 4N chunks: each
    chunk's int32 partial sums (4·M·N bytes) are written and read back
    once, and all of them stay below x's M·K bytes (on the H100, 9 splits
    of yolov8n's 3x3 at 20 ran in 14 µs, 18 in 18). The same inputs give
    the same plan, and an int32 sum is exact in any order, so any split
    gives the same bits."""
    bm, bn = pick_tile(A8_TILES, N)
    return bm, bn, split_k(-(-M // bm) * -(-N // bn), -(-K // _A8_BK),
                           _RESIDENT * sms, max(1, K // (4 * N)))


# Kernel #9 (per-K-block activation scales) on #8's tile: the (BM, BN)
# csrc/qmatmul.cu compiles for it (written into the same header as
# REPRO_A8G_TILES). Each is 4096 outputs, a warp's 512 (16 int32 and 16
# f32 accumulators a thread): #8's tiles of twice that spill under
# the 128 registers of two blocks an SM once the f32 sums sit beside
# the int32 ones.
A8G_TILES = ((256, 16), (128, 32), (64, 64), (32, 128))


@functools.lru_cache(maxsize=1024)
def _plan_a8g(M: int, K: int, N: int, tk: int,
              sms: int = _H100_SMS) -> tuple[int, int, int, int]:
    """(BM, BN, splits, per) of kernel #9 for an (M, K) x (K, N) int8
    product whose activation scale is one a block of ``tk`` features
    (``tk`` divides K), on a card of ``sms`` streaming multiprocessors;
    ``per`` is the slices of ``_A8_BK`` features a K chunk.

    The tile is :func:`_plan_a8`'s rule over ``A8G_TILES``. K is split
    as #8's (:func:`repro_torch.kernels._build.split_k`, at most K / 4N
    chunks: the f32 partial sums, 4·M·N bytes a chunk, stay below x's
    M·K), but in units of lcm(``_A8_BK``, ``tk``) features, so that every
    chunk starts and ends at a block boundary and folds whole blocks;
    where K holds one such unit, K is not split. The same inputs give
    the same plan, so the same bits."""
    bm, bn = pick_tile(A8G_TILES, N)
    k_tiles = -(-K // _A8_BK)
    unit = math.lcm(_A8_BK, tk) // _A8_BK               # slices a unit
    units = -(-k_tiles // unit)
    s = split_k(-(-M // bm) * -(-N // bn), units, _RESIDENT * sms,
                max(1, K // (4 * N)))
    per = min(-(-units // s) * unit, k_tiles)
    return bm, bn, -(-k_tiles // per), per


def _check_shapes(x: torch.Tensor, q: torch.Tensor, w_packed: bool,
                  w_rows: int | None = None) -> tuple[int, int, int]:
    M, K = (int(d) for d in x.shape)
    if w_packed:
        N = int(q.shape[1])
        if w_rows is not None and w_rows != K:
            raise ValueError(f"w_rows={w_rows} but x has K={K}")
        if q.shape[0] != (K + 1) // 2:
            raise ValueError(f"packed codes have {q.shape[0]} byte rows; "
                             f"K={K} needs {(K + 1) // 2}")
    else:
        Kq, N = (int(d) for d in q.shape)
        if Kq != K:
            raise ValueError(f"codes have {Kq} rows, x has K={K}")
    return M, K, N


def _codes(q: torch.Tensor, rows: int, w_packed: bool) -> torch.Tensor:
    """The (rows, N) code matrix of the plain versions: packed-int4
    bytes (ceil(rows/2), N) are unpacked, other codes (an HWIO filter
    too) only reshaped. The kernels take the bytes and unpack while
    staging."""
    if not w_packed:
        return q.reshape(rows, -1)
    return ref.unpack4(q)[:rows]


def _row(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device
                           ).reshape(1, -1)


def _meta(name: str, v, N: int, device) -> tuple[torch.Tensor, int]:
    """A per-tensor or per-column f32 vector and its column stride."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if t.numel() not in (1, N):
        raise ValueError(f"{name} has {t.numel()} values; expected 1 or "
                         f"N={N}")
    check_operand(name, t, device)
    return t, (0 if t.numel() == 1 else 1)


def _optional(name, t, device, shape):
    if t is None:
        return None
    check_operand(name, t, device, shape)
    return t.data_ptr()


@functools.lru_cache(maxsize=1024)
def _device_f32(values: tuple, device: torch.device) -> torch.Tensor:
    """A cached float32 tensor of static calibration values on
    ``device``. The copy runs on the current stream, which is
    synchronised once so that a replica on another stream may read it."""
    t = torch.tensor(values, dtype=torch.float32, device=device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return t


@functools.lru_cache(maxsize=1024)
def _group_tile(x_scale: tuple, K: int, tk: int, w_packed: bool):
    """Align the K tiling to the per-group activation scales (copied
    from the JAX package's ``qmatmul.py:_group_tile``).

    ``x_scale`` is a static per-K-feature tuple. Returns (tk', sv) where
    every tk'-block of the K axis has a single scale — or (None, sv)
    when no usable even tile exists (the caller falls back to folding
    the scales into a float contraction, still one launch). Cached
    once per scale tuple: ``sv`` is read-only."""
    sv = np.asarray(x_scale, np.float32)
    sv.setflags(write=False)
    assert sv.size == K, (sv.size, K)
    runs, start = [], 0
    for i in range(1, K):
        if sv[i] != sv[i - 1]:
            runs.append(i - start)
            start = i
    runs.append(K - start)
    g = 0
    for r in runs:
        g = math.gcd(g, r)
    tk = math.gcd(min(tk, K), g)
    if w_packed and tk % 2:
        tk = 0
    return (tk if tk >= 8 else None), sv


def _scale_tuple(x_scale, K: int) -> tuple:
    xs = x_scale if isinstance(x_scale, tuple) else tuple(
        float(s) for s in x_scale)
    if len(xs) != K:
        raise ValueError(f"x_scale has {len(xs)} values; expected K={K}")
    return xs


def qmatmul(x: torch.Tensor, q: torch.Tensor, scale, zero,
            b: torch.Tensor | None = None, *, act: str = "identity",
            res: torch.Tensor | None = None, w_packed: bool = False,
            w_rows: int | None = None) -> torch.Tensor:
    """x: (M, K) float32; q: (K, N) int8 or int16 codes — or, with
    ``w_packed``, (ceil(K/2), N) packed-int4 bytes (``w_rows`` = logical
    K). scale/zero: per tensor or per column (N,). ``res``: optional
    (M, N) residual added after the activation. Returns (M, N) f32."""
    M, K, N = _check_shapes(x, q, w_packed, w_rows)
    if not x.is_cuda:
        return ref.qmatmul(x, _codes(q, K, w_packed), _row(scale, x.device),
                           _row(zero, x.device), b, act=act, res=res)
    code = act_code(act)
    dev = x.device
    check_operand("x", x, dev, (M, K))
    if w_packed:
        check_operand("q", q, dev, ((K + 1) // 2, N), (torch.int8,))
        kind = _PACKED
    else:
        check_operand("q", q, dev, (K, N), tuple(_CODE_KIND))
        kind = _CODE_KIND[q.dtype]
    s, ss = _meta("scale", scale, N, dev)
    z, zs = _meta("zero", zero, N, dev)
    bp = _optional("b", b, dev, (N,))
    rp = _optional("res", res, dev, (M, N))
    y = torch.empty((M, N), device=dev, dtype=torch.float32)
    check_operand("y", y, dev)
    bm, bn, _, splits = _plan(M, K, N, kind, sm_count(dev))
    # split K: the partial sums (splits, M, N), then the partial row sums
    # (splits, M), summed in split order by the kernel's second pass
    ws = torch.empty(splits * M * (N + 1), device=dev, dtype=torch.float32
                     ) if splits > 1 else None
    launch("repro_qmatmul_f32", dev, x.data_ptr(), q.data_ptr(), kind,
           s.data_ptr(), ss, z.data_ptr(), zs, bp, rp, y.data_ptr(), M, K,
           N, code, bm, bn, splits,
           None if ws is None else ws.data_ptr())
    qmatmul.launches.add()
    return y


qmatmul.launches = LaunchCounter()


def _check_a8(xq, q, w_packed, dev, M, K, N):
    check_operand("xq", xq, dev, (M, K), (torch.int8,))
    check_operand("q", q, dev, ((K + 1) // 2 if w_packed else K, N),
                  (torch.int8,))


def qmatmul_a8_grouped(xq: torch.Tensor, q: torch.Tensor, scale, zero,
                       b: torch.Tensor | None = None, *, x_scale,
                       act: str = "identity",
                       res: torch.Tensor | None = None,
                       w_packed: bool = False,
                       tk: int = 128) -> torch.Tensor:
    """Per-group activation scales: ``x_scale`` is a per-K-feature tuple
    whose runs align to a K tile of at least 8 (``_group_tile``);
    raises ``ValueError`` when they do not (``qmatmul_a8`` then takes
    the float kernel). Returns (M, N) f32.

    On a CUDA tensor: kernel #9 on the int8 tensor cores, exact int32
    sums a block of the aligned tile, each scaled into f32 in block
    order, with the tile, split and chunks of :func:`_plan_a8g`; ``xq``
    is read where it lies (any K, any byte offset)."""
    M, K, N = _check_shapes(xq, q, w_packed)
    xs = _scale_tuple(x_scale, K)
    if not xq.is_cuda:
        return ref.qmatmul_a8(xq, _codes(q, K, w_packed),
                              _row(scale, xq.device), _row(zero, xq.device),
                              _device_f32(xs, xq.device), b, act=act,
                              res=res)
    tkg, sv = _group_tile(xs, K, int(tk), bool(w_packed))
    if tkg is None:
        raise ValueError("the per-K scale runs share no K tile >= 8 "
                         "(even when packed)")
    code = act_code(act)
    dev = xq.device
    _check_a8(xq, q, w_packed, dev, M, K, N)
    sb = _device_f32(tuple(sv[::tkg].tolist()), dev)    # one per K block
    s, ss = _meta("scale", scale, N, dev)
    z, zs = _meta("zero", zero, N, dev)
    bp = _optional("b", b, dev, (N,))
    rp = _optional("res", res, dev, (M, N))
    y = torch.empty((M, N), device=dev, dtype=torch.float32)
    check_operand("y", y, dev)
    bm, bn, splits, per = _plan_a8g(M, K, N, tkg, sm_count(dev))
    # split K: the f32 partial sums (splits, M, N), then the partial row
    # sums (splits, M), summed in split order by the second pass
    ws = torch.empty(splits * M * (N + 1), device=dev, dtype=torch.float32
                     ) if splits > 1 else None
    launch("repro_qmatmul_a8_grouped", dev, xq.data_ptr(), q.data_ptr(),
           int(w_packed), sb.data_ptr(), tkg, s.data_ptr(), ss,
           z.data_ptr(), zs, bp, rp, y.data_ptr(), M, K, N, code, bm, bn,
           splits, per, None if ws is None else ws.data_ptr())
    qmatmul_a8_grouped.launches.add()
    return y


qmatmul_a8_grouped.launches = LaunchCounter()


def qmatmul_a8(xq: torch.Tensor, q: torch.Tensor, scale, zero,
               b: torch.Tensor | None = None, *, x_scale,
               act: str = "identity", res: torch.Tensor | None = None,
               w_packed: bool = False, tk: int = 128,
               pipeline: str = "grid") -> torch.Tensor:
    """xq: (M, K) int8 activation codes (``ref.quantize_activation`` at
    the node's calibrated ``x_scale``); q: (K, N) int8 codes — or, with
    ``w_packed``, (ceil(K/2), N) packed-int4 bytes; scale/zero: per
    tensor or per column (N,) weight metadata. Returns (M, N) f32.

    ``x_scale`` is static: a float (→ the int32 kernel, scale folded in
    its epilogue) or a per-K-feature tuple (→ the grouped kernel when
    its runs align to a K tile of ``tk``, else the float kernel on
    ``xq·s_k``; ``pipeline`` is not read there, as in the JAX package).
    ``pipeline``: with a float scale, ``"grid"`` launches #8 (a K
    slice staged through registers) and ``"double"`` #10 (K slices
    copied into three stages by ``cp.async``), both on the int8 tensor
    cores with the tile and split of :func:`_plan_a8`, bit-equal to each
    other; any other value raises ``ValueError``. ``xq`` is read where
    it lies: any K, any byte offset."""
    check_pipeline(pipeline)
    M, K, N = _check_shapes(xq, q, w_packed)
    grouped = not isinstance(x_scale, (int, float))
    if not xq.is_cuda:
        xs = _device_f32(_scale_tuple(x_scale, K), xq.device) \
            if grouped else float(x_scale)
        return ref.qmatmul_a8(xq, _codes(q, K, w_packed),
                              _row(scale, xq.device), _row(zero, xq.device),
                              xs, b, act=act, res=res)
    if grouped:
        xs = _scale_tuple(x_scale, K)
        tkg, _ = _group_tile(xs, K, int(tk), bool(w_packed))
        if tkg is None:
            # unalignable groups: fold the per-feature scales into the
            # activations and run the float contraction (one launch)
            sv = _device_f32(xs, xq.device).reshape(1, -1)
            # int8 x float32 promotes to float32 in one pass, the same
            # values as converting first
            return qmatmul(xq * sv, q, scale, zero, b, act=act, res=res,
                           w_packed=w_packed)
        return qmatmul_a8_grouped(xq, q, scale, zero, b, x_scale=xs,
                                  act=act, res=res, w_packed=w_packed,
                                  tk=tk)
    code = act_code(act)
    dev = xq.device
    _check_a8(xq, q, w_packed, dev, M, K, N)
    double = pipeline == "double"
    s, ss = _meta("scale", scale, N, dev)
    z, zs = _meta("zero", zero, N, dev)
    bp = _optional("b", b, dev, (N,))
    rp = _optional("res", res, dev, (M, N))
    y = torch.empty((M, N), device=dev, dtype=torch.float32)
    check_operand("y", y, dev)
    bm, bn, splits = _plan_a8(M, K, N, sm_count(dev))
    # split K: the int32 partial sums (splits, M, N), then the partial
    # row sums (splits, M), summed by the kernels' second pass
    ws = torch.empty(splits * M * (N + 1), device=dev, dtype=torch.int32
                     ) if splits > 1 else None
    launch("repro_qmatmul_a8_double" if double else "repro_qmatmul_a8",
           dev, xq.data_ptr(), q.data_ptr(), int(w_packed), s.data_ptr(),
           ss, z.data_ptr(), zs, float(x_scale), bp, rp, y.data_ptr(), M,
           K, N, code, bm, bn, splits, None if ws is None else ws.data_ptr())
    (qmatmul_a8.launches_double if double else qmatmul_a8.launches).add()
    return y


qmatmul_a8.launches = LaunchCounter()
qmatmul_a8.launches_double = LaunchCounter()
