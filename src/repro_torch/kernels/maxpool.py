"""SAME-padded NHWC max pool with an optional epilogue activation.

Replaces the Pallas kernel ``src/repro/kernels/maxpool.py:maxpool2d``.
On a CUDA tensor the wrapper launches ``csrc/maxpool.cu`` as :func:`_plan`
lays it out: overlapping windows (stride < k) from a halo'd tile staged in
shared memory and reduced separably, disjoint ones (stride >= k) as a
grid-stride stream of read-once loads; out-of-image taps count as
``finfo.min`` and NaN propagates, so the result is bit-equal to the plain
version. An empty result returns with no launch. On a CPU tensor it runs
:func:`repro_torch.kernels.ref.maxpool2d`. Bound on the H100: bytes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import ref
from ._build import LaunchCounter, act_code, check_operand, launch, sm_count

launches = LaunchCounter()
plain = ref.maxpool2d

OVERLAP, DISJOINT = 0, 1        # csrc/maxpool.cu enum Route
THREADS = 256                   # csrc/maxpool.cu kThreads
RESIDENT = 6                    # csrc/maxpool.cu kResident: disjoint blocks an SM
SMEM_LIMIT = 48 * 1024          # shared memory a block takes without opt-in
MAX_GRID_YZ = 65535             # CUDA's limit on gridDim.y and gridDim.z
SLAB_BYTES = 128                # a block's channels of one pixel
TILE_ROWS = (8, 4, 2, 1)        # output rows a block, largest first
TILES_PER_SM = 2                # overlap blocks the grid gives each SM


class Plan(NamedTuple):
    """A launch of ``csrc/maxpool.cu``: the route, float4 vectors or
    floats, the overlap route's tile (output rows ``th``, columns ``tw``,
    vectors of channels ``cs``; 0 on the disjoint route) and the grid."""
    route: int
    vec: int
    th: int
    tw: int
    cs: int
    gx: int
    gy: int
    gz: int


class PoolArgs(ctypes.Structure):
    """``csrc/maxpool.cu`` ``PoolArgs``: the shape, the output size, the
    SAME pads, the activation code and the :class:`Plan`, passed to the
    entry point as one pointer."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "N", "H", "W", "C", "k", "stride", "Ho", "Wo", "pad_top", "pad_left",
        "act", *Plan._fields)]

    def values(self) -> tuple:
        return tuple(getattr(self, name) for name, _ in self._fields_)


def smem_bytes(th: int, tw: int, cs: int, k: int, stride: int,
               vec: bool) -> int:
    """Shared memory of an overlap block: its input tile, (th-1)·s + k
    rows of (tw-1)·s + k pixels, and a column of row maxima a thread,
    (th-1)·s + k rows of tw pixels, each pixel ``cs`` vectors."""
    rows = (th - 1) * stride + k
    return rows * ((tw - 1) * stride + k + tw) * cs * (16 if vec else 4)


def _split(n: int, most: int) -> tuple[int, int]:
    """(pieces, size): ``n`` cut into the fewest pieces of at most
    ``most``, all but the last of one size."""
    pieces = -(-n // most)
    return pieces, -(-n // pieces)


def _layout(N: int, H: int, W: int, C: int, k: int, stride: int,
            aligned: bool, sms: int) -> Plan:
    vec = aligned and C % 4 == 0
    CV = C // 4 if vec else C
    Ho, Wo = -(-H // stride), -(-W // stride)
    if stride < k:
        slabs, cs = _split(CV, SLAB_BYTES // (16 if vec else 4))
        wtiles, tw = _split(Wo, THREADS // cs)
        # the smallest tile that fits: fewer columns first, then channels
        while smem_bytes(1, tw, cs, k, stride, vec) > SMEM_LIMIT and tw > 1:
            wtiles, tw = _split(Wo, max(1, tw // 2))
        while smem_bytes(1, tw, cs, k, stride, vec) > SMEM_LIMIT and cs > 1:
            slabs, cs = _split(CV, max(1, cs // 2))
        fits = []                   # (blocks, th, row tiles), largest th first
        for rows in TILE_ROWS:
            htiles, th = _split(Ho, min(rows, Ho))
            if smem_bytes(th, tw, cs, k, stride, vec) <= SMEM_LIMIT:
                fits.append((wtiles * slabs * htiles * N, th, htiles))
        filled = [f for f in fits if f[0] >= TILES_PER_SM * sms]
        pick = filled[0] if filled else max(fits, default=None)
        if pick is not None and pick[2] <= MAX_GRID_YZ and N <= MAX_GRID_YZ:
            _, th, htiles = pick
            return Plan(OVERLAP, int(vec), th, tw, cs, wtiles * slabs,
                        htiles, N)
    pairs = -(-N * Ho * Wo * CV // 2)       # a thread's round: two outputs
    rounds = -(-pairs // (THREADS * sms * RESIDENT))
    blocks = max(1, -(-pairs // (THREADS * rounds)))
    return Plan(DISJOINT, int(vec), 0, 0, 0, blocks, 1, 1)


def _plan(N: int, H: int, W: int, C: int, k: int, stride: int,
          x_ptr: int, y_ptr: int, sms: int) -> Plan:
    """The launch of a (N, H, W, C) input at ``k``×``k``/``stride`` from
    address ``x_ptr`` to ``y_ptr`` on a card of ``sms`` SMs.

    Float4 vectors when C % 4 == 0 and both pointers are 16-byte
    aligned, else floats. Overlapping windows (stride < k) take the
    overlap route: a slab of at most 128 bytes of each pixel's channels,
    as many output columns as keep a block within THREADS threads, and
    the most output rows of TILE_ROWS whose grid still gives every SM
    TILES_PER_SM blocks, so that one block's staging overlaps another's
    compares (else the rows that give the most blocks), within SMEM_LIMIT
    of shared memory. Disjoint windows (stride >= k),
    and an overlap whose smallest tile or whose grid does not fit, take
    the disjoint route: two output vectors a thread a round, walked
    grid-stride by a grid of at most one wave (RESIDENT blocks on every
    SM) that gives every thread the same number of rounds."""
    return _layout(N, H, W, C, k, stride, (x_ptr | y_ptr) % 16 == 0, sms)


@functools.lru_cache(maxsize=512)
def _launch_args(N: int, H: int, W: int, C: int, k: int, stride: int,
                 code: int, aligned: bool, sms: int) -> PoolArgs:
    """The entry point's integers: the shape, the SAME pads, the
    activation code and :func:`_plan`'s launch, cached by their key, so
    that a call's host issue pays one lookup and passes one pointer."""
    Ho, pad_top, _ = ref.same_pads(H, k, stride)
    Wo, pad_left, _ = ref.same_pads(W, k, stride)
    return PoolArgs(N, H, W, C, k, stride, Ho, Wo, pad_top, pad_left, code,
                    *_layout(N, H, W, C, k, stride, aligned, sms))


def maxpool2d(x: torch.Tensor, *, k: int = 2, stride: int | None = None,
              act: str = "identity") -> torch.Tensor:
    """x: (N, H, W, C) → (N, ceil(H/s), ceil(W/s), C)."""
    if not x.is_cuda:
        return plain(x, k=k, stride=stride, act=act)
    code = act_code(act)
    k = int(k)
    stride = int(stride or k)
    if k < 1 or stride < 1:
        raise ValueError(f"k={k}, stride={stride}: expected positive "
                         f"integers")
    dev = x.device
    check_operand("x", x, dev)
    N, H, W, C = x.shape
    y = torch.empty((N, -(-H // stride), -(-W // stride), C), device=dev,
                    dtype=torch.float32)
    if y.numel() == 0:
        return y
    xp, yp = x.data_ptr(), y.data_ptr()
    args = _launch_args(N, H, W, C, k, stride, code, (xp | yp) % 16 == 0,
                        sm_count(dev))
    launch("repro_maxpool2d_nhwc_f32", dev, xp, yp, ctypes.addressof(args))
    launches.add()
    return y
