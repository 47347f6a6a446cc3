"""Kernels #1 and #2 (``conv2d``, ``conv2d(pipeline="double")``) on the
TF32 tensor cores: their plan, their arithmetic, and, on a card, the
kernels against their plain version.

On the CPU: ``kernels.conv2d._plan`` at every conv launch shape of
yolov8n, yolov5n and yolov3-tiny at 640 and at 160 (batch 8, after the
default passes): its tiles come from the table the build compiles
(``CONV_TILES``), cover F with at most 25% waste where F >= 16, cut
K·K·C into whole non-empty slices, and fill 2 x 132 blocks (an H100
SXM's SMs) or split no further; the generated header equals the table;
and the three-term split of both operands into TF32 (hi and lo both
rounded to nearest), emulated in numpy, holds a seeded conv at a 3x3
head shape within 1e-5 of float64.

On the card (``-m gpu``; they skip without one): every tile x {res, no
res} x the activations on ragged shapes (C = 3 and C not a multiple of
4, F not a multiple of the tile, odd H and W, stride 2, K 1 and 3)
against ``ref.conv2d`` at atol = rtol = 1e-4 with cuDNN's TF32 off
(float32 sums in another order); #2 bit-equal to #1; split K bit-equal
over two launches.
"""
import functools
import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.core import codegen, passes
from repro_torch.kernels import _build
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import ref as tref
from repro_torch.models import yolo

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
ACTS = sorted(tref.ACTIVATIONS)
BATCH = 8
TILES = tconv.CONV_TILES
SLOTS = tconv._RESIDENT * tconv._H100_SMS
SOURCES = [f"{arch}@{img}" for arch in ("yolov8n", "yolov5n", "yolov3-tiny")
           for img in (640, 160)]


@functools.lru_cache(maxsize=None)
def _conv_shapes(source: str) -> tuple:
    """(M, K·K·C, F) of every conv launch of ``source`` (arch@img) after
    the default passes, batch 8: each is one #1 launch (#2 on path
    ``double``)."""
    arch, img = source.split("@")
    graph = passes.PassManager(passes.default_pipeline()).run(
        yolo.build(arch, int(img)).graph)
    out = set()
    for name in codegen.launch_nodes(graph):
        n = graph.nodes[name]
        if n.op == "conv":
            out.add((BATCH * n.geom("H") * n.geom("W"),
                     n.geom("K") ** 2 * n.geom("C"), n.geom("F")))
    return tuple(sorted(out))


@pytest.fixture(params=SOURCES)
def shapes(request):
    got = _conv_shapes(request.param)
    assert got, request.param
    return got


def _plans(shapes):
    for M, KKC, F in shapes:
        yield (M, KKC, F), tconv._plan(M, KKC, F)


# --------------------------------------------------------------------------
# the plan, on the CPU
# --------------------------------------------------------------------------

def test_plan_tiles_cover_f_within_a_quarter(shapes):
    for (M, KKC, F), (bm, bn, _) in _plans(shapes):
        assert (bm, bn) in TILES, (M, KKC, F, bm, bn)
        if F >= 16:
            assert -(-F // bn) * bn <= 1.25 * F, (M, KKC, F, bn)


def test_plan_chunks_are_whole_slices(shapes):
    bk = tconv._CONV_BK
    for (M, KKC, F), (_, _, splits) in _plans(shapes):
        k_tiles = -(-KKC // bk)
        assert 1 <= splits <= k_tiles, (M, KKC, F, splits)
        chunk = -(-k_tiles // splits) * bk      # features, whole slices
        # every chunk holds features: none empty, none past K·K·C
        assert (splits - 1) * chunk < KKC <= splits * chunk, (M, KKC, F)


def test_plan_fills_the_card_or_splits_no_further(shapes):
    for (M, KKC, F), (bm, bn, splits) in _plans(shapes):
        blocks = -(-M // bm) * -(-F // bn)
        if blocks >= SLOTS:
            assert splits == 1, (M, KKC, F)
        else:
            # enough blocks, or each chunk is one slice already
            assert blocks * splits >= SLOTS \
                or splits == -(-KKC // tconv._CONV_BK), (M, KKC, F, splits)


def test_plan_is_deterministic(shapes):
    first = list(_plans(shapes))
    tconv._plan.cache_clear()
    again = dict(_plans(list(reversed(shapes))))
    assert all(again[s] == p for s, p in first)


def test_plan_covers_every_builders_filters():
    """The three builders' F (16 to 1024, and the heads' 255) all find a
    tile within 25%."""
    fs = {F for s in SOURCES for _, _, F in _conv_shapes(s)}
    assert {16, 32, 64, 80, 128, 255, 256, 512, 1024} <= fs
    for F in fs:
        bn = tconv._plan(51200, 576, F)[1]
        assert -(-F // bn) * bn <= 1.25 * F, (F, bn)


@pytest.mark.parametrize("M,KKC,F,want", [
    (819200, 27, 16, (256, 16, 1)),       # the stem at 640
    (51200, 576, 64, (128, 64, 1)),       # 3x3 head at 80
    (51200, 64, 80, (128, 80, 1)),        # 1x1 class head at 80
    (3200, 2304, 64, (128, 64, 18)),      # 3x3 at 20
    (3200, 1152, 256, (64, 128, 5)),      # 3x3 s2 at 40, F 256
    (200, 2304, 64, (128, 64, 72)),       # 3x3 at 5 (fusion_off, 160)
])
def test_plan_at_the_named_cases(M, KKC, F, want):
    assert tconv._plan(M, KKC, F) == want


def test_plan_follows_the_cards_sm_count():
    """The split fills _RESIDENT blocks of each of the card's SMs: fewer
    SMs, fewer splits, on the same tile."""
    M, KKC, F = 3200, 2304, 64
    full = tconv._plan(M, KKC, F)
    small = tconv._plan(M, KKC, F, 66)
    assert small[:2] == full[:2] and small[2] < full[2]
    tiles = -(-M // small[0]) * -(-F // small[1])
    assert tiles * small[2] >= tconv._RESIDENT * 66


def test_plan_matches_the_compiled_table():
    """One table: the header the build writes for csrc/conv2d.cu
    instantiates exactly the plan's tiles and slice depth, and the
    library's hash follows it."""
    header = _build.generated_headers()["conv_tiles.h"]
    assert f"#define REPRO_CONV_BK {tconv._CONV_BK}\n" in header
    line = next(ln for ln in header.splitlines()
                if ln.startswith("#define REPRO_CONV_TILES "))
    assert line.split(" ", 2)[2] == " ".join(
        f"REPRO_CONV_TILE({bm}, {bn})" for bm, bn in TILES)
    assert len(set(TILES)) == len(TILES)
    # eight warps: min(8, BM / 16) along the pixels (16 rows each, or a
    # multiple), the rest along F (8 columns each, or a multiple)
    for bm, bn in TILES:
        wm = min(8, bm // 16)
        assert bm % (16 * wm) == 0 and bn % (8 * (8 // wm)) == 0, (bm, bn)
    src = (_build.CSRC / "conv2d.cu").read_text()
    assert '#include "conv_tiles.h"' in src and "REPRO_CONV_TILES" in src
    before = _build._source_hash()
    old = tconv.CONV_TILES
    try:
        tconv.CONV_TILES = old[:-1]
        assert _build._source_hash() != before
    finally:
        tconv.CONV_TILES = old
    assert _build._source_hash() == before


def test_split_scratch_is_one_slot_a_stream(monkeypatch):
    """Split K's partial sums go to one [lock, buffer] a (device, stream):
    the same slot for every call there, another for another stream or
    device, and one slot when many threads ask for it at once."""
    monkeypatch.setattr(_build, "_scratch", {})
    dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)
    slot = _build.scratch_slot(dev0, 11)
    assert _build.scratch_slot(dev0, 11) is slot and slot[1] is None
    assert _build.scratch_slot(dev0, 12) is not slot
    assert _build.scratch_slot(dev1, 11) is not slot
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda _: _build.scratch_slot(dev1, 5),
                            range(64)))
    assert all(g is got[0] for g in got) and len(_build._scratch) == 4


# --------------------------------------------------------------------------
# the split's arithmetic, on the CPU
# --------------------------------------------------------------------------

def _tf32(v: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from 0."""
    b = v.astype(np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's two terms: hi = tf32(v), and lo = tf32(v - hi), the
    remainder (exact in f32) rounded to TF32 as well."""
    hi = _tf32(v)
    return hi, _tf32(v.astype(np.float32) - hi)


def test_three_term_product_error_bound():
    """a·w - (a_hi·w_hi + a_hi·w_lo + a_lo·w_hi) is at most
    3·2^-22·|a·w| (the source's bound, to first order: the second-order
    terms are 2^-11 of it) over many binades."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(50000) * np.exp2(rng.integers(-40, 40, 50000))
         ).astype(np.float32)
    w = (rng.standard_normal(50000) * np.exp2(rng.integers(-40, 40, 50000))
         ).astype(np.float32)
    (ah, al), (wh, wl) = _split(a), _split(w)
    assert np.array_equal(_tf32(ah), ah) and np.array_equal(_tf32(al), al)
    got = (ah.astype(np.float64) * wh + ah.astype(np.float64) * wl
           + al.astype(np.float64) * wh)
    exact = a.astype(np.float64) * w.astype(np.float64)
    assert np.all(np.abs(got - exact)
                  <= 3 * 2.0 ** -22 * (1 + 2.0 ** -9) * np.abs(exact))


def _im2col(x: np.ndarray, K: int, stride: int) -> np.ndarray:
    """(N·Ho·Wo, K·K·C) windows of a SAME-padded NHWC input, k = (kh·K +
    kw)·C + c (the kernels' reduction order)."""
    N, H, W, C = x.shape
    Ho, pt, pb = tref.same_pads(H, K, stride)
    Wo, pl, pr = tref.same_pads(W, K, stride)
    xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    cols = [xp[:, kh:kh + stride * Ho:stride, kw:kw + stride * Wo:stride]
            for kh in range(K) for kw in range(K)]
    return np.concatenate(cols, axis=-1).reshape(N * Ho * Wo, K * K * C)


def test_three_term_split_conv_within_fp32():
    """A seeded conv at the 3x3 head shape (C = F = 64, K·K·C = 576),
    contracted as the kernels do: each k8 step's a_hi·w_hi products
    summed (exactly, as the MMA's products are), rounded to f32 and added
    to the running sum in f32; each 32-feature slice's cross terms
    a_hi·w_lo + a_lo·w_hi summed, rounded and added after its steps; then
    the bias: within 1e-5 of the float64 conv of the same float32 inputs,
    as close as a plain f32 sum in that order."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 11, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 64)) * 576 ** -0.5
         ).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    A, Wm = _im2col(x, 3, 1), w.reshape(576, 64)
    want = A.astype(np.float64) @ Wm.astype(np.float64) + b
    (ah, al), (wh, wl) = _split(A), _split(Wm)
    acc = np.zeros((A.shape[0], 64), np.float32)
    plain = np.zeros_like(acc)
    for k in range(0, 576, 8):
        s = slice(k, k + 8)
        acc += (ah[:, s].astype(np.float64) @ wh[s]).astype(np.float32)
        if k % 32 == 24:                # the slice's cross terms, last
            c = slice(k - 24, k + 8)
            acc += (ah[:, c].astype(np.float64) @ wl[c]
                    + al[:, c].astype(np.float64) @ wh[c]).astype(np.float32)
        plain += (A[:, s].astype(np.float64) @ Wm[s]).astype(np.float32)
    got = acc + b
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    err = np.abs(got - want).max()
    assert err <= 2 * np.abs(plain + b - want).max() + 1e-7, err


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds #1 and #2 "
                    "against their plain version there)")
    return torch.device("cuda", 0)


# (N, H, W, C, K, F, stride): C = 3 and C % 4 != 0 (4-byte staging), F
# not a multiple of any tile, odd H and W, stride 2, K 1 and 3
RAGGED = [(2, 7, 9, 3, 3, 5, 1), (1, 11, 6, 5, 3, 33, 2),
          (3, 5, 5, 16, 1, 80, 1), (2, 9, 9, 12, 3, 130, 2),
          (1, 13, 13, 64, 3, 17, 1), (2, 8, 7, 36, 3, 255, 1)]


def _operands(dev, N, H, W, C, K, F, stride, res, seed):
    rng = np.random.default_rng(seed)
    Ho, Wo = -(-H // stride), -(-W // stride)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((K, K, C, F)) * (K * K * C) ** -0.5
         ).astype(np.float32)
    b = (rng.standard_normal(F) * 0.1).astype(np.float32)
    r = rng.standard_normal((N, Ho, Wo, F)).astype(np.float32) if res \
        else None
    return [None if v is None else torch.from_numpy(v).to(dev)
            for v in (x, w, b, r)]


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("use_res", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_tile_matches_plain_on_the_card(cuda_device, monkeypatch, tile,
                                        use_res, act):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    for i, (shape, splits) in enumerate(itertools.product(RAGGED, (1, 3))):
        monkeypatch.setattr(tconv, "_plan",
                            lambda *a, sp=splits: (*tile, sp))
        x, w, b, res = _operands(cuda_device, *shape, use_res, i)
        kw = dict(stride=shape[-1], act=act, res=res)
        n1 = tconv.launches.value
        got = tconv.conv2d(x, w, b, **kw)
        assert tconv.launches.value == n1 + 1
        torch.testing.assert_close(got, tref.conv2d(x, w, b, **kw), **TOL,
                                   msg=lambda m: f"{shape} {splits}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_double_bit_equal_to_grid_on_the_card(cuda_device, monkeypatch,
                                              tile):
    for i, (shape, splits) in enumerate(itertools.product(RAGGED, (1, 4))):
        monkeypatch.setattr(tconv, "_plan",
                            lambda *a, sp=splits: (*tile, sp))
        x, w, b, res = _operands(cuda_device, *shape, i % 2 == 1, i)
        kw = dict(stride=shape[-1], act=ACTS[i % len(ACTS)], res=res)
        n2 = tconv.launches_double.value
        got = tconv.conv2d(x, w, b, pipeline="double", **kw)
        assert tconv.launches_double.value == n2 + 1
        grid = tconv.conv2d(x, w, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, grid), (shape, splits)


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", ["grid", "double"])
def test_split_k_bit_equal_on_the_card(cuda_device, monkeypatch, pipeline):
    """yolov8n's 3x3 at 20 (M 3200, K·K·C 2304, F 64) as planned (18
    splits) and at other splits: two launches give the same bits, every
    split within 1e-4 of the plain version."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, w, b, _ = _operands(cuda_device, 8, 20, 20, 256, 3, 64, 1, False, 3)
    want = tref.conv2d(x, w, b, act="silu")
    real = tconv._plan
    for splits in (None, 1, 7, 72):
        if splits is not None:
            monkeypatch.setattr(tconv, "_plan", lambda *a, sp=splits: (
                *real(*a)[:2], sp))
        first = tconv.conv2d(x, w, b, act="silu", pipeline=pipeline)
        again = tconv.conv2d(x, w, b, act="silu", pipeline=pipeline)
        torch.cuda.synchronize()
        assert torch.equal(first, again), splits
        torch.testing.assert_close(first, want, **TOL)


@pytest.mark.gpu
def test_split_scratch_grows_and_is_reused_on_the_card(cuda_device,
                                                      monkeypatch):
    """A small split, a larger one, the small again on one stream: each
    within 1e-4 of the plain version, the stream's scratch grown once to
    the larger split's (splits, M, F) and then reused."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(_build, "_scratch", {})
    small = _operands(cuda_device, 2, 9, 9, 64, 3, 64, 1, False, 5)[:3]
    large = _operands(cuda_device, 8, 20, 20, 256, 3, 64, 1, False, 6)[:3]
    stream = torch._C._cuda_getCurrentRawStream(cuda_device.index)
    sizes = []
    for x, w, b in (small, large, small):
        M, KKC = x.shape[0] * x.shape[1] * x.shape[2], 9 * x.shape[-1]
        splits = tconv._plan(M, KKC, 64, _build.sm_count(cuda_device))[2]
        assert splits > 1
        torch.testing.assert_close(tconv.conv2d(x, w, b, act="silu"),
                                   tref.conv2d(x, w, b, act="silu"), **TOL)
        buf = _build._scratch[(cuda_device.index, stream)][1]
        assert buf.numel() >= splits * M * 64
        sizes.append(buf)
    assert sizes[1] is sizes[2] and sizes[0] is not sizes[1]
