"""Kernel #3 (``maxpool2d``) as redesigned for the H100: its plan, its
plain version against the JAX package, and, on a card, the kernel
against its plain version.

On the CPU: ``kernels.maxpool._plan`` takes the overlap route exactly
when stride < k (k in {1, 2, 3, 5, 7, 13}, stride in {1, 2, 3}) with a
tile within its thread and shared-memory limits and a grid that covers
the output; float4 vectors exactly when C % 4 == 0 and both pointers are
16-byte aligned; at SPPF's 8×20×20×128 a grid that fills 1, 78 or 132
SMs, and on the disjoint route never more than one wave; a window whose
smallest tile does not fit shared memory falls to the disjoint route.
The six pools of yolov3-tiny at 416 are those of the compiled graph.
The plain version is bit-equal to JAX's ``ref.maxpool2d`` and to the
Pallas kernel in interpret mode on reduced yolov3-tiny pools (odd H and
W, C in {6, 16}, the leaky-relu epilogue) and keeps NaN where they do
(2×2/s2, 2×2/s1, 5×5/s1); an empty batch returns the JAX shape with no
launch.

On the card (``-m gpu``; they skip without one): the kernel bit-equal to
its plain version over both routes and both vector widths (k > H, odd H
and W, C % 4 != 0, a view at an odd storage offset), every activation
(within #5's 1e-4 where the epilogue's formula rounds),
-inf and finfo.min inputs, NaN inputs (equal NaN positions: the earlier
kernel's fmaxf dropped them), the served shapes, two launches bit-equal,
a launch on a non-default stream, and every empty shape returning its
shape with no launch.
"""
import ctypes
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import maxpool as jpool
from repro.kernels import ref as jref
from repro_torch.core import codegen, passes
from repro_torch.kernels import maxpool as tpool
from repro_torch.kernels import ref as tref
from repro_torch.models import yolo

from _port_memory import release_memory  # noqa: F401

ACTS = sorted(tref.ACTIVATIONS)
KS = (1, 2, 3, 5, 7, 13)
STRIDES = (1, 2, 3)
SPPF = (8, 20, 20, 128)
# (input H, W, C, k, stride, act) of the six maxpool launches of
# yolov3-tiny at 416 after the default passes (batch 8 in chip_smoke.py)
V3T_POOLS = ((416, 416, 16, 2, 2, "leaky_relu"),
             (208, 208, 32, 2, 2, "leaky_relu"),
             (104, 104, 64, 2, 2, "leaky_relu"),
             (52, 52, 128, 2, 2, "leaky_relu"),
             (26, 26, 256, 2, 2, "identity"),
             (13, 13, 512, 2, 1, "leaky_relu"))
# reduced yolov3-tiny pools: (N, H, W, C, k, stride, act)
REDUCED_V3T = ((2, 13, 13, 16, 2, 2, "leaky_relu"),
               (2, 9, 11, 6, 2, 2, "leaky_relu"),
               (1, 7, 7, 16, 2, 1, "leaky_relu"),
               (2, 7, 5, 6, 2, 2, "identity"),
               (1, 5, 5, 6, 2, 1, "leaky_relu"))
NAN_WINDOWS = ((2, 2), (2, 1), (5, 1))
# epilogues the kernel computes exactly as the plain version does
EXACT_ACTS = ("identity", "none", "relu", "leaky_relu")


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _with_nans(seed, shape):
    """Seeded normal values with NaN at (0, 2, 3, 1) and at a random
    tenth of the other positions' first channel."""
    x = _np(seed, shape)
    x[0, 2, 3, 1] = np.nan
    mask = np.random.default_rng(seed + 1).random(shape[:3]) < 0.1
    x[..., 0][mask] = np.nan
    return x


def _covers(p, N, H, W, C, k, s):
    """The overlap plan's tile and grid cover the output exactly once."""
    CV = C // 4 if p.vec else C
    Ho, Wo = -(-H // s), -(-W // s)
    slabs = -(-CV // p.cs)
    assert 1 <= p.cs * p.tw <= tpool.THREADS
    assert p.gx == -(-Wo // p.tw) * slabs
    assert p.gy * p.th >= Ho > (p.gy - 1) * p.th
    assert p.gz == N
    assert tpool.smem_bytes(p.th, p.tw, p.cs, k, s, p.vec) \
        <= tpool.SMEM_LIMIT


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("s", STRIDES)
def test_plan_route_follows_the_window_overlap(k, s):
    for N, H, W, C in (SPPF, (2, 13, 13, 6), (1, 5, 4, 4), (3, 1, 1, 3)):
        p = tpool._plan(N, H, W, C, k, s, 4096, 8192, 132)
        if s < k:
            assert p.route == tpool.OVERLAP, (N, H, W, C)
            _covers(p, N, H, W, C, k, s)
        else:
            assert p.route == tpool.DISJOINT, (N, H, W, C)
            assert (p.th, p.tw, p.cs, p.gy, p.gz) == (0, 0, 0, 1, 1)
            assert 1 <= p.gx <= 132 * tpool.RESIDENT


@pytest.mark.parametrize("C", [3, 4, 6, 16])
@pytest.mark.parametrize("x_off,y_off", [(0, 0), (4, 0), (0, 8), (12, 12)])
def test_plan_vector_width(C, x_off, y_off):
    """float4 only where C % 4 == 0 and x and y both start on a 16-byte
    boundary (an offset view of the input is read one float at a
    time)."""
    for k, s in ((5, 1), (2, 2)):
        p = tpool._plan(2, 9, 7, C, k, s, 4096 + x_off, 8192 + y_off, 132)
        assert p.vec == int(C % 4 == 0 and x_off == y_off == 0)
        if p.route == tpool.OVERLAP:
            _covers(p, 2, 9, 7, C, k, s)


@pytest.mark.parametrize("sms", [1, 78, 132])
def test_plan_fills_the_card_at_sppf(sms):
    """The most rows a block, within shared memory, whose grid still
    gives every SM two blocks."""
    p = tpool._plan(*SPPF, 5, 1, 0, 0, sms)
    assert p.route == tpool.OVERLAP and p.vec == 1
    _covers(p, *SPPF, 5, 1)
    blocks = p.gx * p.gy * p.gz
    assert blocks >= sms
    for rows in tpool.TILE_ROWS:    # a taller tile: too large, or too few
        tiles = -(-20 // rows)
        if tiles < p.gy:
            th = -(-20 // tiles)
            assert p.gx * tiles * p.gz < tpool.TILES_PER_SM * sms or \
                tpool.smem_bytes(th, 20, 8, 5, 1, True) > tpool.SMEM_LIMIT
    if sms == 132:          # 4 slabs of 8 float4s, 10 row tiles of 2, 8 images
        assert p == tpool.Plan(tpool.OVERLAP, 1, 2, 20, 8, 4, 10, 8)


@pytest.mark.parametrize("sms", [1, 78, 132])
def test_disjoint_grid_is_at_most_one_wave(sms):
    """At most RESIDENT blocks an SM, each thread two outputs a round,
    and every thread the same number of rounds (the last partial)."""
    for H, W, C, k, s, _ in V3T_POOLS[:5] + ((80, 80, 64, 2, 2, None),):
        p = tpool._plan(8, H, W, C, k, s, 0, 0, sms)
        assert p.route == tpool.DISJOINT and p.vec == 1
        pairs = -(-8 * -(-H // s) * -(-W // s) * C // 4 // 2)
        assert 1 <= p.gx <= sms * tpool.RESIDENT
        rounds = -(-pairs // (p.gx * tpool.THREADS))
        assert (rounds - 1) * p.gx * tpool.THREADS < pairs
        assert pairs <= rounds * p.gx * tpool.THREADS
        # one block fewer would take another round
        assert p.gx == 1 or pairs > rounds * (p.gx - 1) * tpool.THREADS
    # yolov3-tiny's largest pool, 692,224 pairs of output float4s: a wave
    # of 792 blocks takes them in 4 rounds, which 676 blocks also do;
    # 8x80x80x64: one round of 400 blocks
    assert tpool._plan(8, 416, 416, 16, 2, 2, 0, 0, 132).gx == 676
    assert tpool._plan(8, 80, 80, 64, 2, 2, 0, 0, 132).gx == 400


def test_plan_falls_back_to_the_disjoint_route():
    """A window whose one-pixel tile exceeds shared memory (61×61 float4
    taps) streams from device memory instead; a window that fits after
    narrowing the tile stays on the overlap route."""
    assert tpool._plan(1, 100, 100, 4, 61, 1, 0, 0, 132).route \
        == tpool.DISJOINT
    p = tpool._plan(1, 100, 100, 64, 31, 1, 0, 0, 132)
    assert p.route == tpool.OVERLAP
    _covers(p, 1, 100, 100, 64, 31, 1)


def test_launch_args_are_the_plan_cached_by_shape_and_alignment():
    a = tpool._launch_args(*SPPF, 5, 1, 0, True, 132)
    hits = tpool._launch_args.cache_info().hits
    assert tpool._launch_args(*SPPF, 5, 1, 0, True, 132) is a
    assert tpool._launch_args.cache_info().hits == hits + 1
    # shape, output size, SAME pads (2 a side), the code, then the plan
    assert a.values() == (*SPPF, 5, 1, 20, 20, 2, 2, 0,
                          *tpool._plan(*SPPF, 5, 1, 4096, 8192, 132))
    assert tpool._launch_args(*SPPF, 5, 1, 0, False, 132).values()[11:] \
        == tpool._plan(*SPPF, 5, 1, 4100, 8192, 132)
    assert tpool._plan(*SPPF, 5, 1, 4100, 8192, 132).vec == 0


def test_pool_args_match_the_sources_struct():
    """``PoolArgs`` lists the C struct's int fields in its order (the
    entry point reads them through one pointer)."""
    src = (Path(tpool.__file__).parent.parent / "csrc" / "maxpool.cu"
           ).read_text()
    body = re.search(r"struct PoolArgs \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"\w+", body.replace("int", " "))
    assert tuple(names) == tuple(n for n, _ in tpool.PoolArgs._fields_)
    assert all(t is ctypes.c_int for _, t in tpool.PoolArgs._fields_)


def test_v3t_pools_are_the_compiled_graphs():
    graph = passes.PassManager(passes.default_pipeline()).run(
        yolo.build("yolov3-tiny").graph)
    got = []
    for name in codegen.launch_nodes(graph):
        n = graph.nodes[name]
        if n.op == "maxpool":
            H, W, C = graph.streams[n.inputs[0]].shape
            got.append((H, W, C, n.geom("K"), n.geom("stride"),
                        n.attrs.get("act", "identity")))
    assert tuple(got) == V3T_POOLS


# --------------------------------------------------------------------------
# the plain version against the JAX package, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("N,H,W,C,k,s,act", REDUCED_V3T)
def test_plain_bit_equal_to_jax_on_reduced_v3t_pools(N, H, W, C, k, s, act):
    x = _np(H * W + C, (N, H, W, C), 3.0)
    got = tpool.maxpool2d(torch.from_numpy(x), k=k, stride=s,
                          act=act).numpy()
    want = np.asarray(jref.maxpool2d(jnp.asarray(x), k=k, stride=s, act=act))
    pal = np.asarray(jpool.maxpool2d(jnp.asarray(x), k=k, stride=s, act=act,
                                     interpret=True))
    assert got.shape == (N, -(-H // s), -(-W // s), C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("k,s", NAN_WINDOWS)
def test_plain_keeps_nan_as_jax_does(k, s):
    """The same NaN positions, and the same values elsewhere, as JAX's
    oracle and its Pallas kernel (assert_array_equal takes NaN as equal
    to NaN)."""
    x = _with_nans(k * 10 + s, (1, 6, 6, 4))
    got = tpool.maxpool2d(torch.from_numpy(x), k=k, stride=s).numpy()
    want = np.asarray(jref.maxpool2d(jnp.asarray(x), k=k, stride=s))
    pal = np.asarray(jpool.maxpool2d(jnp.asarray(x), k=k, stride=s,
                                     interpret=True))
    assert np.isnan(got).any() and not np.isnan(got).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("k,s", [(2, 2), (5, 1)])
def test_empty_batch_matches_jax_without_a_launch(k, s):
    x = np.zeros((0, 5, 4, 8), np.float32)
    n = tpool.launches.value
    got = tpool.maxpool2d(torch.from_numpy(x), k=k, stride=s)
    want = np.asarray(jref.maxpool2d(jnp.asarray(x), k=k, stride=s))
    assert tuple(got.shape) == want.shape == (0, -(-5 // s), -(-4 // s), 8)
    assert tpool.launches.value == n


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds #3 against its "
                    "plain version there)")
    return torch.device("cuda", 0)


def _offset(t, off):
    """A contiguous copy of ``t`` starting ``off`` floats past a fresh
    (16-byte aligned) allocation of the card's memory."""
    buf = torch.empty(t.numel() + off, device=t.device)
    v = buf[off:].view(t.shape)
    v.copy_(t)
    return v


def _equal(got, want):
    """Bit-equal values, NaN where the plain version has NaN."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _check(x, k, s, act="identity"):
    """Two launches of the kernel (counted, bit-equal) against the plain
    version: bit-equal (NaN where it has NaN) under an exact epilogue,
    within #5's 1e-4 under one whose formula rounds."""
    n = tpool.launches.value
    got = tpool.maxpool2d(x, k=k, stride=s, act=act)
    again = tpool.maxpool2d(x, k=k, stride=s, act=act)
    torch.cuda.synchronize()
    assert tpool.launches.value == n + 2
    want = tref.maxpool2d(x, k=k, stride=s, act=act)
    _equal(again, got)
    if act in EXACT_ACTS:
        _equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("s", STRIDES)
def test_kernel_bit_equal_on_the_card(cuda_device, k, s):
    """Both routes (stride < k or not), float4 and float (C % 4, a view
    one float past an aligned start), k > H, odd H and W."""
    shapes = ((2, 13, 13, 16), (1, 7, 9, 6), (3, 5, 4, 8), (2, 20, 20, 128),
              (1, 1, 1, 4), (2, 3, 17, 3))
    for shape, off in itertools.product(shapes, (0, 1)):
        x = _offset(torch.randn(shape, device=cuda_device), off)
        _check(x, k, s)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("k,s", [(5, 1), (2, 1), (3, 2), (2, 2), (3, 3)])
def test_every_activation_on_the_card(cuda_device, act, k, s):
    for C in (16, 6):
        x = torch.randn(2, 11, 9, C, device=cuda_device) * 3
        _check(x, k, s, act)


@pytest.mark.gpu
@pytest.mark.parametrize("k,s", [(5, 1), (2, 2), (3, 2)])
def test_lowest_values_on_the_card(cuda_device, k, s):
    """-inf windows stay -inf inside the image and read finfo.min where
    the padding reaches them; finfo.min inputs stay finfo.min."""
    lo = torch.finfo(torch.float32).min
    for C in (8, 5):
        x = torch.randn(2, 9, 10, C, device=cuda_device)
        x[0] = -float("inf")
        x[1, :4] = lo
        x[1, 5:, :, 1] = -float("inf")
        _check(x, k, s)
        assert torch.isinf(tpool.maxpool2d(x, k=k, stride=s)).any()


@pytest.mark.gpu
@pytest.mark.parametrize("k,s", NAN_WINDOWS + ((3, 2), (3, 3)))
@pytest.mark.parametrize("C", [4, 16, 6])
def test_nan_on_the_card(cuda_device, k, s, C):
    """NaN propagates as in the plain version (``F.max_pool2d``): the
    earlier kernel's fmaxf returned the window's other taps instead."""
    x = torch.from_numpy(_with_nans(C, (2, 9, 11, C))).to(cuda_device)
    for act in ("identity", "leaky_relu", "relu"):
        _check(x, k, s, act)
        got = tpool.maxpool2d(x, k=k, stride=s, act=act)
        assert torch.isnan(got).any()


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,C,k,s,act", V3T_POOLS[-2:]
                         + ((20, 20, 128, 5, 1, "identity"),
                            (80, 80, 64, 2, 2, "leaky_relu")))
def test_served_shapes_on_the_card(cuda_device, H, W, C, k, s, act):
    x = torch.randn(8, H, W, C, device=cuda_device)
    _check(x, k, s, act)


@pytest.mark.gpu
@pytest.mark.parametrize("k,s", [(5, 1), (2, 2)])
def test_launch_on_a_non_default_stream(cuda_device, k, s):
    """The copy into x waits on the side stream behind a spin; a kernel
    that launched on any other stream would read x before the copy."""
    src = torch.randn(8, 20, 20, 64, device=cuda_device)
    x = torch.zeros_like(src)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        x.copy_(src)
        got = tpool.maxpool2d(x, k=k, stride=s)
    side.synchronize()
    assert torch.equal(got, tref.maxpool2d(src, k=k, stride=s))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(0, 5, 4, 8), (2, 0, 4, 8), (2, 5, 0, 8),
                                   (2, 5, 4, 0)])
def test_empty_operands_launch_nothing_on_the_card(cuda_device, shape):
    n = tpool.launches.value
    for k, s in ((2, 2), (5, 1)):
        got = tpool.maxpool2d(torch.zeros(shape, device=cuda_device), k=k,
                              stride=s)
        N, H, W, C = shape
        assert got.shape == (N, -(-H // s), -(-W // s), C) and got.is_cuda
    assert tpool.launches.value == n
