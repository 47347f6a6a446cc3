"""Kernels #8 (``qmatmul_a8``) and #10 (``qmatmul_a8(pipeline="double")``)
on the int8 tensor cores: their plan, the wrapper against the JAX
package, and, on a card, the kernels against the int64 contraction.

On the CPU: ``kernels.qmatmul._plan_a8`` at every A8 launch shape of the
compiled yolov8n at 640 (W4A8) and at 160 (W8A8), and at N from 1 to
300: its tiles come from those the build compiles (``A8_TILES``), cover
N with at most 25% waste where a compiled tile can, cut K into whole
slices of ``_A8_BK`` features (even, for packed codes) with no empty
chunk, split only where the tiles do not fill 2 x the card's SMs and
at most K / 4N ways, and follow the SM count. Then the port's
``qmatmul_a8`` (on a CPU tensor, its plain version) against the JAX
package's ``ops.qmatmul_a8`` with its Pallas kernel in interpret mode,
at K = 27 and 75 (no multiple of 16), N = 16 and 80, int8 and packed
int4 codes, per-tensor and per-column scales: atol = rtol = 1e-4 (the
same int32 sums, the scale folds about one ulp apart), both pipelines
equal.

On the card (``-m gpu``; they skip without one): every compiled tile
forced through the planner, both pipelines, int8 and packed int4, on
ragged shapes, the int32 accumulator (read through an identity
epilogue) bit-equal to the int64 contraction and the full epilogue
within 1e-4 of the plain version; a split K bit-equal to no split; an
odd K with x starting at every byte offset 1..3 of a buffer, launched on
the caller's own pointer; #10 bit-equal to #8; a launch on a
non-default stream; an offset view of x.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import ops as jops
from repro_torch.core import codegen, passes
from repro_torch.core import quant as tq
from repro_torch.core.toolflow import CompileConfig
from repro_torch.kernels import _build
from repro_torch.kernels import qmatmul as tqmm
from repro_torch.kernels import ref as tref
from repro_torch.models import yolo

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
BATCH = 8
SLOTS = tqmm._RESIDENT * tqmm._H100_SMS
ACTS = sorted(tref.ACTIVATIONS)
# Activations the Pallas kernel implements as the oracle does (its _act
# returns the identity for gelu).
PALLAS_ACTS = ("hardswish", "leaky_relu", "silu", "relu", "identity")


def _a8_shapes(img: int, w_bits: int) -> set:
    """(M, K, N) of every conv launch of yolov8n at ``img``, batch 8,
    at W``w_bits``A8: each is one #8 (or #10) launch."""
    cfg = CompileConfig(backend="quant", w_bits=w_bits, a_bits=8,
                        batch_size=BATCH)
    graph = passes.PassManager(cfg.pipeline()).run(
        yolo.build("yolov8n", img).graph)
    out = set()
    for name in codegen.launch_nodes(graph):
        n = graph.nodes[name]
        if n.op == "conv":
            out.add((BATCH * n.geom("H") * n.geom("W"),
                     n.geom("K") ** 2 * n.geom("C"), n.geom("F")))
    return out


SOURCES = {
    "yolov8n@640_w4a8": lambda: _a8_shapes(640, 4),
    "yolov8n@160_w8a8": lambda: _a8_shapes(160, 8),
    "N_1_to_300": lambda: {(M, K, N) for N in range(1, 301)
                           for M, K in ((4, 27), (3200, 2304))},
}


@pytest.fixture(scope="module", params=sorted(SOURCES))
def shapes(request):
    got = sorted(SOURCES[request.param]())
    assert got, request.param
    return got


def _chunk(K: int, splits: int) -> int:
    """Features of each K chunk, as the kernels cut them (whole slices;
    the last chunk is cut at K)."""
    return -(-(-(-K // tqmm._A8_BK)) // splits) * tqmm._A8_BK


# --------------------------------------------------------------------------
# the plan, on the CPU
# --------------------------------------------------------------------------

def test_a8_plan_tiles_cover_n_within_a_quarter(shapes):
    for M, K, N in shapes:
        bm, bn, _ = tqmm._plan_a8(M, K, N)
        assert (bm, bn) in tqmm.A8_TILES, (M, K, N, bm, bn)
        cols = -(-N // bn) * bn
        if any(-(-N // b) * b <= 1.25 * N for _, b in tqmm.A8_TILES):
            assert cols <= 1.25 * N, (M, K, N, bn)
        else:
            assert cols == min(-(-N // b) * b for _, b in tqmm.A8_TILES)


def test_a8_plan_chunks_are_whole_and_none_empty(shapes):
    for M, K, N in shapes:
        bm, bn, splits = tqmm._plan_a8(M, K, N)
        chunk = _chunk(K, splits)
        assert chunk % tqmm._A8_BK == 0 and chunk % 2 == 0
        assert (splits - 1) * chunk < K <= splits * chunk, (M, K, N, splits)
        tiles = -(-M // bm) * -(-N // bn)
        if tiles >= SLOTS:
            assert splits == 1, (M, K, N)
        # the partial sums' bytes stay below x's
        assert splits == 1 or splits * 4 * N <= K, (M, K, N, splits)


def test_a8_plan_is_deterministic(shapes):
    first = [tqmm._plan_a8(*s) for s in shapes]
    tqmm._plan_a8.cache_clear()
    assert [tqmm._plan_a8(*s) for s in shapes] == first


def test_a8_plan_matches_the_compiled_table():
    """One table: the header the build writes for csrc/qmatmul.cu
    instantiates exactly the plan's (BM, BN) and its K slice, and the
    library's hash follows it."""
    header = _build.generated_headers()["qmm_tiles.h"]
    assert f"#define REPRO_A8_BK {tqmm._A8_BK}\n" in header
    line = next(ln for ln in header.splitlines()
                if ln.startswith("#define REPRO_A8_TILES "))
    assert line.split(" ", 2)[2] == " ".join(
        f"REPRO_A8_TILE({bm}, {bn})" for bm, bn in tqmm.A8_TILES)
    assert all(bn % 16 == 0 for _, bn in tqmm.A8_TILES)
    src = (_build.CSRC / "qmatmul.cu").read_text()
    assert "REPRO_A8_TILES" in src and "m16n8k32.row.col.s32.s8.s8.s32" in src
    before = _build._source_hash()
    old = tqmm.A8_TILES
    try:
        tqmm.A8_TILES = old[:-1]
        assert _build._source_hash() != before
    finally:
        tqmm.A8_TILES = old
    assert _build._source_hash() == before


def test_a8_plan_follows_the_sm_count():
    """Fewer SMs, fewer slots to fill: the split shrinks, the tile
    stays."""
    M, K, N = 3200, 2304, 64
    full = tqmm._plan_a8(M, K, N)
    assert full == tqmm._plan_a8(M, K, N, tqmm._H100_SMS)
    small = tqmm._plan_a8(M, K, N, 16)
    assert small[:2] == full[:2] and 1 < small[2] < full[2]
    tiles = -(-M // small[0]) * -(-N // small[1])
    assert tiles * small[2] >= tqmm._RESIDENT * 16


@pytest.mark.parametrize("M,K,N,want", [
    (819200, 27, 16, (256, 16, 1)),       # the stem
    (204800, 144, 16, (256, 16, 1)),      # 3x3 + res at 160
    (51200, 576, 64, (128, 64, 1)),       # 3x3 head at 80
    (3200, 2304, 64, (128, 64, 9)),       # 3x3 at 20: split K
    (51200, 64, 80, (128, 80, 1)),        # 1x1 class head at 80
    (3200, 1152, 256, (64, 128, 1)),      # the widest N
    (51200, 288, 32, (256, 32, 2)),
])
def test_a8_plan_at_the_named_cases(M, K, N, want):
    assert tqmm._plan_a8(M, K, N) == want


# --------------------------------------------------------------------------
# against the JAX package, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("per_column", [False, True], ids=["tensor", "col"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("N", [16, 80])
@pytest.mark.parametrize("K", [27, 75])
def test_qmatmul_a8_matches_jax(K, N, kind, per_column):
    M = 21
    packed = kind == "int4"
    rng = np.random.default_rng(K * 1000 + N)
    gran = dict(granularity="per_channel", axis=-1) if per_column \
        else dict(granularity="per_tensor")
    qt = jq.quantize(jnp.asarray((rng.normal(size=(K, N)) * K ** -0.5
                                  ).astype(np.float32)),
                     jq.QuantConfig(bits=4 if packed else 8, pack=packed,
                                    **gran))
    xq = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    b = (rng.normal(size=N) * 0.1).astype(np.float32)
    res = rng.normal(size=(M, N)).astype(np.float32) if per_column else None
    act = PALLAS_ACTS[(K + N) % len(PALLAS_ACTS)]
    xs = 0.04
    want = np.asarray(jops.qmatmul_a8(
        jnp.asarray(xq), qt.q, qt.scale, qt.zero, jnp.asarray(b),
        x_scale=xs, act=act, res=None if res is None else jnp.asarray(res),
        w_packed=packed, backend="interpret", tm=16, tk=16, tn=16))

    def port(pipeline):
        return tqmm.qmatmul_a8(
            torch.from_numpy(xq), torch.from_numpy(np.array(qt.q)),
            torch.from_numpy(np.array(qt.scale)),
            torch.from_numpy(np.array(qt.zero)), torch.from_numpy(b),
            x_scale=xs, act=act,
            res=None if res is None else torch.from_numpy(res),
            w_packed=packed, pipeline=pipeline)
    got = port("grid")
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(port("double").numpy(), got.numpy())


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds #8 and #10 "
                    "against their plain versions there)")
    return torch.device("cuda", 0)


def _codes(rng, K, N, packed):
    """(codes (K, N) int8, the operand: the codes or their packed
    bytes), the padding nibble of an odd K set to a nonzero value that
    the kernels must not read."""
    if not packed:
        c = rng.integers(-128, 128, (K, N)).astype(np.int8)
        return torch.from_numpy(c), torch.from_numpy(c)
    c = torch.from_numpy(rng.integers(-8, 8, (K, N)).astype(np.int8))
    q = tq.pack_int4(c)
    if K % 2:
        q[-1] = q[-1] | 0x50
    return c, q


def _acc(xq, codes):
    """The int64 contraction, as float32 (exact below 2^24)."""
    return (xq.cpu().to(torch.int64) @ codes.to(torch.int64)
            ).to(torch.float32)


def _identity(xq, q, packed, pipeline):
    one = torch.ones(1, device=xq.device)
    nil = torch.zeros(1, device=xq.device)
    return tqmm.qmatmul_a8(xq, q, one, nil, x_scale=1.0, w_packed=packed,
                           pipeline=pipeline)


def _force(monkeypatch, tile, splits=1):
    monkeypatch.setattr(tqmm, "_plan_a8",
                        lambda *shape: (*tile, splits))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", tqmm.A8_TILES,
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("pipeline", ["grid", "double"])
def test_tile_bit_equal_to_int64_on_the_card(cuda_device, monkeypatch,
                                             tile, kind, pipeline):
    _force(monkeypatch, tile)
    packed = kind == "int4"
    for i, (M, K, N) in enumerate(itertools.product(
            (1, 37, 300), (1, 27, 64, 200), (5, 16, 80, 130))):
        rng = np.random.default_rng(i)
        codes, q = _codes(rng, K, N, packed)
        xq = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
            np.int8)).to(cuda_device)
        q = q.to(cuda_device)
        got = _identity(xq, q, packed, pipeline)
        torch.testing.assert_close(got.cpu(), _acc(xq, codes), atol=0,
                                   rtol=0, msg=lambda m: f"{(M, K, N)}: {m}")
        s = torch.rand(N, device=cuda_device) * 0.01
        z = torch.randint(-3, 4, (N,), device=cuda_device).float()
        b = torch.randn(N, device=cuda_device)
        res = torch.randn(M, N, device=cuda_device) if i % 2 else None
        act = ACTS[i % len(ACTS)]
        full = tqmm.qmatmul_a8(xq, q, s, z, b, x_scale=0.02, act=act,
                               res=res, w_packed=packed, pipeline=pipeline)
        want = tref.qmatmul_a8(xq, codes.to(cuda_device), s.reshape(1, -1),
                               z.reshape(1, -1), 0.02, b, act=act, res=res)
        torch.testing.assert_close(full, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("pipeline", ["grid", "double"])
def test_split_k_bit_equal_on_the_card(cuda_device, monkeypatch, kind,
                                       pipeline):
    packed = kind == "int4"
    M, K, N = 300, 1000, 80
    rng = np.random.default_rng(3)
    codes, q = _codes(rng, K, N, packed)
    xq = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)
                          ).to(cuda_device)
    q = q.to(cuda_device)
    s = torch.rand(N, device=cuda_device) * 0.01
    b = torch.randn(N, device=cuda_device)
    outs = {}
    for splits in (1, 3, 16):
        _force(monkeypatch, (128, 80), splits)
        outs[splits] = tqmm.qmatmul_a8(xq, q, s, torch.zeros(N, device=
                                       cuda_device), b, x_scale=0.01,
                                       act="silu", w_packed=packed,
                                       pipeline=pipeline)
        assert torch.equal(_identity(xq, q, packed, pipeline).cpu(),
                           _acc(xq, codes)), splits
    for splits in (3, 16):
        assert torch.equal(outs[splits], outs[1]), splits


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", ["grid", "double"])
def test_odd_k_at_byte_offsets_uses_the_callers_x(cuda_device, monkeypatch,
                                                  pipeline):
    """x rows of 27 and 75 bytes starting 1, 2 and 3 bytes into a buffer:
    the kernel launches on the caller's own pointer (no copy) and its
    sums are exact."""
    seen = []
    real = tqmm.launch

    def spy(fn, dev, *args):
        seen.append(args[0])
        return real(fn, dev, *args)
    monkeypatch.setattr(tqmm, "launch", spy)
    for K, off, packed in itertools.product((27, 75), (1, 2, 3),
                                            (False, True)):
        M, N = 333, 48
        rng = np.random.default_rng(K + off)
        codes, q = _codes(rng, K, N, packed)
        buf = torch.empty(M * K + off, dtype=torch.int8, device=cuda_device)
        xq = buf[off:].view(M, K)
        xq.copy_(torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
            np.int8)))
        assert xq.data_ptr() % 16 and xq.is_contiguous()
        got = _identity(xq, q.to(cuda_device), packed, pipeline)
        assert seen[-1] == xq.data_ptr()
        assert torch.equal(got.cpu(), _acc(xq, codes)), (K, off, packed)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_double_bit_equal_to_grid_on_the_card(cuda_device, kind):
    packed = kind == "int4"
    for i, (M, K, N) in enumerate(((819, 27, 16), (2000, 144, 16),
                                   (513, 576, 64), (300, 2304, 64),
                                   (700, 64, 80), (200, 1152, 256))):
        rng = np.random.default_rng(10 + i)
        _, q = _codes(rng, K, N, packed)
        xq = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
            np.int8)).to(cuda_device)
        q = q.to(cuda_device)
        s = torch.rand(N, device=cuda_device) * 0.01
        z = torch.randint(-3, 4, (N,), device=cuda_device).float()
        b = torch.randn(N, device=cuda_device)
        res = torch.randn(M, N, device=cuda_device)
        n8 = tqmm.qmatmul_a8.launches.value
        n10 = tqmm.qmatmul_a8.launches_double.value
        kw = dict(x_scale=0.03, act="hardswish", res=res, w_packed=packed)
        grid = tqmm.qmatmul_a8(xq, q, s, z, b, **kw)
        dbl = tqmm.qmatmul_a8(xq, q, s, z, b, pipeline="double", **kw)
        assert (tqmm.qmatmul_a8.launches.value,
                tqmm.qmatmul_a8.launches_double.value) == (n8 + 1, n10 + 1)
        assert torch.equal(dbl, grid), (M, K, N)


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", ["grid", "double"])
def test_non_default_stream_on_the_card(cuda_device, pipeline):
    rng = np.random.default_rng(5)
    M, K, N = 4096, 576, 64
    codes, q = _codes(rng, K, N, True)
    xq = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)
                          ).to(cuda_device)
    q = q.to(cuda_device)
    want = _identity(xq, q, True, pipeline)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        got = _identity(xq, q, True, pipeline)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), _acc(xq, codes))


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", ["grid", "double"])
def test_offset_view_of_x_on_the_card(cuda_device, pipeline):
    """Views into a larger x: rows 5.. of K = 144 (aligned rows, 720
    bytes in) and K = 64 rows starting 8 bytes into the buffer."""
    rng = np.random.default_rng(6)
    M, N = 1000, 32
    for K, start in ((144, 5 * 144), (64, 8)):
        codes, q = _codes(rng, K, N, False)
        buf = torch.from_numpy(rng.integers(-128, 128, (M + 8) * K).astype(
            np.int8)).to(cuda_device)
        xq = buf[start:start + M * K].view(M, K)
        assert xq.is_contiguous() and xq.data_ptr() == buf.data_ptr() + start
        got = _identity(xq, q.to(cuda_device), False, pipeline)
        assert torch.equal(got.cpu(), _acc(xq, codes)), K
