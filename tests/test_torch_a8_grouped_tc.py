"""Kernel #9 (``qmatmul_a8`` with per-K-block activation scales) on the
int8 tensor cores: its plan, the wrapper against the JAX package, and,
on a card, the kernel against its plain version and the int64
contraction.

On the CPU: ``kernels.qmatmul._plan_a8g`` at every #9 launch of the
compiled yolov8n at 160 (W8A8, per group of 16 channels: K blocks of 16,
27 at the stem) and at 640 (W4A8), and over a sweep of block widths tk:
its tiles come from those the build compiles (``A8G_TILES``) and cover N
with at most 25% waste where a compiled tile can, K is cut into whole
slices of ``_A8_BK`` features with no empty chunk, and every chunk
starts and ends at a block boundary (it folds whole blocks, in order);
it splits only where the tiles do not fill 2 x the card's SMs, and
follows the SM count. Then the port's ``qmatmul_a8`` with a per-K scale
tuple (on a CPU tensor, its plain version) against the JAX package's
``ops.qmatmul_a8`` with its Pallas kernel in interpret mode, at tk 8, 9,
16, 24, 48 and 128, int8 codes and, where tk is even, packed int4:
atol = rtol = 1e-4 (the plain version scales every feature, the Pallas
kernel every block's sum).

On the card (``-m gpu``; they skip without one): every tk against the
plain version within 1e-4, on every compiled tile and split; an exact
case (block scales alternating 1 and 2, unit weight scale, zero 0,
codes in [-8, 7], so every partial sum is an integer below 2^24)
bit-equal to the int64 contraction, split and unsplit; two launches
bit-equal; x at odd K and at byte offsets 1..3, launched on the caller's
own pointer; a launch on a non-default stream.
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
TKS = (8, 9, 16, 24, 48, 128)


def _group_scales(C: int, k: int, group: int = 16) -> tuple:
    """A per-K-feature scale tuple as the per-group path gives a conv of C
    input channels and k x k taps: one scale a group of ``group``
    channels (adjacent groups different), repeated for every tap in the
    im2col order (kh, kw, C)."""
    per_c = tuple(float(1 + c // group) for c in range(C))
    return per_c * (k * k)


def _grouped_launches(img: int, w_bits: int) -> set:
    """(M, K, N, tk) of every conv launch of yolov8n at ``img``, batch 8,
    at W``w_bits``A8 with per-group scales of 16 channels: each is one #9
    launch, its tk the one ``_group_tile`` aligns."""
    cfg = CompileConfig(backend="quant", w_bits=w_bits, a_bits=8,
                        batch_size=BATCH)
    graph = passes.PassManager(cfg.pipeline()).run(
        yolo.build("yolov8n", img).graph)
    out = set()
    for name in codegen.launch_nodes(graph):
        n = graph.nodes[name]
        if n.op != "conv":
            continue
        C, k = n.geom("C"), n.geom("K")
        K = k * k * C
        tk, _ = tqmm._group_tile(_group_scales(C, k), K, 128, w_bits == 4)
        if tk is not None:
            out.add((BATCH * n.geom("H") * n.geom("W"), K, n.geom("F"), tk))
    return out


SOURCES = {
    "yolov8n@160_w8a8_groups_of_16": lambda: _grouped_launches(160, 8),
    "yolov8n@640_w4a8_groups_of_16": lambda: _grouped_launches(640, 4),
    "tk_sweep": lambda: {(M, tk * r, N, tk) for tk in TKS
                         for r in (1, 3, 8, 37) for M in (200, 3200)
                         for N in (16, 64, 256)},
}


@pytest.fixture(scope="module", params=sorted(SOURCES))
def shapes(request):
    got = sorted(SOURCES[request.param]())
    assert got, request.param
    return got


def _chunks(K: int, per: int) -> list:
    """(first, end) features of each K chunk of ``per`` slices, as the
    kernel cuts them (the last chunk at K)."""
    step = per * tqmm._A8_BK
    return [(k, min(k + step, K)) for k in range(0, K, step)]


# --------------------------------------------------------------------------
# the plan, on the CPU
# --------------------------------------------------------------------------

def test_per_group_path_launches_are_grouped():
    """Every conv of the per-group W8A8 design at 160 takes #9: blocks of
    16 features, 27 at the stem (3 channels, one group)."""
    got = _grouped_launches(160, 8)
    assert {tk for *_, tk in got} == {16, 27}
    assert (BATCH * 80 * 80, 27, 16, 27) in got
    assert min(M for M, *_ in got) == BATCH * 5 * 5


def test_a8g_plan_tiles_cover_n_within_a_quarter(shapes):
    for M, K, N, tk in shapes:
        bm, bn, _, _ = tqmm._plan_a8g(M, K, N, tk)
        assert (bm, bn) in tqmm.A8G_TILES, (M, K, N, bm, bn)
        cols = -(-N // bn) * bn
        if any(-(-N // b) * b <= 1.25 * N for _, b in tqmm.A8G_TILES):
            assert cols <= 1.25 * N, (M, K, N, bn)
        else:
            assert cols == min(-(-N // b) * b for _, b in tqmm.A8G_TILES)


def test_a8g_plan_chunks_are_whole_and_none_empty(shapes):
    for M, K, N, tk in shapes:
        bm, bn, splits, per = tqmm._plan_a8g(M, K, N, tk)
        k_tiles = -(-K // tqmm._A8_BK)
        assert 1 <= per <= k_tiles
        assert (splits - 1) * per < k_tiles <= splits * per, (M, K, N, tk)
        assert len(_chunks(K, per)) == splits
        tiles = -(-M // bm) * -(-N // bn)
        if tiles >= SLOTS:
            assert splits == 1, (M, K, N, tk)
        # the partial sums' bytes stay below x's
        assert splits == 1 or splits * 4 * N <= K, (M, K, N, tk, splits)


def test_a8g_plan_chunks_fold_whole_blocks(shapes):
    """The tk each chunk sees: it starts and ends at a block boundary, so
    it folds whole blocks of tk features, and the chunks' blocks are all
    of K's, in order."""
    for M, K, N, tk in shapes:
        assert K % tk == 0
        _, _, splits, per = tqmm._plan_a8g(M, K, N, tk)
        blocks = []
        for first, end in _chunks(K, per):
            assert first % tk == 0 and end % tk == 0, (M, K, N, tk, per)
            blocks += range(first // tk, end // tk)
        assert blocks == list(range(K // tk)), (M, K, N, tk)


def test_a8g_plan_splits_short_m_where_blocks_allow():
    """The per-group path at 160 is mostly short M: with blocks of 16 a
    chunk can end at any slice, so those launches split as #8's would
    (up to its K / 4N cap); blocks of 9 in 576 features end on a slice
    boundary only at K, so that launch is not split."""
    assert tqmm._plan_a8g(200, 2304, 64, 16)[2] == 9 == 2304 // (4 * 64)
    assert tqmm._plan_a8g(3200, 576, 64, 9)[2] == 1
    # blocks of 48: chunks of whole 192-feature units (3 slices)
    _, _, splits, per = tqmm._plan_a8g(3200, 2304, 64, 48)
    assert splits > 1 and per % 3 == 0


def test_a8g_plan_is_deterministic(shapes):
    first = [tqmm._plan_a8g(*s) for s in shapes]
    tqmm._plan_a8g.cache_clear()
    assert [tqmm._plan_a8g(*s) for s in shapes] == first


def test_a8g_plan_follows_the_sm_count():
    """Fewer SMs, fewer slots to fill: the split shrinks, the tile
    stays."""
    M, K, N, tk = 800, 2304, 64, 16
    full = tqmm._plan_a8g(M, K, N, tk)
    assert full == tqmm._plan_a8g(M, K, N, tk, tqmm._H100_SMS)
    small = tqmm._plan_a8g(M, K, N, tk, 16)
    assert small[:2] == full[:2] and 1 < small[2] < full[2]
    tiles = -(-M // small[0]) * -(-N // small[1])
    assert tiles * small[2] >= tqmm._RESIDENT * 16


def test_a8g_plan_matches_the_compiled_table():
    """One table: the header the build writes for csrc/qmatmul.cu
    instantiates exactly #9's (BM, BN), and the library's hash follows
    it."""
    header = _build.generated_headers()["qmm_tiles.h"]
    line = next(ln for ln in header.splitlines()
                if ln.startswith("#define REPRO_A8G_TILES "))
    assert line.split(" ", 2)[2] == " ".join(
        f"REPRO_A8_TILE({bm}, {bn})" for bm, bn in tqmm.A8G_TILES)
    assert all(bn % 16 == 0 for _, bn in tqmm.A8G_TILES)
    src = (_build.CSRC / "qmatmul.cu").read_text()
    assert "REPRO_A8G_TILES" in src and "qmatmul_a8_grouped_kernel" not in src
    before = _build._source_hash()
    old = tqmm.A8G_TILES
    try:
        tqmm.A8G_TILES = old[:-1]
        assert _build._source_hash() != before
    finally:
        tqmm.A8G_TILES = old
    assert _build._source_hash() == before


@pytest.mark.parametrize("M,K,N,tk,want", [
    (51200, 576, 64, 16, (64, 64, 1, 9)),     # 3x3 head at 80 (640)
    (51200, 27, 16, 27, (256, 16, 1, 1)),     # the stem at 160
    (200, 2304, 64, 16, (64, 64, 9, 4)),      # shortest M, most K
    (200, 1152, 256, 16, (32, 128, 1, 18)),   # widest N
    (3200, 64, 80, 16, (128, 32, 1, 1)),      # class head at 160
    (3200, 576, 64, 9, (64, 64, 1, 9)),       # blocks of 9: no split
    (3200, 2304, 64, 128, (64, 64, 9, 4)),    # blocks of 128: even chunks
])
def test_a8g_plan_at_the_named_cases(M, K, N, tk, want):
    assert tqmm._plan_a8g(M, K, N, tk) == want


# --------------------------------------------------------------------------
# against the JAX package, on the CPU
# --------------------------------------------------------------------------

def _runs(K: int, tk: int) -> tuple:
    """A per-K scale tuple in runs of tk, adjacent runs different."""
    vals = (0.03, 0.06, 0.04, 0.08, 0.05, 0.02, 0.07)
    return tuple(vals[(k // tk) % len(vals)] for k in range(K))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("tk", TKS)
def test_qmatmul_a8_grouped_matches_jax(tk, kind):
    """The port's qmatmul_a8 with runs of tk and the caller's tile tk
    (so that ``_group_tile`` aligns blocks of exactly tk) against the
    JAX package's grouped Pallas kernel in interpret mode with the same
    tile."""
    packed = kind == "int4"
    if packed and tk % 2:
        pytest.skip("packed int4 blocks are even (a byte holds two rows)")
    K = tk * (5 if tk < 48 else 2)
    M, N = 19, 24
    sv = _runs(K, tk)
    assert tqmm._group_tile(sv, K, K, packed)[0] == tk
    rng = np.random.default_rng(tk * 10 + packed)
    qt = jq.quantize(jnp.asarray((rng.normal(size=(K, N)) * K ** -0.5
                                  ).astype(np.float32)),
                     jq.QuantConfig(bits=4 if packed else 8, pack=packed,
                                    granularity="per_channel", axis=-1))
    xq = rng.integers(-128, 128, size=(M, K)).astype(np.int8)
    b = (rng.normal(size=N) * 0.1).astype(np.float32)
    res = rng.normal(size=(M, N)).astype(np.float32)
    act = PALLAS_ACTS[tk % len(PALLAS_ACTS)]
    want = np.asarray(jops.qmatmul_a8(
        jnp.asarray(xq), qt.q, qt.scale, qt.zero, jnp.asarray(b),
        x_scale=sv, act=act, res=jnp.asarray(res), w_packed=packed,
        backend="interpret", tm=16, tk=K, tn=16))
    n9 = tqmm.qmatmul_a8_grouped.launches.value
    got = tqmm.qmatmul_a8(
        torch.from_numpy(xq), torch.from_numpy(np.array(qt.q)),
        torch.from_numpy(np.array(qt.scale)),
        torch.from_numpy(np.array(qt.zero)), torch.from_numpy(b),
        x_scale=sv, act=act, res=torch.from_numpy(res), w_packed=packed,
        tk=K)
    assert tqmm.qmatmul_a8_grouped.launches.value == n9   # the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds #9 against its "
                    "plain version there)")
    return torch.device("cuda", 0)


def _codes(rng, K, N, packed, lo=-128, hi=128):
    """(codes (K, N) int8, the operand: the codes or their packed
    bytes), the padding nibble of an odd K set to a nonzero value that
    the kernel must not read."""
    if not packed:
        c = rng.integers(lo, hi, (K, N)).astype(np.int8)
        return torch.from_numpy(c), torch.from_numpy(c)
    c = torch.from_numpy(rng.integers(max(lo, -8), min(hi, 8), (K, N)
                                      ).astype(np.int8))
    q = tq.pack_int4(c)
    if K % 2:
        q[-1] = q[-1] | 0x50
    return c, q


def _force(monkeypatch, tile, splits=1, per=None):
    """Plan every #9 launch with ``tile``; ``splits`` chunks of ``per``
    slices (per: the fewest that make ``splits`` chunks)."""
    def plan(M, K, N, tk, sms=tqmm._H100_SMS):
        k_tiles = -(-K // tqmm._A8_BK)
        p = per or -(-k_tiles // splits)
        return (*tile, -(-k_tiles // p), p)
    monkeypatch.setattr(tqmm, "_plan_a8g", plan)


def _grouped(xq, q, sv, s, z, b=None, packed=False, **kw):
    return tqmm.qmatmul_a8(xq, q, s, z, b, x_scale=sv, w_packed=packed,
                           tk=xq.shape[1], **kw)


def _plain(xq, codes, sv, s, z, b=None, **kw):
    dev = xq.device
    return tref.qmatmul_a8(xq, codes.to(dev), s.reshape(1, -1),
                           z.reshape(1, -1),
                           torch.tensor(sv, dtype=torch.float32, device=dev),
                           b, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", tqmm.A8G_TILES,
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("tk", TKS)
def test_tk_against_plain_on_the_card(cuda_device, monkeypatch, tk, kind,
                                      tile):
    packed = kind == "int4"
    if packed and tk % 2:
        pytest.skip("packed int4 blocks are even")
    for i, (M, r, N, splits) in enumerate(itertools.product(
            (1, 37, 300), (1, 3, 9), (16, 80, 130), (1, 2))):
        K = tk * r
        _force(monkeypatch, tile, splits)
        rng = np.random.default_rng(i)
        codes, q = _codes(rng, K, N, packed)
        xq = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
            np.int8)).to(cuda_device)
        sv = _runs(K, tk)
        s = torch.rand(N, device=cuda_device) * 0.01
        z = torch.randint(-3, 4, (N,), device=cuda_device).float()
        b = torch.randn(N, device=cuda_device)
        res = torch.randn(M, N, device=cuda_device) if i % 2 else None
        act = ACTS[i % len(ACTS)]
        n9 = tqmm.qmatmul_a8_grouped.launches.value
        got = _grouped(xq, q.to(cuda_device), sv, s, z, b, packed, act=act,
                       res=res)
        assert tqmm.qmatmul_a8_grouped.launches.value == n9 + 1
        want = _plain(xq, codes, sv, s, z, b, act=act, res=res)
        torch.testing.assert_close(
            got, want, **TOL, msg=lambda m: f"{(M, K, N, splits)}: {m}")


def _exact(rng, M, K, N, tk, packed, dev):
    """Codes in [-8, 7], block scales alternating 1 and 2, unit weight
    scale, zero 0: every partial sum is an integer below 2^24, so any
    order of the sums gives the int64 contraction's value exactly."""
    codes, q = _codes(rng, K, N, packed, -8, 8)
    xq = torch.from_numpy(rng.integers(-8, 8, (M, K)).astype(np.int8))
    sv = tuple(float(1 + (k // tk) % 2) for k in range(K))
    sk = torch.tensor(sv, dtype=torch.float64).to(torch.int64)
    want = ((xq.to(torch.int64) * sk) @ codes.to(torch.int64)
            ).to(torch.float32)
    return xq.to(dev), q.to(dev), sv, want


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("tk", TKS)
def test_exact_case_bit_equal_to_int64_on_the_card(cuda_device, monkeypatch,
                                                   tk, kind):
    packed = kind == "int4"
    if packed and tk % 2:
        pytest.skip("packed int4 blocks are even")
    M, N = 333, 80
    K = tk * 24
    rng = np.random.default_rng(tk)
    xq, q, sv, want = _exact(rng, M, K, N, tk, packed, cuda_device)
    one = torch.ones(1, device=cuda_device)
    nil = torch.zeros(1, device=cuda_device)
    got = _grouped(xq, q, sv, one, nil, packed=packed)     # the plan's
    assert torch.equal(got.cpu(), want)
    k_tiles = -(-K // tqmm._A8_BK)
    # unsplit, split, and chunks of one slice (inside a block unless tk
    # divides 64)
    for splits, per in ((1, None), (3, None), (k_tiles, 1)):
        _force(monkeypatch, (64, 64), splits, per)
        got = _grouped(xq, q, sv, one, nil, packed=packed)
        assert torch.equal(got.cpu(), want), (splits, per)


@pytest.mark.gpu
@pytest.mark.parametrize("tk", (9, 16, 128))
def test_two_launches_bit_equal_on_the_card(cuda_device, monkeypatch, tk):
    rng = np.random.default_rng(40 + tk)
    M, K, N = 2000, tk * 18, 64
    _, q = _codes(rng, K, N, False)
    xq = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)
                          ).to(cuda_device)
    sv = _runs(K, tk)
    s = torch.rand(N, device=cuda_device) * 0.01
    z = torch.randint(-3, 4, (N,), device=cuda_device).float()
    b = torch.randn(N, device=cuda_device)
    for splits in (1, 5):
        _force(monkeypatch, (64, 64), splits)
        first = _grouped(xq, q.to(cuda_device), sv, s, z, b, act="silu")
        again = _grouped(xq, q.to(cuda_device), sv, s, z, b, act="silu")
        assert torch.equal(first, again), splits


@pytest.mark.gpu
def test_odd_k_at_byte_offsets_uses_the_callers_x(cuda_device, monkeypatch):
    """x rows of 27, 45 and 54 bytes starting 1, 2 and 3 bytes into a
    buffer: the kernel launches on the caller's own pointer (no copy) and
    agrees with the plain version; its exact case is exact."""
    seen = []
    real = tqmm.launch

    def spy(fn, dev, *args):
        seen.append(args[0])
        return real(fn, dev, *args)
    monkeypatch.setattr(tqmm, "launch", spy)
    one = torch.ones(1, device=cuda_device)
    nil = torch.zeros(1, device=cuda_device)
    for (K, tk, packed), off in itertools.product(
            ((27, 9, False), (27, 27, False), (45, 15, False),
             (54, 18, True)), (1, 2, 3)):
        M, N = 333, 48
        rng = np.random.default_rng(K + off)
        xe, q, sv, want = _exact(rng, M, K, N, tk, packed, cuda_device)
        buf = torch.empty(M * K + off, dtype=torch.int8, device=cuda_device)
        xq = buf[off:].view(M, K)
        xq.copy_(xe)
        assert xq.data_ptr() % 16 and xq.is_contiguous()
        got = _grouped(xq, q, sv, one, nil, packed=packed)
        assert seen[-1] == xq.data_ptr()
        assert torch.equal(got.cpu(), want), (K, tk, off, packed)


@pytest.mark.gpu
def test_non_default_stream_on_the_card(cuda_device):
    rng = np.random.default_rng(5)
    M, K, N, tk = 4096, 576, 64, 16
    xq, q, sv, want = _exact(rng, M, K, N, tk, True, cuda_device)
    one = torch.ones(1, device=cuda_device)
    nil = torch.zeros(1, device=cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        got = _grouped(xq, q, sv, one, nil, packed=True)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_uncompiled_tile_raises_on_the_card(cuda_device, monkeypatch):
    """A plan outside A8G_TILES is refused by the launcher, and the
    wrapper raises: no fallback runs in its place."""
    assert (128, 80) not in tqmm.A8G_TILES
    _force(monkeypatch, (128, 80))
    rng = np.random.default_rng(9)
    xq, q, sv, _ = _exact(rng, 64, 64, 80, 16, False, cuda_device)
    one = torch.ones(1, device=cuda_device)
    nil = torch.zeros(1, device=cuda_device)
    n9 = tqmm.qmatmul_a8_grouped.launches.value
    with pytest.raises(RuntimeError, match="repro_qmatmul_a8_grouped"):
        _grouped(xq, q, sv, one, nil)
    assert tqmm.qmatmul_a8_grouped.launches.value == n9
