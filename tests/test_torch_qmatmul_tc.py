"""Kernel #7 (``qmatmul``) on the tensor cores: its plan, its arithmetic,
and, on a card, the kernel against its plain version.

On the CPU: ``kernels.qmatmul._plan`` at every #7 launch shape of the
compiled yolov8n at 640 (W8A16) and at 160 (``bits="mixed"``), and at
granite-3-8b's W8 linear shapes at M = 4 (a decode step of 4 rows) and
M = 2048 (a prefill): its tiles come from the four the build compiles
(``TILES``), cover N with at most 25% waste where N >= 16, cut K into
whole stages (even, for packed codes) with no empty chunk, and fill
2 x 132 blocks (an H100 SXM's SMs) or split no further; and the error
bound of the kernel's split of x into two TF32 terms, with the exactness
of int16 codes' two planes.

On the card (``-m gpu``; they skip without one): every (BM, BN)
instantiation x {int8, int16, packed int4} x {per tensor, per column}
on ragged shapes, against ``ref.qmatmul`` at atol = rtol = 1e-4 (float32
sums in another order); split K bit-equal over two launches and within
1e-5 of the unsplit kernel (the partials add in another order).
"""
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import codegen, passes
from repro_torch.core import quant as tq
from repro_torch.core.toolflow import CompileConfig
from repro_torch.kernels import _build
from repro_torch.kernels import qmatmul as tqmm
from repro_torch.kernels import ref as tref
from repro_torch.models import yolo

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
SPLIT_TOL = dict(atol=1e-5, rtol=1e-5)
ACTS = sorted(tref.ACTIVATIONS)
KINDS = {"int8": 0, "int16": 1, "int4": tqmm._PACKED}
BATCH = 8
CSRC = Path(tqmm.__file__).resolve().parent.parent / "csrc" / "qmatmul.cu"
TILES = tqmm.TILES
SLOTS = tqmm._RESIDENT * tqmm._H100_SMS


def _yolo_shapes(img: int, cfg: CompileConfig) -> set:
    """(M, K, N) of every conv launch of the rewritten yolov8n at
    ``img``, batch 8: each is one #7 launch on the quantized paths."""
    graph = passes.PassManager(cfg.pipeline()).run(
        yolo.build("yolov8n", img).graph)
    out = set()
    for name in codegen.launch_nodes(graph):
        n = graph.nodes[name]
        if n.op == "conv":
            out.add((BATCH * n.geom("H") * n.geom("W"),
                     n.geom("K") ** 2 * n.geom("C"), n.geom("F")))
    return out


def _granite_shapes(M: int) -> set:
    cfg = registry.get("granite-3-8b")
    d, hd = cfg.d_model, cfg.head_dim
    kn = {(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
          (cfg.n_heads * hd, d), (d, cfg.d_ff), (cfg.d_ff, d),
          (d, cfg.vocab)}
    return {(M, K, N) for K, N in kn}


SOURCES = {
    "yolov8n@640_w8a16": lambda: _yolo_shapes(
        640, CompileConfig(backend="quant", batch_size=BATCH)),
    "yolov8n@160_mixed": lambda: _yolo_shapes(
        160, CompileConfig(bits="mixed", batch_size=BATCH)),
    "granite_M4": lambda: _granite_shapes(4),
    "granite_M2048": lambda: _granite_shapes(2048),
}


@pytest.fixture(scope="module", params=sorted(SOURCES))
def shapes(request):
    got = sorted(SOURCES[request.param]())
    assert got, request.param
    return got


def _split_chunk(K: int, splits: int) -> int:
    """Features of each K chunk of a split, as the kernel cuts them
    (whole stages; the last chunk is cut at K)."""
    return -(-(-(-K // tqmm._BK)) // splits) * tqmm._BK


def _plans(shapes):
    for (M, K, N), (kname, kind) in itertools.product(shapes,
                                                      KINDS.items()):
        yield (M, K, N), kname, tqmm._plan(M, K, N, kind)


# --------------------------------------------------------------------------
# the plan, on the CPU
# --------------------------------------------------------------------------

def test_plan_tiles_cover_n_within_a_quarter(shapes):
    for (M, K, N), kname, (bm, bn, bk, _) in _plans(shapes):
        assert (bm, bn) in TILES, (M, K, N, kname, bm, bn)
        assert bk == tqmm._BK
        assert (bm == 16) == (M <= tqmm._SMALL_M)
        cols = -(-N // bn) * bn
        if N >= 16:
            assert cols <= 1.25 * N, (M, K, N, kname, bn)


def test_plan_chunks_are_whole_even_stages(shapes):
    for (M, K, N), kname, (bm, bn, bk, splits) in _plans(shapes):
        chunk = _split_chunk(K, splits)
        assert chunk % bk == 0 and chunk % 2 == 0, (M, K, N, chunk)
        # every chunk holds features: none empty, none past K
        assert (splits - 1) * chunk < K <= splits * chunk, (M, K, N, chunk)
        assert 1 <= splits <= -(-K // bk)


def test_plan_fills_the_card_or_splits_no_further(shapes):
    for (M, K, N), kname, (bm, bn, bk, splits) in _plans(shapes):
        blocks = -(-M // bm) * -(-N // bn)
        if blocks >= SLOTS:
            assert splits == 1, (M, K, N, kname)
        else:
            # enough blocks, or each chunk is one stage already
            assert blocks * splits >= SLOTS \
                or splits == -(-K // bk), (M, K, N, kname, splits)


def test_plan_is_deterministic(shapes):
    first = list(_plans(shapes))
    again = {(s, k): p for s, k, p in _plans(list(reversed(shapes)))}
    assert all(again[(s, k)] == p for s, k, p in first)


def test_plan_matches_the_compiled_table():
    """One table: the header the build writes for csrc/qmatmul.cu
    instantiates exactly the plan's four (BM, BN) and its K stage, and
    the library's hash follows it."""
    header = _build.generated_headers()["qmm_tiles.h"]
    assert f"#define REPRO_QMM_BK {tqmm._BK}\n" in header
    line = next(ln for ln in header.splitlines()
                if ln.startswith("#define REPRO_QMM_TILES "))
    assert line.split(" ", 2)[2] == " ".join(
        f"REPRO_TILE({bm}, {bn})" for bm, bn in TILES)
    assert len(set(TILES)) == len(TILES) <= 4
    src = CSRC.read_text()
    assert '#include "qmm_tiles.h"' in src and "REPRO_QMM_TILES" in src
    assert "qmatmul_f32_kernel" not in src
    before = _build._source_hash()
    old = tqmm.TILES
    try:
        tqmm.TILES = old[:-1]
        assert _build._source_hash() != before
    finally:
        tqmm.TILES = old
    assert _build._source_hash() == before


def test_plan_follows_the_cards_sm_count():
    """The split fills TC_RESIDENT blocks of each of the card's SMs:
    fewer SMs, fewer splits, on the same tiles."""
    M, K, N = 3200, 2304, 64
    full = tqmm._plan(M, K, N, 0)
    assert full == tqmm._plan(M, K, N, 0, tqmm._H100_SMS)
    small = tqmm._plan(M, K, N, 0, 66)
    assert small[:3] == full[:3] and small[3] < full[3]
    tiles = -(-M // small[0]) * -(-N // small[1])
    assert tiles * small[3] >= tqmm._RESIDENT * 66


@pytest.mark.parametrize("M,K,N,want", [
    (3200, 2304, 64, (128, 64, 32, 18)),      # yolov8n 3x3 at 20
    (4, 4096, 12800, (16, 128, 32, 5)),       # granite decode up
    (819200, 27, 16, (256, 16, 32, 1)),       # the stem
    (51200, 64, 80, (128, 32, 32, 1)),        # 1x1 class head at 80
])
def test_plan_at_the_named_cases(M, K, N, want):
    for kind in KINDS.values():
        assert tqmm._plan(M, K, N, kind) == want


def test_plan_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        tqmm._plan(64, 64, 64, 3)


# --------------------------------------------------------------------------
# the split's arithmetic, on the CPU
# --------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from 0."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the MMA reads of a TF32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two terms as the MMA reads them: hi = tf32(x), and
    the remainder x - hi (exact in f32) truncated to TF32."""
    hi = _tf32(x)
    return hi, _tf32_read(x - hi)


def _planes(codes: torch.Tensor) -> list[torch.Tensor]:
    """The B tiles the kernel contracts: the codes, or for int16 the
    planes 256·(code >> 8) and code & 255."""
    c = codes.to(torch.int32)
    if codes.dtype == torch.int16:
        return [(256 * (c >> 8)).to(torch.float32),
                (c & 255).to(torch.float32)]
    return [c.to(torch.float32)]


def test_tf32_split_error_bound():
    """x - hi is exact in f32 and, with lo its TF32 truncation (what the
    MMA reads), |x - hi - lo| <= 2^-21·|x| over many binades; the codes'
    planes are exact in TF32."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(20000) * np.exp2(
        rng.integers(-60, 60, 20000))).astype(np.float32))
    hi, lo = _split(x)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert torch.equal((x - hi).double(), x.double() - hi.double())
    r = (x.double() - hi.double() - lo.double()).abs()
    assert bool((r <= 2.0 ** -21 * x.double().abs()).all())
    codes = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    h, lw = _planes(codes)
    assert torch.equal(_tf32(h), h) and torch.equal(_tf32(lw), lw)
    assert torch.equal((h + lw).to(torch.int32), codes.to(torch.int32))
    assert float(h.abs().max()) <= 128 * 256 and float(lw.max()) <= 255
    c8 = torch.arange(-128, 128, dtype=torch.float32)
    assert torch.equal(_tf32(c8), c8)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds #7 against "
                    "its plain version there)")
    return torch.device("cuda", 0)


def _card_operands(dev, M, K, N, kind, per_col, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5
                          ).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(N) * 0.1).astype(np.float32))
    gran = dict(granularity="per_channel", axis=-1) if per_col \
        else dict(granularity="per_tensor")
    qt = tq.quantize(w, tq.QuantConfig(bits={"int8": 8, "int16": 16,
                                             "int4": 4}[kind],
                                       pack=kind == "int4", **gran))
    codes = tref.unpack4(qt.q)[:K] if kind == "int4" else qt.q
    return (x.to(dev), qt.q.to(dev), qt.scale.to(dev), qt.zero.to(dev),
            b.to(dev), codes.to(dev))


def _plain(x, codes, scale, zero, b, act, res):
    N = codes.shape[1]
    return tref.qmatmul(x, codes, scale.reshape(1, -1).expand(1, N),
                        zero.reshape(1, -1).expand(1, N), b, act=act,
                        res=res)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("per_col", [False, True])
def test_tile_matches_plain_on_the_card(cuda_device, monkeypatch, tile,
                                        kind, per_col):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(tqmm, "_plan", lambda *shape: (*tile, tqmm._BK,
                                                        1))
    for i, (M, K, N) in enumerate(itertools.product(
            (1, 4, 17, 130), (1, 27, 31, 2304), (1, 16, 20, 80, 130))):
        x, q, s, z, b, codes = _card_operands(cuda_device, M, K, N, kind,
                                              per_col, i)
        act = ACTS[i % len(ACTS)]
        res = torch.randn(M, N, device=cuda_device) if i % 2 else None
        n = tqmm.qmatmul.launches.value
        got = tqmm.qmatmul(x, q, s, z, b, act=act, res=res,
                           w_packed=kind == "int4")
        assert tqmm.qmatmul.launches.value == n + 1
        torch.testing.assert_close(got, _plain(x, codes, s, z, b, act, res),
                                   **TOL, msg=lambda m: f"{(M, K, N)}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("tile", [(128, 64), (16, 128)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_split_k_bit_equal_on_the_card(cuda_device, monkeypatch, kind,
                                       tile):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    M, K, N = (130, 2304, 80) if tile[0] == 128 else (4, 2304, 130)
    x, q, s, z, b, codes = _card_operands(cuda_device, M, K, N, kind, True,
                                          7)
    kw = dict(act="silu", w_packed=kind == "int4")
    outs = {}
    for splits in (1, 3, 11):
        monkeypatch.setattr(tqmm, "_plan", lambda *shape, sp=splits: (
            *tile, tqmm._BK, sp))
        first = tqmm.qmatmul(x, q, s, z, b, **kw)
        again = tqmm.qmatmul(x, q, s, z, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, again), splits
        outs[splits] = first
    for splits in (3, 11):
        torch.testing.assert_close(outs[splits], outs[1], **SPLIT_TOL)
    torch.testing.assert_close(outs[1], _plain(x, codes, s, z, b, "silu",
                                               None), **TOL)


@pytest.mark.gpu
def test_unaligned_x_on_the_card(cuda_device, monkeypatch):
    """K % 4 == 0 but x starts 4 bytes past a 16-byte boundary: the
    kernel stages x by 4-byte copies."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    M, K, N = 300, 64, 48
    x0, q, s, z, b, codes = _card_operands(cuda_device, M, K, N, "int8",
                                           True, 3)
    buf = torch.empty(M * K + 1, device=cuda_device)
    x = buf[1:].view(M, K)
    x.copy_(x0)
    assert x.data_ptr() % 16 and x.is_contiguous()
    got = tqmm.qmatmul(x, q, s, z, b, act="relu")
    torch.testing.assert_close(got, _plain(x0, codes, s, z, b, "relu", None),
                               **TOL)
    torch.testing.assert_close(got, tqmm.qmatmul(x0, q, s, z, b, act="relu"),
                               atol=0, rtol=0)
