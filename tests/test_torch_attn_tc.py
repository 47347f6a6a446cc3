"""Kernel #11 (``mha``) on the TF32 tensor cores: its plan, its
arithmetic, and, on a card, the kernel against its plain version.

On the CPU: ``kernels.attention._plan`` and ``ATTN_TILES`` at every head
width (shared memory within the 227 KB a block may take, BQ a multiple
of 16, BK of 8, the plan deterministic), and its split of the kv sweep,
only where the blocks would fill at most half of an H100 (128 queries
after 2048 keys), never at a prefill's shapes; the generated header equals the
table and the library's hash follows it; the key permutation of QKᵀ's B
fragment is one (each 8-key block covered once, and the score fragment
lands on P·V's A fragment in natural key order); and a numpy emulation of
the route (q·scale, K, V and P split into TF32 hi and lo, three products
a step summed in a fresh accumulator and added in f32, keys permuted
within each 8-key block, online softmax over BK-key tiles) holds seeded
causal GQA cases with a window and a softcap within 2e-5 of float64 and
of the JAX package's ``ref.mha`` on the same numpy inputs, and gives 0
on a row with no visible key.

On the card (``-m gpu``; they skip without one), each against
``ref.mha`` at atol = rtol = 2e-5 (``KERNEL_TOL["mha"]`` in
chip_smoke.py): every head width × {causal, full} × {window, none} ×
{softcap, none} at rep 1, 2, 4 and 8; ragged Tq and Tk; Tq < Tk; rows
with no visible key exactly 0; two launches bit-equal; the split sweep
at forced chunk counts (some chunks empty) and as planned; a tile the
build did not compile refused with a raise.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import ref as tref

from _port_memory import release_memory  # noqa: F401

TOL = 2e-5
HEAD_DIMS = tattn.HEAD_DIMS
SMEM_LIMIT = 232448             # bytes of shared memory an H100 block may take
NEG_INF = np.float32(-1e30)
# column c of an 8-key block of QKᵀ's B fragment holds key PI[c]; key r
# of a block lands in row SLOT[r] of its K block (csrc/attention.cu)
PI = [c // 2 + 4 * (c % 2) for c in range(8)]
SLOT = [2 * (r % 4) + r // 4 for r in range(8)]


# --------------------------------------------------------------------------
# the plan, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D", HEAD_DIMS)
def test_plan_tile_fits_a_block(D):
    bq, bk, stages, splits = tattn._plan(D)
    assert (bq, bk, stages) == tattn.ATTN_TILES[D] and splits == 1
    assert bq % 16 == 0 and bk % 8 == 0 and stages >= 2, (bq, bk, stages)
    assert tattn.smem_bytes(D, bq, bk, stages) <= SMEM_LIMIT
    # BQ / 16 row groups, two warps a group (each half the output columns)
    # at D = 256: at most 1024 threads, and a warp's columns whole
    # 32-column groups (8 n8 tiles of 4 adjacent accumulators)
    dw = 2 if D > 128 else 1
    assert 32 * bq // 16 * dw <= 1024 and (D // dw) % 32 == 0


def test_plan_covers_every_head_width_and_is_deterministic():
    assert sorted(tattn.ATTN_TILES) == sorted(HEAD_DIMS)
    shapes = [(D, *s) for D in HEAD_DIMS for s in (
        (1, 2048, 2048, 32), (1, 128, 2048, 32), (4, 509, 509, 8))]
    first = [tattn._plan(*s) for s in shapes]
    tattn._plan.cache_clear()
    assert [tattn._plan(*s) for s in reversed(shapes)][::-1] == first
    # two blocks of every tile an SM, by shared memory
    assert all(tattn.resident(D, *t) == 2
               for D, t in tattn.ATTN_TILES.items())


# (D, B, Tq, Tk, Hq) -> splits: the chip_smoke.py cases (granite-3-8b's
# prefill at 2048 and at 509, 128 queries after 2048 keys, gemma2-like
# D 256, zamba2-1.2b's prefill) and a short prompt with few tiles
@pytest.mark.parametrize("shape,splits", [
    ((128, 1, 2048, 2048, 32), 1), ((128, 1, 509, 509, 32), 1),
    ((128, 1, 128, 2048, 32), 5), ((256, 1, 1024, 1024, 8), 1),
    ((64, 1, 2048, 2048, 32), 1), ((128, 1, 128, 128, 32), 1)])
def test_plan_splits_the_sweep_only_at_short_tq(shape, splits):
    D, B, Tq, Tk, Hq = shape
    plan = tattn._plan(D, B, Tq, Tk, Hq)
    assert plan == (*tattn.ATTN_TILES[D], splits)
    bq, bk, stages, _ = plan
    blocks = -(-Tq // bq) * B * Hq
    slots = tattn.resident(D, bq, bk, stages) * tattn._H100_SMS
    if splits > 1:
        # the blocks fill at most half the card, the chunks fill it, and
        # each chunk holds at least MIN_SPLIT_TILES tiles
        assert 2 * blocks <= slots <= blocks * splits
        assert (-(-Tk // bk)) // splits >= tattn.MIN_SPLIT_TILES


def test_smem_bytes_at_the_named_tiles():
    """q_hi, q_lo (BQ rows of D floats), stages + 1 of K and of V (BK
    rows): at D = 256 a 64-key K plus V stage alone is 128 KB, so its
    tile is smaller; at D = 128 a 64-row, 16-key tile leaves room for two
    blocks an SM (228 KB, less 1 KB a block)."""
    assert tattn.smem_bytes(128, 64, 32, 2) == 4 * (2 * 64 * 128
                                                   + 3 * 2 * 32 * 128)
    assert 2 * 64 * 256 * 4 == 128 * 1024
    assert tattn.smem_bytes(256, 16, 64, 2) > SMEM_LIMIT
    assert 2 * (tattn.smem_bytes(128, 64, 16, 2) + 1024) <= 228 * 1024


def test_plan_matches_the_compiled_table():
    """One table: the header the build writes for csrc/attention.cu
    instantiates exactly the plan's tiles, and the library's hash follows
    it."""
    header = _build.generated_headers()["attn_tiles.h"]
    line = next(ln for ln in header.splitlines()
                if ln.startswith("#define REPRO_ATTN_TILES "))
    assert line.split(" ", 2)[2] == " ".join(
        f"REPRO_ATTN_TILE({D}, {bq}, {bk}, {st})"
        for D, (bq, bk, st) in sorted(tattn.ATTN_TILES.items()))
    src = (_build.CSRC / "attention.cu").read_text()
    assert '#include "attn_tiles.h"' in src and "REPRO_ATTN_TILES" in src
    before = _build._source_hash()
    old = tattn.ATTN_TILES
    try:
        tattn.ATTN_TILES = {**old, 64: (32, 32, 2)}
        assert _build._source_hash() != before
    finally:
        tattn.ATTN_TILES = old
    assert _build._source_hash() == before


def test_key_permutation_is_one():
    """PI covers each 8-key block once; the copy's row (the source's
    expression, over a 64-key tile) puts key PI[c] in row c; and lane t's
    score columns 2t, 2t + 1 (the m16n8k8 accumulator's) are keys t and
    t + 4, the columns of P·V's A fragment."""
    assert sorted(PI) == list(range(8)) and sorted(SLOT) == list(range(8))
    assert all(SLOT[PI[c]] == c for c in range(8))
    src = (_build.CSRC / "attention.cu").read_text()
    expr = "(r & ~7) | ((r & 3) << 1) | ((r >> 2) & 1)"
    assert expr in src
    rows = [(r & ~7) | ((r & 3) << 1) | ((r >> 2) & 1) for r in range(64)]
    assert sorted(rows) == list(range(64))
    assert rows == [8 * (r // 8) + SLOT[r % 8] for r in range(64)]
    for t in range(4):
        assert (PI[2 * t], PI[2 * t + 1]) == (t, t + 4)


# --------------------------------------------------------------------------
# the route's arithmetic, emulated in numpy on the CPU
# --------------------------------------------------------------------------

def _tf32(v: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from 0."""
    b = np.asarray(v, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _tf32(v)
    return hi, _tf32(np.asarray(v, np.float32) - hi)


def _three(ah, al, bh, bl) -> np.ndarray:
    """One step's fresh accumulator: a_hi·b_hi + a_hi·b_lo + a_lo·b_hi,
    the products exact, rounded once to f32."""
    f = np.float64
    return (ah.astype(f) @ bh.astype(f) + ah.astype(f) @ bl.astype(f)
            + al.astype(f) @ bh.astype(f)).astype(np.float32)


# the features of step s of a 32-feature slice: 8t + 2s (column t) and
# 8t + 2s + 1 (column t + 4)
STEPS = [[8 * t + 2 * s for t in range(4)] + [8 * t + 2 * s + 1
                                              for t in range(4)]
         for s in range(4)]


def _emulate(q, k, v, *, causal, window, softcap, scale, bq, bk):
    """The kernel's arithmetic over (b, q head, BQ-row q tile), in f32
    where it works in f32."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, _ = k.shape
    rep, off = Hq // Hkv, Tk - Tq
    out = np.zeros(q.shape, np.float32)
    f32 = np.float32
    for b, h in itertools.product(range(B), range(Hq)):
        qh, ql = _split(q[b, :, h] * f32(scale))
        kpad = np.zeros((Tk + bk, D), f32)
        vpad = np.zeros((Tk + bk, D), f32)
        kpad[:Tk], vpad[:Tk] = k[b, :, h // rep], v[b, :, h // rep]
        kh, kl = _split(kpad)
        vh, vl = _split(vpad)
        for q0 in range(0, Tq, bq):
            rows = np.arange(q0, min(q0 + bq, Tq))
            qi = (rows + off)[:, None]
            k_hi = min(Tk, rows[-1] + off + 1) if causal else Tk
            k_lo = max(0, q0 + off - window + 1) if window else 0
            m = np.full((len(rows), 1), NEG_INF, f32)
            l = np.zeros((len(rows), 1), f32)
            acc = np.zeros((len(rows), D), f32)
            for k0 in range(k_lo // bk * bk, max(k_hi, 0), bk):
                cols = np.concatenate([k0 + 8 * n + np.array(PI)
                                       for n in range(bk // 8)])
                s = np.zeros((len(rows), bk), f32)
                for sl in range(0, D, 32):
                    for feats in STEPS:
                        fs = [sl + x for x in feats]
                        s += _three(qh[rows][:, fs], ql[rows][:, fs],
                                    kh[cols][:, fs].T, kl[cols][:, fs].T)
                if softcap:
                    s = (f32(softcap) * np.tanh(s / f32(softcap))).astype(f32)
                vis = cols[None, :] < Tk
                if causal:
                    vis = vis & (cols[None, :] <= qi)
                if window:
                    vis = vis & (cols[None, :] > qi - window)
                s = np.where(vis, s, NEG_INF)
                m_new = np.maximum(m, s.max(axis=1, keepdims=True))
                p = np.where(vis, np.exp(s - m_new), f32(0)).astype(f32)
                alpha = np.exp(m - m_new).astype(f32)
                l = (alpha * l + p.sum(axis=1, keepdims=True)).astype(f32)
                m = m_new
                acc = (acc * alpha).astype(f32)
                for n in range(bk // 8):
                    # P's A fragment straight from the score columns:
                    # a0 = c0, a2 = c1 (keys t, t + 4 of the block)
                    blk = p[:, 8 * n:8 * n + 8][:, [0, 2, 4, 6, 1, 3, 5, 7]]
                    ph, pl = _split(blk)
                    keys = slice(k0 + 8 * n, k0 + 8 * n + 8)
                    acc += _three(ph, pl, vh[keys], vl[keys])
            out[b, rows, h] = acc * (f32(1) / np.maximum(l, f32(1e-30)))
    return out


def _exact(q, k, v, *, causal, window, softcap, scale):
    """Float64 attention of the same float32 inputs (NaN on a row with
    no visible key)."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1:3]
    kk = np.repeat(k.astype(np.float64), Hq // Hkv, axis=2)
    vv = np.repeat(v.astype(np.float64), Hq // Hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * scale
    if softcap:
        s = softcap * np.tanh(s / softcap)
    qi = np.arange(Tq)[:, None] + Tk - Tq
    ki = np.arange(Tk)[None, :]
    mask = np.ones((Tq, Tk), bool)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    s = np.where(mask, s, -np.inf)
    with np.errstate(invalid="ignore"):
        p = np.exp(s - s.max(axis=-1, keepdims=True))
        p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


def _inputs(seed, B, Tq, Tk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D)))


# (B, Tq, Tk, Hq, Hkv, causal, window, softcap): causal GQA with a window
# and a softcap, Tq < Tk and neither a multiple of a tile
EMULATED = {64: (1, 45, 83, 4, 2, True, 20, 5.0),
            128: (1, 37, 70, 4, 1, True, 33, 30.0),
            256: (1, 21, 50, 2, 1, True, 19, 50.0)}


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_emulated_route_within_2e5(D):
    B, Tq, Tk, Hq, Hkv, causal, win, cap = EMULATED[D]
    q, k, v = _inputs(D, B, Tq, Tk, Hq, Hkv, D)
    kw = dict(causal=causal, window=win, softcap=cap)
    scale = 1.0 / np.sqrt(D)
    bq, bk = tattn._plan(D)[:2]
    got = _emulate(q, k, v, scale=scale, bq=bq, bk=bk, **kw)
    exact = _exact(q, k, v, scale=scale, **kw)
    np.testing.assert_allclose(got, exact, atol=TOL, rtol=TOL)
    jax = np.asarray(jref.mha(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw))
    np.testing.assert_allclose(got, jax, atol=TOL, rtol=TOL)
    # as close to float64 as the JAX package's own f32 attention, or
    # within a small multiple of it
    assert np.abs(got - exact).max() <= 4 * np.abs(jax - exact).max() + 1e-6


def test_emulated_row_with_no_visible_key_is_zero():
    """Causal with Tq > Tk: queries before the first key see none; they
    come out 0 (the Pallas answer), the rest as float64 does."""
    q, k, v = _inputs(7, 1, 40, 24, 2, 1, 64)
    kw = dict(causal=True, window=None, softcap=None, scale=0.125)
    got = _emulate(q, k, v, bq=16, bk=16, **kw)
    assert np.all(got[:, :16] == 0)
    np.testing.assert_allclose(got[:, 16:], _exact(q, k, v, **kw)[:, 16:],
                               atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds #11 against "
                    "its plain version there)")
    return torch.device("cuda", 0)


def _on(dev, seed, B, Tq, Tk, Hq, Hkv, D):
    return tuple(torch.from_numpy(a).to(dev)
                 for a in _inputs(seed, B, Tq, Tk, Hq, Hkv, D))


def _launch(q, k, v, **kw):
    n = tattn.launches.value
    got = tattn.mha(q, k, v, **kw)
    assert tattn.launches.value == n + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("softcap", [None, 7.5])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_matches_plain_on_the_card(cuda_device, D, causal, window, softcap,
                                   rep):
    q, k, v = _on(cuda_device, rep, 2, 77, 93, 2 * rep, 2, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    torch.testing.assert_close(_launch(q, k, v, **kw),
                               tref.mha(q, k, v, **kw), atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("Tq,Tk", [(1, 1), (3, 17), (63, 65), (129, 250),
                                   (200, 201), (17, 300)])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_and_short_q_on_the_card(cuda_device, D, Tq, Tk, causal):
    """Tq and Tk not multiples of any tile, and Tq < Tk (queries at the
    end of the keys)."""
    q, k, v = _on(cuda_device, Tq + Tk, 1, Tq, Tk, 4, 2, D)
    kw = dict(causal=causal, window=None, softcap=None)
    torch.testing.assert_close(_launch(q, k, v, **kw),
                               tref.mha(q, k, v, **kw), atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_rows_with_no_visible_key_are_zero_on_the_card(cuda_device, D):
    """Causal with Tq > Tk: the first Tq - Tk queries see no key and give
    exactly 0; the rest agree with the plain version."""
    q, k, v = _on(cuda_device, 3, 2, 150, 70, 4, 2, D)
    got = _launch(q, k, v, causal=True)
    assert torch.equal(got[:, :80], torch.zeros_like(got[:, :80]))
    torch.testing.assert_close(got[:, 80:], tref.mha(q, k, v)[:, 80:],
                               atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_two_launches_bit_equal_on_the_card(cuda_device, D):
    q, k, v = _on(cuda_device, 4, 1, 300, 333, 8, 2, D)
    kw = dict(causal=True, window=100 if D == 256 else None,
              softcap=50.0 if D == 256 else None)
    first = _launch(q, k, v, **kw)
    again = _launch(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    torch.testing.assert_close(first, tref.mha(q, k, v, **kw), atol=TOL,
                               rtol=TOL)


@pytest.mark.gpu
def test_uncompiled_tile_is_refused_on_the_card(cuda_device, monkeypatch):
    q, k, v = _on(cuda_device, 5, 1, 16, 16, 2, 1, 64)
    monkeypatch.setattr(tattn, "_plan", lambda *a: (48, 24, 2, 1))
    n = tattn.launches.value
    with pytest.raises(RuntimeError, match="repro_mha_f32"):
        tattn.mha(q, k, v)
    assert tattn.launches.value == n


@pytest.mark.gpu
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("splits", [2, 3, 5, 64])
def test_split_sweep_on_the_card(cuda_device, monkeypatch, D, splits):
    """The kv sweep split into chunks (64: more chunks than tiles, so some
    are empty) and combined: within 2e-5 of the plain version, rows with
    no visible key 0, two launches bit-equal."""
    real = tattn._plan
    monkeypatch.setattr(tattn, "_plan",
                        lambda *a: (*real(*a)[:3], splits))
    q, k, v = _on(cuda_device, splits, 2, 40, 300, 8, 2, D)
    for kw in (dict(causal=True), dict(causal=False, window=70,
                                       softcap=20.0)):
        first = _launch(q, k, v, **kw)
        again = _launch(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
        torch.testing.assert_close(first, tref.mha(q, k, v, **kw),
                                   atol=TOL, rtol=TOL)
    q, k, v = _on(cuda_device, 3, 1, 150, 70, 4, 2, D)
    got = _launch(q, k, v, causal=True)
    assert torch.equal(got[:, :80], torch.zeros_like(got[:, :80]))
    torch.testing.assert_close(got[:, 80:], tref.mha(q, k, v)[:, 80:],
                               atol=TOL, rtol=TOL)


@pytest.mark.gpu
def test_planned_split_on_the_card(cuda_device):
    """128 queries after 2048 keys at granite-3-8b's heads: the plan
    splits the sweep on an H100; the result is the plain version's."""
    q, k, v = _on(cuda_device, 6, 1, 128, 2048, 32, 8, 128)
    plan = tattn._plan(128, 1, 128, 2048, 32, _build.sm_count(cuda_device))
    assert plan[3] > 1
    torch.testing.assert_close(_launch(q, k, v), tref.mha(q, k, v),
                               atol=TOL, rtol=TOL)


# (B, Tq, Tk, Hq, Hkv, D, causal) of the LM families' launches, cut in
# length: qwen3-moe's rep 8 (32/4), llama4-maverick's rep 5 (40/8) and
# llava-next's rep 7 (56/8), causal at D 128; seamless-m4t's
# cross-attention (64 queries over 1024 encoder rows) and encoder (1024
# both ways), non-causal at D 64.
FAMILY_CASES = {"qwen3_rep8": (1, 300, 300, 32, 4, 128, True),
                "llama4_rep5": (1, 300, 300, 40, 8, 128, True),
                "llava_rep7": (2, 200, 200, 56, 8, 128, True),
                "seamless_cross_Tq64_Tk1024": (2, 64, 1024, 16, 16, 64,
                                               False),
                "seamless_encoder_T1024": (1, 1024, 1024, 16, 16, 64,
                                           False)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_lm_family_shapes_on_the_card(cuda_device, case):
    B, Tq, Tk, Hq, Hkv, D, causal = FAMILY_CASES[case]
    q, k, v = _on(cuda_device, len(case), B, Tq, Tk, Hq, Hkv, D)
    kw = dict(causal=causal, window=None, softcap=None)
    torch.testing.assert_close(_launch(q, k, v, **kw),
                               tref.mha(q, k, v, **kw), atol=TOL, rtol=TOL)
