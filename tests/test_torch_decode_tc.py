"""Kernel #12 (``decode_attention``) as fixed-size shares of the live
cache: its plan, its arithmetic, and, on a card, the kernel against its
plain version.

On the CPU: ``kernels.decode_attention._plan`` at every chip_smoke.py
``DEC_CASES`` shape and at the decode shapes of granite-3-8b,
zamba2-1.2b and gemma2-2b (local and global layers): for every length
1..S, with and without a window, the grid's shares cover the live range
and the busy ones, ceil(live / L), tile it exactly; at most
``MAX_SHARES`` shares; shared memory within a block's 227 KB at D in
{64, 128, 256} x rep in {1, 2, 4, 8}; the plan deterministic, and above
``MIN_SHARE`` as long as a full cache's grid fills the card and a share
stays within ``SHARE_BYTES``. A numpy
emulation of the route (fixed-size shares; each share's steps dealt to
the warps, each warp an online softmax over its stages; the warps merged
in the block, then the shares in share order) holds seeded GQA cases
with a window and a softcap within 2e-5 of the JAX package's
``ref.decode_attention`` on the same numpy inputs, and gives exactly 0
on a row with no visible position; past S with a window (the window
starts at len - window, also past S) it holds within 2e-5 of the Pallas
kernel in interpret mode, 0 where nothing is visible.

On the card (``-m gpu``; they skip without one), each against
``ref.decode_attention`` at atol = rtol = 2e-5
(``KERNEL_TOL["decode_attention"]`` in chip_smoke.py): D in {36, 64,
128, 256} x rep in {1, 2, 4, 8} x window x softcap; lengths 0, 1, L - 1,
L, L + 1, 2L + 1, S and S + 9, with and without a window; lengths past
S + window (nothing visible: 0); 12 and 16 q heads a
kv head (two head groups); two launches bit-equal; a non-default stream;
the scratch grown and reused across two shapes; no host sync
(``torch.cuda.set_sync_debug_mode("error")``); the library's shared
memory equal to ``smem_bytes``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdec
from repro.kernels import ref as jref
from repro_torch.configs import registry
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ref as tref

TOL = 2e-5
SMEM_LIMIT = 232448             # bytes of shared memory an H100 block may take
NEG_INF = np.float32(-1e30)
f32 = np.float32
# chip_smoke.py's DEC_CASES: (B, S, Hq, Hkv, D, window)
DEC_SHAPES = {"granite_B4_S4096": (4, 4096, 32, 8, 128, None),
              "gemma2_D256_win512_cap50": (4, 4096, 8, 4, 256, 512),
              "zamba2_B4_S4096_D64": (4, 4096, 32, 32, 64, None)}


def _model_shapes():
    """(B, S, Hq, Hkv, D, window) of the served decode steps: 4 slots
    over a 4096 cache (chip_smoke.py's LM_BATCH, LM_CACHE), gemma2-2b's
    local layers with its window and its global ones without."""
    out = {}
    for name in ("granite-3-8b", "zamba2-1.2b", "gemma2-2b"):
        cfg = registry.get(name)
        wins = (cfg.window, None) if cfg.window else (None,)
        for w in wins:
            out[f"{name}_win{w}"] = (4, 4096, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim, w)
    return out


PLAN_SHAPES = {**DEC_SHAPES, **_model_shapes()}


def _live(n, S, window):
    """The visible range [lo, hi) of a row of length n: the positions
    below min(n, S) and, with a window, from n - window on (the Pallas
    kernel's and ``ref.decode_attention``'s rule, also for n > S);
    empty where lo >= hi."""
    hi = max(min(n, S), 0)
    lo = max(n - window, 0) if window else 0
    return lo, hi


# --------------------------------------------------------------------------
# the plan, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_plan_covers_every_length(name):
    """For every length 1..S + 1 and a few past S + window: the busy
    shares, ceil(live / L), fit the grid, and tile the live range
    [lo, hi) exactly, each but the last L positions (none where the
    range is empty); the grid is the fewest shares that cover the
    span."""
    B, S, Hq, Hkv, D, win = PLAN_SHAPES[name]
    L, shares = tdec._plan(S, win or 0, D, Hq // Hkv, B * Hkv)
    span = min(S, win) if win else S
    assert L >= tdec.MIN_SHARE and L & (L - 1) == 0
    assert shares == -(-span // L) <= tdec.MAX_SHARES
    for window in (win or 0, 0, 1, 7, L, L + 1):
        Lw, sw = tdec._plan(S, window, D, Hq // Hkv, B * Hkv)
        for n in [*range(1, S + 2), S + 9, S + window, S + window + 1]:
            lo, hi = _live(n, S, window)
            if lo >= hi:                    # nothing visible: no share
                assert window and n >= S + 1, (window, n)
                continue
            busy = -(-(hi - lo) // Lw)
            assert 1 <= busy <= sw, (window, n)
            starts = [lo + j * Lw for j in range(busy)]
            ends = [min(s + Lw, hi) for s in starts]
            assert starts[0] == lo and ends[-1] == hi
            assert all(e > s for s, e in zip(starts, ends))
            assert all(e - s == Lw for s, e in zip(starts[:-1], ends[:-1]))


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_plan_fills_the_card_at_a_full_cache(name):
    """Above ``MIN_SHARE``, a full cache's grid fills ``WAVES`` waves of
    an H100 and a share holds at most ``SHARE_BYTES`` of K and V; L
    doubled would break one of the two."""
    B, S, Hq, Hkv, D, win = PLAN_SHAPES[name]
    rep = Hq // Hkv
    L, shares = tdec._plan(S, win or 0, D, rep, B * Hkv)
    span = min(S, win) if win else S
    blocks = B * Hkv * -(-rep // tdec.head_block(rep))
    slots = tdec.WAVES * tdec.resident(D, rep) * _build.H100_SMS
    if L > tdec.MIN_SHARE:
        assert blocks * shares >= slots and L * 8 * D <= tdec.SHARE_BYTES
    if 2 * L < span:
        assert (blocks * -(-span // (2 * L)) < slots
                or 2 * L * 8 * D > tdec.SHARE_BYTES)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_shared_memory_fits_a_block(D, rep):
    assert tdec.smem_bytes(D, rep) <= SMEM_LIMIT
    assert tdec.resident(D, rep) >= 3


def test_plan_is_deterministic_and_at_the_named_shapes():
    shapes = [(S, w or 0, D, Hq // Hkv, B * Hkv)
              for B, S, Hq, Hkv, D, w in PLAN_SHAPES.values()]
    first = [tdec._plan(*s) for s in shapes]
    tdec._plan.cache_clear()
    assert [tdec._plan(*s) for s in reversed(shapes)][::-1] == first
    assert tdec._plan(4096, 0, 128, 4, 32) == (128, 32)      # granite
    assert tdec._plan(4096, 0, 64, 1, 128) == (256, 16)      # zamba2
    assert tdec._plan(4096, 512, 256, 2, 16) == (32, 16)     # gemma2 case
    # one row: the waves bind, and on fewer SMs the shares are longer;
    # a short cache, one share
    assert tdec._plan(4096, 0, 128, 4, 8) == (32, 128)
    assert tdec._plan(4096, 0, 128, 4, 8, 66) == (64, 64)
    assert tdec._plan(20, 0, 128, 4, 32) == (32, 1)


def test_head_block_and_row_slots():
    assert [tdec.head_block(r) for r in (1, 2, 3, 4, 5, 8, 9, 16)] == [
        1, 2, 4, 4, 8, 8, 8, 8]
    assert [tdec.row_slots(D) for D in (4, 36, 64, 68, 128, 132, 256)] == [
        16, 16, 16, 32, 32, 64, 64]


# --------------------------------------------------------------------------
# the route's arithmetic, emulated in numpy
# --------------------------------------------------------------------------

def _emulate(q, kc, vc, lens, *, window, softcap, scale, L):
    """The kernel's arithmetic in f32: per (row, kv head), the busy
    shares of L positions; each share's steps of PS positions dealt to
    the warps (step t to warp t mod WARPS), each warp an online softmax
    over its steps; the warps merged by their max; then the shares, in
    order, by theirs. 0 on a row with no visible position."""
    B, Hq, D = q.shape
    S, Hkv = kc.shape[1:3]
    rep = Hq // Hkv
    ps = tdec.SLOTS // tdec.row_slots(D)
    out = np.zeros(q.shape, f32)
    for b, hk in itertools.product(range(B), range(Hkv)):
        lo, hi = _live(int(lens[b]), S, window)
        if lo >= hi:                        # nothing visible: 0
            continue
        busy = -(-(hi - lo) // L)
        heads = slice(hk * rep, (hk + 1) * rep)
        qs = (q[b, heads] * f32(scale)).astype(f32)
        parts = []
        for j in range(busy):
            c0 = lo + j * L
            c1 = min(c0 + L, hi)
            steps = -(-(c1 - c0) // ps)
            warps = []
            for w in range(tdec.WARPS):
                m = np.full(rep, NEG_INF, f32)
                l = np.zeros(rep, f32)
                acc = np.zeros((rep, D), f32)
                for t in range(w, steps, tdec.WARPS):
                    pos = np.arange(c0 + t * ps, c0 + (t + 1) * ps)
                    vis = pos < c1
                    at = np.minimum(pos, S - 1)
                    s = (qs @ kc[b, at, hk].T).astype(f32)
                    if softcap:
                        s = (f32(softcap) * np.tanh(s / f32(softcap))
                             ).astype(f32)
                    s = np.where(vis, s, NEG_INF)
                    m_new = np.maximum(m, s.max(axis=1))
                    alpha = np.exp(m - m_new).astype(f32)
                    p = np.where(vis, np.exp(s - m_new[:, None]), f32(0)
                                 ).astype(f32)
                    l = (alpha * l + p.sum(axis=1)).astype(f32)
                    acc = (alpha[:, None] * acc + p @ vc[b, at, hk]
                           ).astype(f32)
                    m = m_new
                warps.append((m, l, acc))
            M = np.max([w[0] for w in warps], axis=0)
            e = [np.exp(w[0] - M).astype(f32) for w in warps]
            parts.append((M, sum(x * w[1] for x, w in zip(e, warps)),
                          sum(x[:, None] * w[2] for x, w in zip(e, warps))))
        M = np.max([p[0] for p in parts], axis=0)
        wts = [np.exp(p[0] - M).astype(f32) for p in parts]
        lsum = sum(w * p[1] for w, p in zip(wts, parts))
        acc = sum(w[:, None] * p[2] for w, p in zip(wts, parts))
        out[b, heads] = acc / np.maximum(lsum, f32(1e-30))[:, None]
    return out


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


# (B, S, Hq, Hkv, D, lengths, window, softcap): GQA at rep 1, 2 and 4
# with ragged lengths (1, a share's edges, the full cache and past it)
EMULATED = {
    "rep4_D128": (3, 200, 8, 2, 128, (1, 65, 230), None, None),
    "rep2_D256_window_softcap": (3, 160, 4, 2, 256, (2, 97, 160), 70, 50.0),
    "rep1_D64_window": (2, 230, 4, 4, 64, (31, 230), 100, None),
    "rep4_D36_softcap": (2, 120, 8, 2, 36, (33, 119), None, 5.0),
}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_route_within_2e5(case):
    B, S, Hq, Hkv, D, lens, win, cap = EMULATED[case]
    q, kc, vc = _inputs(len(case), B, S, Hq, Hkv, D)
    L = tdec._plan(S, win or 0, D, Hq // Hkv, B * Hkv)[0]
    assert -(-S // L) > 1                   # the shares' merge is exercised
    got = _emulate(q, kc, vc, lens, window=win, softcap=cap,
                   scale=1.0 / np.sqrt(D), L=L)
    want = np.asarray(jref.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(np.asarray(lens, np.int32)), window=win, softcap=cap))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_emulated_row_with_no_visible_position_is_zero():
    q, kc, vc = _inputs(9, 3, 100, 4, 2, 64)
    lens = (0, 40, -3)
    got = _emulate(q, kc, vc, lens, window=None, softcap=None, scale=0.125,
                   L=32)
    assert np.all(got[0] == 0) and np.all(got[2] == 0)
    want = np.asarray(jref.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(np.asarray(lens, np.int32)), scale=0.125))
    np.testing.assert_allclose(got[1], want[1], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [40, 7])
def test_emulated_past_s_with_a_window_matches_pallas(window):
    """Lengths past S with a window: the route's live range starts at
    len - window (not min(len, S) - window), as the Pallas kernel's
    does; where nothing is visible both give exactly 0."""
    B, S, Hq, Hkv, D = 8, 160, 4, 2, 64
    lens = (S - 1, S, S + 1, S + 9, S + window - 1, S + window,
            S + window + 23, 20)
    q, kc, vc = _inputs(window, B, S, Hq, Hkv, D)
    L = tdec._plan(S, window, D, Hq // Hkv, B * Hkv)[0]
    got = _emulate(q, kc, vc, lens, window=window, softcap=None,
                   scale=1.0 / np.sqrt(D), L=L)
    want = np.asarray(jdec.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(np.asarray(lens, np.int32)), window=window))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    for b, n in enumerate(lens):
        lo, hi = _live(n, S, window)
        if lo >= hi:
            assert np.all(got[b] == 0) and np.all(want[b] == 0)
        # the rule the route had before: the window from min(len, S)
        old_lo = max(min(n, S) - window, 0)
        assert (old_lo != lo) == (n > S)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds #12 against "
                    "its plain version there)")
    return torch.device("cuda", 0)


def _on(dev, seed, B, S, Hq, Hkv, D):
    return tuple(torch.from_numpy(a).to(dev)
                 for a in _inputs(seed, B, S, Hq, Hkv, D))


def _launch(q, kc, vc, lens, **kw):
    n = tdec.launches.value
    ln = torch.tensor(lens, dtype=torch.int32, device=q.device)
    got = tdec.decode_attention(q, kc, vc, ln, **kw)
    assert tdec.launches.value == n + 1
    return got, ln


def _check(got, q, kc, vc, ln, lens, **kw):
    """Within 2e-5 of the plain version; exactly 0 on a row with no
    visible position (where the plain version gives NaN)."""
    want = tref.decode_attention(q, kc, vc, ln, **kw)
    S = kc.shape[1]
    for b, n in enumerate(lens):
        lo, hi = _live(n, S, kw.get("window"))
        if lo >= hi:
            assert torch.equal(got[b], torch.zeros_like(got[b]))
        else:
            torch.testing.assert_close(got[b], want[b], atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [36, 64, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [None, 45])
@pytest.mark.parametrize("softcap", [None, 20.0])
def test_matches_plain_on_the_card(cuda_device, D, rep, window, softcap):
    q, kc, vc = _on(cuda_device, D + rep, 3, 300, 2 * rep, 2, D)
    lens = (1, 150, 300)
    kw = dict(window=window, softcap=softcap)
    got, ln = _launch(q, kc, vc, lens, **kw)
    _check(got, q, kc, vc, ln, lens, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("window", [None, 100])
def test_lengths_at_the_share_edges_on_the_card(cuda_device, D, window):
    """Lengths 0, 1, L - 1, L, L + 1, 2L + 1, S and S + 9, with and
    without a window (with one, the live range at S + 9 starts at
    len - window, as the plain version's window does)."""
    B, S, Hq, Hkv = 8, 700, 8, 2
    L = tdec._plan(S, window or 0, D, Hq // Hkv, B * Hkv,
                   _build.sm_count(cuda_device))[0]
    lens = (0, 1, L - 1, L, L + 1, S, S + 9, 2 * L + 1)
    q, kc, vc = _on(cuda_device, 11, B, S, Hq, Hkv, D)
    got, ln = _launch(q, kc, vc, lens, window=window)
    _check(got, q, kc, vc, ln, lens, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
def test_past_s_with_a_window_on_the_card(cuda_device, D):
    """Lengths past S with a window, some with nothing visible (0)."""
    B, S, Hq, Hkv, window = 8, 700, 8, 2, 100
    lens = (S + 1, S + 9, S + 50, S + window - 1, S + window,
            S + window + 37, 3 * S, S - 1)
    q, kc, vc = _on(cuda_device, 11, B, S, Hq, Hkv, D)
    got, ln = _launch(q, kc, vc, lens, window=window)
    _check(got, q, kc, vc, ln, lens, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
def test_two_launches_bit_equal_on_the_card(cuda_device, D):
    q, kc, vc = _on(cuda_device, 4, 4, 1000, 8, 2, D)
    lens = (1, 333, 999, 1000)
    kw = dict(window=500 if D == 256 else None,
              softcap=50.0 if D == 256 else None)
    first, ln = _launch(q, kc, vc, lens, **kw)
    again, _ = _launch(q, kc, vc, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    _check(first, q, kc, vc, ln, lens, **kw)


@pytest.mark.gpu
def test_non_default_stream_on_the_card(cuda_device):
    q, kc, vc = _on(cuda_device, 5, 4, 900, 16, 4, 128)
    lens = (900, 1, 450, 0)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    want, _ = _launch(q, kc, vc, lens)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        got = tdec.decode_attention(q, kc, vc, ln)
        again = tdec.decode_attention(q, kc, vc, ln)
    side.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    _check(got, q, kc, vc, ln, lens)


@pytest.mark.gpu
def test_scratch_grown_and_reused_on_the_card(cuda_device):
    stream = torch._C._cuda_getCurrentRawStream(cuda_device.index)
    small = _on(cuda_device, 6, 1, 100, 4, 2, 64)
    large = _on(cuda_device, 7, 4, 2000, 16, 2, 128)
    got, ln = _launch(*small, (77,))
    _check(got, *small, ln, (77,))
    slot = _build.scratch_slot(cuda_device, stream)
    first = slot[1]
    got, ln = _launch(*large, (2000, 5, 1999, 64))
    _check(got, *large, ln, (2000, 5, 1999, 64))
    grown = slot[1]
    L, shares = tdec._plan(2000, 0, 128, 8, 8, _build.sm_count(cuda_device))
    assert grown.numel() >= 4 * 16 * shares * (128 + 2)
    assert grown.numel() >= first.numel()
    got, ln = _launch(*small, (100,))
    _check(got, *small, ln, (100,))
    assert slot[1] is grown                 # reused, not made again


@pytest.mark.gpu
def test_no_host_sync_on_the_card(cuda_device):
    q, kc, vc = _on(cuda_device, 8, 4, 4096, 32, 8, 128)
    ln = torch.tensor((1, 700, 2048, 4096), dtype=torch.int32,
                      device=cuda_device)
    tdec.decode_attention(q, kc, vc, ln)        # built, opted in, scratch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tdec.decode_attention(q, kc, vc, ln)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check(got, q, kc, vc, ln, (1, 700, 2048, 4096))


@pytest.mark.gpu
def test_smem_bytes_match_the_library_on_the_card(cuda_device):
    _build.library()
    fn = _build._fns["repro_decode_smem_bytes"]
    for D, rep in itertools.product((4, 36, 64, 128, 132, 256),
                                    (1, 2, 3, 4, 8, 16)):
        assert fn(D, rep) == tdec.smem_bytes(D, rep), (D, rep)


@pytest.mark.gpu
def test_rep_above_a_block_on_the_card(cuda_device):
    """16 and 12 q heads a kv head: two head groups a kv head (the
    second one partly empty at 12)."""
    for rep in (16, 12):
        q, kc, vc = _on(cuda_device, rep, 2, 500, 2 * rep, 2, 128)
        lens = (499, 37)
        got, ln = _launch(q, kc, vc, lens, window=200)
        _check(got, q, kc, vc, ln, lens, window=200)
