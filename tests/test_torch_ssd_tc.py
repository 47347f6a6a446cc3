"""Kernel #13 (``ssd_scan``) as the chunk-parallel SSD on the TF32 tensor
cores: its plan, its arithmetic, and, on a card, the kernel against its
plain version.

On the CPU: ``kernels.ssd_scan._plan`` at every ssd_scan launch of the
served mamba2-130m and zamba2-1.2b prefills (chip_smoke.py's
``SSM_PROMPTS``) and of chip_smoke.py's ``SSD_CASES`` (the chunks
covering T with the last one non-empty, no empty head tile, shared memory
within a block's 227 KB, deterministic, the heads a block the least of
pass 3's waves times a block's work on cards of 66, 132 and 264 SMs); the
generated header equals the table and the library's hash follows it; and
a numpy emulation of the route (per-chunk state contributions dS and
C·Bᵀ, the passing recurrence over the chunk states, the chunk outputs
with W's decay factored below the diagonal 16 x 16 blocks; every
product's operands split into TF32 hi and lo, three products a step in a
fresh accumulator, the steps added in f32) holds G = 2, h0, T below one
chunk, a ragged last chunk and T = 1 within 2e-5 of float64, and within 1e-3 of the JAX
package's ``ref.ssd_scan`` and of its Pallas ``ssd_scan`` in interpret
mode (the JAX package's own SSD kernel tolerance). JAX is imported only
inside those tests.

On the card (``-m gpu``; they skip without one), each against
``ref.ssd_chunked`` at atol = rtol = 1e-3 (``KERNEL_TOL["ssd_scan"]`` in
chip_smoke.py): G in {1, 2} x h0 x ragged T (T = 1 included); head
tiles that do not divide the group; two launches bit-equal; a
non-default stream; the scratch grown and reused; a head tile the build
did not compile refused with a raise; the library's shared memory sizes
equal to ``smem_bytes``; the wrapper's guards.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd

from _port_memory import release_memory  # noqa: F401

ROUTE_TOL = 2e-5                # the emulated route against float64
TOL = 1e-3                      # against the JAX oracle and Pallas kernel
SMEM_LIMIT = 232448             # bytes of shared memory an H100 block may take
# chip_smoke.py's SSM_PROMPTS (one prefill a prompt) and SSD_CASES
SSM_PROMPTS = (64, 160, 256, 512, 768, 1024, 1536, 2048)
SSD_CASES = {"mamba2_T2048": (1, 2048, 24, 64, 1, 128),
             "zamba2_T2048": (1, 2048, 64, 64, 1, 64),
             "mamba2_B4_T509_ragged": (4, 509, 24, 64, 1, 128),
             "mamba2_B2_T768_h0": (2, 768, 24, 64, 1, 128),
             "G2_T1024": (1, 1024, 24, 64, 2, 128)}


def _launch_shapes():
    """(Bt, T, H, P, G, N) of every ssd_scan launch of the served paths
    and of the SSD cases."""
    out = set(SSD_CASES.values())
    for arch in ("mamba2-130m", "zamba2-1.2b"):
        sc = registry.get(arch).ssm
        H = sc.n_heads
        for T in SSM_PROMPTS:
            out.add((1, T, H, sc.head_dim, sc.n_groups, sc.d_state))
    return sorted(out)


# --------------------------------------------------------------------------
# the plan, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", _launch_shapes(),
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_at_every_launch(shape):
    Bt, T, H, P, G, N = shape
    heads = tssd._plan(Bt, T, H, P, G, N)
    chunk = tssd.SSD_CHUNK
    nc = -(-T // chunk)
    assert 0 < T - (nc - 1) * chunk <= chunk        # last chunk non-empty
    rep = H // G
    assert 1 <= heads <= min(tssd.SSD_HEADS, rep)
    tiles = -(-rep // heads)
    assert rep - (tiles - 1) * heads >= 1           # no empty head tile
    assert all(b <= SMEM_LIMIT for b in tssd.smem_bytes(N))
    assert tssd.scratch_floats(Bt, T, H, G, N, P) == (
        (Bt * nc * H * N * P if nc > 1 else 0) + Bt * nc * H * chunk
        + Bt * nc * G * chunk * chunk)


def test_plan_is_deterministic_and_follows_the_sm_count():
    shapes = _launch_shapes()
    first = [tssd._plan(*s) for s in shapes]
    tssd._plan.cache_clear()
    assert [tssd._plan(*s) for s in reversed(shapes)][::-1] == first
    for (Bt, T, H, P, G, N), sms in itertools.product(shapes,
                                                     (66, 132, 264)):
        heads = tssd._plan(Bt, T, H, P, G, N, sms=sms)
        # the heads minimise pass 3's waves on that card times a block's
        # work (one head's worth of staging plus one a head)
        rep = H // G
        per_tile = Bt * -(-T // tssd.SSD_CHUNK) * G * -(-P // tssd.SSD_PT)
        slots = tssd.resident(N) * sms

        def cost(ht):
            return -(-per_tile * -(-rep // ht) // slots) * (1 + ht)
        assert cost(heads) == min(cost(ht) for ht in range(
            1, min(tssd.SSD_HEADS, rep) + 1))
    # the named cases on an H100 (two pass-3 blocks an SM at chunk 64),
    # and mamba2-130m's prefill at 2048 on a card of twice the SMs
    assert tssd._plan(1, 2048, 24, 64, 1, 128) == 6
    assert tssd._plan(1, 2048, 64, 64, 1, 64) == 8
    assert tssd._plan(1, 512, 24, 64, 1, 128) == 2
    assert tssd._plan(1, 1, 24, 64, 1, 128) == 1
    assert tssd._plan(1, 2048, 24, 64, 1, 128, sms=264) == 3
    assert tssd.resident(128) == tssd.resident(64) == 2


def test_smem_fits_at_the_widest_state():
    p1, p3 = tssd.smem_bytes(128)
    assert max(p1, p3) <= SMEM_LIMIT, (p1, p3)
    # pass 3 leaves room for two blocks an SM
    assert 2 * (p3 + 1024) <= tssd.SM_SMEM


def test_plan_matches_the_compiled_table():
    """One table: the header the build writes for csrc/ssd_scan.cu
    instantiates the wrapper's chunk, with its head and P tile limits,
    and the library's hash follows it."""
    header = _build.generated_headers()["ssd_tiles.h"]
    lines = dict(ln.split(" ", 2)[1:] for ln in header.splitlines()
                 if ln.startswith("#define "))
    assert int(lines["REPRO_SSD_CHUNK"]) == tssd.SSD_CHUNK
    assert int(lines["REPRO_SSD_HEADS"]) == tssd.SSD_HEADS
    assert int(lines["REPRO_SSD_PT"]) == tssd.SSD_PT
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    assert '#include "ssd_tiles.h"' in src
    assert "launch_chunked<REPRO_SSD_CHUNK>" in src
    # the serial kernel is gone
    assert "ssd_scan_kernel" not in src and "dot4" not in src
    before = _build._source_hash()
    old = tssd.SSD_CHUNK
    try:
        tssd.SSD_CHUNK = 128
        assert _build._source_hash() != before
    finally:
        tssd.SSD_CHUNK = old
    assert _build._source_hash() == before


# --------------------------------------------------------------------------
# the route's arithmetic, emulated in numpy on the CPU
# --------------------------------------------------------------------------

F32 = np.float32


def _tf32(v: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from 0."""
    b = np.asarray(v, F32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def _split(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _tf32(v)
    return hi, _tf32(np.asarray(v, F32) - hi)


def _mma3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (..., M, K) · b (..., K, N) by the route: both split into hi and
    lo, each 8-wide step of K one fresh accumulator of a_hi·b_hi +
    a_hi·b_lo + a_lo·b_hi (exact products, rounded once to f32), the
    steps added in order in f32."""
    ah, al = (t.astype(np.float64) for t in _split(a))
    bh, bl = (t.astype(np.float64) for t in _split(b))
    out = np.zeros(a.shape[:-1] + b.shape[-1:], F32)
    for k in range(0, a.shape[-1], 8):
        s = slice(k, k + 8)
        step = (ah[..., s] @ bh[..., s, :] + ah[..., s] @ bl[..., s, :]
                + al[..., s] @ bh[..., s, :])
        out = out + step.astype(F32)
    return out


def _emulate(x, dt, A, B, C, h0, chunk):
    """The kernel's three passes on one batch row, in f32 where it works
    in f32: x (T, H, P), dt (T, H), B, C (T, G, N), h0 (H, N, P) or None.
    Returns (y, final state)."""
    T, H, P = x.shape
    G, N = B.shape[1:]
    rep = H // G
    nc = -(-T // chunk)
    pad = nc * chunk - T
    xp = np.pad(x, ((0, pad), (0, 0), (0, 0)))
    dtp = np.pad(dt, ((0, pad), (0, 0)))
    Bp, Cp = (np.pad(t, ((0, pad), (0, 0), (0, 0))) for t in (B, C))
    dS, CB, cs_all = [], [], []
    for c in range(nc):                                     # pass 1
        rows = slice(c * chunk, (c + 1) * chunk)
        cs = np.cumsum(dtp[rows] * A, axis=0, dtype=F32)    # (L, H)
        w = (np.exp(cs[-1] - cs) * dtp[rows]).astype(F32)
        xw = (xp[rows] * w[:, :, None]).astype(F32)         # (L, H, P)
        Bh = np.repeat(Bp[rows], rep, axis=1).transpose(1, 2, 0)  # H, N, L
        dS.append(_mma3(Bh, xw.transpose(1, 0, 2)))         # (H, N, P)
        CB.append(_mma3(Cp[rows].transpose(1, 0, 2),
                        Bp[rows].transpose(1, 2, 0)))       # (G, L, L)
        cs_all.append(cs)
    S = np.zeros((H, N, P), F32) if h0 is None else h0.astype(F32)
    prev = []
    for c in range(nc):                                     # pass 2
        prev.append(S)
        S = (np.exp(cs_all[c][-1])[:, None, None] * S + dS[c]).astype(F32)
    y = np.zeros_like(xp)
    t_idx = np.arange(chunk)
    mask = t_idx[None, :] <= t_idx[:, None]
    for c in range(nc):                                     # pass 3
        rows = slice(c * chunk, (c + 1) * chunk)
        cs = cs_all[c]
        diff = np.where(mask[:, :, None], cs[:, None, :] - cs[None, :, :],
                        -np.inf)                            # (t, s, H)
        cbh = np.repeat(CB[c], rep, axis=0).transpose(1, 2, 0)
        W = np.where(mask[:, :, None], cbh * np.exp(diff).astype(F32)
                     * dtp[rows][None, :, :], F32(0)).astype(F32)
        # below the diagonal 16 x 16 blocks the kernel factors the decay
        # at the last token e of s's 16: (CB·exp(cs_t − cs_e))·gamma_s,
        # gamma_s = exp(cs_e − cs_s)·dt_s
        e = t_idx | 15
        gamma = (np.exp(cs[e] - cs) * dtp[rows]).astype(F32)    # (s, H)
        off = (t_idx[:, None] // 16) > (t_idx[None, :] // 16)
        # exponent <= 0 where taken; 0 elsewhere (never taken)
        rho = np.exp(np.where(off[:, :, None], cs[:, None, :]
                              - cs[None, e, :], 0)).astype(F32)
        W = np.where(off[:, :, None],
                     (cbh * rho).astype(F32) * gamma[None], W).astype(F32)
        yc = _mma3(W.transpose(2, 0, 1), xp[rows].transpose(1, 0, 2))
        if c > 0 or h0 is not None:
            Ch = np.repeat(Cp[rows], rep, axis=1).transpose(1, 0, 2)
            ys = _mma3(Ch, prev[c])                         # (H, L, P)
            yc = (np.exp(cs).T[:, :, None] * ys + yc).astype(F32)
        y[rows] = yc.transpose(1, 0, 2)
    return y[:T], S


def _exact(x, dt, A, B, C, h0):
    """The recurrence in float64 from the same float32 inputs."""
    T, H, P = x.shape
    rep = H // B.shape[1]
    f = np.float64
    Bh, Ch = (np.repeat(t.astype(f), rep, axis=1) for t in (B, C))
    S = np.zeros((H, B.shape[2], P)) if h0 is None else h0.astype(f)
    y = np.zeros((T, H, P))
    for t in range(T):
        S = np.exp(dt[t].astype(f) * A)[:, None, None] * S \
            + Bh[t][:, :, None] * (dt[t].astype(f)[:, None]
                                   * x[t].astype(f))[:, None, :]
        y[t] = np.einsum("hn,hnp->hp", Ch[t], S)
    return y, S


def _inputs(seed, Bt, T, H, P, G, N, h0):
    """As the JAX package's kernel test draws them: dt > 0, A < 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bt, T, H, P)).astype(F32)
    dt = (np.abs(rng.normal(size=(Bt, T, H))) * 0.5 + 0.01).astype(F32)
    A = (-np.abs(rng.normal(size=(H,))) - 0.1).astype(F32)
    B = rng.normal(size=(Bt, T, G, N)).astype(F32)
    C = rng.normal(size=(Bt, T, G, N)).astype(F32)
    s0 = rng.normal(size=(Bt, H, N, P)).astype(F32) if h0 else None
    return x, dt, A, B, C, s0


# (Bt, T, H, P, G, N, h0) at the kernel's chunk: G = 2, h0, T below one
# chunk, a ragged last chunk, T = 1, several whole chunks
EMULATED = {
    "G2_ragged_three_chunks": (1, 150, 4, 16, 2, 32, False),
    "h0_ragged_G2": (2, 100, 4, 16, 2, 16, True),
    "below_one_chunk_h0": (1, 37, 4, 16, 1, 32, True),
    "T1_h0_G2": (1, 1, 4, 16, 2, 16, True),
    "T1": (1, 1, 2, 16, 1, 16, False),
    "four_whole_chunks": (1, 256, 2, 16, 1, 16, False),
    "ragged_h0_G2_four_chunks": (1, 200, 4, 32, 2, 16, True),
}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_route(case):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels import ssd_scan as jssd
    Bt, T, H, P, G, N, with_h0 = EMULATED[case]
    chunk = tssd.SSD_CHUNK
    x, dt, A, B, C, s0 = _inputs(len(case), Bt, T, H, P, G, N, with_h0)
    ys, ss = [], []
    for b in range(Bt):
        h0b = None if s0 is None else s0[b]
        y, s = _emulate(x[b], dt[b], A, B[b], C[b], h0b, chunk)
        ey, es = _exact(x[b], dt[b], A, B[b], C[b], h0b)
        np.testing.assert_allclose(y, ey, atol=ROUTE_TOL, rtol=ROUTE_TOL)
        np.testing.assert_allclose(s, es, atol=ROUTE_TOL, rtol=ROUTE_TOL)
        jy, js = jref.ssd_scan(*(jnp.asarray(a) for a in (
            x[b], dt[b], A, B[b], C[b])), h0=None if h0b is None
            else jnp.asarray(h0b), return_state=True)
        np.testing.assert_allclose(y, np.asarray(jy), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(s, np.asarray(js), atol=TOL, rtol=TOL)
        ys.append(y)
        ss.append(s)
    if s0 is None:
        # the Pallas kernel (no h0; T a multiple of its chunk)
        tc = next(c for c in (16, 8, 4, 2, 1) if T % c == 0)
        py, ps = jssd.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                               tc=tc, th=min(2, H))
        np.testing.assert_allclose(np.stack(ys), np.asarray(py), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(np.stack(ss), np.asarray(ps), atol=TOL,
                                   rtol=TOL)


def test_emulated_split_is_exact_to_2_22():
    """hi + lo carries v within 2^-22 |v| (the bound the source states),
    both TF32 (low 13 bits zero)."""
    v = np.random.default_rng(0).normal(size=10000).astype(F32) * 1e3
    hi, lo = _split(v)
    assert not np.any(hi.view(np.uint32) & 0x1FFF)
    assert not np.any(lo.view(np.uint32) & 0x1FFF)
    err = np.abs(v.astype(np.float64) - hi - lo)
    assert np.all(err <= 2.0 ** -22 * np.abs(v) + 1e-30)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds #13 against "
                    "its plain version there)")
    return torch.device("cuda", 0)


def _on(dev, seed, Bt, T, H, P, G, N, h0):
    return tuple(None if a is None else torch.from_numpy(a).to(dev)
                 for a in _inputs(seed, Bt, T, H, P, G, N, h0))


def _run(x, dt, A, B, C, h0):
    n = tssd.launches.value
    got = tssd.ssd_scan(x, dt, A, B, C, h0=h0)
    assert tssd.launches.value == n + 1
    return got


def _close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("T", [1, 37, 64, 129, 300])
def test_matches_plain_on_the_card(cuda_device, G, h0, T):
    args = _on(cuda_device, T + G, 2, T, 8, 48, G, 64, h0)
    _close(_run(*args), tref.ssd_chunked(*args[:5], h0=args[5]))


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [1, 3, 8])
def test_head_tiles_and_widths_on_the_card(cuda_device, monkeypatch, heads):
    """Head tiles that do not divide the group (the last one short), N
    16 and 128, P 16 and 64."""
    monkeypatch.setattr(tssd, "_plan", lambda *a: heads)
    for N, P in ((16, 16), (128, 64)):
        args = _on(cuda_device, N + P, 1, 2 * tssd.SSD_CHUNK + 5, 10, P, 2,
                   N, True)
        _close(_run(*args), tref.ssd_chunked(*args[:5], h0=args[5]))


@pytest.mark.gpu
def test_planned_launch_and_two_launches_bit_equal_on_the_card(
        cuda_device):
    args = _on(cuda_device, 1, 1, 2048, 24, 64, 1, 128, False)
    first, again = _run(*args), _run(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    _close(first, tref.ssd_chunked(*args[:5]))


@pytest.mark.gpu
def test_non_default_stream_on_the_card(cuda_device):
    args = _on(cuda_device, 2, 2, 300, 8, 64, 2, 64, True)
    want = tref.ssd_chunked(*args[:5], h0=args[5])
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        got = _run(*args)
    side.synchronize()
    _close(got, want)


@pytest.mark.gpu
def test_scratch_grown_and_reused_on_the_card(cuda_device):
    stream = torch._C._cuda_getCurrentRawStream(cuda_device.index)
    small = _on(cuda_device, 3, 1, 200, 8, 64, 1, 64, False)
    large = _on(cuda_device, 4, 2, 900, 8, 64, 1, 64, True)
    _close(_run(*small), tref.ssd_chunked(*small[:5]))
    slot = _build.scratch_slot(cuda_device, stream)
    first = slot[1]
    _close(_run(*large), tref.ssd_chunked(*large[:5], h0=large[5]))
    grown = slot[1]
    assert grown.numel() >= tssd.scratch_floats(2, 900, 8, 1, 64, 64)
    assert grown.numel() >= first.numel()
    _close(_run(*small), tref.ssd_chunked(*small[:5]))
    assert slot[1] is grown                 # reused, not made again


@pytest.mark.gpu
def test_uncompiled_tile_is_refused_on_the_card(cuda_device, monkeypatch):
    args = _on(cuda_device, 5, 1, 40, 4, 16, 1, 16, False)
    n = tssd.launches.value
    for plan in (0, tssd.SSD_HEADS + 1):
        monkeypatch.setattr(tssd, "_plan", lambda *a, p=plan: p)
        with pytest.raises(RuntimeError, match="repro_ssd_scan_f32"):
            tssd.ssd_scan(*args[:5])
    assert tssd.launches.value == n


@pytest.mark.gpu
def test_smem_bytes_match_the_library_on_the_card(cuda_device):
    """The one layout counted twice: ``smem_bytes`` against the library's
    ``smem_pass1``/``smem_pass3`` at every state width the kernel takes."""
    _build.library()
    fn = _build._fns["repro_ssd_smem_bytes"]
    for N in range(16, 129, 16):
        assert (fn(N, 1), fn(N, 3)) == tssd.smem_bytes(N), N
    assert fn(128, 2) == -1


@pytest.mark.gpu
def test_wrapper_guards_on_the_card(cuda_device):
    x, dt, A, B, C, _ = _on(cuda_device, 12, 1, 16, 4, 16, 1, 16, False)
    with pytest.raises(RuntimeError, match="backward"):
        tssd.ssd_scan(x.requires_grad_(), dt, A, B, C)
    x = x.detach()
    with pytest.raises(ValueError, match="state width"):
        tssd.ssd_scan(x, dt, A, B[..., :8].contiguous(),
                      C[..., :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd_scan(x.transpose(1, 2), dt, A, B, C)
    with pytest.raises(ValueError, match="head width"):
        tssd.ssd_scan(x[..., :8].contiguous(), dt, A, B, C)
    with pytest.raises(ValueError, match="groups"):
        tssd.ssd_scan(x, dt, A, *(t.expand(1, 16, 3, 16).contiguous()
                                  for t in (B, C)))
    h0 = torch.zeros(1, 4, 16, 16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        tssd.ssd_scan(x, dt, A, B, C,
                      h0=torch.zeros(4 * 16 * 16 + 1, device=cuda_device)[
                          1:].view(1, 4, 16, 16))
    for T in (0, 1):
        got = _run(x[:, :T].contiguous(), dt[:, :T].contiguous(), A,
                   B[:, :T].contiguous(), C[:, :T].contiguous(), h0 + 1)
        _close(got, tref.ssd_chunked(x[:, :T], dt[:, :T], A, B[:, :T],
                                     C[:, :T], h0=h0 + 1))
