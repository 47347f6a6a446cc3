"""The port's LM kernel modules (RMSNorm #6, attention #11, decode
attention #12) against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go through the JAX
package's oracles (``repro.kernels.ref``), its Pallas kernels in
interpret mode (``repro.kernels.{pointwise,attention,decode_attention}``,
small tiles so that several kv tiles and a ragged tail are swept) and
the XLA-native forms its LM stack runs (``repro.nn.flash``), and through
the port's kernel wrappers and ``ops`` dispatch, which on a CPU tensor
run the plain versions (``repro_torch.kernels.ref``). The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.

Tolerances are the JAX package's own kernel tests': atol 2e-5 for
attention, 1e-5 for RMSNorm (float32 sums in another order). Every
query row here sees at least one key: a row with none is NaN in the
oracles, the mean of V in ``flash.decode_grouped`` and 0 in the Pallas
kernels (ROADMAP.md, reference hazards).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as jattn
from repro.kernels import decode_attention as jdec
from repro.kernels import pointwise as jpw
from repro.kernels import ref as jref
from repro.nn import flash as jflash
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops
from repro_torch.kernels import pointwise as tpw
from repro_torch.kernels import ref as tref

from _port_memory import release_memory  # noqa: F401

ATTN_TOL = 2e-5
NORM_TOL = 1e-5


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# --------------------------------------------------------------------------
# #6 rmsnorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 33, 64), (5, 4096), (509, 36),
                                   (3, 2, 4, 16), (1, 33)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rmsnorm_matches_jax(shape):
    """Any row count, D a multiple of 4 or not."""
    x = _np(1, shape, 2.0)
    g = _np(2, shape[-1:], 0.1)
    want = jref.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-6)
    pallas = jpw.rmsnorm(jnp.asarray(x), jnp.asarray(g), eps=1e-6, tr=16)
    for got in (tpw.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-6),
                ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(g),
                            eps=1e-6)):
        assert got.shape == shape and got.dtype == torch.float32
        _close(got, want, NORM_TOL)
        _close(got, pallas, NORM_TOL)


def test_rmsnorm_eps_and_zero_gain():
    """g = 0 is the identity scale of the (1+g) convention; eps enters
    inside the root."""
    x = _np(3, (4, 8), 1e-3)
    g = np.zeros(8, np.float32)
    for eps in (1e-6, 1e-2):
        got = tpw.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), eps)
        want = x / np.sqrt((x * x).mean(-1, keepdims=True) + eps)
        _close(got, want, NORM_TOL)


# --------------------------------------------------------------------------
# #11 mha
# --------------------------------------------------------------------------

# (B, Tq, Tk, Hq, Hkv, D, causal, window, softcap)
MHA_CASES = {
    "rep1_causal": (2, 32, 32, 4, 4, 16, True, None, None),
    "rep2_causal": (1, 48, 48, 4, 2, 32, True, None, None),
    "rep4_causal": (1, 32, 32, 8, 2, 16, True, None, None),
    "rep2_full": (2, 24, 40, 4, 2, 16, False, None, None),
    "rep4_window": (1, 48, 48, 8, 2, 16, True, 8, None),
    "rep2_softcap": (1, 32, 32, 4, 2, 32, True, None, 20.0),
    "window_softcap": (2, 40, 40, 4, 2, 16, True, 12, 5.0),
    "tq_lt_tk": (2, 8, 40, 4, 2, 16, True, None, None),
    "tq_lt_tk_window": (1, 12, 44, 4, 1, 16, True, 10, None),
    "ragged_t": (1, 37, 37, 4, 2, 16, True, None, None),
    "ragged_full_window": (2, 21, 29, 2, 1, 16, False, 9, 30.0),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_mha_matches_jax(case):
    B, Tq, Tk, Hq, Hkv, D, causal, win, cap = MHA_CASES[case]
    q, k, v = (_np(10 + i, s) for i, s in enumerate(
        [(B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D)]))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kw = dict(causal=causal, window=win, softcap=cap)
    want = jref.mha(jq, jk, jv, **kw)
    pallas = jattn.mha(jq, jk, jv, tq=16, tk=16, **kw)
    flash = jflash.flash_mha(jq, jk, jv, cq=8 if Tq % 8 == 0 else Tq,
                             ck=8 if Tk % 8 == 0 else Tk, **kw)
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    for got in (tattn.mha(tq_, tk_, tv_, **kw), ops.mha(tq_, tk_, tv_, **kw),
                ops.mha(tq_, tk_, tv_, backend="ref", **kw)):
        assert got.shape == (B, Tq, Hq, D)
        for w in (want, pallas, flash):
            _close(got, w, ATTN_TOL)


def test_mha_explicit_scale():
    q, k, v = (_np(20 + i, (1, 16, 2, 16)) for i in range(3))
    want = jref.mha(*(jnp.asarray(a) for a in (q, k, v)), scale=0.3)
    got = tattn.mha(*(torch.from_numpy(a) for a in (q, k, v)), scale=0.3)
    _close(got, want, ATTN_TOL)


# --------------------------------------------------------------------------
# #12 decode_attention
# --------------------------------------------------------------------------

# (B, Hq, Hkv, D, S, window, softcap, lengths)
DEC_CASES = {
    "rep1": (2, 4, 4, 32, 64, None, None, (5, 64)),
    "rep2": (3, 4, 2, 16, 48, None, None, (1, 17, 48)),
    "rep4": (2, 8, 2, 16, 40, None, None, (40, 3)),
    "rep2_window": (3, 4, 2, 32, 64, 8, None, (1, 9, 64)),
    "rep4_window_softcap": (2, 8, 2, 16, 96, 20, 15.0, (96, 21)),
    "rep2_softcap": (2, 4, 2, 16, 50, None, 20.0, (50, 33)),
}


@pytest.mark.parametrize("case", sorted(DEC_CASES))
def test_decode_attention_matches_jax(case):
    """Per-row lengths (including 1 and the full cache), with and
    without a window: the live range of each row differs."""
    B, Hq, Hkv, D, S, win, cap, lens = DEC_CASES[case]
    q = _np(30, (B, Hq, D))
    kc = _np(31, (B, S, Hkv, D))
    vc = _np(32, (B, S, Hkv, D))
    ln = np.asarray(lens, np.int32)
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, kc, vc, ln))
    kw = dict(window=win, softcap=cap)
    want = jref.decode_attention(jq, jk, jv, jl, **kw)
    pallas = jdec.decode_attention(jq, jk, jv, jl, ts=16, **kw)
    grouped = jflash.decode_grouped(jq, jk, jv, jl, **kw)
    args = [torch.from_numpy(a) for a in (q, kc, vc, ln)]
    for got in (tdec.decode_attention(*args, **kw),
                ops.decode_attention(*args, **kw)):
        assert got.shape == (B, Hq, D)
        for w in (want, pallas, grouped):
            _close(got, w, ATTN_TOL)


def test_decode_equals_last_row_of_mha():
    """A decode step over a cache of T keys is the last query row of
    causal attention over those T keys (what prefill + decode relies
    on)."""
    T, Hq, Hkv, D = 20, 4, 2, 16
    q = _np(40, (1, T, Hq, D))
    k = _np(41, (1, T, Hkv, D))
    v = _np(42, (1, T, Hkv, D))
    full = tref.mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    pad = np.zeros((1, 12, Hkv, D), np.float32)
    got = tdec.decode_attention(
        torch.from_numpy(q[:, -1]),
        torch.from_numpy(np.concatenate([k, pad], 1)),
        torch.from_numpy(np.concatenate([v, pad], 1)),
        torch.tensor([T], dtype=torch.int32))
    _close(got, full[:, -1], ATTN_TOL)


# --------------------------------------------------------------------------
# dispatch and guards
# --------------------------------------------------------------------------

def test_ops_dispatch_and_default_backend():
    q = torch.from_numpy(_np(50, (1, 8, 2, 16)))
    with pytest.raises(ValueError, match="cuda"):
        ops.mha(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ops.rmsnorm(q, torch.zeros(16), backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ops.decode_attention(q[:, 0], q, q, torch.tensor([8], dtype=torch.int32),
                             backend="cuda")
    with pytest.raises(ValueError):
        ops.set_default_backend("pallas")
    assert ops._DEFAULT == "auto"
    ops.set_default_backend("ref")
    try:
        assert ops._DEFAULT == "ref"
        torch.testing.assert_close(ops.mha(q, q, q), tref.mha(q, q, q),
                                   rtol=0, atol=0)
        with pytest.raises(ValueError, match="cuda"):
            ops.mha(q, q, q, backend="cuda")
    finally:
        ops.set_default_backend("auto")


def test_cpu_tensors_never_count_a_launch():
    before = (tpw.rmsnorm_launches.value, tattn.launches.value,
              tdec.launches.value)
    x = torch.from_numpy(_np(60, (2, 8, 2, 16)))
    tpw.rmsnorm(x, torch.zeros(16))
    tattn.mha(x, x, x)
    tdec.decode_attention(x[:, 0], x, x, torch.tensor([3, 8],
                                                      dtype=torch.int32))
    assert (tpw.rmsnorm_launches.value, tattn.launches.value,
            tdec.launches.value) == before


def test_kernel_guards():
    """What the CUDA wrappers refuse before any launch: operands that
    require grad (no backward yet), windows < 1, softcaps <= 0; and the
    decode plan's shares cover the cache's span (the window's where it
    is shorter) within the merge's cap."""
    w = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        _build.check_no_grad(torch.zeros(4), w)
    _build.check_no_grad(torch.zeros(4), w.detach())
    assert tattn.check_window(None) == 0 and tattn.check_window(256) == 256
    assert tattn.check_softcap(None) == 0.0
    with pytest.raises(ValueError):
        tattn.check_window(0)
    with pytest.raises(ValueError):
        tattn.check_softcap(-1.0)
    assert tdec._plan(4096, 0, 128, 4, 32) == (128, 32)
    assert tdec._plan(4096, 0, 128, 4, 1) == (tdec.MIN_SHARE, 128)
    assert tdec._plan(20, 0, 128, 4, 32) == (tdec.MIN_SHARE, 1)
    assert tdec._plan(4096, 0, 128, 4, 512) == (128, 32)    # SHARE_BYTES
    assert tdec._plan(4096, 300, 128, 4, 32)[1] == -(-300 // tdec.MIN_SHARE)
    assert tdec._plan(10 ** 6, 0, 128, 1, 1)[1] <= tdec.MAX_SHARES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds the kernels "
                    "against their plain versions there)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_wrappers_refuse_grad_on_the_card(cuda_device):
    x = torch.zeros((2, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        tpw.rmsnorm(x, torch.zeros(64, device=cuda_device))
    q = torch.zeros((1, 4, 2, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        tattn.mha(q, q, q)
