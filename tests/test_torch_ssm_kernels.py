"""The port's SSD scan (kernel #13) against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go through the JAX
package's sequential oracle (``repro.kernels.ref.ssd_scan``), its Pallas
kernel in interpret mode (``repro.kernels.ssd_scan``, the shapes of its
own ``tests/test_kernels.py``, which include G = 2 and G = H) and the
XLA-native chunked form its LM stack runs (``repro.nn.ssm.ssd_chunked``,
B and C repeated per head as it takes them), and through the port's
plain versions (``repro_torch.kernels.ref``), kernel wrapper and ``ops``
dispatch, which on a CPU tensor run ``ref.ssd_chunked``. The CUDA kernel
itself is held against the same plain version on the card by
``chip_smoke.py``.

Tolerances: 1e-4 against the JAX chunked form (float32, sums in another
order and another chunk); 1e-3 against the oracle and the Pallas kernel,
the JAX package's own SSD kernel test's (``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro.nn import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd

from _port_memory import release_memory  # noqa: F401

CHUNK_TOL = 1e-4
ORACLE_TOL = 1e-3


def _inputs(Bt, T, H, P, G, N, seed=0, h0=False):
    """x, dt (softplus-like, > 0), A (< 0), B, C and an optional h0, as
    the JAX package's kernel test draws them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(Bt, T, H, P)).astype(f)
    dt = (np.abs(rng.normal(size=(Bt, T, H))) * 0.5 + 0.01).astype(f)
    A = (-np.abs(rng.normal(size=(H,))) - 0.1).astype(f)
    B = rng.normal(size=(Bt, T, G, N)).astype(f)
    C = rng.normal(size=(Bt, T, G, N)).astype(f)
    s0 = rng.normal(size=(Bt, H, N, P)).astype(f) if h0 else None
    return x, dt, A, B, C, s0


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _port_sides(x, dt, A, B, C, s0):
    """(y, state) of every port entry that runs the plain chunked form on
    a CPU tensor: ``ref.ssd_chunked`` at the kernel's chunk and at 16,
    the wrapper, and ``ops.ssd_scan`` on both backends."""
    args = _t(x, dt, A, B, C)
    h0 = _t(s0)[0]
    return [tref.ssd_chunked(*args, h0=h0),
            tref.ssd_chunked(*args, h0=h0, chunk=16),
            tssd.ssd_scan(*args, h0=h0),
            ops.ssd_scan(*args, h0=h0),
            ops.ssd_scan(*args, h0=h0, backend="ref")]


def _jax_chunked(x, dt, A, B, C, s0, chunk):
    H, G = x.shape[2], B.shape[2]
    Bh, Ch = (np.repeat(a, H // G, axis=2) for a in (B, C))
    return jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bh, Ch)),
                            h0=None if s0 is None else jnp.asarray(s0),
                            chunk=chunk)


# (Bt, T, H, P, G, N, JAX chunk, h0)
CHUNKED_CASES = {
    "mamba2_like_G1": (2, 64, 8, 16, 1, 16, 16, False),
    "G2_rep4": (1, 96, 8, 16, 2, 32, 32, False),
    "G_eq_H": (2, 48, 4, 8, 4, 16, 16, False),
    "h0_four_chunks": (2, 64, 4, 16, 2, 16, 16, True),
    "one_chunk_h0": (1, 40, 4, 16, 1, 32, 256, True),
}


@pytest.mark.parametrize("case", sorted(CHUNKED_CASES))
def test_ssd_chunked_matches_jax_chunked(case):
    """The port's plain chunked form, wrapper and ops against the JAX
    package's ``nn/ssm.ssd_chunked`` (what its LM stack runs), with and
    without an initial state carried over several chunks."""
    Bt, T, H, P, G, N, chunk, with_h0 = CHUNKED_CASES[case]
    x, dt, A, B, C, s0 = _inputs(Bt, T, H, P, G, N, seed=1, h0=with_h0)
    want_y, want_s = _jax_chunked(x, dt, A, B, C, s0, chunk)
    for y, s in _port_sides(x, dt, A, B, C, s0):
        assert y.shape == (Bt, T, H, P) and s.shape == (Bt, H, N, P)
        assert y.dtype == s.dtype == torch.float32
        _close(y, want_y, CHUNK_TOL)
        _close(s, want_s, CHUNK_TOL)


# the JAX package's kernel test shapes: (Bt, T, H, P, G, N, tc, th)
PALLAS_CASES = [(1, 64, 4, 16, 2, 32, 16, 2), (2, 128, 8, 32, 8, 64, 32, 4),
                (1, 32, 4, 16, 1, 16, 32, 4)]


@pytest.mark.parametrize("cfg", PALLAS_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_ssd_scan_matches_jax_pallas_and_oracle(cfg):
    """Against the Pallas kernel in interpret mode and the sequential
    oracle, per batch row, y and the final state."""
    Bt, T, H, P, G, N, tc, th = cfg
    x, dt, A, B, C, _ = _inputs(Bt, T, H, P, G, N, seed=2)
    jy, js = jssd.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                           tc=tc, th=th)
    for y, s in _port_sides(x, dt, A, B, C, None):
        _close(y, jy, ORACLE_TOL)
        _close(s, js, ORACLE_TOL)
        for b in range(Bt):
            yr, sr = jref.ssd_scan(x[b], dt[b], A, B[b], C[b],
                                   return_state=True)
            _close(y[b], yr, ORACLE_TOL)
            _close(s[b], sr, ORACLE_TOL)


# (Bt, T, H, P, G, N, h0): T below one kernel chunk, ragged last chunks
RAGGED_CASES = {
    "T12_below_one_chunk": (2, 12, 4, 16, 1, 16, False),
    "T1": (1, 1, 4, 16, 2, 16, True),
    "T37_ragged_h0": (2, 37, 4, 16, 2, 16, True),
    "T160_ragged_G_eq_H": (1, 160, 4, 16, 4, 16, False),
}


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ssd_scan_any_length_matches_oracle(case):
    """Any T (the kernel pads a ragged last chunk with dt = 0), with the
    initial state given: the port against the JAX oracle, and the port's
    copy of the oracle against it too."""
    Bt, T, H, P, G, N, with_h0 = RAGGED_CASES[case]
    x, dt, A, B, C, s0 = _inputs(Bt, T, H, P, G, N, seed=3, h0=with_h0)
    for b in range(Bt):
        h0b = None if s0 is None else s0[b]
        yr, sr = jref.ssd_scan(x[b], dt[b], A, B[b], C[b],
                               h0=None if h0b is None else jnp.asarray(h0b),
                               return_state=True)
        ty, ts = tref.ssd_scan(*_t(x[b], dt[b], A, B[b], C[b], h0b),
                               return_state=True)
        _close(ty, yr, ORACLE_TOL)
        _close(ts, sr, ORACLE_TOL)
        for y, s in _port_sides(x, dt, A, B, C, s0):
            _close(y[b], yr, ORACLE_TOL)
            _close(s[b], sr, ORACLE_TOL)


def test_oracle_without_state_returns_y_only():
    x, dt, A, B, C, _ = _inputs(1, 9, 4, 8, 2, 8, seed=4)
    want = jref.ssd_scan(x[0], dt[0], A, B[0], C[0])
    got = tref.ssd_scan(*_t(x[0], dt[0], A, B[0], C[0]))
    assert isinstance(got, torch.Tensor) and got.shape == (9, 4, 8)
    _close(got, want, ORACLE_TOL)


def test_ssd_decode_step_matches_jax():
    """One recurrent step, G = 2 (head h reads group h // 2), against the
    JAX package's; and a step of the scan from the same state."""
    H, P, G, N = 4, 8, 2, 16
    rng = np.random.default_rng(5)
    x = rng.normal(size=(H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(H,))) + 0.01).astype(np.float32)
    A = (-np.abs(rng.normal(size=(H,))) - 0.1).astype(np.float32)
    B, C = (rng.normal(size=(G, N)).astype(np.float32) for _ in range(2))
    S = rng.normal(size=(H, N, P)).astype(np.float32)
    wy, ws = jref.ssd_decode_step(*(jnp.asarray(a) for a in (x, dt, A, B, C,
                                                             S)))
    ty, ts = tref.ssd_decode_step(*_t(x, dt, A, B, C, S))
    _close(ty, wy, CHUNK_TOL)
    _close(ts, ws, CHUNK_TOL)
    sy, ss = tref.ssd_chunked(*_t(x[None, None], dt[None, None], A,
                                  B[None, None], C[None, None]),
                              h0=torch.from_numpy(S[None]))
    _close(sy[0, 0], wy, CHUNK_TOL)
    _close(ss[0], ws, CHUNK_TOL)


def test_heads_map_to_groups_by_repeat():
    """Reference hazard: ``ref.ssd_scan``'s docstring says "group g =
    h % G", its code (and the Pallas kernel's, and ``nn/ssm.py``'s)
    repeats, so head h reads group h // (H / G). The port follows the
    code; at G > 1 the two mappings give different results."""
    Bt, T, H, P, G, N = 1, 24, 4, 8, 2, 8
    x, dt, A, B, C, _ = _inputs(Bt, T, H, P, G, N, seed=6)
    want = jref.ssd_scan(x[0], dt[0], A, B[0], C[0])
    y, _ = ops.ssd_scan(*_t(x, dt, A, B, C))
    _close(y[0], want, ORACLE_TOL)
    mod = np.arange(H) % G                       # the docstring's mapping
    by_mod = jref.ssd_scan(x[0], dt[0], A, B[0][:, mod], C[0][:, mod])
    assert np.abs(np.asarray(by_mod) - np.asarray(want)).max() > 0.1


def test_chunk_is_a_tile_not_a_result():
    """The plain chunked form gives the same function at any chunk."""
    x, dt, A, B, C, s0 = _inputs(2, 80, 4, 16, 2, 16, seed=7, h0=True)
    args, h0 = _t(x, dt, A, B, C), torch.from_numpy(s0)
    y0, s_0 = tref.ssd_chunked(*args, h0=h0, chunk=80)
    for chunk in (1, 7, 16, 64, 256):
        y, s = tref.ssd_chunked(*args, h0=h0, chunk=chunk)
        _close(y, y0, CHUNK_TOL)
        _close(s, s_0, CHUNK_TOL)


# --------------------------------------------------------------------------
# dispatch and guards
# --------------------------------------------------------------------------

def test_cpu_tensors_never_count_a_launch():
    before = tssd.launches.value
    x, dt, A, B, C, _ = _inputs(1, 8, 4, 16, 1, 16, seed=8)
    tssd.ssd_scan(*_t(x, dt, A, B, C))
    ops.ssd_scan(*_t(x, dt, A, B, C))
    assert tssd.launches.value == before


def test_ops_dispatch_and_default_backend():
    x, dt, A, B, C, _ = _t(*_inputs(1, 8, 4, 16, 1, 16, seed=9))
    with pytest.raises(ValueError, match="cuda"):
        ops.ssd_scan(x, dt, A, B, C, backend="cuda")
    ops.set_default_backend("ref")
    try:
        got = ops.ssd_scan(x, dt, A, B, C)
    finally:
        ops.set_default_backend("auto")
    want = tref.ssd_chunked(x, dt, A, B, C)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ops_takes_split_views():
    """The mixer hands x, B and C over as views of one projection; ops
    makes them contiguous (the kernel takes contiguous operands)."""
    Bt, T, H, P, G, N = 1, 20, 4, 8, 1, 16
    rng = np.random.default_rng(10)
    xbc = torch.from_numpy(rng.normal(size=(Bt, T, H * P + 2 * G * N)
                                      ).astype(np.float32))
    xs, Bm, Cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    dt = torch.full((Bt, T, H), 0.3)
    A = -torch.ones(H)
    got = ops.ssd_scan(xs.reshape(Bt, T, H, P), dt, A,
                       Bm.reshape(Bt, T, G, N), Cm.reshape(Bt, T, G, N))
    want = tref.ssd_chunked(xs.reshape(Bt, T, H, P).contiguous(), dt, A,
                            Bm.reshape(Bt, T, G, N).contiguous(),
                            Cm.reshape(Bt, T, G, N).contiguous())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds the kernel "
                    "against its plain version there)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card(cuda_device):
    x, dt, A, B, C, s0 = _t(*_inputs(2, 100, 8, 32, 2, 32, seed=11,
                                     h0=True))
    args = [t.to(cuda_device) for t in (x, dt, A, B, C)]
    h0 = s0.to(cuda_device)
    before = tssd.launches.value
    y, s = tssd.ssd_scan(*args, h0=h0)
    assert tssd.launches.value == before + 1
    wy, ws = tref.ssd_chunked(*args, h0=h0)
    torch.testing.assert_close(y, wy, atol=ORACLE_TOL, rtol=ORACLE_TOL)
    torch.testing.assert_close(s, ws, atol=ORACLE_TOL, rtol=ORACLE_TOL)


@pytest.mark.gpu
def test_wrapper_guards_on_the_card(cuda_device):
    x, dt, A, B, C = (t.to(cuda_device) for t in _t(
        *_inputs(1, 16, 4, 16, 1, 16, seed=12)[:5]))
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
