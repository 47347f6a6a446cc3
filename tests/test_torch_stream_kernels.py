"""Kernels #5 (``pointwise``) and #4 (``resize_nearest``), the port's two
streams of bytes, and the launch path every kernel shares.

On the CPU: the port's wrappers (which on a CPU tensor run their plain
versions, ``repro_torch.kernels.ref``) against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode, on
inputs from numpy with a fixed seed: resize bit-equal at C in {3, 4, 6,
8} and scale in {1, 2, 3} (copies only), and at N = 0 (against the
oracle alone: the Pallas kernel cannot slice an empty batch); every
activation within atol = rtol = 1e-4 (the Pallas ``_act`` multiplies
hardswish by 1/6 where the oracle divides by 6) on lengths that are not
a multiple of 4 and on an offset contiguous view, and relu keeping NaN
as ``jax.nn.relu`` does. Then the wrappers'
plans (``_plan``: the float4 path taken or not, the grid from the SM
count) and ``_build.launch`` with its CUDA calls replaced by stand-ins
(the current stream's handle, the device switch, a nonzero return code).

On the card (``-m gpu``; they skip without one): the CUDA kernels
against the same plain versions on misaligned starts, C % 4 != 0 and
every activation, relu keeping NaN, two launches bit-equal, a launch on a non-default
stream, a refused launch raising, and an empty operand returning an
empty result with no launch.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pointwise as jpw
from repro.kernels import ref as jref
from repro.kernels import resize as jresize
from repro_torch.kernels import _build
from repro_torch.kernels import pointwise as tpw
from repro_torch.kernels import ref as tref
from repro_torch.kernels import resize as tresize

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
ACTS = sorted(tref.ACTIVATIONS)
# Activations the Pallas kernel implements as the oracle does (its _act
# returns the identity for gelu; only the oracle is compared there).
PALLAS_ACTS = ("hardswish", "leaky_relu", "silu", "relu", "identity")
LENGTHS = (1, 3, 13, 4099)        # none a multiple of 4


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# --------------------------------------------------------------------------
# against the JAX package, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("C", [3, 4, 6, 8])
@pytest.mark.parametrize("scale", [1, 2, 3])
def test_resize_bit_equal_to_jax(C, scale):
    x = _np(C * 10 + scale, (2, 5, 7, C))
    got = tresize.resize_nearest(torch.from_numpy(x), scale=scale).numpy()
    want = np.asarray(jref.resize_nearest(jnp.asarray(x), scale=scale))
    pal = np.asarray(jresize.resize_nearest(jnp.asarray(x), scale=scale,
                                            interpret=True))
    assert got.shape == (2, 5 * scale, 7 * scale, C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_resize_empty_batch_matches_jax(scale):
    x = np.zeros((0, 5, 4, 6), np.float32)
    got = tresize.resize_nearest(torch.from_numpy(x), scale=scale)
    want = np.asarray(jref.resize_nearest(jnp.asarray(x), scale=scale))
    assert tuple(got.shape) == want.shape == (0, 5 * scale, 4 * scale, 6)


@pytest.mark.parametrize("act", ACTS)
def test_pointwise_ragged_lengths_match_jax(act):
    for n in LENGTHS:
        x = _np(n, (n,), 4.0)
        got = tpw.pointwise(torch.from_numpy(x), act).numpy()
        want = np.asarray(jref.ACTIVATIONS[act](jnp.asarray(x)))
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"n={n}")
        if act in PALLAS_ACTS:
            pal = np.asarray(jpw.pointwise(jnp.asarray(x), act,
                                           interpret=True))
            np.testing.assert_allclose(got, pal, **TOL, err_msg=f"n={n}")


@pytest.mark.parametrize("act", ACTS)
def test_pointwise_offset_view_matches_jax(act):
    """``x.view(-1)[1:]``: contiguous, one element past the start of its
    storage."""
    base = _np(11, (2, 5, 7, 3), 4.0)
    x = torch.from_numpy(base).view(-1)[1:]
    assert x.is_contiguous() and x.storage_offset() == 1
    got = tpw.pointwise(x, act).numpy()
    want = np.asarray(jref.ACTIVATIONS[act](jnp.asarray(base.ravel()[1:])))
    np.testing.assert_allclose(got, want, **TOL)


def test_relu_keeps_nan_as_jax_does():
    """``jax.nn.relu`` and the plain ``pointwise(·, "relu")`` both give
    NaN for NaN (assert_array_equal takes NaN as equal to NaN)."""
    x = _np(12, (4099,), 4.0)
    x[::7] = np.nan
    got = tpw.pointwise(torch.from_numpy(x), "relu").numpy()
    want = np.asarray(jax.nn.relu(jnp.asarray(x)))
    assert np.isnan(got).sum() == np.isnan(x).sum() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(
        jref.ACTIVATIONS["relu"](jnp.asarray(x))))


def test_empty_operands_return_empty_results_on_the_cpu():
    n_pw, n_rs = tpw.launches.value, tresize.launches.value
    assert tpw.pointwise(torch.zeros(0), "silu").shape == (0,)
    assert tresize.resize_nearest(torch.zeros(2, 0, 3, 4)).shape == \
        (2, 0, 6, 4)
    assert (tpw.launches.value, tresize.launches.value) == (n_pw, n_rs)


# --------------------------------------------------------------------------
# the wrappers' plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [132, 114, 1])
def test_pointwise_grid_follows_the_sm_count(sms):
    cap = sms * tpw.BLOCKS_PER_SM
    # one thread a float4 up to one wave of the card; 8×80×80×64 floats
    # (a chip_smoke case) fill the wave on an H100, 8×5×5×64 take 13
    # blocks
    for n in (8 * 80 * 80 * 64, 8 * 5 * 5 * 64, 5, 1 << 30):
        head, nvec, blocks = tpw._plan(n, 0, 512, sms)
        assert (head, nvec) == (0, n // 4)
        assert blocks == max(1, min(-(-nvec // tpw.THREADS), cap))
    assert tpw._plan(8 * 80 * 80 * 64, 0, 512, 132)[2] == 132 * 8
    assert tpw._plan(8 * 5 * 5 * 64, 0, 512, 132)[2] == 13


@pytest.mark.parametrize("x_off,y_off", [(0, 0), (4, 4), (8, 8), (12, 12),
                                         (4, 0), (0, 8), (12, 4)])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 7, 4099])
def test_pointwise_vector_path_needs_one_alignment(x_off, y_off, n):
    """The float4 body is taken when x and y sit at the same offset from
    a 16-byte boundary: the head brings both to it, and head + body +
    tail cover n. Else every element is a scalar."""
    head, nvec, blocks = tpw._plan(n, 4096 + x_off, 8192 + y_off, 132)
    assert blocks >= 1
    if x_off != y_off:
        assert (head, nvec) == (0, 0)
        return
    assert head == min(n, (16 - x_off) % 16 // 4)
    assert (4096 + x_off + 4 * head) % 16 == 0 or head == n
    tail = n - head - 4 * nvec
    assert 0 <= tail < 4 and nvec >= 0


@pytest.mark.parametrize("C", [1, 3, 4, 6, 8, 64, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_resize_plan(C, aligned):
    for N, H, W in ((8, 20, 20), (8, 40, 40), (1, 1, 1), (300, 400, 3)):
        vec, threads, gx, gy = tresize._plan(N, H, W, C, aligned)
        assert vec == int(aligned and C % 4 == 0)
        row = W * (C // 4 if vec else C)
        assert threads % 32 == 0 and 32 <= threads <= tresize.MAX_THREADS
        assert gx * threads >= row > (gx - 1) * threads
        assert gy == min(N * H, tresize.MAX_GRID_Y)
    # main's two resize launches at 640: one block row of 5 × 256 each
    assert tresize._plan(8, 20, 20, 256, True) == (1, 256, 5, 160)
    assert tresize._plan(8, 40, 40, 128, True) == (1, 256, 5, 320)


# --------------------------------------------------------------------------
# the launch path, its CUDA calls replaced by stand-ins
# --------------------------------------------------------------------------

class _Card:
    """Stand-ins for the calls ``_build.launch`` makes into CUDA: a
    current device, a raw stream handle per device, the device switch."""

    def __init__(self, monkeypatch, current=0, rc=0):
        self.current, self.rc, self.calls, self.switches = current, rc, [], []
        monkeypatch.setattr(_build, "_lib", object())
        monkeypatch.setattr(_build, "_fns", {"repro_fake": self.fn})
        monkeypatch.setattr(torch._C, "_cuda_getDevice",
                            lambda: self.current, raising=False)
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            lambda idx: 1000 + idx + 100 * self.current,
                            raising=False)
        monkeypatch.setattr(torch.cuda, "device", self.device)

    def fn(self, *args):
        self.calls.append((self.current, args))
        return self.rc

    @contextlib.contextmanager
    def device(self, idx):
        before, self.current = self.current, idx
        self.switches.append(idx)
        try:
            yield
        finally:
            self.current = before


def test_launch_uses_the_current_stream_without_a_switch(monkeypatch):
    card = _Card(monkeypatch, current=0)
    _build.launch("repro_fake", torch.device("cuda", 0), 7, 8)
    assert card.calls == [(0, (7, 8, 1000))] and card.switches == []


def test_launch_switches_to_the_operands_device(monkeypatch):
    card = _Card(monkeypatch, current=0)
    _build.launch("repro_fake", torch.device("cuda", 2), 7)
    # launched with device 2 current, on device 2's stream, then back
    assert card.calls == [(2, (7, 1202))] and card.switches == [2]
    assert card.current == 0


def test_launch_raises_on_a_cuda_error_code(monkeypatch):
    _Card(monkeypatch, rc=9)        # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="repro_fake.*error 9"):
        _build.launch("repro_fake", torch.device("cuda", 0))


def test_library_returns_the_loaded_library_without_the_lock(monkeypatch):
    lib = object()

    class Held:
        def __enter__(self):
            raise AssertionError("library() took the lock")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "_lock", Held())
    assert _build.library() is lib


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds #4 and #5 "
                    "against their plain versions there)")
    return torch.device("cuda", 0)


def _offset(t, off):
    """A contiguous copy of ``t`` starting ``off`` floats past a fresh
    allocation (16-byte aligned) of the card's memory."""
    buf = torch.empty(t.numel() + off, device=t.device)
    v = buf[off:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("C", [3, 4, 6, 8])
@pytest.mark.parametrize("scale", [1, 2, 3])
@pytest.mark.parametrize("off", [0, 1])
def test_resize_on_the_card(cuda_device, C, scale, off):
    x = _offset(torch.randn(2, 5, 7, C, device=cuda_device), off)
    n = tresize.launches.value
    got = tresize.resize_nearest(x, scale=scale)
    again = tresize.resize_nearest(x, scale=scale)
    torch.cuda.synchronize()
    assert tresize.launches.value == n + 2
    assert torch.equal(got, tref.resize_nearest(x, scale=scale))
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
def test_pointwise_on_the_card(cuda_device, act):
    for n in LENGTHS + (8 * 5 * 5 * 64, 3 * 1_000_003):
        for off in (0, 1, 3):
            x = _offset(torch.randn(n, device=cuda_device) * 4, off)
            got = tpw.pointwise(x, act)
            again = tpw.pointwise(x, act)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, tref.pointwise(x, act), **TOL,
                                       msg=lambda m: f"n={n} off={off}: {m}")
            assert torch.equal(got, again), (n, off)


@pytest.mark.gpu
@pytest.mark.parametrize("off", [0, 1, 3])
def test_relu_keeps_nan_on_the_card(cuda_device, off):
    """NaN stays NaN, as in ``torch.relu`` (the earlier epilogue's fmaxf
    gave 0), on the float4 body and the scalar head and tail alike."""
    for n in LENGTHS + (8 * 5 * 5 * 64,):
        x = torch.randn(n, device=cuda_device) * 4
        x[::7] = float("nan")
        x = _offset(x, off)
        got = tpw.pointwise(x, "relu")
        torch.cuda.synchronize()
        torch.testing.assert_close(got, tref.pointwise(x, "relu"), rtol=0,
                                   atol=0, equal_nan=True)
        assert torch.isnan(got).sum() == torch.isnan(x).sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("off", [1, 2, 3])
def test_pointwise_head_on_the_card(cuda_device, off):
    """x and y both ``off`` floats past a 16-byte boundary: the kernel's
    scalar head, float4 body and tail, launched through the entry point
    the wrapper calls."""
    n = 4099
    x = _offset(torch.randn(n, device=cuda_device) * 4, off)
    y = _offset(torch.zeros(n, device=cuda_device), off)
    head, nvec, blocks = tpw._plan(n, x.data_ptr(), y.data_ptr(),
                                   _build.sm_count(cuda_device))
    assert head == 4 - off and nvec > 0
    _build.launch("repro_pointwise_f32", cuda_device, x.data_ptr(),
                  y.data_ptr(), n, head, nvec, _build.act_code("silu"),
                  blocks)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, tref.pointwise(x, "silu"), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["pointwise", "resize"])
def test_launch_on_a_non_default_stream(cuda_device, kernel):
    """The copy into x waits on the side stream behind a spin; a kernel
    that launched on any other stream would read x before the copy."""
    src = torch.randn(8, 20, 20, 64, device=cuda_device)
    x = torch.zeros_like(src)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        x.copy_(src)
        got = tpw.pointwise(x, "silu") if kernel == "pointwise" \
            else tresize.resize_nearest(x)
    side.synchronize()
    want = tref.pointwise(src, "silu") if kernel == "pointwise" \
        else tref.resize_nearest(src)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_refused_launch_raises_and_is_not_counted(cuda_device,
                                                  monkeypatch):
    """A grid of 0 blocks is refused (invalid configuration): the wrapper
    raises and does not count it."""
    x = torch.randn(1000, device=cuda_device)
    monkeypatch.setattr(tpw, "_plan", lambda *a: (0, 250, 0))
    n = tpw.launches.value
    with pytest.raises(RuntimeError, match="repro_pointwise_f32"):
        tpw.pointwise(x, "relu")
    assert tpw.launches.value == n
    monkeypatch.setattr(tresize, "_plan", lambda *a: (1, 32, 0, 1))
    n = tresize.launches.value
    with pytest.raises(RuntimeError, match="repro_resize_nearest"):
        tresize.resize_nearest(torch.randn(1, 2, 2, 4, device=cuda_device))
    assert tresize.launches.value == n


@pytest.mark.gpu
def test_empty_operands_launch_nothing_on_the_card(cuda_device):
    n_pw, n_rs = tpw.launches.value, tresize.launches.value
    got = tpw.pointwise(torch.zeros(0, device=cuda_device), "gelu")
    assert got.shape == (0,) and got.is_cuda
    for shape in ((0, 5, 4, 8), (2, 0, 4, 3), (2, 5, 0, 8), (2, 5, 4, 0)):
        got = tresize.resize_nearest(torch.zeros(shape, device=cuda_device),
                                     scale=3)
        N, H, W, C = shape
        assert got.shape == (N, 3 * H, 3 * W, C) and got.is_cuda
    assert (tpw.launches.value, tresize.launches.value) == (n_pw, n_rs)
