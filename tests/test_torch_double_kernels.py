"""The double-buffered pipelines (``pipeline="double"``) of the port
against the JAX package, on the CPU.

The JAX side runs its DMA double-buffered Pallas kernels in interpret
mode (``conv2d._conv_dma_kernel``, ``qmatmul._qmm_a8_dma_kernel``); the
port runs ``conv2d(pipeline="double")``, ``qmatmul_a8(pipeline=
"double")`` and ``ops.qconv2d_a8(pipeline="double")``, which on a CPU
tensor run their plain versions whatever the knob. On the card the same
calls launch kernels #2 and #10 (``csrc/conv2d.cu``,
``csrc/qmatmul.cu``); ``chip_smoke.py`` holds them against their plain
versions and their grid siblings there, and the ``gpu``-marked tests
below do the same when run on a card.

Inputs and weights come from numpy with fixed seeds; the integer codes
come from the JAX package's quantizer and reach both sides as the same
arrays. Tolerances: the float conv atol = rtol = 1e-4 (float32 sums in
another order); the quantized outputs ``_quant_atol`` = 16·2^-bits of
the output range (``tests/test_backends.py``), the A8 outputs also
within 1e-4 of the JAX side (the same int32 sums, the scale folds about
1 ulp apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import conv2d as jconv
from repro.kernels import ops as jops
from repro.kernels import qmatmul as jqmm
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as tqmm
from repro_torch.kernels import ref as tref

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
PALLAS_ACTS = ("hardswish", "leaky_relu", "silu", "relu", "identity")


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _quant_atol(bits: int, out_scale: float) -> float:
    return 16.0 * 2.0 ** -bits * out_scale


# --------------------------------------------------------------------------
# #2: conv2d(pipeline="double")
# --------------------------------------------------------------------------

# (K, stride, res, th, tf): every K x stride, res on half of them; the
# JAX kernel's tiling: th 3 leaves a ragged last strip of the 9 (or 5)
# output rows, tf 4 < F = 10 gives a ragged last filter tile (the port
# takes no tiling hints: its tile is fixed)
CONV_CASES = [(1, 1, False, 8, 128), (1, 2, True, 3, 4),
              (3, 1, True, 3, 4), (3, 2, False, 8, 128),
              (6, 1, False, 4, 4), (6, 2, True, 2, 128)]


@pytest.mark.parametrize("K,stride,use_res,th,tf", CONV_CASES,
                         ids=lambda v: str(v))
def test_conv2d_double_matches_jax_dma_kernel(K, stride, use_res, th, tf):
    act = PALLAS_ACTS[(K + stride) % len(PALLAS_ACTS)]
    x = _np(K * 10 + stride, (2, 9, 7, 5))
    w = _np(1, (K, K, 5, 10), (K * K * 5) ** -0.5)
    b = _np(2, (10,), 0.1)
    Ho, Wo = -(-9 // stride), -(-7 // stride)
    res = _np(3, (2, Ho, Wo, 10)) if use_res else None
    got = tconv.conv2d(_t(x), _t(w), _t(b), stride=stride, act=act,
                       res=None if res is None else _t(res),
                       pipeline="double")
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        stride=stride, act=act,
                        res=None if res is None else jnp.asarray(res),
                        th=th, tf=tf, pipeline="double", interpret=True)
    assert tuple(got.shape) == tuple(want.shape) == (2, Ho, Wo, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    grid = tconv.conv2d(_t(x), _t(w), _t(b), stride=stride, act=act,
                        res=None if res is None else _t(res))
    np.testing.assert_array_equal(got.numpy(), grid.numpy())


# --------------------------------------------------------------------------
# #10: qmatmul_a8(pipeline="double")
# --------------------------------------------------------------------------

# (kind, K, per-column scales, act, res): int8 and packed int4 with an
# odd K (the last high nibble is padding), per-tensor and per-column
QMM_CASES = [("int8", 40, False, "leaky_relu", True),
             ("int8", 27, True, "identity", False),
             ("int4", 27, True, "hardswish", True),
             ("int4", 37, False, "relu", False)]


@pytest.mark.parametrize("kind,K,per_column,act,use_res", QMM_CASES,
                         ids=lambda v: str(v))
def test_qmatmul_a8_double_matches_jax_dma_kernel(kind, K, per_column, act,
                                                  use_res):
    M, N = 37, 20
    packed = kind == "int4"
    gran = dict(granularity="per_channel", axis=-1) if per_column \
        else dict(granularity="per_tensor")
    qt = jq.quantize(jnp.asarray(_np(K, (K, N), K ** -0.5)),
                     jq.QuantConfig(bits=4 if packed else 8, pack=packed,
                                    **gran))
    xq = np.random.default_rng(K + 1).integers(-127, 128, size=(M, K)
                                               ).astype(np.int8)
    b = _np(5, (N,), 0.1)
    res = _np(6, (M, N)) if use_res else None
    xs = 0.05
    got = tqmm.qmatmul_a8(_t(xq), _t(np.asarray(qt.q)),
                          _t(np.asarray(qt.scale)), _t(np.asarray(qt.zero)),
                          _t(b), x_scale=xs, act=act,
                          res=None if res is None else _t(res),
                          w_packed=packed, pipeline="double")
    want = np.asarray(jqmm.qmatmul_a8(
        jnp.asarray(xq), qt.q, qt.scale, qt.zero, jnp.asarray(b),
        x_scale=xs, act=act, res=None if res is None else jnp.asarray(res),
        w_packed=packed, pipeline="double", tm=16, tk=16, tn=16,
        interpret=True))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, atol=_quant_atol(
        8, float(np.abs(want).max())))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    grid = tqmm.qmatmul_a8(_t(xq), _t(np.asarray(qt.q)),
                           _t(np.asarray(qt.scale)),
                           _t(np.asarray(qt.zero)), _t(b), x_scale=xs,
                           act=act, res=None if res is None else _t(res),
                           w_packed=packed)
    np.testing.assert_array_equal(got.numpy(), grid.numpy())


@pytest.mark.parametrize("run", [8, 6])
def test_per_k_scales_ignore_the_pipeline(run):
    """A per-K tuple ``x_scale`` takes the grouped route (runs of 8) or
    the float one (runs of 6, no K tile >= 8) whatever ``pipeline``
    says, in both packages: "double" equals "grid" on each side, and the
    two sides agree."""
    M, K, N = 24, 48, 16
    qt = jq.quantize(jnp.asarray(_np(7, (K, N), K ** -0.5)),
                     jq.QuantConfig(bits=8, granularity="per_channel",
                                    axis=-1))
    xq = np.random.default_rng(8).integers(-127, 128, size=(M, K)
                                           ).astype(np.int8)
    sv = tuple(float(v) for v in np.repeat(
        np.linspace(0.01, 0.05, K // run), run))
    b = _np(9, (N,), 0.1)
    assert (jqmm._group_tile(sv, K, 128, False)[0] is None) == (run == 6)
    outs = {}
    for pipeline in ("grid", "double"):
        outs["jax", pipeline] = np.asarray(jqmm.qmatmul_a8(
            jnp.asarray(xq), qt.q, qt.scale, qt.zero, jnp.asarray(b),
            x_scale=sv, act="leaky_relu", pipeline=pipeline, tk=16,
            interpret=True))
        outs["torch", pipeline] = tqmm.qmatmul_a8(
            _t(xq), _t(np.asarray(qt.q)), _t(np.asarray(qt.scale)),
            _t(np.asarray(qt.zero)), _t(b), x_scale=sv, act="leaky_relu",
            pipeline=pipeline, tk=16).numpy()
    for side in ("jax", "torch"):
        np.testing.assert_array_equal(outs[side, "double"],
                                      outs[side, "grid"])
    np.testing.assert_allclose(outs["torch", "double"],
                               outs["jax", "double"], **TOL)


# --------------------------------------------------------------------------
# ops.qconv2d_a8(pipeline="double")
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K,stride,kind,pool", [
    (3, 1, "int4", (2, 2, "leaky_relu")), (1, 1, "int8", (2, 2, "relu")),
    (3, 2, "int8", None)], ids=lambda v: str(v))
def test_qconv2d_a8_double_matches_jax(K, stride, kind, pool):
    """``x`` and ``res`` as channel-window lists, a fused maxpool, a
    per-tensor activation scale."""
    a, c = _np(10, (2, 9, 7, 4)), _np(11, (2, 9, 7, 6))
    xd = np.concatenate([a, c[..., 1:5]], -1)            # C = 8
    F = 12
    packed = kind == "int4"
    qt = jq.quantize(jnp.asarray(_np(12, (K, K, 8, F), (K * K * 8) ** -0.5)),
                     jq.QuantConfig(bits=4 if packed else 8,
                                    granularity="per_channel", axis=-1,
                                    pack=packed))
    Ho, Wo = -(-9 // stride), -(-7 // stride)
    r1, r2 = _np(13, (2, Ho, Wo, 5)), _np(14, (2, Ho, Wo, 9))
    b = _np(15, (F,), 0.1)
    xs = float(np.abs(xd).max() / 127)
    args = dict(x_scale=xs, K=K, stride=stride, act="hardswish",
                w_packed=packed, pool=pool, pipeline="double")
    got = ops.qconv2d_a8([(_t(a), 0, 4), (_t(c), 1, 4)],
                         _t(np.asarray(qt.q)), _t(np.asarray(qt.scale)),
                         _t(np.asarray(qt.zero)), _t(b),
                         res=[(_t(r1), 0, 5), (_t(r2), 2, 7)], **args)
    want = np.asarray(jops.qconv2d_a8(
        [(jnp.asarray(a), 0, 4), (jnp.asarray(c), 1, 4)], qt.q, qt.scale,
        qt.zero, jnp.asarray(b),
        res=[(jnp.asarray(r1), 0, 5), (jnp.asarray(r2), 2, 7)],
        backend="interpret", **args))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=_quant_atol(
        8, float(np.abs(want).max())))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --------------------------------------------------------------------------
# the knob's interface
# --------------------------------------------------------------------------

def _small_qmm():
    xq = torch.ones((4, 16), dtype=torch.int8)
    q = torch.ones((16, 8), dtype=torch.int8)
    return xq, q


@pytest.mark.parametrize("pipeline", ["dma", "Double", ""])
def test_unknown_pipeline_raises(pipeline):
    x, w = torch.zeros((1, 4, 4, 3)), torch.zeros((3, 3, 3, 2))
    with pytest.raises(ValueError, match="pipeline"):
        tconv.conv2d(x, w, pipeline=pipeline)
    xq, q = _small_qmm()
    with pytest.raises(ValueError, match="pipeline"):
        tqmm.qmatmul_a8(xq, q, 1.0, 0.0, x_scale=0.1, pipeline=pipeline)
    with pytest.raises(ValueError, match="pipeline"):
        tqmm.qmatmul_a8(xq, q, 1.0, 0.0, x_scale=(0.1,) * 16,
                        pipeline=pipeline)
    with pytest.raises(ValueError, match="pipeline"):
        ops.qconv2d_a8(torch.zeros((1, 4, 4, 16)), q.reshape(1, 1, 16, 8),
                       torch.ones(1), torch.zeros(1), x_scale=0.1,
                       pipeline=pipeline)


def test_ref_backend_does_not_read_the_pipeline():
    """``ops.qconv2d_a8(backend="ref")`` ignores ``pipeline``, as the
    JAX package's ``ops.py:427-438`` does."""
    q = torch.ones((1, 1, 16, 8), dtype=torch.int8)
    x = torch.from_numpy(_np(16, (1, 4, 4, 16)))
    want = ops.qconv2d_a8(x, q, torch.ones(1), torch.zeros(1), x_scale=0.1,
                          backend="ref")
    got = ops.qconv2d_a8(x, q, torch.ones(1), torch.zeros(1), x_scale=0.1,
                         pipeline="no such pipeline", backend="ref")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _counts():
    return (tconv.launches.value, tconv.launches_double.value,
            tqmm.qmatmul_a8.launches.value,
            tqmm.qmatmul_a8.launches_double.value)


@pytest.mark.parametrize("pipeline", ["grid", "double"])
@pytest.mark.parametrize("entry", ["conv2d", "qmatmul_a8", "qconv2d_a8"])
def test_cpu_tensors_launch_no_kernel(entry, pipeline):
    """On CPU tensors every entry point runs its plain version whatever
    the knob: no kernel counter moves."""
    xq, q = _small_qmm()
    before = _counts()
    if entry == "conv2d":
        tconv.conv2d(torch.ones((1, 4, 4, 3)), torch.ones((3, 3, 3, 2)),
                     pipeline=pipeline)
    elif entry == "qmatmul_a8":
        tqmm.qmatmul_a8(xq, q, 1.0, 0.0, x_scale=0.1, pipeline=pipeline)
    else:
        ops.qconv2d_a8(torch.ones((1, 4, 4, 16)), q.reshape(1, 1, 16, 8),
                       torch.ones(1), torch.zeros(1), x_scale=0.1,
                       pipeline=pipeline)
    assert _counts() == before


# --------------------------------------------------------------------------
# on the card: #2 and #10 against #1 and #8
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py holds #2 and #10 "
                    "against their grid siblings there)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_double_conv_equals_grid_on_the_card(cuda_device, monkeypatch):
    # the plain version's F.conv2d runs through cuDNN, in TF32 unless
    # told otherwise; the kernels are full float32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 19, 17, 24, generator=gen, device=cuda_device)
    w = torch.randn(3, 3, 24, 70, generator=gen, device=cuda_device) * 0.1
    res = torch.randn(2, 10, 9, 70, generator=gen, device=cuda_device)
    n1, n2 = tconv.launches.value, tconv.launches_double.value
    grid = tconv.conv2d(x, w, stride=2, act="silu", res=res)
    got = tconv.conv2d(x, w, stride=2, act="silu", res=res,
                       pipeline="double")
    assert (tconv.launches.value, tconv.launches_double.value) == (n1 + 1,
                                                                   n2 + 1)
    torch.testing.assert_close(got, grid, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, tref.conv2d(x, w, stride=2, act="silu",
                                                res=res), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_double_qmatmul_a8_accumulator_on_the_card(cuda_device, packed):
    rng = np.random.default_rng(1)
    M, K, N = 130, 75, 67
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    codes = rng.integers(-8, 8, (K, N)).astype(np.int8)
    q = _t(jq.pack_int4(jnp.asarray(codes))) if packed \
        else torch.from_numpy(codes)
    xq, q = xq.to(cuda_device), q.to(cuda_device)
    one = torch.ones(1, device=cuda_device)
    nil = torch.zeros(1, device=cuda_device)
    n8, n10 = tqmm.qmatmul_a8.launches.value, \
        tqmm.qmatmul_a8.launches_double.value
    grid = tqmm.qmatmul_a8(xq, q, one, nil, x_scale=1.0, w_packed=packed)
    got = tqmm.qmatmul_a8(xq, q, one, nil, x_scale=1.0, w_packed=packed,
                          pipeline="double")
    assert (tqmm.qmatmul_a8.launches.value,
            tqmm.qmatmul_a8.launches_double.value) == (n8 + 1, n10 + 1)
    torch.testing.assert_close(got, grid, atol=0, rtol=0)
    want = xq.cpu().to(torch.int64) @ torch.from_numpy(codes).to(torch.int64)
    torch.testing.assert_close(got.cpu(), want.to(torch.float32), atol=0,
                               rtol=0)
