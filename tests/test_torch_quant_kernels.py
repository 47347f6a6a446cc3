"""The port's quantized kernels against the JAX package, on the CPU.

Inputs and weights come from numpy with fixed seeds; the integer codes
come from the JAX package's quantizer and reach both sides as the same
arrays. The JAX side runs ``repro.kernels.ops`` on its oracles
(``backend="ref"``) and on its Pallas kernels in interpret mode
(``backend="interpret"``); the port runs its kernel wrappers, which on a
CPU tensor run their plain versions (``repro_torch.kernels.ref``). The
CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``.

Tolerances: float outputs atol = rtol = 1e-4 (float32 sums in another
order; the Pallas a8 kernel folds ``wscale·x_scale`` where the oracle
computes ``x_scale·scale``, ~1 ulp apart). Bit-exact: the unpacked int4
codes, the activation codes (``round(x / s)`` half to even, saturated),
the im2col patches and the int32 accumulators.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels import qmatmul as jqmm
from repro.kernels import ref as jref
from repro_torch.core import quant as tq
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as tqmm
from repro_torch.kernels import ref as tref

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
ACTS = sorted(tref.ACTIVATIONS)
# the Pallas epilogue returns the identity for gelu; compare it to the
# oracle only
PALLAS_ACTS = ("hardswish", "leaky_relu", "silu", "relu", "identity")


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _codes(seed, K, N, kind, per_column):
    """A JAX QTensor of a random (K, N) weight: int8, int16 or packed
    int4 codes, per-tensor or per-column scales."""
    bits = {"int8": 8, "int16": 16, "int4": 4}[kind]
    gran = dict(granularity="per_channel", axis=-1) if per_column \
        else dict(granularity="per_tensor")
    return jq.quantize(jnp.asarray(_np(seed, (K, N), K ** -0.5)),
                       jq.QuantConfig(bits=bits, pack=(kind == "int4"),
                                      **gran))


# --------------------------------------------------------------------------
# bit-exact pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [6, 7])
def test_unpack4_bit_exact(rows):
    q = np.random.default_rng(rows).integers(-8, 8, size=(rows, 9)
                                             ).astype(np.int8)
    packed = np.asarray(jq.pack_int4(jnp.asarray(q)))
    got = tref.unpack4(_t(packed))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jqmm._unpack4(packed)))
    np.testing.assert_array_equal(got[:rows].numpy(), q)
    np.testing.assert_array_equal(
        got[:rows].numpy(), tq.unpack_int4(_t(packed), rows).numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_activation_bit_exact(bits):
    """Exact .5 ties go to even, out-of-range values saturate, and a
    per-channel scale vector broadcasts over the trailing axis."""
    s = 0.25
    ties = np.array([0.125, 0.375, -0.125, -0.375, 0.625, 1.125, -1.125,
                     100.0, -100.0, 31.875, -32.125], np.float32)
    x = np.concatenate([ties, _np(0, (53,), 3.0)]).reshape(8, 8)
    got = tref.quantize_activation(_t(x), s, bits=bits)
    want = np.asarray(jref.quantize_activation(jnp.asarray(x), s,
                                               bits=bits))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    qmax = 2 ** (bits - 1) - 1
    assert got.max() == qmax and got.min() == -qmax - 1
    np.testing.assert_array_equal(got.numpy().ravel()[:4],
                                  [0, 2, 0, -2])     # half to even
    sv = np.linspace(0.05, 0.4, 8).astype(np.float32)
    got = tref.quantize_activation(_t(x), _t(sv), bits=bits)
    want = jref.quantize_activation(jnp.asarray(x), jnp.asarray(sv),
                                    bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K,stride,dtype", [(1, 1, "f32"), (1, 2, "f32"),
                                            (3, 1, "f32"), (3, 2, "i8"),
                                            (6, 2, "f32"), (6, 1, "i8")])
def test_im2col_bit_equal(K, stride, dtype):
    x = _np(1, (2, 9, 7, 5), 2.0)
    if dtype == "i8":
        x = np.clip(np.round(x * 20), -128, 127).astype(np.int8)
    got, geo = ops._im2col(_t(x), K, stride)
    want, jgeo = jops._im2col(jnp.asarray(x), K, stride)
    assert geo == tuple(jgeo)
    assert got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,K", [("int8", 64), ("int4", 37)])
def test_int32_accumulator_bit_exact(kind, K):
    """scale = 1, zero = 0, x_scale = 1, no bias, identity act: y is the
    int32 accumulator exactly, on every side."""
    M, N = 24, 20
    xq = np.random.default_rng(2).integers(-128, 128, size=(M, K)
                                           ).astype(np.int8)
    codes = np.random.default_rng(3).integers(
        -8 if kind == "int4" else -128, 8 if kind == "int4" else 128,
        size=(K, N)).astype(np.int8)
    packed = kind == "int4"
    q = np.asarray(jq.pack_int4(jnp.asarray(codes))) if packed else codes
    acc = xq.astype(np.int64) @ codes.astype(np.int64)
    np.testing.assert_array_equal(
        tref.int_matmul(_t(xq), _t(codes)).numpy(), acc)
    got = tqmm.qmatmul_a8(_t(xq), _t(q), 1.0, 0.0, x_scale=1.0,
                          w_packed=packed)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.float32))
    jint = jqmm.qmatmul_a8(jnp.asarray(xq), jnp.asarray(q),
                           jnp.float32(1.0), jnp.float32(0.0), x_scale=1.0,
                           w_packed=packed, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jint))


# --------------------------------------------------------------------------
# qmatmul (#7): float x × int8 / int16 / packed-int4 codes
# --------------------------------------------------------------------------

QMM_CASES = [(kind, per_col, ACTS[i % len(ACTS)], i % 2 == 1)
             for i, (kind, per_col) in enumerate(itertools.product(
                 ("int8", "int16", "int4"), (False, True)))]


@pytest.mark.parametrize("kind,per_col,act,use_res", QMM_CASES,
                         ids=lambda v: str(v))
def test_qmatmul_matches_jax(kind, per_col, act, use_res):
    M, K, N = 40, 27, 20                  # odd K: the packed pad nibble
    x = _np(4, (M, K))
    b = _np(5, (N,), 0.1)
    res = _np(6, (M, N)) if use_res else None
    qt = _codes(7, K, N, kind, per_col)
    packed = kind == "int4"
    q = np.asarray(qt.q)
    if not packed:
        assert q.dtype == (np.int16 if kind == "int16" else np.int8)
    scale, zero = np.asarray(qt.scale), np.asarray(qt.zero)
    got = tqmm.qmatmul(_t(x), _t(q), _t(scale), _t(zero), _t(b), act=act,
                       res=None if res is None else _t(res),
                       w_packed=packed)
    got_ops = ops.qmatmul(_t(x), _t(q), _t(scale), _t(zero), _t(b),
                          act=act, res=None if res is None else _t(res),
                          w_packed=packed, backend="ref")
    np.testing.assert_array_equal(got.numpy(), got_ops.numpy())
    codes = np.asarray(jqmm._unpack4(jnp.asarray(q)))[:K] if packed else q
    want = jops.qmatmul(jnp.asarray(x), jnp.asarray(codes),
                        jnp.asarray(scale), jnp.asarray(zero),
                        jnp.asarray(b), act=act,
                        res=None if res is None else jnp.asarray(res),
                        backend="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if act in PALLAS_ACTS:
        pal = jops.qmatmul(jnp.asarray(x), jnp.asarray(q),
                           jnp.asarray(scale), jnp.asarray(zero),
                           jnp.asarray(b), act=act,
                           res=None if res is None else jnp.asarray(res),
                           backend="interpret", w_packed=packed)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), **TOL)


# --------------------------------------------------------------------------
# qmatmul_a8 (#8) and the grouped variant (#9)
# --------------------------------------------------------------------------

def _a8_inputs(K, N=16, M=24, kind="int8", per_col=True, seed=8):
    x = _np(seed, (M, K))
    qt = _codes(seed + 1, K, N, kind, per_col)
    return x, qt, _np(seed + 2, (N,), 0.1)


def _jax_a8(x, qt, b, x_scale, act, backend, packed=False):
    q = np.asarray(qt.q)
    if backend == "ref" and packed:
        q = np.asarray(jqmm._unpack4(jnp.asarray(q)))[:x.shape[1]]
        packed = False
    return np.asarray(jops.qmatmul_a8(
        jnp.asarray(x), jnp.asarray(q), qt.scale, qt.zero, jnp.asarray(b),
        x_scale=x_scale, act=act, w_packed=packed, backend=backend))


@pytest.mark.parametrize("kind,per_col,act", [
    ("int8", True, "leaky_relu"), ("int8", False, "hardswish"),
    ("int4", True, "identity"), ("int4", False, "relu")])
def test_qmatmul_a8_per_tensor_matches_jax(kind, per_col, act):
    K = 45
    x, qt, b = _a8_inputs(K, kind=kind, per_col=per_col)
    packed = kind == "int4"
    xs = float(np.abs(x).max() / 127)
    got = ops.qmatmul_a8(_t(x), _t(np.asarray(qt.q)), _t(np.asarray(
        qt.scale)), _t(np.asarray(qt.zero)), _t(b), x_scale=xs, act=act,
        w_packed=packed)
    for be in ("ref", "interpret"):
        np.testing.assert_allclose(
            got.numpy(), _jax_a8(x, qt, b, xs, act, be, packed), **TOL)


def _group_scales(runs):
    vals = (0.03, 0.06, 0.04, 0.08, 0.05, 0.02, 0.07)
    return tuple(float(v) for v, r in zip(vals, runs) for _ in range(r))


@pytest.mark.parametrize("runs,launch", [
    ((16, 16, 16, 16), "grouped"),          # aligned: tk 16
    # the tuple of test_quant_speed.py:215; its comment expects the
    # float fallback, but _group_tile aligns runs of 9 at tk = 9
    ((9,) * 7, "grouped"),
    ((6,) * 7, "qmatmul")])                 # gcd 6 < 8: no usable tile
def test_qmatmul_a8_per_group_matches_jax(runs, launch):
    sv = _group_scales(runs)
    K = len(sv)
    x, qt, b = _a8_inputs(K, seed=11)
    tk, _ = tqmm._group_tile(sv, K, 128, False)
    jtk, _ = jqmm._group_tile(sv, K, 128, False)
    assert tk == jtk and (tk is None) == (launch == "qmatmul")
    got = ops.qmatmul_a8(_t(x), _t(np.asarray(qt.q)), _t(np.asarray(
        qt.scale)), _t(np.asarray(qt.zero)), _t(b), x_scale=sv,
        act="leaky_relu")
    for be in ("ref", "interpret"):
        np.testing.assert_allclose(
            got.numpy(), _jax_a8(x, qt, b, sv, "leaky_relu", be), **TOL)
    if launch == "grouped":
        xq = tref.quantize_activation(_t(x), _t(np.asarray(sv)))
        direct = tqmm.qmatmul_a8_grouped(
            xq, _t(np.asarray(qt.q)), _t(np.asarray(qt.scale)),
            _t(np.asarray(qt.zero)), _t(b), x_scale=sv, act="leaky_relu")
        np.testing.assert_array_equal(direct.numpy(), got.numpy())


def test_double_pipeline_equals_grid_on_cpu():
    """``pipeline`` raises only on a value other than "grid" and
    "double": "double" (kernel #10 on the card) runs, and on the CPU it
    equals "grid" (tests/test_torch_double_kernels.py holds it against
    the JAX package's DMA kernel)."""
    rng = np.random.default_rng(3)
    xq = _t(rng.integers(-127, 128, (8, 16)).astype(np.int8))
    q = _t(rng.integers(-127, 128, (16, 8)).astype(np.int8))
    x = _t(_np(4, (1, 4, 4, 16)))
    got = {p: (tqmm.qmatmul_a8(xq, q, 0.01, 0.0, x_scale=0.1, pipeline=p),
               ops.qconv2d_a8(x, q.reshape(1, 1, 16, 8), torch.ones(1),
                              torch.zeros(1), x_scale=0.1, pipeline=p))
           for p in ("grid", "double")}
    for g, d in zip(got["grid"], got["double"]):
        np.testing.assert_array_equal(d.numpy(), g.numpy())
    with pytest.raises(ValueError, match="pipeline"):
        tqmm.qmatmul_a8(xq, q, 1.0, 0.0, x_scale=1.0, pipeline="dma")
    with pytest.raises(ValueError, match="pipeline"):
        ops.qconv2d_a8(x, q.reshape(1, 1, 16, 8), torch.ones(1),
                       torch.zeros(1), x_scale=0.1, pipeline="dma")


# --------------------------------------------------------------------------
# quantized convs
# --------------------------------------------------------------------------

CONV_CASES = [(K, s, ACTS[i % len(ACTS)], i % 2 == 0)
              for i, (K, s) in enumerate(itertools.product((1, 3, 6),
                                                           (1, 2)))]


def _conv_inputs(K, s, use_res, kind, seed):
    """Odd H and W; ``x`` given as a channel-window list."""
    a = _np(seed, (2, 9, 7, 4))
    c = _np(seed + 1, (2, 9, 7, 6))
    xd = np.concatenate([a, c[..., 1:5]], -1)         # C = 8
    F = 12
    w = _np(seed + 2, (K, K, 8, F), (K * K * 8) ** -0.5)
    bits = {"int8": 8, "int16": 16, "int4": 4}[kind]
    qt = jq.quantize(jnp.asarray(w), jq.QuantConfig(
        bits=bits, granularity="per_channel", axis=-1,
        pack=(kind == "int4")))
    Ho, Wo = -(-9 // s), -(-7 // s)
    res = _np(seed + 3, (2, Ho, Wo, F)) if use_res else None
    b = _np(seed + 4, (F,), 0.1)
    jwin = [(jnp.asarray(a), 0, 4), (jnp.asarray(c), 1, 4)]
    twin = [(_t(a), 0, 4), (_t(c), 1, 4)]
    return xd, jwin, twin, qt, res, b


@pytest.mark.parametrize("K,stride,act,use_res", CONV_CASES,
                         ids=lambda v: str(v))
def test_qconv2d_matches_jax(K, stride, act, use_res):
    kind = ("int8", "int16", "int4")[K % 3]
    xd, jwin, twin, qt, res, b = _conv_inputs(K, stride, use_res, kind, 20)
    packed = kind == "int4"
    pool = (2, 2, "leaky_relu") if K == 3 else None
    args = dict(K=K, stride=stride, act=act, w_packed=packed, pool=pool)
    got = ops.qconv2d(twin, _t(np.asarray(qt.q)), _t(np.asarray(qt.scale)),
                      _t(np.asarray(qt.zero)), _t(b),
                      res=None if res is None else _t(res), **args)
    want = jops.qconv2d(jwin, qt.q, qt.scale, qt.zero, jnp.asarray(b),
                        res=None if res is None else jnp.asarray(res),
                        backend="ref", **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if act in PALLAS_ACTS:
        pal = jops.qconv2d(jwin, qt.q, qt.scale, qt.zero, jnp.asarray(b),
                           res=None if res is None else jnp.asarray(res),
                           backend="interpret", **args)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), **TOL)


@pytest.mark.parametrize("K,stride,act,use_res", CONV_CASES,
                         ids=lambda v: str(v))
def test_qconv2d_a8_matches_jax(K, stride, act, use_res):
    kind = ("int8", "int4")[K % 2]
    xd, jwin, twin, qt, res, b = _conv_inputs(K, stride, use_res, kind, 30)
    packed = kind == "int4"
    amax = np.abs(xd).max(axis=(0, 1, 2))
    if stride == 1:                           # per-channel (per group of 4)
        g = np.repeat(amax.reshape(2, 4).max(1), 4)
        xs = tuple(float(v / 127) for v in g)
    else:
        xs = float(amax.max() / 127)
    pool = (2, 2, "relu") if K == 1 else None
    args = dict(x_scale=xs, a_bits=8 if K != 6 else 4, K=K, stride=stride,
                act=act, w_packed=packed, pool=pool)
    got = ops.qconv2d_a8(twin, _t(np.asarray(qt.q)),
                         _t(np.asarray(qt.scale)), _t(np.asarray(qt.zero)),
                         _t(b), res=None if res is None else _t(res), **args)
    want = jops.qconv2d_a8(jwin, qt.q, qt.scale, qt.zero, jnp.asarray(b),
                           res=None if res is None else jnp.asarray(res),
                           backend="ref", **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if act in PALLAS_ACTS:
        pal = jops.qconv2d_a8(jwin, qt.q, qt.scale, qt.zero,
                              jnp.asarray(b),
                              res=None if res is None else jnp.asarray(res),
                              backend="interpret", **args)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), **TOL)


def test_conv2d_pool_epilogue_matches_jax():
    x = _np(40, (2, 9, 9, 6))
    w = _np(41, (3, 3, 6, 8), 0.2)
    b = _np(42, (8,), 0.1)
    pool = (2, 2, "leaky_relu")
    got = ops.conv2d(_t(x), _t(w), _t(b), act="identity", pool=pool)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       act="identity", pool=pool, backend="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quant_helpers_match_jax():
    """fake_quant, dequantize_tree and quant_error of the port's quant
    module against the JAX package's."""
    w = _np(50, (3, 3, 4, 6))
    np.testing.assert_allclose(
        tq.fake_quant(_t(w), bits=8).numpy(),
        np.asarray(jq.fake_quant(jnp.asarray(w), bits=8)), rtol=0,
        atol=1e-7)
    for cfg in (dict(bits=8), dict(bits=4, granularity="per_channel",
                                   axis=-1, pack=True)):
        je = jq.quant_error(jnp.asarray(w), jq.QuantConfig(**cfg))
        te = tq.quant_error(_t(w), tq.QuantConfig(**cfg))
        assert te.keys() == je.keys()
        for k in je:
            assert te[k] == pytest.approx(je[k], rel=1e-5), k
    tree = {"c": {"w": tq.quantize(_t(w), tq.QuantConfig(bits=8)),
                  "b": _t(w[0, 0, 0])}}
    jtree = {"c": {"w": jq.quantize(jnp.asarray(w), jq.QuantConfig(bits=8)),
                   "b": jnp.asarray(w[0, 0, 0])}}
    got, want = tq.dequantize_tree(tree), jq.dequantize_tree(jtree)
    np.testing.assert_array_equal(got["c"]["w"].numpy(),
                                  np.asarray(want["c"]["w"]))
    np.testing.assert_array_equal(got["c"]["b"].numpy(), w[0, 0, 0])
