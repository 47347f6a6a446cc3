"""The port's quantizer (``repro_torch.core.quant``) against the JAX
package's: integer codes and packed bytes bit-exact, scales and zero
points bit-exact, dequantized weights bit-exact, and the half-to-even
rounding of ``round(w/S − Z)`` pinned at exact .5 points."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq

from _port_memory import release_memory  # noqa: F401


def _w(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cfg_pair(**kw):
    return jq.QuantConfig(**kw), tq.QuantConfig(**kw)


def _assert_same(jt, tt):
    assert tt.bits == jt.bits and tt.shape == tuple(jt.shape)
    assert tt.packed == jt.packed
    assert str(tt.q.dtype) == f"torch.{jt.q.dtype}"
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(tt.scale.numpy(), np.asarray(jt.scale))
    np.testing.assert_array_equal(tt.zero.numpy(), np.asarray(jt.zero))
    assert tt.code_nbytes == jt.code_nbytes


CASES = [dict(bits=8, granularity="per_tensor"),
         dict(bits=8, granularity="per_channel", axis=-1),
         dict(bits=8, granularity="per_channel", axis=0),
         dict(bits=16, granularity="per_tensor"),
         dict(bits=16, granularity="per_channel", axis=-1),
         dict(bits=4, granularity="per_tensor", pack=True),
         dict(bits=4, granularity="per_channel", axis=-1, pack=True),
         dict(bits=8, granularity="per_tensor", symmetric=True)]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_codes_bit_exact(kw):
    w = _w(0, (3, 3, 5, 7))
    jc, tc = _cfg_pair(**kw)
    jt = jq.quantize(jnp.asarray(w), jc)
    tt = tq.quantize(torch.from_numpy(w), tc)
    _assert_same(jt, tt)
    np.testing.assert_array_equal(tt.dequantize().numpy(),
                                  np.asarray(jt.dequantize()))
    np.testing.assert_array_equal(tq.dequantize(tt).numpy(),
                                  np.asarray(jq.dequantize(jt)))


def test_half_points_round_to_even():
    """Weights chosen so that w/S − Z lands on exact .5 points: S = 1
    (range 255 at W8) and integer-plus-half weights."""
    w = np.array([[0.0, 255.0, 0.5, 1.5, 2.5, 3.5, 100.5, 101.5]],
                 np.float32)
    jc, tc = _cfg_pair(bits=8, granularity="per_tensor")
    jt = jq.quantize(jnp.asarray(w), jc)
    tt = tq.quantize(torch.from_numpy(w), tc)
    assert float(tt.scale) == 1.0
    _assert_same(jt, tt)
    # z = round(0/1) + 128 = 128; q = round(w − 128): .5 ties go to even
    np.testing.assert_array_equal(tt.q.numpy()[0, 2:6], [-128, -126, -126,
                                                         -124])


def test_pack_unpack_roundtrip_bit_exact():
    q = np.random.default_rng(3).integers(-8, 8, size=(7, 5)).astype(np.int8)
    jp = jq.pack_int4(jnp.asarray(q))
    tp = tq.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tq.unpack_int4(tp, 7).numpy(), q)


def test_quantize_tree_and_params_from_numpy():
    """The toolflow's default storage scheme (W8; ≥3-dim leaves get
    per-channel scales over axis 0) and the numpy bridge: a JAX QTensor
    converted by duck typing equals the port's own quantization."""
    params = {"c1": {"w": _w(4, (3, 3, 4, 8)), "b": _w(5, (8,))},
              "c2": {"w": _w(6, (1, 1, 8, 2)), "b": _w(7, (2,))}}
    cfg = dataclasses.asdict(tq.QuantConfig(bits=8))
    jtree = jq.quantize_tree({k: {kk: jnp.asarray(v) for kk, v in p.items()}
                              for k, p in params.items()},
                             jq.QuantConfig(**cfg))
    ttree = tq.quantize_tree(params_from_numpy(params, device="cpu"),
                             tq.QuantConfig(**cfg))
    conv = params_from_numpy(
        {k: {kk: (v if isinstance(v, jq.QTensor) else np.asarray(v))
             for kk, v in p.items()} for k, p in jtree.items()}, device="cpu")
    for name in params:
        _assert_same(jtree[name]["w"], ttree[name]["w"])
        _assert_same(jtree[name]["w"], conv[name]["w"])
        assert ttree[name]["b"].dtype == torch.float32
        np.testing.assert_array_equal(ttree[name]["b"].numpy(),
                                      params[name]["b"])
