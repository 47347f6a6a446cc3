"""The port's kernel modules against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go through both the JAX
package's oracles (``repro.kernels.ref``) and its Pallas kernels in
interpret mode (``repro.kernels.{conv2d,maxpool,resize,pointwise}``),
and through the port's kernel wrappers, which on a CPU tensor run their
plain versions (``repro_torch.kernels.ref``). The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.

Tolerances: conv and pointwise atol = rtol = 1e-4 (float32 sums in
another order; the Pallas ``_act`` multiplies hardswish by 1/6 where the
oracle divides by 6); maxpool and resize are bit-equal (no arithmetic
beyond compares and copies, plus a monotone act on the pooled value).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv2d as jconv
from repro.kernels import maxpool as jpool
from repro.kernels import pointwise as jpw
from repro.kernels import ref as jref
from repro.kernels import resize as jresize
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import maxpool as tpool
from repro_torch.kernels import ops
from repro_torch.kernels import pointwise as tpw
from repro_torch.kernels import ref as tref
from repro_torch.kernels import resize as tresize

TOL = dict(atol=1e-4, rtol=1e-4)
# Activations the Pallas conv epilogue implements (its _act returns the
# identity for gelu; only the oracle is compared there).
PALLAS_ACTS = ("hardswish", "leaky_relu", "silu", "relu", "identity")


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


# every (K, stride, res) combination, cycling through every activation
_ACTS = sorted(tref.ACTIVATIONS)
CONV_CASES = [(K, s, res, _ACTS[i % len(_ACTS)])
              for i, (K, s, res) in enumerate(itertools.product(
                  (1, 3, 6), (1, 2), (False, True)))]


@pytest.mark.parametrize("K,stride,use_res,act", CONV_CASES,
                         ids=lambda v: str(v))
def test_conv2d_matches_jax(K, stride, use_res, act):
    """Odd H and W: the SAME pad splits asymmetrically (the extra row
    and column go at the bottom/right)."""
    N, H, W, C, F = 2, 9, 7, 5, 6
    x = _np(1, (N, H, W, C))
    w = _np(2, (K, K, C, F), 0.3)
    b = _np(3, (F,))
    Ho, Wo = -(-H // stride), -(-W // stride)
    r = _np(4, (N, Ho, Wo, F)) if use_res else None
    got = tconv.conv2d(_t(x), _t(w), _t(b), stride=stride, act=act,
                       res=_t(r) if use_res else None).numpy()
    want = np.asarray(jref.conv2d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), stride=stride, act=act,
                                  res=None if r is None else jnp.asarray(r)))
    assert got.shape == (N, Ho, Wo, F)
    np.testing.assert_allclose(got, want, **TOL)
    if act in PALLAS_ACTS or act == "none":
        pal = np.asarray(jconv.conv2d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
            act="identity" if act == "none" else act,
            res=None if r is None else jnp.asarray(r), interpret=True))
        np.testing.assert_allclose(got, pal, **TOL)


@pytest.mark.parametrize("size,K,stride", [(64, 3, 2), (64, 6, 2)],
                         ids=["v8-stem-3x3s2", "v5-stem-6x6s2"])
def test_conv2d_stem_padding_is_asymmetric(size, K, stride):
    """The v8 stem (3×3/2 on an even size) pads 0 rows on top and 1 at
    the bottom; a symmetric ``F.conv2d(padding=1)`` would be wrong."""
    x = _np(5, (1, size, size, 3))
    w = _np(6, (K, K, 3, 8), 0.3)
    got = tconv.conv2d(_t(x), _t(w), stride=stride).numpy()
    want = np.asarray(jref.conv2d(jnp.asarray(x), jnp.asarray(w),
                                  stride=stride))
    np.testing.assert_allclose(got, want, **TOL)
    if K == 3:
        sym = torch.nn.functional.conv2d(
            _t(x).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1),
            stride=stride, padding=1).permute(0, 2, 3, 1).numpy()
        assert np.abs(sym - want).max() > 1e-2


@pytest.mark.parametrize("k,stride,H", [(5, 1, 20), (2, 2, 13), (2, 1, 13)],
                         ids=["sppf-5s1", "down-2s2", "v3tiny-2s1"])
@pytest.mark.parametrize("act", ["identity", "leaky_relu"])
def test_maxpool_bit_equal_to_jax(k, stride, H, act):
    x = _np(7, (2, H, H + 2, 6))
    got = tpool.maxpool2d(_t(x), k=k, stride=stride, act=act).numpy()
    want = np.asarray(jref.maxpool2d(jnp.asarray(x), k=k, stride=stride,
                                     act=act))
    pal = np.asarray(jpool.maxpool2d(jnp.asarray(x), k=k, stride=stride,
                                     act=act, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("H,scale", [(5, 2), (7, 3)])
def test_resize_bit_equal_to_jax(H, scale):
    x = _np(8, (2, H, 4, 3))
    got = tresize.resize_nearest(_t(x), scale=scale).numpy()
    want = np.asarray(jref.resize_nearest(jnp.asarray(x), scale=scale))
    pal = np.asarray(jresize.resize_nearest(jnp.asarray(x), scale=scale,
                                            interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("act", sorted(tref.ACTIVATIONS))
def test_pointwise_matches_jax(act):
    x = _np(9, (2, 5, 7, 3), 4.0)
    got = tpw.pointwise(_t(x), act).numpy()
    want = np.asarray(jref.ACTIVATIONS[act](jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    if act in PALLAS_ACTS:
        pal = np.asarray(jpw.pointwise(jnp.asarray(x), act, interpret=True))
        np.testing.assert_allclose(got, pal, **TOL)


def test_activation_names_match_jax_reference():
    assert set(tref.ACTIVATIONS) == set(jref.ACTIVATIONS)


@pytest.mark.parametrize("act", ["sigmoid", "swish"])
def test_unknown_activation_raises(act):
    x = torch.zeros(1, 3, 3, 2)
    w = torch.zeros(1, 1, 2, 2)
    for call in (lambda: tpw.pointwise(x, act),
                 lambda: tref.pointwise(x, act),
                 lambda: tconv.conv2d(x, w, act=act),
                 lambda: tpool.maxpool2d(x, k=2, act=act)):
        with pytest.raises(ValueError):
            call()


def test_ops_backends_agree_and_windows_gather():
    """``ref`` and ``auto`` agree on the CPU; a channel-window operand
    equals the materialised concat; ``cuda`` refuses a CPU tensor."""
    a, b = _t(_np(10, (1, 6, 6, 4))), _t(_np(11, (1, 6, 6, 6)))
    w = _t(_np(12, (3, 3, 5, 4), 0.3))
    win = [(a, 1, 3), (b, 2, 2)]
    dense = torch.cat([a[..., 1:4], b[..., 2:4]], dim=-1)
    for be in ("ref", "auto"):
        got = ops.conv2d(win, w, stride=1, act="silu", backend=be)
        want = tref.conv2d(dense, w, act="silu")
        torch.testing.assert_close(got, want, **TOL)
    with pytest.raises(ValueError):
        ops.conv2d(dense, w, backend="cuda")
    # a split output is a non-contiguous view; ops makes it dense
    part = ops.channel_split(b, (2, 4))[1]
    assert not part.is_contiguous()
    torch.testing.assert_close(ops.pointwise(part, "relu"),
                               torch.relu(part.contiguous()))
