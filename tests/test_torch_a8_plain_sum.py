"""The plain version of ``qmatmul_a8`` with per-K activation scales
(``kernels.ref.qmatmul_a8``), which kernel #9 and ``chip_smoke.py``'s A8
check are held against: its two sums over K (the product and the row
sum of the scaled codes) are the exact sums rounded once to float32, and
the affine correction after them is float32.

On the CPU, int8 codes at per-block scales (runs of 16, 27 and 9
features, as the per-group path and its stem give them): the scales are
multiples of 2^-12 below 2^-2, so the exact sums are integers times
2^-12 that numpy computes in int64; each is converted to float32 once
and the correction applied as the plain version states it. The result
must be bit-equal. A float32 GEMM over the scaled codes rounds K times
and is not (checked on the widest case).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref

ULP_SCALE = 2.0 ** -12

CASES = [  # (M, K, N, tk)
    (8, 144, 24, 16),
    (16, 27, 32, 27),
    (4, 81, 40, 9),
    (32, 576, 64, 16),
]


def _case(M, K, N, tk, seed, with_zero):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-128, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-128, 128, (K, N)).astype(np.int8)
    m = np.repeat(rng.integers(1, 1024, K // tk), tk).astype(np.int64)
    scale = rng.uniform(1e-3, 1e-2, (1, N)).astype(np.float32)
    zero = (rng.normal(size=(1, N)) if with_zero
            else np.zeros((1, N))).astype(np.float32)
    return xq, wq, m, scale, zero


def _exact(xq, wq, m, scale, zero):
    xs = xq.astype(np.int64) * m                       # codes · s_k / 2^-12
    acc = (xs @ wq.astype(np.int64)).astype(np.float64) * ULP_SCALE
    xsum = xs.sum(axis=1, keepdims=True).astype(np.float64) * ULP_SCALE
    acc, xsum = acc.astype(np.float32), xsum.astype(np.float32)
    return acc * scale + xsum * (zero * scale)


def _plain(xq, wq, m, scale, zero):
    sk = torch.from_numpy((m * ULP_SCALE).astype(np.float32))
    return tref.qmatmul_a8(torch.from_numpy(xq), torch.from_numpy(wq),
                           torch.from_numpy(scale), torch.from_numpy(zero),
                           sk).numpy()


@pytest.mark.parametrize("with_zero", [False, True], ids=["zero0", "zero"])
@pytest.mark.parametrize("M,K,N,tk", CASES,
                         ids=[f"K{c[1]}_tk{c[3]}" for c in CASES])
def test_per_k_sums_are_exact_rounded_once(M, K, N, tk, with_zero):
    xq, wq, m, scale, zero = _case(M, K, N, tk, K + N, with_zero)
    got = _plain(xq, wq, m, scale, zero)
    want = _exact(xq, wq, m, scale, zero)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_a_float32_gemm_is_not_the_exact_sum():
    """The test above has teeth: on its widest case the scaled codes'
    float32 GEMM differs from the exact sum rounded once."""
    M, K, N, tk = CASES[-1]
    xq, wq, m, scale, zero = _case(M, K, N, tk, K + N, False)
    xs = torch.from_numpy(xq).float() * torch.from_numpy(
        (m * ULP_SCALE).astype(np.float32))
    gemm = (xs @ torch.from_numpy(wq).float()).numpy() * scale
    assert (gemm != _exact(xq, wq, m, scale, zero)).any()
