"""Training through the forward kernels on the card (``-m gpu``; every
test skips without one, and the file imports no JAX).

Each autograd Function of ``kernels/autograd.py``, reached through
``ops`` with operands that require grad, launches its kernel once a
call and gives the plain version's gradients (its backward is the plain
version's autograd): RMSNorm (#6); attention (#11) causal, windowed,
softcapped, GQA, and non-causal with Tq != Tk; the SSD scan (#13) with
``h0`` and the gradient of the returned state. A direct call of a
wrapper with a grad operand raises. Under ``torch.inference_mode()`` a
forward launches what it launched before training was ported, whatever
``cfg.remat`` says; with grad and ``remat="full"`` every layer's
kernels launch twice (the forward, then the recompute) and the
gradients agree with the all-plain route's.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import ops
from repro_torch.kernels import pointwise as tpw
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm
from repro_torch.tree import flatten_with_path

from _port_memory import release_memory  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's train path runs "
                    "the same Functions at full width there)")
    return torch.device("cuda", 0)


def _grads(fn, inputs, proj):
    ins = [t.clone().requires_grad_(True) for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * p).sum() for o, p in zip(outs, proj))
    return outs, torch.autograd.grad(loss, ins)


def _check(fn_kernel, fn_plain, inputs, counter, launches=1):
    gen = torch.Generator(device=inputs[0].device).manual_seed(9)
    with torch.no_grad():
        outs = fn_plain(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    proj = [torch.randn(o.shape, generator=gen, device=o.device)
            for o in outs]
    before = counter.value
    got_out, got = _grads(fn_kernel, inputs, proj)
    assert counter.value - before == launches
    want_out, want = _grads(fn_plain, inputs, proj)
    for a, b in zip(got_out, want_out):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_rmsnorm_function(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(3, 100, 512, generator=gen, device=cuda_device)
    g = 0.1 * torch.randn(512, generator=gen, device=cuda_device)
    _check(lambda a, b: ops.rmsnorm(a, b, eps=1e-5),
           lambda a, b: ops.rmsnorm(a, b, eps=1e-5, backend="ref"),
           [x, g], tpw.rmsnorm_launches)


@pytest.mark.gpu
@pytest.mark.parametrize("Tq,Tk,Hq,Hkv,D,causal,window,softcap", [
    (128, 128, 8, 8, 64, True, None, None),       # causal
    (200, 200, 8, 2, 128, True, 64, None),        # windowed, GQA
    (96, 96, 4, 4, 256, True, None, 30.0),        # softcapped
    (64, 64, 16, 4, 128, True, None, None),       # GQA
    (40, 150, 8, 4, 64, False, None, None),       # non-causal, Tq != Tk
])
def test_mha_function(cuda_device, Tq, Tk, Hq, Hkv, D, causal, window,
                      softcap):
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _check(lambda q, k, v: ops.mha(q, k, v, **kw),
           lambda q, k, v: ops.mha(q, k, v, backend="ref", **kw),
           [rnd(2, Tq, Hq, D), rnd(2, Tk, Hkv, D), rnd(2, Tk, Hkv, D)],
           tattn.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_function(cuda_device, with_h0):
    """The gradients of x, dt, A, B, C (and h0) from those of y and of
    the returned state."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    Bt, T, H, P, G, N = 2, 200, 8, 64, 2, 128

    def rnd(*shape, s=1.0):
        return s * torch.randn(*shape, generator=gen, device=cuda_device)
    dt = torch.rand(Bt, T, H, generator=gen, device=cuda_device) * 0.1 + 0.01
    A = -torch.rand(H, generator=gen, device=cuda_device) - 0.5
    ins = [rnd(Bt, T, H, P), dt, A, rnd(Bt, T, G, N, s=0.3),
           rnd(Bt, T, G, N, s=0.3)]
    if with_h0:
        ins.append(rnd(Bt, H, N, P, s=0.1))

    def kern(*a):
        return ops.ssd_scan(*a[:5], h0=a[5] if with_h0 else None)

    def plain(*a):
        return ops.ssd_scan(*a[:5], h0=a[5] if with_h0 else None,
                            backend="ref")
    _check(kern, plain, ins, tssd.launches)


@pytest.mark.gpu
def test_wrappers_refuse_grad(cuda_device):
    x = torch.zeros((2, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        tpw.rmsnorm(x, torch.zeros(64, device=cuda_device))
    q = torch.zeros((1, 4, 2, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        tattn.mha(q, q, q)
    xs = torch.zeros((1, 16, 2, 16), device=cuda_device, requires_grad=True)
    bc = torch.zeros((1, 16, 1, 16), device=cuda_device)
    with pytest.raises(RuntimeError, match="backward"):
        tssd.ssd_scan(xs, torch.ones((1, 16, 2), device=cuda_device),
                      -torch.ones(2, device=cuda_device), bc, bc)


def _small(device, remat):
    cfg = dataclasses.replace(registry.reduced("granite-3-8b"), n_layers=4,
                              d_model=256, n_heads=4, n_kv_heads=2,
                              head_dim=64, remat=remat)
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(
        0), device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                              device=device, dtype=torch.int32)
             for k in ("tokens", "labels")}
    return cfg, params, batch


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "full", "dots", "group"])
def test_launches_under_inference_and_training(cuda_device, remat):
    cfg, params, batch = _small(cuda_device, remat)
    L = cfg.n_layers
    for c in (tpw.rmsnorm_launches, tattn.launches):
        c.reset()
    with torch.inference_mode():
        lm.forward(params, cfg, batch)
    assert (tpw.rmsnorm_launches.value, tattn.launches.value) == \
        (2 * L + 1, L)
    for c in (tpw.rmsnorm_launches, tattn.launches):
        c.reset()
    got, _ = tsteps.grads_of(params, cfg, batch)
    recomputed = 0 if remat == "none" else L
    if remat != "group":
        assert (tpw.rmsnorm_launches.value, tattn.launches.value) == \
            (2 * L + 1 + 2 * recomputed, L + recomputed)
    ops.set_default_backend("ref")
    try:
        want, _ = tsteps.grads_of(params, cfg, batch)
    finally:
        ops.set_default_backend("auto")
    flat = dict(flatten_with_path(want))
    for path, g in flatten_with_path(got):
        w = flat[path]
        assert (g - w).abs().max() <= 1e-4 * w.abs().max() + 1e-8, path


@pytest.mark.gpu
def test_no_grad_forward_is_unchanged(cuda_device):
    """With grad off (no_grad), the forward launches the kernels as
    serving does and equals the inference-mode forward bit for bit."""
    cfg, params, batch = _small(cuda_device, "full")
    with torch.inference_mode():
        want, _ = lm.forward(params, cfg, batch)
    with torch.no_grad():
        got, _ = lm.forward(params, cfg, batch)
    assert torch.equal(got, want)
