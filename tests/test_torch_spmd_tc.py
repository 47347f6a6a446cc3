"""The sharded LM steps on the card (``-m gpu``; every test skips without
one, and the file imports no JAX).

Positions wrap over ``cuda_devices()`` (one card: all name cuda:0). A
granite-shaped config small enough for a test but with the kernels' head
width (d 256, 4 q and 2 kv heads of 64, d_ff 384, vocab 512, 2 layers)
and a mamba2-shaped one (d 128, heads of 64, N 64) run through
``launch.steps`` on ``place_params`` trees over (2, 2) and (1, 4) —
(1, 4) cuts the kv projections within a head and gathers them. Each
sharded call through the kernels (#6, #11, #12, #13; #11 and #13 under
autograd in the train step) is held within 1e-4 to the same call on
the plain versions (``ops.set_default_backend("ref")``) and to the
unsharded call through the kernels, with its launches counted: every
position runs its own norms and its attention or mixer. Each parameter
of the sharded adamw step is held to its old value plus the update its
own gathered moments give, within 1e-4 x lr plus one float32 rounding.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.dist import spmd
from repro_torch.kernels import attention, decode_attention, ops, ssd_scan
from repro_torch.kernels import pointwise as tpw
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.nn.ssm import SsmCfg
from repro_torch.optim import optimizers
from repro_torch.tree import flatten_with_path

from _port_memory import release_memory  # noqa: F401

TOL = 1e-4
B, T = 4, 64
LR = 1e-3
ADAMW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
COUNTERS = {"rmsnorm": tpw.rmsnorm_launches, "mha": attention.launches,
            "decode_attention": decode_attention.launches,
            "ssd_scan": ssd_scan.launches}


@pytest.fixture
def devs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's sharded path runs "
                    "these at full width there)")
    from repro_torch.device import cuda_devices
    return cuda_devices()


def _cfg(arch):
    cfg = registry.reduced(arch)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, d_model=128, ssm=SsmCfg(
            d_model=128, d_state=64, head_dim=64, chunk=64), remat="full")
    return dataclasses.replace(cfg, d_model=256, head_dim=64, d_ff=384,
                               remat="full")


def _mesh(devs, shape):
    n = shape[0] * shape[1]
    return mesh_lib.make_mesh(shape, ("data", "model"),
                              devices=[devs[i % len(devs)] for i in range(n)])


def _batch(cfg, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (B, T), generator=g, device=dev,
                         dtype=torch.int32)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _counts():
    return {k: c.value for k, c in COUNTERS.items()}


def _zero():
    for c in COUNTERS.values():
        c.reset()


def _adamw_once(p, m, v):
    """p after one adamw step (step 0, lr LR) of moments m and v, in the
    optimizer's float32 arithmetic."""
    t = torch.tensor(0, device=p.device).to(torch.float32) + 1.0
    c1, c2 = 1 - ADAMW["b1"] ** t, 1 - ADAMW["b2"] ** t
    u = (m / c1) / (torch.sqrt(v / c2) + ADAMW["eps"]) \
        + ADAMW["weight_decay"] * p
    return p + (-LR * u)


def _plain(fn):
    ops.set_default_backend("ref")
    try:
        return fn()
    finally:
        ops.set_default_backend("auto")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ((2, 2), (1, 4)), ids=str)
@pytest.mark.parametrize("arch", ("granite-3-8b", "mamba2-130m"))
def test_sharded_train_step_kernels_match_plain(devs, arch, shape):
    """One adamw step over two microbatches: loss, grad norm and the
    gathered moments through the kernels within 1e-4 of the plain
    versions and of the unsharded step; every gathered parameter its
    old value plus the update of its gathered moments; launches: every
    position's norms and attention (or scan), twice under remat, the
    final norm at every position (vocab 512 divides the model axis)."""
    cfg = _cfg(arch)
    dev = devs[0]
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    sp = steps.place_params(params, _mesh(devs, shape), cfg=cfg)
    opt = optimizers.adamw(lr=LR, **ADAMW)
    step = steps.make_train_step(cfg, opt, 2)
    b = {k: v.reshape(2, B // 2, T) for k, v in _batch(cfg, dev, 1).items()}
    st = steps.init_opt_state(opt, sp, cfg)
    _zero()
    p_k, s_k, m_k = step(sp, st, 0, b)
    got = _counts()
    _zero()
    _, s_p, m_p = _plain(lambda: step(sp, st, 0, b))
    assert _counts() == {k: 0 for k in COUNTERS}
    _, s_u, m_u = step(params, opt.init(params), 0, b)
    n = shape[0] * shape[1]
    L = cfg.n_layers
    want = {k: 0 for k in COUNTERS}
    want["rmsnorm"] = 2 * (n * L * 2 * 2 + n)
    want["ssd_scan" if cfg.family == "ssm" else "mha"] = 2 * n * L * 2
    assert got == want
    for ref in (m_p, m_u):
        for k in ("loss", "grad_norm"):
            assert abs(float(m_k[k]) - float(ref[k])) <= TOL * abs(
                float(ref[k])), k
    flat_p = dict(flatten_with_path(spmd.gather(s_p)))
    flat_u = dict(flatten_with_path(s_u))
    for path, leaf in flatten_with_path(spmd.gather(s_k)):
        assert _rel(leaf, flat_p[path]) <= TOL, path
        assert _rel(leaf, flat_u[path]) <= TOL, path
    old = dict(flatten_with_path(params))
    gm, gv = (dict(flatten_with_path(spmd.gather(s_k[k]))) for k in "mv")
    eps32 = torch.finfo(torch.float32).eps
    for path, leaf in flatten_with_path(spmd.gather(p_k)):
        want = _adamw_once(old[path], gm[path], gv[path])
        assert bool(((leaf - want).abs()
                     <= TOL * LR + eps32 * want.abs()).all()), path


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ((2, 2), (1, 4)), ids=str)
def test_sharded_prefill_decode_kernels_match_plain(devs, shape):
    """granite-shaped: a prefill (#11 a position a layer) and three
    decode steps (#12 a position a layer) through the kernels, logits
    and the gathered cache within 1e-4 of the plain versions and of the
    unsharded steps."""
    cfg = _cfg("granite-3-8b")
    dev = devs[0]
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    sp = steps.place_params(params, _mesh(devs, shape), cfg=cfg)
    pf, dc = steps.make_prefill_step(cfg, T + 4), steps.make_decode_step(cfg)
    b = {"tokens": _batch(cfg, dev, 2)["tokens"]}
    n, L = shape[0] * shape[1], cfg.n_layers
    _zero()
    l_k, c_k = pf(sp, b)
    assert _counts() == {"rmsnorm": n * L * 2 + n, "mha": n * L,
                         "decode_attention": 0, "ssd_scan": 0}
    l_p, c_p = _plain(lambda: pf(sp, b))
    l_u, c_u = pf(params, b)
    assert _rel(l_k, l_p) <= TOL and _rel(l_k, l_u) <= TOL
    for s in range(3):
        tok = torch.full((B,), 7 + s, dtype=torch.int32, device=dev)
        _zero()
        l_k, c_k = dc(sp, tok, c_k)
        assert _counts() == {"rmsnorm": n * L * 2 + n, "mha": 0,
                             "decode_attention": n * L, "ssd_scan": 0}
        l_p, c_p = _plain(lambda: dc(sp, tok, c_p))
        l_u, c_u = dc(params, tok, c_u)
        assert _rel(l_k, l_p) <= TOL and _rel(l_k, l_u) <= TOL, s
    for k in ("k", "v"):
        assert _rel(c_k[k].gather(), c_u[k]) <= TOL
