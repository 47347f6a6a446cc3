"""The hybrid and encdec families, the int8 KV cache, and adafactor and
int8_adamw over sharded parameters on the card (``-m gpu``; every test
skips without one, and the file imports no JAX).

Positions wrap over ``cuda_devices()`` (one card: all name cuda:0).
Configs small enough for a test but with the kernels' head width:
zamba2-shaped (d 128, 4 q and 2 kv heads of 64 in the shared block,
Mamba heads of 64, N 64, 4 layers, a shared-block call every 2),
seamless-shaped and granite-shaped (d 256, 4 q and 2 kv heads of 64,
d_ff 384, vocab 512, 2 layers; seamless over 48 source frames; granite
with ``kv_bits=8``), over (2, 2) and (1, 4): (1, 4) cuts the kv
projections within a head and gathers them. Each sharded call through
the kernels (#6, #11, #12, #13) is held within 1e-4 to the same call on
the plain versions (``ops.set_default_backend("ref")``) and to the
unsharded call through the kernels, with its launches counted; the int8
cache's decode logits (tensor code over codes that may round the other
way) by their mean relative difference, below 0.05, and its codes
within one. One adafactor and one int8_adamw step (remat ``group``):
loss and grad norm within 1e-4 of plain and unsharded, every parameter
its optimizer's unsharded update of the step's own gathered gradients,
within 1e-4 x lr plus one float32 rounding.
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
from repro_torch.tree import flatten_with_path, tree_map

from _port_memory import release_memory  # noqa: F401

TOL = 1e-4
Q8_MEAN_REL = 0.05
B, T, SRC = 4, 64, 48
LR = 1e-3
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


def _cfg(arch, **replace):
    name, _, kv = arch.partition("@")
    cfg = registry.reduced(name)
    if kv:
        replace["kv_bits"] = 8
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, d_model=128, head_dim=64, d_ff=384, ssm=SsmCfg(
                d_model=128, d_state=64, head_dim=64, chunk=64), **replace)
    return dataclasses.replace(cfg, d_model=256, head_dim=64, d_ff=384,
                               **replace)


def _mesh(devs, shape):
    n = shape[0] * shape[1]
    return mesh_lib.make_mesh(shape, ("data", "model"),
                              devices=[devs[i % len(devs)] for i in range(n)])


def _batch(cfg, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (B, T), generator=g, device=dev,
                         dtype=torch.int32)
    b = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    if cfg.is_encdec:
        b["src_embeds"] = torch.randn(B, SRC, cfg.d_model, generator=g,
                                      device=dev)
    return b


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _mean_rel(a, b) -> float:
    return float((a - b).abs().mean() / b.abs().mean())


def _counts():
    return {k: c.value for k, c in COUNTERS.items()}


def _zero():
    for c in COUNTERS.values():
        c.reset()


def _plain(fn):
    ops.set_default_backend("ref")
    try:
        return fn()
    finally:
        ops.set_default_backend("auto")


def _launches(cfg, n: int, kind: str) -> dict:
    """Each position's norms and attention (or mixer) of a prefill or a
    decode step; the final norm at every position (vocab 512 divides
    the model axis)."""
    L, fwd = cfg.n_layers, kind == "prefill"
    att = "mha" if fwd else "decode_attention"
    out = {k: 0 for k in COUNTERS}
    if cfg.family == "hybrid":
        calls = -(-L // cfg.shared_attn_every)
        out["rmsnorm"] = n * (L * 2 + calls * 2 + 1)
        out["ssd_scan"] = n * L if fwd else 0
        out[att] = n * calls
        return out
    out["rmsnorm"] = n * (L * (3 if cfg.is_encdec else 2) + 1)
    if fwd or cfg.kv_bits != 8:
        out[att] = n * L * (2 if cfg.is_encdec else 1)
    if cfg.is_encdec and fwd:
        out["rmsnorm"] += n * (cfg.n_enc_layers * 2 + 1)
        out["mha"] += n * cfg.n_enc_layers
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ((2, 2), (1, 4)), ids=str)
@pytest.mark.parametrize("arch", ("zamba2-1.2b", "seamless-m4t-medium",
                                  "granite-3-8b@kv8"))
def test_sharded_prefill_decode_kernels_match_plain(devs, arch, shape):
    """A prefill and three decode steps through the kernels: launches
    counted; logits and every gathered cache leaf within 1e-4 of the
    plain versions and of the unsharded steps (the int8 cache: decode
    logits by mean relative difference, codes within one)."""
    cfg = _cfg(arch)
    dev = devs[0]
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    sp = steps.place_params(params, _mesh(devs, shape), cfg=cfg)
    pf, dc = steps.make_prefill_step(cfg, T + 4), steps.make_decode_step(cfg)
    b = {k: v for k, v in _batch(cfg, dev, 2).items() if k != "labels"}
    n = shape[0] * shape[1]
    q8 = cfg.kv_bits == 8
    _zero()
    l_k, c_k = pf(sp, b)
    assert _counts() == _launches(cfg, n, "prefill")
    l_p, c_p = _plain(lambda: pf(sp, b))
    l_u, c_u = pf(params, b)
    assert _rel(l_k, l_p) <= TOL and _rel(l_k, l_u) <= TOL
    for s in range(3):
        tok = torch.full((B,), 7 + s, dtype=torch.int32, device=dev)
        _zero()
        l_k, c_k = dc(sp, tok, c_k)
        assert _counts() == _launches(cfg, n, "decode")
        l_p, c_p = _plain(lambda: dc(sp, tok, c_p))
        l_u, c_u = dc(params, tok, c_u)
        for ref in (l_p, l_u):
            if q8:
                assert _mean_rel(l_k, ref) < Q8_MEAN_REL, s
            else:
                assert _rel(l_k, ref) <= TOL, s
    for k, st in c_k.items():
        for ref in (c_p[k].gather(), c_u[k]):
            got = st.gather()
            if got.dtype == torch.int8:
                assert int((got.to(torch.int32) - ref).abs().max()) <= 1, k
            elif k != "len":
                assert _rel(got, ref) <= TOL, k


@pytest.mark.gpu
@pytest.mark.parametrize("opt_name", ("adafactor", "int8_adamw"))
@pytest.mark.parametrize("shape", ((2, 2), (1, 4)), ids=str)
def test_sharded_optimizer_step_kernels_match_plain(devs, shape, opt_name):
    """One step over two microbatches of the granite-shaped config at
    remat ``group``: loss and grad norm within 1e-4 of the plain
    versions and of the unsharded step; launches as the plan (every
    layer's forward three times); each parameter its optimizer's
    unsharded update of the step's own gathered gradients."""
    cfg = _cfg("granite-3-8b", remat="group")
    dev = devs[0]
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    sp = steps.place_params(params, _mesh(devs, shape), cfg=cfg)
    opt = optimizers.get(opt_name, lr=LR)
    step = steps.make_train_step(cfg, opt, 2)
    b = {k: v.reshape(2, B // 2, T) for k, v in _batch(cfg, dev, 1).items()}
    st = steps.init_opt_state(opt, sp, cfg)
    _zero()
    p_k, _, m_k = step(sp, st, 0, b)
    n, L = shape[0] * shape[1], cfg.n_layers
    assert _counts() == {"rmsnorm": 2 * (n * L * 2 * 3 + n),
                         "mha": 2 * n * L * 3, "decode_attention": 0,
                         "ssd_scan": 0}
    _, _, m_p = _plain(lambda: step(sp, st, 0, b))
    state = opt.init(params)
    _, _, m_u = step(params, state, 0, b)
    for ref in (m_p, m_u):
        for k in ("loss", "grad_norm"):
            assert abs(float(m_k[k]) - float(ref[k])) <= TOL * abs(
                float(ref[k])), k
    dt = spmd.Distinct(sp)
    g, _ = steps.accumulate_grads(dt.tensors, cfg, b, 2, loss_fn=dt.loss_fn)
    g = dt.sum_blocks(g)
    g, _ = optimizers.clip_by_global_norm(g, 1.0, dt.norm(g))
    upd, _ = opt.update(spmd.gather(dt.sharded(g)), state, params, 0)
    want = dict(flatten_with_path(tree_map(optimizers.apply_update, params,
                                           upd)))
    eps32 = torch.finfo(torch.float32).eps
    for path, leaf in flatten_with_path(spmd.gather(p_k)):
        assert bool(((leaf - want[path]).abs()
                     <= TOL * LR + eps32 * want[path].abs()).all()), path
