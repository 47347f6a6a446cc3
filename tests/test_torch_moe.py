"""The port's MoE layer and moe LM family against the JAX package, on the
CPU; the combine's determinism on a card.

Parameters come from the JAX package's ``moe.init`` / ``lm.init_params``
and reach the port through ``convert.lm_params_from_numpy``; inputs come
from numpy with a fixed seed. ``moe.forward_with_aux`` at the reduced
qwen3-moe (8 experts, top-2) and llama4-maverick (top-1 and a shared
expert) configs: outputs within atol 1e-4, ``load_balance`` and
``dropped_frac`` alike, the routes (top-k experts) and the capacity
keep mask EXACTLY equal to those the JAX package's routing and pack
compute (``nn/moe.py:60-73``, re-run here with its own functions), and
at ``capacity_factor`` 1.25 on skewed inputs the layer really drops
assignments, the same ones. The LM: ``forward`` (logits and
``load_balance``), ``prefill`` + ``decode_step`` and prefill/decode ≡
forward for the reduced qwen3-moe and llama4-maverick (grouped layout,
``moe_every`` 2), and ``Engine``'s tokens for qwen3-moe equal to the
JAX ``Engine``'s. On the card (``-m gpu``): two runs of the layer
bit-equal (the combine gathers and sums, no atomics).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.nn import layers as jL
from repro.nn import moe as jmoe
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.nn import moe as tmoe
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import Request as TRequest

from _port_memory import release_memory  # noqa: F401

ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
TOL = dict(atol=1e-4, rtol=0)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _jax_routes(p, cfg, x):
    """(idx, keep) of the JAX package's layer on x: its routing and pack
    (``nn/moe.py:60-73``), with its own functions."""
    N = x.shape[0] * x.shape[1]
    E, K = cfg.n_experts, cfg.top_k
    C = jmoe.capacity(N, cfg)
    logits = jL.linear(p["router"], x.reshape(N, -1)).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    flat_e = idx.reshape(-1)
    sorted_e = flat_e[jnp.argsort(flat_e, stable=True)]
    first = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
    pos_in_e = jnp.arange(N * K) - first[sorted_e]
    return np.asarray(idx), np.asarray(pos_in_e < C)


def _port_routes(monkeypatch, tp, cfg, x):
    """(y, aux, idx, keep) of the port's layer: its routes as
    ``moe.route`` returned them, its keep mask from the assignments each
    expert received (the first C of each, in sort order)."""
    seen = []
    route = tmoe.route

    def record(p, c, xt):
        out = route(p, c, xt)
        seen.append(out[2])
        return out

    monkeypatch.setattr(tmoe, "route", record)
    y, aux = tmoe.forward_with_aux(tp, cfg, x)
    idx = seen[0]
    flat = idx.reshape(-1)
    srt = flat[torch.argsort(flat, stable=True)]
    rank = torch.arange(flat.numel()) - torch.searchsorted(
        srt, torch.arange(cfg.n_experts))[srt]
    C = tmoe.capacity(x.shape[0] * x.shape[1], cfg)
    return y, aux, idx.numpy(), (rank < C).numpy()


def _layer_case(arch, capacity_factor=None, skew=0.0, seed=0):
    cfg = jreg.reduced(arch).moe
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jp = jmoe.init(jax.random.PRNGKey(seed), cfg)
    tp = lm_params_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    x += skew * rng.standard_normal(cfg.d_model).astype(np.float32)
    return cfg, jp, tp, x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor,skew", [(None, 0.0), (1.25, 0.5)])
def test_layer_matches_jax(monkeypatch, arch, capacity_factor, skew):
    """The output, both aux values, the routes and the keep mask; at
    ``capacity_factor`` 1.25 with a shared component in every token
    (skewed routing) some assignments are dropped, the same ones."""
    cfg, jp, tp, x = _layer_case(arch, capacity_factor, skew)
    want, jaux = jmoe.forward_with_aux(jp, cfg, jnp.asarray(x))
    got, aux, idx, keep = _port_routes(monkeypatch, tp, cfg,
                                       torch.from_numpy(x))
    jidx, jkeep = _jax_routes(jp, cfg, jnp.asarray(x))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(keep, jkeep)
    _close(got, want)
    for k in ("load_balance", "dropped_frac"):
        assert aux[k].ndim == 0
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-6, atol=1e-7)
    if capacity_factor is None:             # the reduced configs' 8.0
        assert float(aux["dropped_frac"]) == 0.0
    else:
        assert 0.0 < float(aux["dropped_frac"]) < 1.0
        assert 0 < int(keep.sum()) < keep.size


def test_capacity_and_init_match_jax():
    for arch in ARCHS:
        cfg = jreg.reduced(arch).moe
        full = jreg.get(arch).moe
        for n in (1, 4, 7, 64, 509, 2048):
            assert tmoe.capacity(n, cfg) == jmoe.capacity(n, cfg)
            assert tmoe.capacity(n, full) == jmoe.capacity(n, full)
        jp = jmoe.init(jax.random.PRNGKey(0), cfg)
        tp = tmoe.init(torch.Generator().manual_seed(0), cfg)
        assert tlm.tree_map(lambda t: tuple(t.shape), tp) == \
            jax.tree_util.tree_map(lambda a: a.shape, jp)
        # the experts' (E, d, f) weights take E as their fan-in
        bound = 2.0 * cfg.n_experts ** -0.5
        assert float(tp["w_up"].abs().max()) <= bound * (1 + 1e-6)
        assert float(tp["w_up"].abs().max()) > 0.5 * bound


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(JAX cfg, port cfg, JAX params, port params) of a reduced arch."""
    jc, tc = jreg.reduced(request.param), treg.reduced(request.param)
    jp = jlm.init_params(jc, jax.random.PRNGKey(3))
    tp = lm_params_from_numpy(jp, device="cpu")
    return jc, tc, jp, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def test_lm_forward_matches_jax(model):
    jc, tc, jp, tp = model
    toks = _tokens(jc, (2, 19))
    want, jaux = jlm.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    got, aux = tlm.forward(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 19, jc.vocab) and set(aux) == {"load_balance"}
    _close(got, want)
    np.testing.assert_allclose(float(aux["load_balance"]),
                               float(jaux["load_balance"]), rtol=1e-5)


def test_lm_prefill_and_decode_match_jax(model):
    """Logits and cache after prefill, then after each of 3 greedy decode
    steps; the grouped layout's cache keeps one row a layer."""
    jc, tc, jp, tp = model
    toks = _tokens(jc, (2, 13), seed=1)
    jl, jcache = jlm.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, 24)
    tl, tcache = tlm.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, 24)
    assert tcache["k"].shape[0] == tc.n_layers
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jcache = jlm.decode_step(jp, jc, jnp.asarray(nxt), jcache)
        tl, tcache = tlm.decode_step(tp, tc, torch.from_numpy(nxt), tcache)
        _close(tl, jl)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])
        np.testing.assert_array_equal(tcache["len"].numpy(), jcache["len"])


def test_lm_prefill_then_decode_equals_forward(model):
    _, tc, _, tp = model
    toks = torch.from_numpy(_tokens(tc, (2, 14), seed=2))
    full, _ = tlm.forward(tp, tc, {"tokens": toks})
    logits, cache = tlm.prefill(tp, tc, {"tokens": toks[:, :10]}, 16)
    torch.testing.assert_close(logits, full[:, 9], **TOL)
    for t in range(10, 14):
        logits, cache = tlm.decode_step(tp, tc, toks[:, t], cache)
        torch.testing.assert_close(logits, full[:, t], **TOL)


def test_grouped_layers_are_the_jax_layout():
    """llama4's layers: one group of (moe_every - 1) dense sublayers and
    an MoE layer; ``layer(i)`` reads sublayer i % moe_every of group
    i // moe_every, views of the stacked tensors."""
    tc = treg.reduced("llama4-maverick-400b-a17b")
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    me, G = tc.moe_every, tc.n_layers // tc.moe_every
    assert set(tp["layers"]) == {"dense", "moe"}
    assert tp["layers"]["dense"]["ln1"]["g"].shape == (G, me - 1, tc.d_model)
    assert tp["layers"]["moe"]["moe"]["w_up"].shape == (
        G, tc.moe.n_experts, tc.d_model, tc.moe.d_ff)
    first, last = tlm.layer(tp["layers"], 0, tc), \
        tlm.layer(tp["layers"], me - 1, tc)
    assert "mlp" in first and "moe" in last
    w = first["attn"]["wq"]["w"]
    assert w.data_ptr() == tp["layers"]["dense"]["attn"]["wq"]["w"].data_ptr()
    split = tlm.split_layers(tp, tc)["layers"]
    assert len(split) == tc.n_layers and "moe" in split[me - 1]


def _serving_prompts(vocab):
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(0, vocab, size=n)]
            for n in (5, 9, 7)]


def test_engine_matches_jax_engine():
    """Three prompts through two slots, 6 greedy tokens each: qwen3-moe's
    tokens equal the JAX package's Engine's."""
    arch = "qwen3-moe-30b-a3b"
    jc, tc = jreg.reduced(arch), treg.reduced(arch)
    jp = jlm.init_params(jc, jax.random.PRNGKey(2))
    tp = lm_params_from_numpy(jp, device="cpu")
    prompts = _serving_prompts(jc.vocab)
    jeng = JEngine(jc, jp, max_batch=2, cache_size=64)
    teng = TEngine(tc, tp, max_batch=2, cache_size=64, device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(uid=i, prompt=p, max_new_tokens=6))
        teng.submit(TRequest(uid=i, prompt=p, max_new_tokens=6))
    want = {r.uid: r.out_tokens for r in jeng.run()}
    done = teng.run()
    assert len(done) == 3 and all(r.done for r in done)
    assert {r.uid: r.out_tokens for r in done} == want
    teng.close()
    jeng.close()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py serves the moe path "
                    "there)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_combine_is_bit_equal_across_runs_on_the_card(cuda_device, arch):
    """Two runs of the layer on the same inputs, 512 tokens with skewed
    routing at capacity 1.25 (drops included): the outputs and both aux
    values equal bit for bit."""
    cfg = dataclasses.replace(treg.reduced(arch).moe, capacity_factor=1.25)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = tmoe.init(gen, cfg, device=cuda_device)
    x = torch.randn(4, 128, cfg.d_model, generator=gen, device=cuda_device)
    x += 3.0 * torch.randn(cfg.d_model, generator=gen, device=cuda_device)
    with torch.inference_mode():
        y1, a1 = tmoe.forward_with_aux(p, cfg, x)
        y2, a2 = tmoe.forward_with_aux(p, cfg, x)
    assert float(a1["dropped_frac"]) > 0
    assert torch.equal(y1, y2)
    assert all(torch.equal(a1[k], a2[k]) for k in a1)
