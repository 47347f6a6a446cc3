"""The port's dense LM stack against the JAX package, on the CPU.

Parameters come from the JAX package's ``lm.init_params`` and reach the
port through ``convert.lm_params_from_numpy``; tokens come from numpy
with a fixed seed. On CPU tensors the port's kernel wrappers run their
plain versions (``repro_torch.kernels.ref``), so this holds the port's
model code — embeddings, RoPE, GQA, windows, softcaps, sandwich norms,
the KV cache and its in-place update, the serving replica — to the JAX
package's, which runs ``nn/flash.py`` and ``ref.rmsnorm``. Tolerance:
atol 1e-4 on logits (float32 through a few layers, sums in another
order), the float paths' tolerance of the port's parity tests; tokens
and cache lengths exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import quant as jquant
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.serve import ContinuousBatch, Deployment, LmReplica
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import Request as TRequest

from _port_memory import release_memory  # noqa: F401

ARCHS = ("granite-3-8b", "gemma2-2b", "starcoder2-7b")
TOL = dict(atol=1e-4, rtol=0)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


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


def test_configs_are_the_jax_packages():
    for name in jreg.ARCHS:
        assert dataclasses.asdict(treg.get(name)) == \
            dataclasses.asdict(jreg.get(name))
        assert dataclasses.asdict(treg.reduced(name)) == \
            dataclasses.asdict(jreg.reduced(name))
    g = treg.get("granite-3-8b")
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.head_dim,
            g.d_ff, g.vocab, g.tie_embeddings) == (40, 4096, 32, 8, 128,
                                                   12800, 49155, False)


def test_forward_matches_jax(model):
    jc, tc, jp, tp = model
    toks = _tokens(jc, (2, 19))
    want, _ = jlm.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    got, aux = tlm.forward(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 19, jc.vocab) and aux == {}
    _close(got, want)


def test_prefill_and_decode_match_jax(model):
    """Logits and cache after prefill, then after each of 3 greedy decode
    steps (the port updates its cache in place)."""
    jc, tc, jp, tp = model
    toks = _tokens(jc, (2, 13), seed=1)
    jl, jcache = jlm.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, 24)
    tl, tcache = tlm.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, 24)
    _close(tl, jl)
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key])
    np.testing.assert_array_equal(tcache["len"].numpy(), jcache["len"])
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jcache = jlm.decode_step(jp, jc, jnp.asarray(nxt), jcache)
        tl, tcache2 = tlm.decode_step(tp, tc, torch.from_numpy(nxt), tcache)
        assert tcache2 is tcache
        _close(tl, jl)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])
        np.testing.assert_array_equal(tcache["len"].numpy(), jcache["len"])


def test_prefill_then_decode_equals_forward(model):
    """Within the port: the logits of prefill on a prefix and of each
    decode step after it are forward's logits at those positions."""
    _, tc, _, tp = model
    toks = torch.from_numpy(_tokens(tc, (2, 14), seed=2))
    full, _ = tlm.forward(tp, tc, {"tokens": toks})
    logits, cache = tlm.prefill(tp, tc, {"tokens": toks[:, :10]}, 16)
    torch.testing.assert_close(logits, full[:, 9], **TOL)
    for t in range(10, 14):
        logits, cache = tlm.decode_step(tp, tc, toks[:, t], cache)
        torch.testing.assert_close(logits, full[:, t], **TOL)


def _w8_pred(path, leaf):
    """Stacked matrices and the embedding/readout tables (the JAX
    package's dry-run predicate); norm gains stay float."""
    ps = "/".join(str(getattr(k, "key", k)) for k in path)
    return leaf.ndim >= 3 or ("embed" in ps or "lm_head" in ps)


def test_w8_weights_forward_matches_jax(model):
    """W8 QTensor weights: every projection runs ``ops.qmatmul`` (#7)
    on the codes, the embedding gathers codes, the tied readout
    contracts them."""
    jc, tc, jp, _ = model
    qp = jquant.quantize_tree(jp, jquant.QuantConfig(bits=8),
                              predicate=_w8_pred)
    tq = lm_params_from_numpy(qp, device="cpu")
    assert type(tq["layers"]["attn"]["wq"]["w"]).__name__ == "QTensor"
    toks = _tokens(jc, (2, 11), seed=3)
    want, _ = jlm.forward(qp, jc, {"tokens": jnp.asarray(toks)})
    got, _ = tlm.forward(tq, tc, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


def test_init_params_tree_and_distributions(model):
    """The port's init makes the JAX package's tree, shapes and dtypes,
    with the same distributions (fan-in truncated normals at ±2σ for the
    weights, 0.02 for the embedding, zero gains): standard deviations
    within 5% of the JAX package's draw, no value past 2σ."""
    jc, tc, jp, _ = model
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0),
                         device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: a.shape, jp)
    tshapes = tlm.tree_map(lambda t: tuple(t.shape), tp)
    assert tshapes == jshapes
    assert all(t.dtype == torch.float32 for t in _leaves(tp))
    for path, sigma in ((("layers", "attn", "wq", "w"), tc.d_model ** -0.5),
                        (("layers", "mlp", "down", "w"), tc.d_ff ** -0.5),
                        (("embed", "table"), 0.02)):
        t, j = tp, jp
        for k in path:
            t, j = t[k], j[k]
        std = float(np.std(np.asarray(j)))
        assert abs(float(t.std()) - std) < 0.05 * std, path
        assert float(t.abs().max()) <= 2.0 * sigma * (1 + 1e-6), path
    assert float(tp["layers"]["ln1"]["g"].abs().max()) == 0.0
    again = tlm.init_params(tc, torch.Generator().manual_seed(0),
                            device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tp),
                                                  _leaves(again)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _serving_prompts(vocab):
    """The prompts of tests/test_serving.py: lengths 5, 9, 7 from
    default_rng(5)."""
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(0, vocab, size=n)]
            for n in (5, 9, 7)]


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-2b"])
def test_engine_matches_jax_engine(arch):
    """Three prompts through two slots, 6 greedy tokens each: the same
    tokens as the JAX package's Engine."""
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


def test_replica_frees_slots_and_counts():
    """Four requests through two slots on a Deployment with the
    continuous-batching scheduler: finished requests free their slot at
    once, and the replica's counters add up."""
    tc = treg.reduced("granite-3-8b")
    tp = tlm.init_params(tc, torch.Generator().manual_seed(1), device="cpu")
    rep = LmReplica(tc, tp, max_batch=2, cache_size=32, device="cpu")
    assert rep.device == torch.device("cpu") and rep.capacity() == 2
    dep = Deployment(replicas=[rep], scheduler=ContinuousBatch(),
                     prefetch=False)
    for i in range(4):
        dep.submit(TRequest(uid=i, prompt=[1, 2, 3], max_new_tokens=3 + i))
    done = dep.run()
    assert sorted(r.uid for r in done) == [0, 1, 2, 3]
    assert all(len(r.out_tokens) == 3 + r.uid for r in done)
    assert rep.stats["frames"] == 4 and not rep.has_work()
    assert rep.cache["len"].dtype == torch.int32
    dep.close()


def test_unported_lm_paths_raise():
    """Nothing of the LM is left unported: every registry config, and
    granite-3-8b with the int8 KV cache, runs ``init_params``,
    ``prefill`` and a ``decode_step`` at its reduced size (with patch
    embeddings for vlm, source frames for encdec), finite logits of the
    vocabulary's width."""
    names = list(treg.ARCHS) + ["granite-3-8b@kv8"]
    for name in names:
        cfg = treg.reduced(name.split("@")[0])
        if name.endswith("@kv8"):
            cfg = dataclasses.replace(cfg, kv_bits=8)
        params = tlm.init_params(cfg, torch.Generator().manual_seed(1),
                                 device="cpu")
        gen = torch.Generator().manual_seed(2)
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 6),
                                         generator=gen, dtype=torch.int32)}
        if cfg.family == "vlm":
            batch["embeds"] = torch.randn(2, cfg.n_frontend_tokens,
                                          cfg.d_model, generator=gen)
        if cfg.is_encdec:
            batch["src_embeds"] = torch.randn(2, 5, cfg.d_model,
                                              generator=gen)
        logits, cache = tlm.prefill(params, cfg, batch, 24)
        logits, cache = tlm.decode_step(params, cfg, logits.argmax(-1)
                                        .to(torch.int32), cache)
        assert logits.shape == (2, cfg.vocab), name
        assert bool(torch.isfinite(logits).all()), name
        if name.endswith("@kv8"):
            assert cache["k"].dtype == torch.int8


def test_entry_points_refuse_silent_cpu(monkeypatch):
    tc = treg.reduced("granite-3-8b")
    tp = tlm.init_params(tc, torch.Generator().manual_seed(1), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: LmReplica(tc, tp), lambda: TEngine(tc, tp),
                 lambda: tlm.init_params(tc, torch.Generator()),
                 lambda: tlm.init_cache(tc, 1, 8)):
        with pytest.raises(RuntimeError, match="CPU"):
            make()
