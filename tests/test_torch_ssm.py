"""The port's SSM and hybrid LM stack (mamba2-130m, zamba2-1.2b) against
the JAX package, on the CPU.

Parameters come from the JAX package's ``init_params`` and reach the
port through ``convert.lm_params_from_numpy``; tokens and activations
come from numpy with a fixed seed. On CPU tensors the port's kernel
wrappers run their plain versions, so this holds the port's model code
— the Mamba-2 mixer (projections, causal conv, the chunked scan through
``ops.ssd_scan``, the D skip, the gated norm), its in-place decode
recurrence, zamba2's shared block with the embedding re-injected, the
caches and the serving replica — to the JAX package's. Sizes are
``registry.reduced`` (plus a G = 2 variant, which pins the head-to-group
mapping). Tolerance: atol 1e-4 on logits and states (float32, sums in
another order), the float paths' tolerance of the port's parity tests;
tokens and cache lengths exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.nn import ssm as jssm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import lm as tlm
from repro_torch.nn import ssm as tssm
from repro_torch.serve import LmReplica
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import Request as TRequest

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=0)
VARIANTS = ("mamba2-130m", "zamba2-1.2b", "mamba2-130m-G2")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _cfgs(variant):
    """(JAX cfg, port cfg); ``-G2`` gives the SSM two state groups."""
    name, g2 = variant.removesuffix("-G2"), variant.endswith("-G2")
    jc, tc = jreg.reduced(name), treg.reduced(name)
    if g2:
        jc, tc = (dataclasses.replace(c, ssm=dataclasses.replace(
            c.ssm, n_groups=2)) for c in (jc, tc))
    return jc, tc


@pytest.fixture(scope="module", params=VARIANTS)
def model(request):
    """(JAX cfg, port cfg, JAX params, port params) of a reduced arch."""
    jc, tc = _cfgs(request.param)
    jp = jlm.init_params(jc, jax.random.PRNGKey(3))
    return jc, tc, jp, lm_params_from_numpy(jp, device="cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# --------------------------------------------------------------------------
# the mixer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
def test_mixer_forward_and_decode_match_jax(groups):
    """Mixer forward from zero and from a handed-over state, then two
    decode steps; the port's decode writes the state IN PLACE."""
    jcfg = dataclasses.replace(jreg.reduced("mamba2-130m").ssm,
                               n_groups=groups)
    tcfg = tssm.SsmCfg(**dataclasses.asdict(jcfg))
    jp = jssm.init(jax.random.PRNGKey(1), jcfg)
    tp = lm_params_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
    jy, jst = jssm.forward(jp, jcfg, jnp.asarray(x[:, :16]))
    ty, tst = tssm.forward(tp, tcfg, torch.from_numpy(x[:, :16]))
    _close(ty, jy)
    for k in ("conv", "ssm"):
        _close(tst[k], jst[k])
    jy, jst = jssm.forward(jp, jcfg, jnp.asarray(x[:, 16:]), jst)
    ty, tst = tssm.forward(tp, tcfg, torch.from_numpy(x[:, 16:]), tst)
    _close(ty, jy)
    state = {k: v.clone() for k, v in tst.items()}
    for t in range(2):
        xt = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jssm.decode_step(jp, jcfg, jnp.asarray(xt), jst)
        ty, out = tssm.decode_step(tp, tcfg, torch.from_numpy(xt), state)
        assert out is state
        _close(ty, jy)
        for k in ("conv", "ssm"):
            _close(state[k], jst[k])
    fresh = tssm.init_state(tcfg, 3)
    jfresh = jssm.init_state(jcfg, 3)
    for k in ("conv", "ssm"):
        assert tuple(fresh[k].shape) == jfresh[k].shape
        assert fresh[k].dtype == torch.float32 and not fresh[k].any()


# --------------------------------------------------------------------------
# the LM stack
# --------------------------------------------------------------------------

def test_forward_matches_jax(model):
    jc, tc, jp, tp = model
    toks = _tokens(jc, (2, 32))
    want, _ = jlm.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    got, aux = tlm.forward(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 32, jc.vocab) and aux == {}
    _close(got, want)


def test_prefill_and_decode_match_jax(model):
    """Logits and every cache leaf (conv, ssm, and the shared block's
    sk/sv) after prefill and after each of 3 greedy decode steps."""
    jc, tc, jp, tp = model
    toks = _tokens(jc, (2, 12), seed=1)
    jl, jcache = jlm.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, 20)
    tl, tcache = tlm.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, 20)
    keys = {"len", "conv", "ssm"} | ({"sk", "sv"} if jc.family == "hybrid"
                                     else set())
    assert set(tcache) == set(jcache) == keys

    def same():
        _close(tl, jl)
        for k in keys - {"len"}:
            assert tuple(tcache[k].shape) == jcache[k].shape, k
            _close(tcache[k], jcache[k])
        np.testing.assert_array_equal(tcache["len"].numpy(), jcache["len"])

    same()
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jcache = jlm.decode_step(jp, jc, jnp.asarray(nxt), jcache)
        tl, tcache2 = tlm.decode_step(tp, tc, torch.from_numpy(nxt), tcache)
        assert tcache2 is tcache
        same()


def test_prefill_then_decode_equals_forward(model):
    """Within the port: prefill on a prefix and 3 decode steps give
    forward's logits at those positions (at decode, zamba2's re-injected
    embedding is the current token's, the same quantity as forward's
    per-position one)."""
    _, tc, _, tp = model
    toks = torch.from_numpy(_tokens(tc, (2, 32), seed=2))
    full, _ = tlm.forward(tp, tc, {"tokens": toks})
    logits, cache = tlm.prefill(tp, tc, {"tokens": toks[:, :16]}, 24)
    torch.testing.assert_close(logits, full[:, 15], **TOL)
    for t in range(16, 19):
        logits, cache = tlm.decode_step(tp, tc, toks[:, t], cache)
        torch.testing.assert_close(logits, full[:, t], **TOL)


def test_prompt_lengths_refused_by_both(model):
    """T > chunk with T % chunk != 0 fails the chunked scan's assert in
    both packages; T <= chunk and multiples of it pass."""
    jc, tc, jp, tp = model
    c = tc.ssm.chunk
    bad = _tokens(jc, (1, c + 3), seed=3)
    with pytest.raises(AssertionError):
        jlm.forward(jp, jc, {"tokens": jnp.asarray(bad)})
    with pytest.raises(AssertionError):
        tlm.forward(tp, tc, {"tokens": torch.from_numpy(bad)})
    with pytest.raises(AssertionError):
        tlm.prefill(tp, tc, {"tokens": torch.from_numpy(bad)}, 2 * c + 8)
    for T in (c - 3, 2 * c):
        tlm.forward(tp, tc, {"tokens": torch.from_numpy(
            _tokens(tc, (1, T), seed=4))})


def test_params_carry_across(model):
    """``lm_params_from_numpy`` carries the SSM/hybrid trees leaf for
    leaf: A_log, D, dt_bias, conv_w and, for zamba2, the shared block."""
    jc, _, jp, tp = model
    jshapes = jax.tree_util.tree_map(lambda a: a.shape, jp)
    assert tlm.tree_map(lambda t: tuple(t.shape), tp) == jshapes
    mix, jmix = tp["layers"]["mixer"], jp["layers"]["mixer"]
    for k in ("A_log", "D", "dt_bias", "conv_w", "conv_b"):
        np.testing.assert_array_equal(mix[k].numpy(), np.asarray(jmix[k]))
    assert ("shared" in tp) == (jc.family == "hybrid")
    if "shared" in tp:
        np.testing.assert_array_equal(
            tp["shared"]["in_proj"]["w"].numpy(),
            np.asarray(jp["shared"]["in_proj"]["w"]))
        assert tp["shared"]["in_proj"]["w"].shape == (2 * jc.d_model,
                                                      jc.d_model)


def test_init_params_tree_and_distributions(model):
    """The port's init makes the JAX package's tree, shapes and dtypes,
    the same deterministic leaves (A_log = log(linspace(1, 16, H)),
    D = 1, zero dt_bias, conv_b and gains) and the same distributions
    (fan-in truncated normals at ±2σ, 0.2 for the conv taps): standard
    deviations within 5% of the JAX package's draw."""
    jc, tc, jp, _ = model
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0),
                         device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: a.shape, jp)
    assert tlm.tree_map(lambda t: tuple(t.shape), tp) == jshapes
    assert all(t.dtype == torch.float32 for t in _leaves(tp))
    mix, jmix = tp["layers"]["mixer"], jp["layers"]["mixer"]
    np.testing.assert_allclose(mix["A_log"].numpy(), np.asarray(jmix["A_log"]),
                               atol=1e-6, rtol=0)
    for k in ("D", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(mix[k].numpy(), np.asarray(jmix[k]))
    assert float(tp["layers"]["ln"]["g"].abs().max()) == 0.0
    paths = [(("layers", "mixer", "in_proj", "w"), tc.d_model ** -0.5),
             (("layers", "mixer", "conv_w"), 0.2),
             (("layers", "mixer", "out_proj", "w"),
              tc.ssm.d_inner ** -0.5)]
    if jc.family == "hybrid":
        paths.append((("shared", "in_proj", "w"), (2 * tc.d_model) ** -0.5))
    for path, sigma in paths:
        t, j = tp, jp
        for k in path:
            t, j = t[k], j[k]
        std = float(np.std(np.asarray(j)))
        assert abs(float(t.std()) - std) < 0.05 * std, path
        assert float(t.abs().max()) <= 2.0 * sigma * (1 + 1e-6), path


def test_kv_bits_is_not_read_by_ssm_caches(model):
    """``kv_bits=8`` names the attention families' int8 KV cache; the
    SSM and hybrid caches ignore it, as in the JAX package
    (``models/lm.py:init_cache``), so the port serves such a config as
    the float one (and gives a dense model its int8 cache)."""
    _, tc, _, tp = model
    q8 = dataclasses.replace(tc, kv_bits=8)
    toks = {"tokens": torch.from_numpy(_tokens(tc, (1, 8), seed=5))}
    tl, tcache = tlm.prefill(tp, q8, toks, 12)
    wl, wcache = tlm.prefill(tp, tc, toks, 12)
    torch.testing.assert_close(tl, wl, rtol=0, atol=0)
    assert {k: (v.dtype, v.shape) for k, v in tcache.items()} == \
        {k: (v.dtype, v.shape) for k, v in wcache.items()}
    LmReplica(q8, tp, max_batch=1, cache_size=12, device="cpu")
    dense = tlm.init_cache(dataclasses.replace(treg.reduced("granite-3-8b"),
                                               kv_bits=8), 1, 12,
                           device="cpu")
    assert dense["k"].dtype == dense["v"].dtype == torch.int8
    assert dense["k_s"].dtype == torch.float32


def test_cpu_run_counts_no_kernel_launch(model):
    _, tc, _, tp = model
    before = tssd.launches.value
    tlm.forward(tp, tc, {"tokens": torch.from_numpy(_tokens(tc, (1, 8)))})
    assert tssd.launches.value == before


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _serving_prompts(vocab):
    """Lengths 5, 9, 7 and 16 from default_rng(5): all at most the
    reduced configs' chunk of 16."""
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(0, vocab, size=n)]
            for n in (5, 9, 7, 16)]


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_engine_matches_jax_engine(arch):
    """Four prompts through two slots, 6 greedy tokens each: the same
    tokens as the JAX package's Engine (slots reused: the conv ring, the
    state and the shared block's K/V rows are installed per slot)."""
    jc, tc = _cfgs(arch)
    jp = jlm.init_params(jc, jax.random.PRNGKey(2))
    tp = lm_params_from_numpy(jp, device="cpu")
    prompts = _serving_prompts(jc.vocab)
    jeng = JEngine(jc, jp, max_batch=2, cache_size=32)
    teng = TEngine(tc, tp, max_batch=2, cache_size=32, device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(uid=i, prompt=p, max_new_tokens=6))
        teng.submit(TRequest(uid=i, prompt=p, max_new_tokens=6))
    want = {r.uid: r.out_tokens for r in jeng.run()}
    done = teng.run()
    assert len(done) == 4 and all(r.done for r in done)
    assert {r.uid: r.out_tokens for r in done} == want
    teng.close()
    jeng.close()


def test_entry_points_refuse_silent_cpu(monkeypatch):
    tc = treg.reduced("zamba2-1.2b")
    tp = tlm.init_params(tc, torch.Generator().manual_seed(1), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: LmReplica(tc, tp), lambda: TEngine(tc, tp),
                 lambda: tlm.init_params(tc, torch.Generator()),
                 lambda: tlm.init_cache(tc, 1, 8)):
        with pytest.raises(RuntimeError, match="CPU"):
            make()


def test_converters_default_to_the_card(monkeypatch):
    """``convert``'s two functions resolve ``device=None`` to the card, as
    the other entry points do: without CUDA they raise, naming the CPU
    escape, and ``device="cpu"`` converts."""
    from repro_torch.convert import params_from_numpy
    tree = {"layer": {"w": np.ones((2, 3), np.float32)}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for convert in (lm_params_from_numpy, params_from_numpy):
        with pytest.raises(RuntimeError, match="CPU device explicitly"):
            convert(tree)
        got = convert(tree, device="cpu")
        assert got["layer"]["w"].device == torch.device("cpu")
