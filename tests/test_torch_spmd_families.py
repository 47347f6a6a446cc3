"""The hybrid and encdec families and the int8 KV cache over a sharded
``(data, model)`` mesh against the unsharded steps of the port and of
the JAX package, on the CPU.

zamba2-1.2b (a Mamba-2 stack with one shared transformer block every 2
of its 4 layers), seamless-m4t-medium (2 encoder and 2 decoder layers
with cross-attention, over 12 source frames) and granite-3-8b with
``kv_bits=8`` (int8 codes and row scales) at ``registry.reduced`` size
(d = 64, H = 4, Hkv = 2, Dh = 16, vocab 512), their parameters from the
JAX package's ``lm.init_params`` through ``convert.lm_params_from_numpy``
and laid over meshes (1, 2), (2, 2) and (1, 4) of CPU positions by
``launch.steps.place_params``; (1, 4) is the cut-heads case (8 kv
columns a position: the kv projections all-gathered). Inputs come from
numpy with a seed. Held at atol = rtol = 1e-4:

* logits against the port's ``forward``; loss and token count of
  ``loss_fn`` and ``make_eval_step`` against the JAX ``loss_fn``;
* two adamw train steps, the first of one microbatch, the second of
  two: every gathered parameter and moment, loss and grad_norm, against
  the port's step and the JAX ``make_train_step`` jitted unsharded;
* a prefill and three decode steps: logits and every gathered cache
  leaf against the port's unsharded steps, and against the JAX
  ``prefill``/``decode_step`` (the int8 cache's decode logits within
  the JAX package's own bound for it, a mean relative 0.05: the port's
  float rows and the JAX package's may round to other codes). The int8
  codes are compared bit for bit with the port's unsharded cache: a code
  may differ only by one, where its float row (the ``kv_bits=16``
  cache's) lies within a rounding of a half step; the count is printed;
* the labelled transfers of a forward and of a decode step on (2, 2)
  and (1, 4): kinds, counts and bytes as the plan implies them (the
  encoder's collectives of the source rows, each decoder layer's
  cross-attention all-reduce, zamba2's two all-reduces a shared-block
  call and none in its Mamba layers);
* ``seq_shard`` on (2, 2): the same logits and train step; zamba2's
  residual stays whole (no reduce-scatter), seamless's encoder keeps its
  all-reduces of the source rows while its decoder's become
  reduce-scatters.

Serial time about 30 s: one JAX jit of the loss, of the prefill, of the
decode step and of each microbatch count's train step an arch. The
module runs on one intra-op thread (``one_thread``).
"""
import dataclasses
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist import sharding as tsh
from repro_torch.dist import spmd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.roofline import trace
from repro_torch.tree import flatten_with_path

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("zamba2-1.2b", "seamless-m4t-medium", "granite-3-8b@kv8")
MESHES = ((1, 2), (2, 2), (1, 4))
B, T, CACHE, SRC = 4, 16, 32, 12
# the JAX package's bound for the int8 cache's decode logits
Q8_MEAN_REL = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the lockstep over a mesh's positions is many
    small ops, which a pool of threads a test worker only slows when the
    workers of a parallel run share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return tmesh.make_mesh(shape, ("data", "model"), devices=["cpu"] * 8)


def _batch(cfg, seed, n=B, t=T):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (n, t)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (n, t)).astype(np.int32)}
    b["labels"][:, -2:] = -1                       # masked positions
    if cfg.is_encdec:
        b["src_embeds"] = rng.standard_normal(
            (n, SRC, cfg.d_model)).astype(np.float32)
    return b


def _prompt(cfg) -> dict:
    bb = _batch(cfg, 5)
    bb.pop("labels")
    return bb


def _mb(b: dict, n: int) -> dict:
    return {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
            for k, v in b.items()}


def _t(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tflat(tree) -> dict:
    return {"|".join(map(str, path)): leaf.detach().numpy()
            for path, leaf in flatten_with_path(tree)}


def _jflat(tree) -> dict:
    return {"|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **TOL)


def _tokens(s: int) -> np.ndarray:
    return np.asarray([3, 1, 4, 1 + s], dtype=np.int32)


def _steps_batches(cfg) -> list:
    """The train steps' batches: one microbatch, then two."""
    return [_mb(_batch(cfg, 10), 1), _mb(_batch(cfg, 11), 2)]


@functools.lru_cache(maxsize=None)
def _model(arch):
    name, _, kv = arch.partition("@")
    extra = {"kv_bits": 8} if kv else {}
    jc = dataclasses.replace(jreg.reduced(name), **extra)
    tc = dataclasses.replace(treg.reduced(name), **extra)
    jp = jlm.init_params(jc, jax.random.PRNGKey(4))
    return jc, tc, jp, lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _port_infer(tc, tp):
    """The port's unsharded prefill and three decode steps: (logits,
    the cache at the end)."""
    logits, cache = tlm.prefill(tp, tc, _t(_prompt(tc)), CACHE)
    out = [logits.numpy()]
    for s in range(3):
        logits, cache = tlm.decode_step(tp, tc, torch.from_numpy(_tokens(s)),
                                        cache)
        out.append(logits.numpy())
    return out, _tflat(cache)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The unsharded answers: the port's logits and the JAX loss of one
    batch; the JAX adamw steps (one microbatch, then two); the port's
    and the JAX prefill and three decode steps; for the int8 cache, the
    port's float cache of the same calls."""
    jc, tc, jp, tp = _model(arch)
    b = _batch(tc, 1)
    out = {"logits": tlm.forward(tp, tc, _t(b))[0].numpy(),
           "jloss": jax.jit(lambda p, x: jlm.loss_fn(p, jc, x)[1])(
               jp, _j(b))}
    jo = jopt.adamw(lr=1e-3)
    p, s, mets = jp, jo.init(jp), []
    for i, mb in enumerate(_steps_batches(tc)):
        step = jax.jit(jsteps.make_train_step(jc, jo, i + 1))
        p, s, m = step(p, s, jnp.int32(i), _j(mb))
        mets.append(m)
    out["train"] = (_jflat(p), _jflat(s), mets)
    jl, jcache = jax.jit(lambda p, x: jlm.prefill(p, jc, x, CACHE))(
        jp, _j(_prompt(tc)))
    dec = jax.jit(lambda p, t, c: jlm.decode_step(p, jc, t, c))
    logits = [np.asarray(jl)]
    for s in range(3):
        jl, jcache = dec(jp, jnp.asarray(_tokens(s)), jcache)
        logits.append(np.asarray(jl))
    out["jinfer"] = (logits, _jflat(jcache))
    out["infer"] = _port_infer(tc, tp)
    if tc.kv_bits == 8:
        out["float_cache"] = _port_infer(
            dataclasses.replace(tc, kv_bits=16), tp)[1]
    return out


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_unsharded(arch, shape):
    """Logits within 1e-4 of the port's unsharded ``forward``; loss and
    token count of ``loss_fn`` and of ``make_eval_step`` within 1e-4 of
    the JAX ``loss_fn``."""
    jc, tc, jp, tp = _model(arch)
    ref = _reference(arch)
    b = _t(_batch(tc, 1))
    sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
    np.testing.assert_allclose(spmd.forward(sp, tc, b).numpy(),
                               ref["logits"], **TOL)
    loss, m = spmd.loss_fn(sp, tc, b)
    ev = tsteps.make_eval_step(tc)(sp, b)
    for got in (m, ev):
        for k in ("loss", "tokens"):
            np.testing.assert_allclose(float(got[k]), float(ref["jloss"][k]),
                                       err_msg=k, **TOL)
    assert float(loss) == float(m["loss"])


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_unsharded(arch, shape):
    """Two adamw steps, of one microbatch and of two: every gathered
    parameter and moment, each step's loss, tokens and grad_norm, within
    1e-4 of the port's unsharded steps and the JAX steps."""
    _, tc, _, tp = _model(arch)
    jparams, jstate, jmets = _reference(arch)["train"]
    opt = topt.adamw(lr=1e-3)
    sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
    ss = tsteps.init_opt_state(opt, sp, tc)
    p, s = tp, tsteps.init_opt_state(opt, tp, tc)
    for i, mb in enumerate(_steps_batches(tc)):
        step = tsteps.make_train_step(tc, opt, i + 1)
        p, s, mu = step(p, s, i, _t(mb))
        sp, ss, ms = step(sp, ss, i, _t(mb))
        for k in ("loss", "tokens", "grad_norm"):
            for want in (mu[k], jmets[i][k]):
                np.testing.assert_allclose(float(ms[k]), float(want),
                                           err_msg=f"step {i} {k}", **TOL)
    assert all(isinstance(x, tsh.ShardedTensor)
               for _, x in flatten_with_path({"p": sp, "s": ss}))
    gp, gs = _tflat(spmd.gather(sp)), _tflat(spmd.gather(ss))
    _close(gp, _tflat(p), "params vs port")
    _close(gs, _tflat(s), "state vs port")
    _close(gp, jparams, "params vs JAX")
    _close(gs, jstate, "state vs JAX")


def _codes_check(got: dict, want: dict, floats: dict, what: str) -> None:
    """The int8 cache's codes bit for bit with the unsharded cache's,
    but where one differs by one at a row whose float value lies within
    a rounding of a half step (``floats``: the float cache; the scales
    ``want``'s)."""
    for k in ("k", "v"):
        d = got[k].astype(np.int32) - want[k].astype(np.int32)
        n = int(np.count_nonzero(d))
        print(f"{what} {k}: {n} of {d.size} codes differ from the unsharded "
              f"cache's")
        if n:
            assert np.abs(d).max() == 1, (what, k)
            ratio = np.abs(floats[k] / want[k + "_s"][..., None])[d != 0]
            assert np.abs(ratio - np.floor(ratio) - 0.5).max() < 1e-3, \
                (what, k)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unsharded(arch, shape):
    """A prefill and three decode steps through ``make_prefill_step`` and
    ``make_decode_step``: logits within 1e-4 of the port's unsharded
    steps and of the JAX steps (at ``kv_bits=8``, the decode steps'
    within the JAX bound); every gathered cache leaf within 1e-4 of the
    port's, the int8 codes bit for bit (``_codes_check``), and of the
    JAX cache's (the codes within one)."""
    jc, tc, jp, tp = _model(arch)
    ref = _reference(arch)
    (want, cache), (jlogits, jcache) = ref["infer"], ref["jinfer"]
    pf, dc = tsteps.make_prefill_step(tc, CACHE), tsteps.make_decode_step(tc)
    sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
    logits, c1 = pf(sp, _t(_prompt(tc)))
    assert all(isinstance(v, tsh.ShardedTensor) for v in c1.values())
    got = [logits.numpy()]
    for s in range(3):
        logits, c1 = dc(sp, torch.from_numpy(_tokens(s)), c1)
        got.append(logits.numpy())
    for i in range(4):
        np.testing.assert_allclose(got[i], want[i], err_msg=f"step {i}",
                                   **TOL)
        if tc.kv_bits == 8 and i:
            rel = np.abs(got[i] - jlogits[i]).mean() / np.abs(
                jlogits[i]).mean()
            assert rel < Q8_MEAN_REL, (i, rel)
        else:
            np.testing.assert_allclose(got[i], jlogits[i],
                                       err_msg=f"step {i}", **TOL)
    gc = _tflat(spmd.gather(c1))
    assert set(gc) == set(cache) == set(jcache)
    codes = ("k", "v") if tc.kv_bits == 8 else ()
    _close({k: v for k, v in gc.items() if k not in codes},
           {k: v for k, v in cache.items() if k not in codes},
           "cache vs port")
    _close({k: v for k, v in gc.items() if k not in codes},
           {k: v for k, v in jcache.items() if k not in codes},
           "cache vs JAX")
    if codes:
        _codes_check(gc, cache, ref["float_cache"], f"{arch} {shape}")
        for k in codes:
            assert np.abs(gc[k].astype(np.int32)
                          - jcache[k].astype(np.int32)).max() <= 1


def _transfers(fn) -> Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return Counter(trace._parse(e.name) for e in prof.events()
                   if trace._parse(e.name))


def _plan(cfg, shape, t: int, decode: bool) -> Counter:
    """The transfers of a forward (``t`` tokens a row) or of a decode
    step of the reduced configs (d 64, vocab 512: the tied or ``lm_head``
    table vocab-sharded; H·Dh 64 and Hkv·Dh 32 cut over ``model``, whole
    kv heads at ``model = 2``, 8 kv columns a position at 4)."""
    dp, tp = shape
    rows, d, V = B // dp, cfg.d_model, cfg.vocab
    kvc = cfg.n_kv_heads * cfg.head_dim * 4
    want = Counter()
    if tp > 1:
        act = rows * t * d * 4
        want[("all-reduce", act)] += 1                      # the embedding
        want[("all-gather", rows * t * V * 4)] += 1         # the logits
        if cfg.family == "hybrid":                          # a call: wo, down
            calls = -(-cfg.n_layers // cfg.shared_attn_every)
            want[("all-reduce", act)] += 2 * calls
            if tp == 4:
                want[("all-gather", rows * t * kvc)] += 2 * calls
        else:                       # wo, (xattn's wo), down a layer
            want[("all-reduce", act)] += (3 if cfg.is_encdec else 2) \
                * cfg.n_layers
            if tp == 4:
                want[("all-gather", rows * t * kvc)] += 2 * cfg.n_layers
        if cfg.is_encdec and not decode:
            src = rows * SRC * d * 4
            want[("all-reduce", src)] += 2 * cfg.n_enc_layers
            if tp == 4:             # the encoder's and cross-attention's
                want[("all-gather", rows * SRC * kvc)] += 2 * (
                    cfg.n_enc_layers + cfg.n_layers)
    if dp > 1:
        want[("all-gather", B * t * V * 4)] += 1
    return want


@pytest.mark.parametrize("shape", ((2, 2), (1, 4)), ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_transfers_equal_the_plan(arch, shape):
    """A forward and a decode step (after a prefill): every labelled
    transfer as ``_plan`` derives it from the layout."""
    _, tc, _, tp = _model(arch)
    sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
    b = _t(_batch(tc, 1))
    assert _transfers(lambda: spmd.forward(sp, tc, b)) == \
        _plan(tc, shape, T, False)
    _, cache = spmd.prefill(sp, tc, _t(_prompt(tc)), CACHE)
    got = _transfers(lambda: spmd.decode_step(
        sp, tc, torch.from_numpy(_tokens(0)), cache))
    assert got == _plan(tc, shape, 1, True)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_seq_shard_keeps_encoder_and_hybrid_whole(arch):
    """``seq_shard`` on (2, 2), remat full: the forward's logits, a train
    step's parameters and loss equal the residual kept whole. zamba2's
    trace holds no reduce-scatter (its shared block calls no ``_sp``);
    seamless's holds the encoder's 2 all-reduces a layer of the source
    rows unchanged, and its decoder's 3 a layer become reduce-scatters."""
    _, tc, _, tp = _model(arch)
    on = dataclasses.replace(tc, seq_shard=True, remat="full")
    sp = tsteps.place_params(tp, _mesh((2, 2)), cfg=tc)
    b = _t(_batch(tc, 2))
    want = tlm.forward(tp, tc, b)[0].numpy()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = spmd.forward(sp, on, b).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    seen = Counter(trace._parse(e.name) for e in prof.events()
                   if trace._parse(e.name))
    kinds = Counter()
    for (k, _), n in seen.items():
        kinds[k] += n
    if tc.family == "hybrid":
        assert kinds["reduce-scatter"] == 0, seen
    else:
        assert kinds["reduce-scatter"] == 3 * tc.n_layers, seen
        src = (B // 2) * SRC * tc.d_model * 4
        assert seen[("all-reduce", src)] == 2 * tc.n_enc_layers, seen
    opt = topt.adamw(lr=1e-3)
    st = tsteps.init_opt_state(opt, sp, tc)
    one = {k: v[None] for k, v in b.items()}
    p0, _, m0 = tsteps.make_train_step(tc, opt, 1)(sp, st, 0, one)
    p1, _, m1 = tsteps.make_train_step(on, opt, 1)(sp, st, 0, one)
    _close(_tflat(spmd.gather(p1)), _tflat(spmd.gather(p0)), "params")
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]), **TOL)
