"""The moe family's LM steps over a sharded ``(data, model)`` mesh
against the unsharded steps of the port and of the JAX package, on the
CPU (serial time about 30 s, most of it the JAX package jitting its
loss, train, prefill and decode steps once an arch).

qwen3-moe (every layer MoE, top-2 of 8 experts) and llama4 (the grouped
layout: a dense layer, then an MoE layer with a shared expert) at
``registry.reduced`` size, with ``capacity_factor`` 1.0 so that the
calls drop assignments (``dropped_frac > 0``), laid over (2, 2) and
(1, 2) meshes of CPU positions by ``launch.steps.place_params``. Under
GSPMD a sharded step computes the unsharded step's function: capacity
is ``capacity(B·T)`` of the whole call and the stable-sort pack runs
over the whole batch. Held at atol = rtol = 1e-4:

* logits against the port's ``forward``; the loss with its load-balance
  term (0.01 × the mean over the MoE layers) and the token count, of
  ``loss_fn`` and ``make_eval_step``, against the JAX ``loss_fn``;
* a train step (adamw, two microbatches): the gathered parameters and
  moments, loss and grad_norm, against the port's step and the JAX
  ``make_train_step``;
* a prefill and three decode steps, logits and the gathered cache,
  against the port's and the JAX ``prefill`` / ``decode_step``;
* the drops: the unsharded call drops, and a pack taken per data group
  would give other outputs (so the comparisons above would see one);
* the MoE input's all-gather over the data groups, labelled with the
  whole batch's bytes, once a MoE layer.
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
from repro_torch.dist import spmd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.nn import moe as tmoe
from repro_torch.optim import optimizers as topt
from repro_torch.roofline import trace
from repro_torch.tree import flatten_with_path

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
MESHES = ((2, 2), (1, 2))
B, T, CACHE = 4, 16, 32


def _mesh(shape):
    return tmesh.make_mesh(shape, ("data", "model"), devices=["cpu"] * 8)


def _dropping(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))


def _batch(cfg, seed, n=B, t=T):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (n, t)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (n, t)).astype(np.int32)}
    b["labels"][:, -2:] = -1
    return b


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


@functools.lru_cache(maxsize=None)
def _model(arch):
    jc, tc = _dropping(jreg.reduced(arch)), _dropping(treg.reduced(arch))
    jp = jlm.init_params(jc, jax.random.PRNGKey(4))
    return jc, tc, jp, lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The unsharded answers: the port's logits, the JAX loss of one
    batch, one JAX adamw step over two microbatches, the JAX prefill and
    three decode steps."""
    jc, tc, jp, tp = _model(arch)
    b = _batch(tc, 1)
    out = {"logits": tlm.forward(tp, tc, _t(b))[0].numpy(),
           "jloss": jax.jit(lambda p, x: jlm.loss_fn(p, jc, x)[1])(
               jp, _j(b))}
    jo = jopt.adamw(lr=1e-3)
    p, s, m = jax.jit(jsteps.make_train_step(jc, jo, 2))(
        jp, jo.init(jp), jnp.int32(0), _j(_mb(_batch(tc, 10), 2)))
    out["train"] = (_jflat(p), _jflat(s), m)
    bb = _batch(tc, 5)
    bb.pop("labels")
    jl, jcache = jax.jit(lambda p, x: jlm.prefill(p, jc, x, CACHE))(
        jp, _j(bb))
    dec = jax.jit(lambda p, t, c: jlm.decode_step(p, jc, t, c))
    logits = [np.asarray(jl)]
    for s in range(3):
        jl, jcache = dec(jp, jnp.asarray(_tokens(s)), jcache)
        logits.append(np.asarray(jl))
    out["infer"] = (logits, _jflat(jcache))
    return out


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_unsharded(arch, shape):
    """Logits within 1e-4 of the port's ``forward``; loss (its
    load-balance term included) and tokens of ``loss_fn`` and
    ``make_eval_step`` within 1e-4 of the JAX ``loss_fn``."""
    _, tc, _, tp = _model(arch)
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
    run = spmd.Run(sp, tc)
    with torch.no_grad():
        spmd.loss_fn(sp, tc, b, run)
    moe_layers = sum(run.moe_layer(i) for i in range(tc.n_layers))
    assert len(run.load_balance) == moe_layers >= 1
    nll = float(loss) - 0.01 * float(sum(run.load_balance) / moe_layers)
    assert abs(nll - float(loss)) > 1e-3      # the aux term is counted
    _, aux = tlm.forward(tp, tc, b)
    np.testing.assert_allclose(float(sum(run.load_balance) / moe_layers),
                               float(aux["load_balance"]), **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_unsharded(arch, shape):
    """One adamw step over two microbatches: every gathered parameter and
    moment, loss, tokens and grad_norm within 1e-4 of the port's
    unsharded step and the JAX step (the replicated router and experts'
    gradient counted once, the aux's too)."""
    _, tc, _, tp = _model(arch)
    jparams, jstate, jm = _reference(arch)["train"]
    batch = _t(_mb(_batch(tc, 10), 2))
    opt = topt.adamw(lr=1e-3)
    step = tsteps.make_train_step(tc, opt, 2)
    p, s, mu = step(tp, tsteps.init_opt_state(opt, tp, tc), 0, batch)
    sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
    gp, gs, ms = step(sp, tsteps.init_opt_state(opt, sp, tc), 0, batch)
    gp, gs = spmd.gather(gp), spmd.gather(gs)
    _close(_tflat(gp), _tflat(p), "params vs port")
    _close(_tflat(gs), _tflat(s), "state vs port")
    _close(_tflat(gp), jparams, "params vs JAX")
    _close(_tflat(gs), jstate, "state vs JAX")
    for k in ("loss", "tokens", "grad_norm"):
        for want in (mu[k], jm[k]):
            np.testing.assert_allclose(float(ms[k]), float(want),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unsharded(arch, shape):
    """A prefill (capacity of its 4 × 16 rows) and three decode steps:
    logits within 1e-4 of the port's and the JAX steps; the gathered
    cache likewise."""
    _, tc, _, tp = _model(arch)
    jlogits, jcache = _reference(arch)["infer"]
    bb = _batch(tc, 5)
    bb.pop("labels")
    pf, dc = tsteps.make_prefill_step(tc, CACHE), tsteps.make_decode_step(tc)
    sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
    l0, c0 = pf(tp, _t(bb))
    l1, c1 = pf(sp, _t(bb))
    got, want = [l1.numpy()], [l0.numpy()]
    for s in range(3):
        tok = torch.from_numpy(_tokens(s))
        l0, c0 = dc(tp, tok, c0)
        l1, c1 = dc(sp, tok, c1)
        got.append(l1.numpy())
        want.append(l0.numpy())
    for i in range(4):
        np.testing.assert_allclose(got[i], want[i], err_msg=f"step {i}",
                                   **TOL)
        np.testing.assert_allclose(got[i], jlogits[i], err_msg=f"step {i}",
                                   **TOL)
    gc = _tflat(spmd.gather(c1))
    _close(gc, _tflat(c0), "cache vs port")
    _close(gc, jcache, "cache vs JAX")


@pytest.mark.parametrize("arch", ARCHS)
def test_the_calls_drop_and_need_the_whole_batch(arch, monkeypatch):
    """The unsharded call drops assignments at capacity 1.0, and the
    MoE layer on each data group's rows alone (a pack and capacity per
    group) gives other outputs than on the whole batch, which the
    sharded call matches."""
    _, tc, _, tp = _model(arch)
    fwa, seen = tmoe.forward_with_aux, []

    def record(p, cfg, x):
        y, aux = fwa(p, cfg, x)
        seen.append((p, x, y, aux))
        return y, aux
    monkeypatch.setattr(tmoe, "forward_with_aux", record)
    with torch.no_grad():
        tlm.forward(tp, tc, _t(_batch(tc, 1)))
    assert seen and max(float(a["dropped_frac"]) for *_, a in seen) > 0
    p, x, y, _ = seen[0]
    halves = torch.cat([fwa(p, tc.moe, x[:B // 2])[0],
                        fwa(p, tc.moe, x[B // 2:])[0]])
    assert float((halves - y).abs().max()) > 1e-3


def test_moe_input_gathered_over_the_data_groups():
    """A forward on (2, 2) labels, for each MoE layer, one all-gather of
    the whole batch's MoE input (B · T · d float32 at each position)
    beside the plan's other transfers."""
    _, tc, _, tp = _model("qwen3-moe-30b-a3b")
    sp = tsteps.place_params(tp, _mesh((2, 2)), cfg=tc)
    b = _t(_batch(tc, 1))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        spmd.forward(sp, tc, b)
    events = Counter()
    for e in prof.events():
        if e.name.startswith(trace.PREFIX):
            events[e.name] += 1
    whole = B * T * tc.d_model * 4
    gathers = sum(n for name, n in events.items()
                  if name == trace.label("all-gather", whole))
    assert gathers == tc.n_layers, events
