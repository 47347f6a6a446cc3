"""The LM steps over a sharded ``(data, model)`` mesh against the
unsharded steps of the port and of the JAX package, on the CPU.

Parameters come from the JAX package's ``lm.init_params`` (reduced
configs) and reach the port through ``convert.lm_params_from_numpy``;
``launch.steps.place_params`` lays them over meshes of CPU positions
(1, 2), (2, 1), (2, 2) and (1, 4); inputs come from numpy with a seed.
Under GSPMD a sharded JAX step computes its unsharded step's function,
so each sharded step is held to the unsharded ones, at atol = rtol =
1e-4:

* the loss and logits of granite, gemma2 (windows, softcaps, post-norms,
  a tied vocab-sharded table), starcoder2, llava (embeds) and mamba2 on
  every mesh, against the port's ``forward`` and the JAX ``loss_fn``;
  (1, 4) is the cut-head case (``n_kv_heads = 2``, ``head_dim = 16``:
  8 columns a position), whose kv projections are all-gathered;
* two train steps (adamw, two microbatches) on every mesh, and adamw
  and sgd at one and two microbatches on (2, 2) and (1, 4): the gathered
  parameters and optimizer state, ``loss`` and ``grad_norm``, against
  the port's step and the JAX ``make_train_step`` jitted unsharded;
* a prefill and three decode steps, logits and the gathered cache;
* the labelled transfers of a forward and a decode step: kinds, counts
  and bytes as the plan implies them;
* ``seq_shard`` on equals off, and a T that does not divide leaves the
  residual whole;
* ``restore(shardings=)`` of a checkpoint the JAX package saved, and a
  sharded ``save`` read back;
* the dry run: every registry arch × cell on both production meshes
  yields a record or the JAX ``skip_reason`` text, its analytic fields
  equal the JAX ``roofline.analysis`` functions, ``per_position`` the
  sum of the shard sizes; and the reference hazard, read with ``ast``
  (``repro.launch.dryrun`` forces 512 host devices at import and is
  never imported here): the seven ``sh.*`` names it calls and the four
  plan fields it reads do not exist in ``repro.dist.sharding``.
"""
import ast
import dataclasses
import functools
import json
import math
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.ckpt import checkpoint as jckpt
from repro.configs import registry as jreg
from repro.configs.base import ALL_SHAPES as JSHAPES
from repro.dist import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.roofline import analysis as jra
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ALL_SHAPES as TSHAPES
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist import sharding as tsh
from repro_torch.dist import spmd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.roofline import trace
from repro_torch.tree import flatten_with_path

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("granite-3-8b", "gemma2-2b", "starcoder2-7b", "llava-next-34b",
         "mamba2-130m")
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
B, T, CACHE = 4, 16, 32
JAX_DRYRUN = Path(__file__).resolve().parent.parent / "src" / "repro" \
    / "launch" / "dryrun.py"


def _mesh(shape):
    return tmesh.make_mesh(shape, ("data", "model"), devices=["cpu"] * 8)


def _batch(cfg, seed, n=B, t=T):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (n, t)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (n, t)).astype(np.int32)}
    b["labels"][:, -2:] = -1                       # masked positions
    if cfg.family == "vlm":
        b["embeds"] = rng.standard_normal(
            (n, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
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


@functools.lru_cache(maxsize=None)
def _model(arch):
    jc, tc = jreg.reduced(arch), treg.reduced(arch)
    jp = jlm.init_params(jc, jax.random.PRNGKey(4))
    return jc, tc, jp, lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The unsharded answers: the port's logits and the JAX loss of one
    batch; two JAX adamw steps over two microbatches; the JAX prefill
    and three decode steps."""
    jc, tc, jp, tp = _model(arch)
    b = _batch(tc, 1)
    out = {"logits": tlm.forward(tp, tc, _t(b))[0].numpy(),
           "jloss": jax.jit(lambda p, x: jlm.loss_fn(p, jc, x)[1])(
               jp, _j(b))}
    jo = jopt.adamw(lr=1e-3)
    step = jax.jit(jsteps.make_train_step(jc, jo, 2))
    p, s, mets = jp, jo.init(jp), []
    for i in range(2):
        p, s, m = step(p, s, jnp.int32(i), _j(_mb(_batch(tc, 10 + i), 2)))
        mets.append(m)
    out["train"] = (_jflat(p), _jflat(s), mets)
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


def _tokens(s: int) -> np.ndarray:
    return np.asarray([3, 1, 4, 1 + s], dtype=np.int32)


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


def _train_both(tc, tp, shape, opt, n_mb, batches):
    """(unsharded, sharded) after ``len(batches)`` steps: params, state,
    metrics of each step."""
    step = tsteps.make_train_step(tc, opt, n_mb)
    sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
    ss = tsteps.init_opt_state(opt, sp, tc)
    p, s = tp, tsteps.init_opt_state(opt, tp, tc)
    mu, ms = [], []
    for i, b in enumerate(batches):
        p, s, m1 = step(p, s, i, b)
        sp, ss, m2 = step(sp, ss, i, b)
        mu.append(m1)
        ms.append(m2)
    assert all(isinstance(x, tsh.ShardedTensor)
               for x in list(dict(flatten_with_path(sp)).values())
               + list(dict(flatten_with_path(ss)).values()))
    return (p, s, mu), (spmd.gather(sp), spmd.gather(ss), ms)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_unsharded(arch, shape):
    """Two adamw steps over two microbatches: every gathered parameter
    and moment, each step's loss, tokens and grad_norm, within 1e-4 of
    the port's unsharded step and the JAX step."""
    jc, tc, jp, tp = _model(arch)
    jparams, jstate, jmets = _reference(arch)["train"]
    batches = [_t(_mb(_batch(tc, 10 + i), 2)) for i in range(2)]
    (p, s, mu), (gp, gs, ms) = _train_both(
        tc, tp, shape, topt.adamw(lr=1e-3), 2, batches)
    _close(_tflat(gp), _tflat(p), "params vs port")
    _close(_tflat(gs), _tflat(s), "state vs port")
    _close(_tflat(gp), jparams, "params vs JAX")
    _close(_tflat(gs), jstate, "state vs JAX")
    for i in range(2):
        for k in ("loss", "tokens", "grad_norm"):
            for want in (mu[i][k], jmets[i][k]):
                np.testing.assert_allclose(float(ms[i][k]), float(want),
                                           err_msg=f"step {i} {k}", **TOL)


@functools.lru_cache(maxsize=None)
def _jax_steps(opt_name: str, n_mb: int):
    if (opt_name, n_mb) == ("adamw", 2):        # the reference's own steps
        return _reference("granite-3-8b")["train"]
    jc, tc, jp, _ = _model("granite-3-8b")
    jo = jopt.get(opt_name, lr=1e-3)
    step = jax.jit(jsteps.make_train_step(jc, jo, n_mb))
    p, s, mets = jp, jo.init(jp), []
    for i in range(2):
        p, s, m = step(p, s, jnp.int32(i),
                       _j(_mb(_batch(tc, 10 + i), n_mb)))
        mets.append(m)
    return _jflat(p), _jflat(s), mets


@pytest.mark.parametrize("n_mb", (1, 2))
@pytest.mark.parametrize("opt_name", ("adamw", "sgd"))
def test_optimizers_and_microbatches(opt_name, n_mb):
    """granite: adamw and sgd at one and two microbatches, two steps on
    (2, 2) and on (1, 4), against the port's step and the JAX step."""
    _, tc, _, tp = _model("granite-3-8b")
    jparams, jstate, jmets = _jax_steps(opt_name, n_mb)
    batches = [_t(_mb(_batch(tc, 10 + i), n_mb)) for i in range(2)]
    for shape in ((2, 2), (1, 4)):
        (p, s, mu), (gp, gs, ms) = _train_both(
            tc, tp, shape, topt.get(opt_name, lr=1e-3), n_mb, batches)
        _close(_tflat(gp), _tflat(p), f"{shape} params vs port")
        _close(_tflat(gs), _tflat(s), f"{shape} state vs port")
        _close(_tflat(gp), jparams, f"{shape} params vs JAX")
        _close(_tflat(gs), jstate, f"{shape} state vs JAX")
        for i in range(2):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(ms[i][k]),
                                           float(jmets[i][k]), **TOL)
                np.testing.assert_allclose(float(ms[i][k]), float(mu[i][k]),
                                           **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unsharded(arch, shape):
    """A prefill and three decode steps through ``make_prefill_step`` and
    ``make_decode_step``: logits within 1e-4 of the port's unsharded
    steps and the JAX steps; the gathered cache likewise."""
    jc, tc, jp, tp = _model(arch)
    jlogits, jcache = _reference(arch)["infer"]
    bb = _batch(tc, 5)
    bb.pop("labels")
    pf, dc = tsteps.make_prefill_step(tc, CACHE), tsteps.make_decode_step(tc)
    sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
    l0, c0 = pf(tp, _t(bb))
    l1, c1 = pf(sp, _t(bb))
    assert all(isinstance(v, tsh.ShardedTensor) for v in c1.values())
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


def _transfers(fn) -> Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return Counter(trace._parse(e.name) for e in prof.events()
                   if trace._parse(e.name))


@pytest.mark.parametrize("shape", ((2, 2), (1, 4), (2, 1)), ids=str)
def test_transfers_equal_the_plan(shape):
    """granite reduced (L = 2, d = 64, vocab 512, H = 4, Hkv = 2, Dh =
    16), batch 4 × 16. A forward: the embedding's all-reduce (vocab 512
    divides ``model``), two all-reduces a layer (``wo``, ``down``), the
    kv projections all-gathered a layer where they are cut (``model =
    4``), the logits' all-gather over ``model`` and then over the data
    groups. A decode step: the same, of one token a row."""
    _, tc, _, tp = _model("granite-3-8b")
    dp, tp_ = shape
    sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
    b = _t(_batch(tc, 1))
    got = _transfers(lambda: spmd.forward(sp, tc, b))
    L, d, V, kvc = tc.n_layers, tc.d_model, tc.vocab, 2 * 16
    rows = B // dp

    def want_of(t):         # t tokens a row
        want = Counter()
        if tp_ > 1:
            want[("all-reduce", rows * t * d * 4)] += 1 + 2 * L
            want[("all-gather", rows * t * V * 4)] += 1
            if tp_ == 4:                      # 8 kv columns a position
                want[("all-gather", rows * t * kvc * 4)] += 2 * L
        if dp > 1:
            want[("all-gather", B * t * V * 4)] += 1
        return want
    assert got == want_of(T)
    _, cache = spmd.prefill(sp, tc, {"tokens": b["tokens"]}, CACHE)
    got = _transfers(lambda: spmd.decode_step(
        sp, tc, torch.from_numpy(_tokens(0)), cache))
    assert got == want_of(1)


def test_train_transfers_equal_the_plan():
    """One adamw step of granite reduced on (2, 2), one microbatch: the
    forward's 5 all-reduces, its logits' all-gather and the loss's
    all-reduce (8 bytes); their adjoints (5 + 1 all-reduces, one
    reduce-scatter); one gradient all-reduce for each of the 12
    parameter leaves (every block held by both data groups); the global
    norm's all-reduce."""
    _, tc, _, tp = _model("granite-3-8b")
    sp = tsteps.place_params(tp, _mesh((2, 2)), cfg=tc)
    opt = topt.adamw()
    st = tsteps.init_opt_state(opt, sp, tc)
    b = _t(_mb(_batch(tc, 1), 1))
    got = _transfers(lambda: tsteps.make_train_step(tc, opt, 1)(
        sp, st, 0, b))
    act = (B // 2) * T * tc.d_model * 4
    want = Counter({("all-reduce", act): 2 * 5, ("all-reduce", 8): 2,
                    ("all-gather", (B // 2) * T * tc.vocab * 4): 1,
                    ("reduce-scatter", (B // 2) * T * tc.vocab * 2): 1,
                    ("all-reduce", 4): 1})
    for _, st_ in flatten_with_path(sp):
        want[("all-reduce", math.prod(st_.shard(0).shape) * 4)] += 1
    assert got == want


@pytest.mark.parametrize("arch", ("granite-3-8b", "gemma2-2b",
                                  "llava-next-34b"))
def test_seq_shard_equals_whole(arch):
    """``seq_shard`` on (2, 2), remat full: the forward's logits, a
    train step and a prefill equal the residual kept whole; with T
    divisible by ``tp`` the trace shows reduce-scatters and no
    block all-reduce, and with T odd (llava: T + 8 patches odd too) none
    at all."""
    _, tc, _, tp = _model(arch)
    on = dataclasses.replace(tc, seq_shard=True, remat="full")
    sp = tsteps.place_params(tp, _mesh((2, 2)), cfg=tc)
    opt = topt.adamw(lr=1e-3)
    st = tsteps.init_opt_state(opt, sp, tc)
    for t in (T, T - 1):
        b = _t(_batch(tc, 2, t=t))
        want = tlm.forward(tp, tc, b)[0].numpy()
        kinds = Counter()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = spmd.forward(sp, on, b).numpy()
        kinds.update(trace._parse(e.name)[0] for e in prof.events()
                     if trace._parse(e.name))
        np.testing.assert_allclose(got, want, **TOL)
        assert (kinds["reduce-scatter"] > 0) == (t == T), kinds
        assert kinds["reduce-scatter"] in (0, 2 * tc.n_layers)
        one = {k: v[None] for k, v in b.items()}
        p0, _, m0 = tsteps.make_train_step(tc, opt, 1)(sp, st, 0, one)
        p1, _, m1 = tsteps.make_train_step(on, opt, 1)(sp, st, 0, one)
        _close(_tflat(spmd.gather(p1)), _tflat(spmd.gather(p0)), "params")
        np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                                   **TOL)
        bb = {k: v for k, v in b.items() if k != "labels"}
        l0, _ = spmd.prefill(sp, tc, bb, t + 12)
        l1, _ = spmd.prefill(sp, on, bb, t + 12)
        np.testing.assert_allclose(l1.numpy(), l0.numpy(), **TOL)


def test_restore_onto_shardings(tmp_path):
    """A checkpoint the JAX package saved (params and adamw state),
    restored onto (2, 2) and (1, 4) from ``meta`` stand-ins: every
    gathered leaf equals the saved array, each shard the block its
    ``tree_specs`` sharding names; a sharded ``save`` reads back equal
    through the JAX package's ``restore``."""
    jc, tc, jp, _ = _model("gemma2-2b")
    jo = jopt.adamw()
    jtree = {"params": jp, "opt": jo.init(jp)}
    jckpt.save(tmp_path / "j", 3, jtree, extras={"cursor": 7})
    saved = _jflat(jtree)
    meta = tsteps.param_specs(tc)
    template = {"params": meta, "opt": topt.adamw().init(meta)}
    for shape in ((2, 2), (1, 4)):
        mesh = _mesh(shape)
        specs = tsh.tree_specs(template, mesh, tsh.plan_for(tc))
        tree, extras = tckpt.restore(tmp_path / "j", template,
                                     shardings=specs)
        assert extras == {"cursor": 7, "step": 3}
        flat = dict(flatten_with_path(tree))
        for path, st in flat.items():
            key = "|".join(map(str, path))
            assert isinstance(st, tsh.ShardedTensor), key
            assert st.sharding == dict(flatten_with_path(specs))[path]
            np.testing.assert_array_equal(st.gather().numpy(), saved[key])
            for p in range(len(st.shards)):
                sl = tsh._slices(tuple(st.shape), st.sharding, p)
                np.testing.assert_array_equal(st.shard(p).numpy(),
                                              saved[key][sl])
        assert any("model" in ns.spec for _, ns in flatten_with_path(specs))
        tckpt.save(tmp_path / f"t{shape[1]}", 5, tree)
        back, _ = jckpt.restore(tmp_path / f"t{shape[1]}", jtree)
        _close(_jflat(back), saved, "round trip")


def _jax_skip_reason():
    """The JAX dry run's ``skip_reason``, compiled from its source: its
    module forces 512 host devices at import."""
    tree = ast.parse(JAX_DRYRUN.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "skip_reason")
    fn.returns = None
    for a in fn.args.args:
        a.annotation = None
    ns: dict = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(JAX_DRYRUN),
                 "exec"), ns)
    return ns["skip_reason"]


@pytest.mark.parametrize("mesh_kind", ("single", "multi"))
def test_dryrun_covers_every_cell(tmp_path, mesh_kind):
    """``dryrun.run`` over every registry arch and shape cell: a record
    with ``status`` ok, or the JAX ``skip_reason`` text; each written to
    its JSON file; ``--opt`` raises."""
    jskip = _jax_skip_reason()
    recs = dryrun.run("all", "all", mesh_kind, str(tmp_path))
    assert len(recs) == len(treg.ARCHS) * len(JSHAPES)
    for rec in recs:
        jc = jreg.get(rec["arch"])
        cell = next(c for c in JSHAPES if c.name == rec["cell"])
        reason = jskip(jc, cell)
        if reason:
            assert rec["skipped"] == reason
        else:
            assert rec["status"] == "ok", rec
            assert rec["chips"] == (512 if mesh_kind == "multi" else 256)
        tag = f"{rec['arch']}__{rec['cell']}__{mesh_kind}"
        assert json.loads((tmp_path / f"{tag}.json").read_text())["arch"] \
            == rec["arch"]
    with pytest.raises(NotImplementedError):
        dryrun.main(["--opt", "--arch", "granite-3-8b", "--shape",
                     "train_4k", "--out", str(tmp_path)])


@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_dryrun_analytic_fields_equal_jax(arch):
    """Each cell's analytic memory, roofline terms, model FLOPs and
    parameter counts on the 16 × 16 and 2 × 16 × 16 meshes equal the JAX
    package's ``roofline.analysis`` called directly (float32,
    ``param_bytes=4``; one microbatch, adamw); ``per_position`` equals
    the sum of each leaf's shard size."""
    tc, jc = treg.get(arch), jreg.get(arch)
    for mp in (False, True):
        mesh = tmesh.make_production_mesh(multi_pod=mp)
        desc = dict(mesh.shape)
        dp = math.prod(v for k, v in desc.items() if k != "model")
        for tcell, jcell in zip(TSHAPES, JSHAPES):
            if dryrun.skip_reason(tc, tcell):
                continue
            rec = dryrun.lower_cell(tc, tcell, mesh)
            ana = rec["roofline_analytic"]
            assert ana["flops"] == jra.analytic_flops(jc, jcell)["total"]
            assert ana["hbm_bytes"] == jra.analytic_bytes(
                jc, jcell, 1, param_bytes=4)
            assert ana["coll_bytes"] == jra.analytic_collective_bytes(
                jc, jcell, desc, 1, param_bytes=4)
            assert rec["memory"]["analytic_per_chip"] == \
                jra.analytic_memory_per_chip(jc, jcell, desc, 1, "adamw",
                                             param_bytes=4, grad_bytes=4)
            assert rec["model_flops"] == jra.model_flops(jc, jcell)
            assert rec["params"] == jc.param_count()
            assert rec["params_active"] == jc.param_count(active_only=True)
            assert rec["compute_chips_effective"] == (
                dp if tc.family == "ssm" else rec["chips"])
            _per_position_is_shard_sum(tc, tcell, mesh, rec)


def _per_position_is_shard_sum(cfg, cell, mesh, rec):
    """``per_position``'s params (and a train cell's optimizer state):
    the sum over leaves of numel / (the sizes of the axes its dims are
    cut over) × 4 bytes, from ``tree_specs``."""
    per = rec["memory"]["per_position"]

    def total(tree):
        n = 0
        for path, ns in flatten_with_path(tsh.tree_specs(
                tree, mesh, tsh.plan_for(cfg))):
            leaf = dict(flatten_with_path(tree))[path]
            cut = math.prod(mesh.shape[a] for ax in ns.spec
                            if ax is not None for a in tsh._axes(ax))
            n += leaf.numel() // cut * leaf.element_size()
        return n
    shapes = tsteps.param_specs(cfg)
    assert per["params"] == total(shapes)
    if cell.kind == "train":
        assert per["opt_state"] == total(topt.adamw().init(shapes))
        assert per["grads"] == per["params"]
    assert per["total"] == sum(v for k, v in per.items() if k != "total")


def test_jax_dryrun_reads_undefined_names():
    """The reference hazard: ``src/repro/launch/dryrun.py`` calls seven
    ``sh.*`` functions that ``repro.dist.sharding`` never defines and
    reads four ``plan`` fields its ``ShardingPlan`` lacks, so it raises
    before it records a cell."""
    tree = ast.parse(JAX_DRYRUN.read_text())
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
              and isinstance(n.func.value, ast.Name)
              and n.func.value.id == "sh"}
    missing = sorted(a for a in called if not hasattr(jsh, a))
    assert missing == sorted(["plan_for_opt", "dp_axes", "axis_size",
                              "batch_specs", "optimizer_for",
                              "cache_specs", "sanitize_specs"])
    fields = {n.attr for n in ast.walk(tree)
              if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
              and n.value.id == "plan"}
    plan_fields = {f.name for f in dataclasses.fields(jsh.ShardingPlan)}
    assert sorted(fields - plan_fields - {"spec_for"}) == sorted(
        ["microbatches", "grad_dtype", "shard_experts", "dp_over_model"])
