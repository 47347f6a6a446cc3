"""adafactor and int8_adamw over sharded parameters, the optimizer
state's layout, its checkpoints, and ``remat`` over a sharded mesh,
against the unsharded steps of the port and of the JAX package, on the
CPU.

granite-3-8b at ``registry.reduced`` size (d = 64, d_ff = 96, H·Dh = 64,
Hkv·Dh = 32, vocab 512) on meshes (1, 2), (2, 2) and (1, 4) of CPU
positions: int8_adamw's groups (``_qgroup``: 128 along the last axis,
or the whole axis where 128 does not divide it) are whole last axes
there, so a column-cut leaf's groups straddle its shards and each
group's absmax is a maximum over positions. A wider variant (d 256,
Hkv = H = 4, Dh 64, d_ff 512) on (1, 2) has groups of 128 that lie
whole in every shard. Held at atol = rtol = 1e-4:

* two steps (adafactor, int8_adamw), at one and at two microbatches:
  every gathered parameter, loss and grad_norm against the port's
  unsharded step and the JAX ``make_train_step`` jitted unsharded;
  adafactor's ``vr``/``vc`` likewise; int8_adamw's scales likewise and
  its moments dequantized within one scale step (a code may round the
  other way where the gradient's sums differ in their last bits);
* the state's layout: each leaf's spec equals the JAX package's
  ``plan_for`` + ``_guard`` of the same state tree on the same mesh
  shape (adafactor's ``vr`` of a column-cut ``wq`` cut on d, of a
  stacked row-cut ``wo`` on the layer axis);
* the optimizer's labelled transfers on (1, 2): one all-reduce for each
  cross-block statistic of a cut leaf (adafactor's row or column mean
  of g², the mean of ``vr`` of a row-cut leaf, the rms of every cut
  leaf; int8_adamw's two group maxima of a leaf whose groups straddle),
  and one all-gather for each state leaf read or written across a
  layout it is not stored in;
* ``ckpt.restore(shardings=)`` of adafactor and int8_adamw states the
  JAX package saved, onto their ``tree_specs`` layouts, and a sharded
  ``save`` read back by the JAX ``restore``, bit-equal;
* ``remat`` ``full``, ``dots`` and ``group`` (groups of two layers) on
  (2, 2) and (1, 4): the loss and every gathered gradient equal to
  ``none`` (granite; seamless, whose encoder layers are checkpointed
  too).

Serial time about 25 s: one JAX jit a (optimizer, microbatch count) and
config. The module runs on one intra-op thread (``one_thread``).
"""
import dataclasses
import functools
import math
import types
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.ckpt import checkpoint as jckpt
from repro.configs import registry as jreg
from repro.dist import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist import sharding as tsh
from repro_torch.dist import spmd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.optim import optimizers as topt
from repro_torch.roofline import trace
from repro_torch.tree import flatten_with_path

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
MESHES = ((1, 2), (2, 2), (1, 4))
B, T, SRC = 4, 16, 12
WIDE = dict(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512)


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


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    b["labels"][:, -2:] = -1
    if cfg.is_encdec:
        b["src_embeds"] = rng.standard_normal(
            (B, SRC, cfg.d_model)).astype(np.float32)
    return b


def _mb(b: dict, n: int) -> dict:
    return {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
            for k, v in b.items()}


def _t(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _tflat(tree) -> dict:
    return {"|".join(map(str, path)): leaf.detach().numpy()
            for path, leaf in flatten_with_path(tree)}


def _jflat(tree) -> dict:
    return {"|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got: dict, want: dict, what: str, keys=None) -> None:
    assert set(got) == set(want), what
    for k in keys if keys is not None else want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **TOL)


@functools.lru_cache(maxsize=None)
def _model(arch, wide: bool = False):
    jc, tc = jreg.reduced(arch), treg.reduced(arch)
    if wide:
        jc, tc = (dataclasses.replace(c, **WIDE) for c in (jc, tc))
    jp = jlm.init_params(jc, jax.random.PRNGKey(4))
    return jc, tc, jp, lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_step(opt_name: str, n_mb: int, wide: bool = False):
    """The JAX ``make_train_step`` of ``opt_name`` over ``n_mb``
    microbatches, jitted once, and its state's initial tree."""
    jc, _, jp, _ = _model("granite-3-8b", wide)
    jo = jopt.get(opt_name, lr=1e-3)
    return jax.jit(jsteps.make_train_step(jc, jo, n_mb)), jo.init(jp)


def _jtree(like, flat: dict):
    """``flat`` (keys as ``_jflat`` names them) in the JAX tree ``like``."""
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like),
        [jnp.asarray(flat[k]) for k in _jflat(like)])


def _dq_check(got: dict, want: dict, what: str) -> None:
    """int8_adamw's state: scales within 1e-4, each moment dequantized
    within one scale step of ``want``'s (the larger of the two scales,
    plus 127 times their difference)."""
    for name in ("m", "v"):
        for key in [k for k in want if k.startswith(name + "|")
                    and k.endswith("|q")]:
            s = key[:-1] + "s"
            np.testing.assert_allclose(got[s], want[s], err_msg=s, **TOL)
            g = max(got[key].shape[-1] // got[s].shape[-1], 1)

            def dq(state):          # exact, in float64
                return state[key].astype(np.float64) * np.repeat(
                    state[s].astype(np.float64), g, axis=-1)
            # one step, plus the scales' own difference over 127 codes
            s1, s2 = (x[s].astype(np.float64) for x in (got, want))
            step = np.repeat(np.maximum(s1, s2) + 127 * np.abs(s1 - s2), g,
                             axis=-1)
            assert (np.abs(dq(got) - dq(want)) <= step).all(), \
                f"{what} {key}"


def _check_steps(shape, opt_name, n_mb, wide=False) -> list:
    """Two steps of granite reduced (``wide``: the wide variant), each of
    the sharded step, the port's unsharded step and the JAX step from
    the same parameters and state (the sharded ones, gathered), so that
    each step is held to its own function: parameters, loss, tokens and
    grad_norm within 1e-4, adafactor's state too, int8_adamw's within
    ``_dq_check``. Returns the sharded parameters of each step."""
    jc, tc, jp, tp = _model("granite-3-8b", wide)
    jstep, jinit = _jax_step(opt_name, n_mb, wide)
    opt = topt.get(opt_name, lr=1e-3)
    step = tsteps.make_train_step(tc, opt, n_mb)
    sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
    ss = tsteps.init_opt_state(opt, sp, tc)
    out = []
    for i in range(2):
        b = _mb(_batch(tc, 10 + i), n_mb)
        p0, s0 = spmd.gather(sp), spmd.gather(ss)
        p, s, mu = step(p0, s0, i, _t(b))
        jpar, jst, jm = jstep(
            _jtree(jp, _tflat(p0)), _jtree(jinit, _tflat(s0)), jnp.int32(i),
            {k: jnp.asarray(v) for k, v in b.items()})
        sp, ss, ms = step(sp, ss, i, _t(b))
        out.append(sp)
        gp, gs = _tflat(spmd.gather(sp)), _tflat(spmd.gather(ss))
        _close(gp, _tflat(p), f"step {i} params vs port")
        _close(gp, _jflat(jpar), f"step {i} params vs JAX")
        if opt_name == "adafactor":
            _close(gs, _tflat(s), f"step {i} state vs port")
            _close(gs, _jflat(jst), f"step {i} state vs JAX")
        else:
            _dq_check(gs, _tflat(s), f"step {i} state vs port")
            _dq_check(gs, _jflat(jst), f"step {i} state vs JAX")
        for k in ("loss", "tokens", "grad_norm"):
            for want in (mu[k], jm[k]):
                np.testing.assert_allclose(float(ms[k]), float(want),
                                           err_msg=f"step {i} {k}", **TOL)
    assert all(isinstance(x, tsh.ShardedTensor)
               for _, x in flatten_with_path({"p": sp, "s": ss}))
    return out


@pytest.mark.parametrize("n_mb", (1, 2))
@pytest.mark.parametrize("opt_name", ("adafactor", "int8_adamw"))
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_steps_match_unsharded(shape, opt_name, n_mb):
    """Two steps of granite reduced (``_check_steps``); every
    column-cut leaf's int8 groups straddle its shards here."""
    sp = _check_steps(shape, opt_name, n_mb)[0]
    if opt_name == "int8_adamw":
        assert any(spmd._straddles(st) for _, st in flatten_with_path(sp))


@pytest.mark.parametrize("shape", ((1, 2), (2, 2)), ids=str)
def test_int8_groups_within_shards(shape):
    """The wide variant at ``model = 2``: every leaf's groups of 128 lie
    whole in its shards, so no leaf takes the lockstep update; two
    steps (``_check_steps``)."""
    sp = _check_steps(shape, "int8_adamw", 1, wide=True)[0]
    assert not any(spmd._straddles(st) for _, st in flatten_with_path(sp))
    assert any(spmd._on_model(st) for _, st in flatten_with_path(sp))


def _jax_specs(tree, plan, sizes: dict) -> dict:
    """keystr → the JAX package's guarded spec of each leaf, a tuple."""
    mesh = types.SimpleNamespace(shape=sizes)
    return {jax.tree_util.keystr(k): tuple(jsh._guard(
        v.shape, plan.spec_for(jax.tree_util.keystr(k), v.ndim), mesh))
        for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("opt_name", ("adafactor", "int8_adamw", "adamw"))
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_state_layout_is_the_jax_tree_specs(shape, opt_name):
    """``init_opt_state``'s layout equals the JAX package's specs of the
    same state tree (``jax.eval_shape`` of its ``init``) on the same mesh
    shape, and its values the unsharded ``init``'s."""
    jc, tc, jp, tp = _model("granite-3-8b")
    want = _jax_specs(jax.eval_shape(jopt.get(opt_name).init, jp),
                      jsh.plan_for(jc), {"data": shape[0], "model": shape[1]})
    opt = topt.get(opt_name)
    ss = tsteps.init_opt_state(
        opt, tsteps.place_params(tp, _mesh(shape), cfg=tc), tc)
    got = {tsh.keystr(p): tuple(st.spec) for p, st in flatten_with_path(ss)}
    assert got == want
    if opt_name == "adafactor" and shape[1] == 2:
        assert got["['f']['layers']['attn']['wq']['w']['vr']"] == \
            (None, "model")
        assert got["['f']['layers']['attn']['wo']['w']['vr']"] == ("model",)
    for k, v in _tflat(spmd.gather(ss)).items():
        np.testing.assert_array_equal(v, _tflat(opt.init(tp))[k], err_msg=k)


def _opt_transfers(opt_name, sp, ss) -> Counter:
    """The optimizer's transfers, leaf by leaf from the layouts: what
    ``spmd.optimizer_step`` is to label."""
    want = Counter()
    for path, st in flatten_with_path(sp):
        nd, cut = st.ndim, spmd._cut_axis(st.spec)
        sub = ss
        for k in path:
            sub = {n: v[k] for n, v in sub.items()}
        if opt_name == "int8_adamw":
            if spmd._straddles(st):
                k = st.shape[-1] // topt._qgroup(tuple(st.shape))
                want[("all-reduce", math.prod(st.shape[:-1]) * k * 4)] += 2
            continue
        f = sub["f"]
        lay = spmd._adafactor_layout(st)
        for name, spec in lay.items():
            if f[name].spec != spec:        # read across layouts
                if spmd._cut_axis(f[name].spec) is not None:
                    want[("all-gather", math.prod(f[name].shape) * 4)] += 1
                if spmd._cut_axis(spec) is not None:  # and written back
                    want[("all-gather", math.prod(f[name].shape) * 4)] += 1
        if cut is None:
            continue
        if nd >= 2:             # the row mean (col-cut) or column mean
            kept = st.shape[:-1] if cut == nd - 1 \
                else st.shape[:-2] + st.shape[-1:]
            want[("all-reduce", math.prod(kept) * 4)] += 1
            if cut == nd - 2:               # the mean of vr over its rows
                want[("all-reduce", math.prod(st.shape[:-2]) * 4)] += 1
        want[("all-reduce", 4)] += 1        # the rms
    return want


@pytest.mark.parametrize("opt_name", ("adafactor", "int8_adamw"))
def test_optimizer_transfers(opt_name):
    """On (1, 2), the transfers of ``optimizer_step`` alone (gradients
    given) equal ``_opt_transfers``' derivation from the layouts."""
    _, tc, _, tp = _model("granite-3-8b")
    opt = topt.get(opt_name, lr=1e-3)
    sp = tsteps.place_params(tp, _mesh((1, 2)), cfg=tc)
    ss = tsteps.init_opt_state(opt, sp, tc)
    dt = spmd.Distinct(sp)
    grads = {k: torch.full_like(t, 1e-3) for k, t in dt.tensors.items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spmd.optimizer_step(opt, dt, grads, ss, 0)
    got = Counter(trace._parse(e.name) for e in prof.events()
                  if trace._parse(e.name))
    want = _opt_transfers(opt_name, sp, ss)
    assert got == want and sum(want.values()) > 0


@pytest.mark.parametrize("opt_name", ("adafactor", "int8_adamw"))
def test_restore_and_save_sharded_state(tmp_path, opt_name):
    """A checkpoint the JAX package saved (params and ``opt_name``'s
    state after one step) restored onto (2, 2) and (1, 4) from ``meta``
    stand-ins laid out by ``tree_specs``: every gathered leaf equals the
    saved array and each shard the block its sharding names; a sharded
    ``save`` reads back bit-equal through the JAX package's ``restore``;
    a train step runs from the restored trees."""
    jc, tc, jp, _ = _model("granite-3-8b")
    jstep, jinit = _jax_step(opt_name, 1)
    _, jstate, _ = jstep(jp, jinit, jnp.int32(0), {
        k: jnp.asarray(v) for k, v in _mb(_batch(tc, 10), 1).items()})
    jtree = {"params": jp, "opt": jstate}
    jckpt.save(tmp_path / "j", 1, jtree)
    saved = _jflat(jtree)
    meta = tsteps.param_specs(tc)
    opt = topt.get(opt_name, lr=1e-3)
    template = {"params": meta, "opt": opt.init(meta)}
    for shape in ((2, 2), (1, 4)):
        specs = tsh.tree_specs(template, _mesh(shape), tsh.plan_for(tc))
        tree, _ = tckpt.restore(tmp_path / "j", template, shardings=specs)
        for path, st in flatten_with_path(tree):
            key = "|".join(map(str, path))
            assert st.sharding == dict(flatten_with_path(specs))[path]
            np.testing.assert_array_equal(st.gather().numpy(), saved[key])
            for p in range(len(st.shards)):
                sl = tsh._slices(tuple(st.shape), st.sharding, p)
                np.testing.assert_array_equal(st.shard(p).numpy(),
                                              saved[key][sl])
        if opt_name == "adafactor":
            vr = tree["opt"]["f"]["layers"]["attn"]["wq"]["w"]["vr"]
            assert spmd._cut_axis(vr.spec) == 1 != spmd._cut_axis(
                tree["params"]["layers"]["attn"]["wq"]["w"].spec) == 2
        tckpt.save(tmp_path / f"t{shape[1]}", 2, tree)
        back, _ = jckpt.restore(tmp_path / f"t{shape[1]}", jtree)
        for k, v in _jflat(back).items():
            np.testing.assert_array_equal(v, saved[k], err_msg=k)
        _, _, m = tsteps.make_train_step(tc, opt, 1)(
            tree["params"], tree["opt"], 1, _t(_mb(_batch(tc, 11), 1)))
        assert np.isfinite(float(m["loss"]))


def _sharded_grads(cfg, sp, batch):
    """(loss, every gathered gradient) of the sharded loss."""
    dt = spmd.Distinct(sp)
    grads, m = tsteps.accumulate_grads(dt.tensors, cfg, batch, 1,
                                       loss_fn=dt.loss_fn)
    return float(m["loss"]), _tflat(spmd.gather(dt.sharded(
        dt.sum_blocks(grads))))


@pytest.mark.parametrize("remat", ("full", "dots", "group"))
@pytest.mark.parametrize("arch", ("granite-3-8b", "seamless-m4t-medium"))
def test_remat_equals_none(arch, remat):
    """On (2, 2) and (1, 4): the loss and every gathered gradient under
    ``remat`` equal those without it (``group``: both layers in one
    checkpointed group, each checkpointed inside)."""
    _, tc, _, tp = _model(arch)
    b = _t(_mb(_batch(tc, 3), 1))
    for shape in ((2, 2), (1, 4)):
        sp = tsteps.place_params(tp, _mesh(shape), cfg=tc)
        l0, g0 = _sharded_grads(dataclasses.replace(tc, remat="none"), sp, b)
        l1, g1 = _sharded_grads(dataclasses.replace(
            tc, remat=remat, remat_group=2), sp, b)
        np.testing.assert_allclose(l1, l0, **TOL)
        _close(g1, g0, f"{shape} gradients")
