"""The port's optimizers and schedule against the JAX package, on the CPU.

Each optimizer takes 5 steps on the same parameters and gradients
(numpy, fixed seeds) in both packages: updates, parameters and states
within 1e-6 relative (``atol`` 1e-6 of the leaf's largest magnitude).
``int8_adamw`` takes each step from the JAX package's state (so one
differing code cannot carry over): its codes are equal, or one apart
where the value quantized lies within 1e-5 of a rounding tie (counted
and printed); its scales and updates within 1e-6. ``warmup_cosine``
and ``clip_by_global_norm`` agree with the JAX package, and the cases
of the JAX package's ``tests/test_optim.py`` run on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt
from repro_torch.tree import flatten_with_path, leaves, tree_map

from _port_memory import release_memory  # noqa: F401

SHAPES = {"w": (16, 256), "stack": (8, 4, 128), "b": (7,), "m": (3, 5)}
B1, B2 = 0.9, 0.95


def _rel_close(got, want, rtol=1e-6, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _flat_j(tree) -> dict:
    return {"|".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree) -> dict:
    return {"|".join(map(str, path)): v.numpy()
            for path, v in flatten_with_path(tree)}


def _trees(seed: int):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _pair(tree_np):
    return ({k: jnp.asarray(v) for k, v in tree_np.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree_np.items()})


def _make(name, pkg):
    sched = pkg.warmup_cosine(1e-2, 2, 5)
    kw = {"sgd": dict(lr=sched), "adamw": dict(lr=sched),
          "adafactor": dict(lr=1e-2), "int8_adamw": dict(lr=sched)}[name]
    return pkg.get(name, **kw)


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizer_matches_jax(name):
    jo, to = _make(name, jopt), _make(name, topt)
    jp, tp = _pair(_trees(0))
    js, ts = jo.init(jp), to.init(tp)
    for i in range(5):
        jg, tg = _pair(_trees(100 + i))
        ju, js = jo.update(jg, js, jp, jnp.int32(i))
        tu, ts = to.update(tg, ts, tp, i)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = tree_map(lambda p, u: p + u, tp, tu)
        for got, want in ((tu, ju), (tp, jp), (ts, js)):
            g, w = _flat_t(got), _flat_j(want)
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                _rel_close(g[k], w[k], err_msg=f"step {i} {k}")


def _dq8_np(q, s, shape):
    g = topt._qgroup(shape)
    lead = tuple(shape[:-1]) + (shape[-1] // g, g)
    return (q.reshape(lead).astype(np.float64)
            * s.astype(np.float64)[..., None]).reshape(shape)


def _moments_np(g, ms, vs):
    """The float moments int8_adamw quantizes, in float64 from the
    state it starts from."""
    g = g.astype(np.float64)
    m = B1 * _dq8_np(ms["q"], ms["s"], g.shape) + (1 - B1) * g
    vdq = _dq8_np(vs["q"], vs["s"], g.shape)
    floor = np.repeat(vs["s"].astype(np.float64) / 4.0,
                      topt._qgroup(g.shape), axis=-1).reshape(g.shape)
    vdq = np.where(vdq <= 0.0, floor, vdq)
    return m, B2 * vdq + (1 - B2) * g * g


def test_int8_adamw_matches_jax():
    jo, to = _make("int8_adamw", jopt), _make("int8_adamw", topt)
    jp, tp = _pair(_trees(1))
    js = jo.init(jp)
    ties = codes = 0
    for i in range(5):
        jg, tg = _pair(_trees(200 + i))
        state_np = jax.tree_util.tree_map(np.asarray, js)
        ts = tree_map(lambda a: torch.from_numpy(np.array(a)), state_np)
        ju, js = jo.update(jg, js, jp, jnp.int32(i))
        tu, ts2 = to.update(tg, ts, tp, i)
        for k in SHAPES:
            _rel_close(tu[k].numpy(), ju[k], err_msg=f"step {i} upd {k}")
            floats = _moments_np(np.asarray(jg[k]), state_np["m"][k],
                                 state_np["v"][k])
            for mom, x in zip(("m", "v"), floats):
                want, got = js[mom][k], ts2[mom][k]
                _rel_close(got["s"].numpy(), want["s"],
                           err_msg=f"step {i} {mom} {k} scale")
                qw, qg = np.asarray(want["q"]), got["q"].numpy()
                assert qg.dtype == np.int8 and qg.shape == qw.shape
                diff = qg.astype(np.int32) - qw
                codes += diff.size
                off = np.nonzero(diff)
                if off[0].size:
                    assert np.abs(diff).max() == 1, (i, mom, k)
                    g_ = topt._qgroup(x.shape)
                    scale = np.repeat(np.asarray(want["s"], np.float64),
                                      g_, axis=-1).reshape(x.shape)
                    frac = np.abs(x / scale)[off] % 1.0
                    assert np.all(np.abs(frac - 0.5) < 1e-5), frac
                    ties += off[0].size
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = tree_map(lambda p, u: p + u, tp, tu)
    print(f"int8_adamw: {ties} of {codes} codes one apart at a tie")


def test_warmup_cosine_and_clip_match_jax():
    for base, warm, total in ((1.0, 10, 100), (3e-4, 20, 200),
                              (1e-3, 0, 50)):
        jl, tl = jopt.warmup_cosine(base, warm, total), \
            topt.warmup_cosine(base, warm, total)
        for step in (0, 1, warm, warm + 1, total // 2, total - 1, total,
                     total + 7):
            got = tl(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            _rel_close(got.numpy(), np.asarray(jl(jnp.int32(step))))
    for max_norm, scale in ((1.0, 10.0), (100.0, 1.0), (0.5, 1e-3)):
        jg, tg = _pair({k: v * scale for k, v in _trees(3).items()})
        jc, jn = jopt.clip_by_global_norm(jg, max_norm)
        tc, tn = topt.clip_by_global_norm(tg, max_norm)
        _rel_close(tn.numpy(), np.asarray(jn))
        _rel_close(topt.global_norm(tg).numpy(),
                   np.asarray(jopt.global_norm(jg)))
        for k in SHAPES:
            _rel_close(tc[k].numpy(), jc[k])


def test_states_keep_the_jax_layout():
    """Leaf names, shapes and dtypes of every state equal the JAX
    package's, so a checkpoint crosses between them."""
    jp, tp = _pair(_trees(4))
    for name in topt.OPTIMIZERS:
        js, ts = jopt.get(name).init(jp), topt.get(name).init(tp)
        jf, tf = _flat_j(js), _flat_t(ts)
        assert set(jf) == set(tf), name
        for k in jf:
            assert (tf[k].shape, tf[k].dtype) == (jf[k].shape,
                                                  jf[k].dtype), (name, k)


# ---- the JAX package's tests/test_optim.py cases, on the port ----------

def quad_loss(p):
    return torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["b"] + 1.0) ** 2)


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor",
                                  "int8_adamw"])
def test_optimizer_descends(name):
    opt = topt.get(name, lr=0.05, **({"weight_decay": 0.0}
                                     if "adam" in name else {}))
    params = {"w": torch.ones((4, 8)), "b": torch.zeros((8,))}
    state = opt.init(params)
    l0 = float(quad_loss(params))
    for i in range(60):
        pg = tree_map(lambda p: p.detach().requires_grad_(), params)
        g = dict(zip(pg, torch.autograd.grad(quad_loss(pg), list(
            pg.values()))))
        upd, state = opt.update(g, state, params, i)
        params = tree_map(lambda p, u: p + u, params, upd)
    assert float(quad_loss(params)) < 0.2 * l0


def test_int8_state_tracks_fp32_adam():
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(size=(16, 128)).astype(
        np.float32))}
    a = topt.get("adamw", lr=2e-2, weight_decay=0.0)
    b = topt.get("int8_adamw", lr=2e-2, weight_decay=0.0)
    pa = pb = params
    sa, sb = a.init(pa), b.init(pb)

    def grad(p):
        return {"w": 2.0 * (p["w"] - 1.5)}

    def loss(p):
        return float(torch.sum((p["w"] - 1.5) ** 2))
    for i in range(40):
        ua, sa = a.update(grad(pa), sa, pa, i)
        ub, sb = b.update(grad(pb), sb, pb, i)
        pa = tree_map(lambda p, u: p + u, pa, ua)
        pb = tree_map(lambda p, u: p + u, pb, ub)
    assert loss(pb) < 1.1 * loss(pa) + 1e-3
    diff = float(torch.max(torch.abs(pa["w"] - pb["w"])))
    scale = float(torch.max(torch.abs(pa["w"] - params["w"])))
    assert diff < 0.3 * scale, (diff, scale)


def test_int8_state_memory_is_quarter():
    params = {"w": torch.zeros((128, 1024))}
    s8 = topt.get("int8_adamw").init(params)
    s32 = topt.get("adamw").init(params)

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in leaves(tree))
    assert nbytes(s8) < 0.3 * nbytes(s32)
    # 1 byte a moment and a float scale per 128: 2.0625 bytes a parameter
    assert nbytes(s8) / params["w"].numel() == 2.0625


def test_int8_state_shape_preserving():
    params = {"w": torch.zeros((8, 16, 256)), "b": torch.zeros((7,))}
    s = topt.get("int8_adamw").init(params)
    assert s["m"]["w"]["q"].shape == (8, 16, 256)
    assert s["m"]["b"]["q"].shape == (7,)


@settings(max_examples=30, deadline=None)
@given(st.floats(0.01, 100.0), st.integers(0, 2**31 - 1))
def test_clip_by_global_norm(max_norm, seed):
    rng = np.random.default_rng(seed)
    g = {"a": torch.from_numpy((rng.normal(size=(5, 5)) * 10).astype(
        np.float32)),
         "b": torch.from_numpy((rng.normal(size=(3,)) * 10).astype(
             np.float32))}
    clipped, norm = topt.clip_by_global_norm(g, max_norm)
    new_norm = float(topt.global_norm(clipped))
    assert new_norm <= max_norm * 1.001 + 1e-6
    if float(norm) <= max_norm:
        for x, y in zip(leaves(g), leaves(clipped)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6)


def test_warmup_cosine_schedule():
    lr = topt.warmup_cosine(1.0, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 0.05
    assert float(lr(99)) < 0.2
    assert float(lr(55)) < float(lr(20))
