"""The port's toolflow against the JAX package's, on the CPU, for the
three paper builders at img 64.

One set of parameters, made with numpy from a seed (He-scaled
truncated normals, as ``init_params`` draws them) and handed to the port
through ``params_from_numpy``, drives both sides. The port must
reproduce the rewritten IR (node attrs, pass log), the design report
(floats to 1e-9), the design-rule check, the launch counts, and the
executor's outputs (atol = rtol = 1e-4: float32 convs summed in another
order) — with the default pipeline through ``compile`` and with no
passes through ``codegen.generate``, which exercises pointwise, add,
concat and split.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import codegen as jcg
from repro.models import yolo as jyolo
from repro_torch.convert import params_from_numpy
from repro_torch.core import codegen as tcg
from repro_torch.core import passes as tpasses
from repro_torch.models import yolo as tyolo

MODELS = ["yolov3-tiny", "yolov5n", "yolov8n"]
IMG = 64
TOL = dict(atol=1e-4, rtol=1e-4)


def _plain(v):
    """Attr values as plain Python (QuantConfigs of either package
    compare by their fields)."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "__dataclass_fields__"):
        return {k: _plain(getattr(v, k)) for k in v.__dataclass_fields__}
    return v


def _graph_view(g):
    return ({n.name: (n.op, list(n.inputs), list(n.outputs),
                      _plain(n.attrs)) for n in g.nodes.values()},
            {s.name: (tuple(s.shape), s.src, list(s.dsts))
             for s in g.streams.values()},
            list(g.inputs), list(g.outputs))


def _ops_count(g, names):
    out: dict = {}
    for n in names:
        out[g.nodes[n].op] = out.get(g.nodes[n].op, 0) + 1
    return out


def _np_params(graph, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for n in graph.topo_order():
        if n.op == "conv":
            K, C, F = n.geom("K"), n.geom("C"), n.geom("F")
            w = np.clip(rng.normal(size=(K, K, C, F)), -2.0, 2.0)
            out[n.name] = {"w": (w / np.sqrt(K * K * C)).astype(np.float32),
                           "b": rng.normal(0.0, 0.1, F).astype(np.float32)}
    return out


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    name = request.param
    jm, tm = jyolo.build(name, IMG), tyolo.build(name, IMG)
    np_params = _np_params(jm.graph, seed=MODELS.index(name))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jacc = jcore.compile(jm, jcore.CompileConfig(batch_size=2), params=jp)
    tacc = tcore.compile(tm, tcore.CompileConfig(batch_size=2),
                         params=params_from_numpy(np_params),
                         torch_device="cpu")
    x = np.random.default_rng(0).normal(
        0.5, 0.25, size=(2, IMG, IMG, 3)).astype(np.float32)
    return dict(name=name, jm=jm, tm=tm, np_params=np_params, jacc=jacc,
                tacc=tacc, x=x)


def test_passes_rewrite_identically(pair):
    """The port's PassManager(default_pipeline()) — inside compile and
    on its own — yields the JAX package's node attrs and pass log."""
    jacc, tacc = pair["jacc"], pair["tacc"]
    assert _graph_view(tacc.graph) == _graph_view(jacc.graph)
    assert tacc.pass_log == jacc.pass_log
    pm = tpasses.PassManager(tpasses.default_pipeline(), verify_each=True)
    assert _graph_view(pm.run(pair["tm"].graph)) == _graph_view(jacc.graph)


def test_design_report_and_drc_match(pair):
    jr, tr = pair["jacc"].report, pair["tacc"].report
    assert set(tr) == set(jr)
    for k, v in jr.items():
        if isinstance(v, float):
            assert tr[k] == pytest.approx(v, rel=1e-9, abs=1e-12), k
        else:
            assert tr[k] == v, k
    assert tr["check"]["errors"] == 0
    ja, ta = pair["jacc"].allocation, pair["tacc"].allocation
    assert (ta.parallelism, ta.trace) == (ja.parallelism, ja.trace)
    assert ta.latency_cycles == ja.latency_cycles
    assert tcore.check_accelerator(pair["tacc"]).summary() == \
        jcore.check_accelerator(pair["jacc"]).summary()


def test_launch_counts_match(pair):
    jg, tg = pair["jacc"].graph, pair["tacc"].graph
    assert tcg.launch_nodes(tg) == jcg.launch_nodes(jg)
    assert _ops_count(tg, tcg.launch_nodes(tg)) == \
        _ops_count(jg, jcg.launch_nodes(jg))
    assert tcg.launch_nodes(pair["tm"].graph) == \
        jcg.launch_nodes(pair["jm"].graph)


def test_compiled_executor_matches_jax_ref(pair):
    """Default pipeline: W8-storage weights (bit-exact on both sides),
    fused epilogues, channel windows, materialised output concats."""
    jacc, x = pair["jacc"], pair["x"]
    want = jcg.generate(jacc.graph, backend="ref")(jacc.params,
                                                   jnp.asarray(x))
    got = pair["tacc"].forward(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_unfused_executor_matches_jax_ref(pair):
    """No passes: every activation, add, concat and split launches."""
    x, p = pair["x"], pair["np_params"]
    want = jcg.generate(pair["jm"].graph, backend="ref")(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    with torch.inference_mode():
        got = tcg.generate(pair["tm"].graph)(params_from_numpy(p),
                                             torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
