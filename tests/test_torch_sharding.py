"""The port's meshes, sharding plans, step stand-ins and tensor-parallel
YOLO replicas against the JAX package's, on the CPU.

* ``tree_specs`` gives, leaf for leaf, the spec the JAX package's
  ``plan_for(cfg).spec_for`` + ``_guard`` give over its own
  ``param_specs`` (the (2, 4) data×model mesh and the 16×16 production
  plan), every sharded dim dividing its axes; ``conv_tp_plan`` likewise
  over yolov3-tiny's float and W8-stored parameters. ``_guard`` reads
  only a mesh's axis sizes, so the JAX side needs no devices.
* ``param_specs``, ``input_specs`` and ``cache_specs_shapes`` have the
  shapes of the JAX package's ``eval_shape`` stand-ins for every
  registry config and shape cell, on the ``meta`` device, in the port's
  dtypes.
* A tensor-parallel replica over ``["cpu", "cpu"]`` (yolov3-tiny at 64,
  batch 2, as the JAX package's ``tests/test_elastic.py``) serves within
  1e-4 of the one-device replica and of the JAX ``ref`` executor, and
  its profiled forward's all-gathers carry the bytes of the sharded
  convs' outputs; ``Deployment(replicas=2, tensor_parallel=2)``
  completes 8 of 8 over two groups of positions.
* The hazard: ``jax.device_put`` onto a mesh that repeats a device
  raises; the port's placement over one runs.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.core import codegen as jcg
from repro.dist import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import yolo as jyolo
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.core import codegen as tcg
from repro_torch.dist import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm
from repro_torch.models import yolo as tyolo
from repro_torch.roofline import trace
from repro_torch.serve import AcceleratorReplica, Deployment, DetectRequest
from repro_torch.tree import flatten_with_path

from _port_memory import release_memory  # noqa: F401

IMG, BATCH = 64, 2


def _jax_specs(tree, plan, sizes: dict) -> dict:
    """keystr → the JAX package's guarded spec, as a tuple."""
    mesh = types.SimpleNamespace(shape=sizes)
    return {jax.tree_util.keystr(k): tuple(jsh._guard(
        v.shape, plan.spec_for(jax.tree_util.keystr(k), v.ndim), mesh))
        for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_specs(specs) -> dict:
    return {tsh.keystr(p): tuple(ns.spec)
            for p, ns in flatten_with_path(specs)}


def _bad(shapes: dict, specs: dict, sizes: dict) -> list:
    bad = []
    for k, spec in specs.items():
        for dim, ax in zip(shapes[k], spec):
            if ax is None:
                continue
            n = int(np.prod([sizes[a] for a in ((ax,) if isinstance(ax, str)
                                                else ax)]))
            if dim % n:
                bad.append((k, shapes[k], spec))
    return bad


@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_tree_specs_match_jax_plan(arch):
    tcfg, jcfg = treg.get(arch), jreg.get(arch)
    tshapes = tsteps.param_specs(tcfg)
    jshapes = jsteps.param_specs(jcfg)
    shapes = {tsh.keystr(p): tuple(v.shape)
              for p, v in flatten_with_path(tshapes)}
    for sizes, mesh in (
            ({"data": 2, "model": 4}, tmesh.make_mesh(
                (2, 4), ("data", "model"), devices=["cpu"] * 8)),
            ({"data": 16, "model": 16}, tmesh.make_production_mesh())):
        got = _port_specs(tsh.tree_specs(tshapes, mesh, tsh.plan_for(tcfg)))
        want = _jax_specs(jshapes, jsh.plan_for(jcfg), sizes)
        assert got == want
        assert _bad(shapes, got, sizes) == []
        # the launcher wiring is the same function
        assert _port_specs(tsteps.param_shardings(tcfg, mesh)) == got
    if arch == "granite-3-8b":     # the column rule shards; norms do not
        assert got["['layers']['attn']['wq']['w']"] == (None, None, "model")
        assert got["['layers']['ln1']['g']"] == ()
        assert got["['embed']['table']"] == ()      # 49155 rows: whole


@pytest.fixture(scope="module")
def accs():
    jm = jyolo.build("yolov3-tiny", IMG)
    jp = jax.jit(lambda k: jcg.init_params(jm.graph, k))(
        jax.random.PRNGKey(3))
    cfg = dict(batch_size=BATCH)
    jacc = jcore.compile(jm, jcore.CompileConfig(**cfg), params=jp)
    tacc = tcore.compile(tyolo.build("yolov3-tiny", IMG),
                         tcore.CompileConfig(**cfg),
                         params=params_from_numpy(
                             jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu"),
                         torch_device="cpu")
    return jp, jacc, tacc


def test_conv_tp_plan_matches_jax(accs):
    jp, jacc, tacc = accs
    sizes = {"model": 2}
    mesh = tsh.tp_mesh(["cpu", "cpu"])
    plan, jplan = tsh.conv_tp_plan(), jsh.conv_tp_plan()
    fp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    got = _port_specs(tsh.tree_specs(fp, mesh, plan))
    assert got == _jax_specs(jp, jplan, sizes)
    assert any("model" in s for k, s in got.items() if "['w']" in k)
    assert any(s == () for k, s in got.items() if "['w']" in k)  # F 255
    # W8 storage: the port shards a QTensor as a leaf, the JAX package
    # its codes (child 0) and bias by the same rules
    got = _port_specs(tsh.tree_specs(tacc.params, mesh, plan))
    want = _jax_specs(jacc.params, jplan, sizes)
    for k, spec in got.items():
        assert spec == want[k + "[<flat index 0>]" if k.endswith("['w']")
                            else k], k


def test_steps_stand_ins_match_jax_eval_shape():
    for arch in sorted(treg.ARCHS):
        tcfg, jcfg = treg.get(arch), jreg.get(arch)
        tp = dict(flatten_with_path(tsteps.param_specs(tcfg)))
        jp = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
              v for p, v in jax.tree_util.tree_leaves_with_path(
                  jsteps.param_specs(jcfg))}
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}, arch
        assert all(v.device.type == "meta" and v.dtype == torch.float32
                   for v in tp.values())
        for name in TSHAPES:
            tc, jc = TSHAPES[name], JSHAPES[name]
            assert tsteps.src_len_for(tcfg, tc) == jsteps.src_len_for(jcfg,
                                                                      jc)
            assert tsteps.cache_size_for(tcfg, tc) == \
                jsteps.cache_size_for(jcfg, jc)
            for mb in (1, 2):
                ti = tsteps.input_specs(tcfg, tc, n_microbatches=mb)
                ji = jsteps.input_specs(jcfg, jc, n_microbatches=mb)
                assert {k: tuple(v.shape) for k, v in ti.items()} == \
                    {k: tuple(v.shape) for k, v in ji.items()}
                assert ti["tokens"].dtype == torch.int32
                assert all(v.device.type == "meta" for v in ti.values())
            tcache = tsteps.cache_specs_shapes(tcfg, tc)
            jcache = jsteps.cache_specs_shapes(jcfg, jc)
            assert {k: tuple(v.shape) for k, v in tcache.items()} == \
                {k: tuple(v.shape) for k, v in jcache.items()}, (arch, name)
            assert all(v.device.type == "meta" for v in tcache.values())


def test_prefill_and_decode_steps_are_the_model_calls():
    cfg = treg.reduced("granite-3-8b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {"tokens": torch.tensor([[1, 5, 9, 2]], dtype=torch.int32)}
    logits, cache = tsteps.make_prefill_step(cfg, 8)(params, batch)
    want, want_cache = lm.prefill(params, cfg, batch, 8)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    tok = torch.tensor([3], dtype=torch.int32)
    got, _ = tsteps.make_decode_step(cfg)(params, tok, cache)
    want, _ = lm.decode_step(params, cfg, tok, want_cache)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not got.requires_grad


def test_place_params_over_a_2d_mesh():
    cfg = treg.get("granite-3-8b")
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    tiny = {"wq": torch.arange(128.0).reshape(16, 8), "norm": torch.ones(8)}
    placed = tsteps.place_params(tiny, mesh, cfg=cfg)
    assert "model" in placed["wq"].spec and "model" not in placed["norm"].spec
    assert [tuple(s.shape) for s in placed["wq"].shards] == [(16, 2)] * 8
    assert torch.equal(placed["wq"].shard(5), tiny["wq"][:, 2:4])
    assert torch.equal(placed["wq"].gather(), tiny["wq"])
    assert torch.equal(placed["norm"].gather(), tiny["norm"])
    with pytest.raises(ValueError):
        tsteps.place_params(tiny, mesh)
    # a dim over two axes: blocks numbered row-major over (data, model)
    x = torch.arange(48.0).reshape(16, 3)
    plan = tsh.ShardingPlan(rules=(("['x']", (("data", "model"), None)),))
    px = tsh.place({"x": x}, tsh.tree_specs({"x": x}, mesh, plan))["x"]
    assert torch.equal(px.shard(6), x[12:14]) and torch.equal(px.gather(), x)


def test_mesh_needs_enough_devices(monkeypatch):
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 7)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPU"):
        tmesh.make_mesh((1,), ("model",))
    m = tmesh.make_mesh((2,), ("model",), devices=["cpu"] * 3)
    assert m.device_list() == [torch.device("cpu")] * 2


def test_repeated_device_hazard():
    """``jax.device_put`` refuses a mesh that names one device twice; the
    port's placement runs there (one shard a position)."""
    d = jax.devices()[0]
    jmesh = jax.sharding.Mesh(np.asarray([d, d]), ("model",))
    with pytest.raises((ValueError, AssertionError)):
        jax.device_put(jnp.ones((4, 4)), jax.sharding.NamedSharding(
            jmesh, jax.sharding.PartitionSpec(None, "model")))
    w = torch.arange(16.0).reshape(4, 4)
    placed = tsh.place_sharded({"conv": {"w": w, "b": torch.zeros(4)}},
                               ["cpu", "cpu"])
    assert [tuple(s.shape) for s in placed["conv"]["w"].shards] == \
        [(4, 2), (4, 2)]
    assert torch.equal(placed["conv"]["w"].gather(), w)


def _infer(replica, imgs):
    reqs = [DetectRequest(uid=i, image=imgs[i]) for i in range(BATCH)]
    replica.complete(replica.dispatch(reqs))
    return [r.outputs for r in reqs]


def test_tp_replica_matches_one_device_and_jax(accs):
    _, jacc, tacc = accs
    imgs = np.random.default_rng(0).standard_normal(
        (BATCH, IMG, IMG, 3)).astype(np.float32)
    one = _infer(AcceleratorReplica(tacc, index=0, device="cpu"), imgs)
    tp_rep = AcceleratorReplica(tacc, index=1, device=["cpu", "cpu"])
    assert tp_rep.positions == (0, 1) and len(tp_rep.devices) == 2
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tp = _infer(tp_rep, imgs)
    want = jcg.generate(jacc.graph, backend="ref")(jacc.params,
                                                   jnp.asarray(imgs))
    for i in range(BATCH):
        assert len(tp[i]) == len(one[i]) == len(want) == 2
        for a, b, c in zip(tp[i], one[i], want):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(a, np.asarray(c)[i], atol=1e-4,
                                       rtol=1e-4)
    # one all-gather per sharded conv, of its whole output
    sharded = [n for n in tacc.graph.topo_order()
               if n.op == "conv" and n.geom("F") % 2 == 0]
    assert 0 < len(sharded) < sum(n.op == "conv"
                                  for n in tacc.graph.topo_order())
    nbytes = sum(BATCH * int(np.prod(tacc.graph.streams[n.outputs[0]].shape))
                 * 4 for n in sharded)
    assert trace.collective_bytes(prof) == {"all-gather": nbytes,
                                            "total": nbytes}
    assert trace.collective_count(prof) == len(sharded)


def test_tp_conv_runs_once_per_shard(accs, monkeypatch):
    """Each sharded conv calls the conv entry point once per position
    with its filter slice; the others once with the whole filters."""
    _, _, tacc = accs
    calls = []
    real = tcg.ops.conv2d

    def counted(x, w, b=None, **kw):
        calls.append(tuple(w.shape))
        return real(x, w, b, **kw)
    monkeypatch.setattr(tcg.ops, "conv2d", counted)
    x = torch.zeros(BATCH, IMG, IMG, 3)
    step = tcg.generate(tacc.graph, backend=tcg.TensorParallel(
        tcg.get_backend("auto")))
    placed = tsh.place_sharded(tacc.params, ["cpu", "cpu"])
    with torch.inference_mode():
        step(placed, x)
    convs = [n for n in tacc.graph.topo_order() if n.op == "conv"]
    want = []
    for n in convs:
        K, C, F = n.geom("K"), n.geom("C"), n.geom("F")
        want += [(K, K, C, F // 2)] * 2 if F % 2 == 0 else [(K, K, C, F)]
    assert calls == want


def test_tp_deployment_over_two_groups(accs):
    _, _, tacc = accs
    imgs = np.random.default_rng(1).standard_normal(
        (2, IMG, IMG, 3)).astype(np.float32)
    for prefetch in (False, True):
        with Deployment(tacc, replicas=2, tensor_parallel=2,
                        devices=["cpu"] * 4, prefetch=prefetch) as dep:
            assert [r.positions for r in dep.replicas] == [(0, 1), (2, 3)]
            for i in range(8):
                assert dep.submit(DetectRequest(uid=i, image=imgs[i % 2]))
            done = dep.run()
            assert sum(r.done for r in done) == 8
            assert dict(dep.stats)["frames"] == 8
    # groups wrap past the end of the device list
    with Deployment(tacc, replicas=3, tensor_parallel=2,
                    devices=["cpu"] * 4, prefetch=False) as dep:
        assert [r.positions for r in dep.replicas] == [(0, 1), (2, 3),
                                                       (0, 1)]


def test_tp_refuses_the_quant_backend(accs):
    _, _, tacc = accs
    with pytest.raises(NotImplementedError, match="float"):
        AcceleratorReplica(tacc, device=["cpu", "cpu"], backend="quant")
    with pytest.raises(NotImplementedError, match="float"):
        Deployment(tacc, devices=["cpu"] * 2, tensor_parallel=2,
                   backend="quant")
