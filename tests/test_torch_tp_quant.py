"""Tensor-parallel quantized YOLO replicas against one device and the JAX
package, on the CPU (serial time about 60 s, most of it the JAX package
jitting its eight quantized executors).

One numpy parameter set per builder drives both packages. yolov3-tiny
and yolov8n at img 64 are compiled by the port at W8A16, W8A8, packed
W4A8, W8A8 recalibrated with per-group activation scales, and the
per-layer mix of ``bits="mixed"`` (int16 and int8 codes), then served
over the positions ``["cpu", "cpu"]`` (``place_sharded`` under
``conv_tp_plan``, ``codegen.TensorParallel`` over ``QuantBackend``):

* against the one-device quant executor: each sharded conv runs once a
  position on its filter block, the integer results are bit-equal (the
  weight codes, the int8 activation codes, and the int32 accumulators of
  an A8 conv, joined over the filter blocks), and the outputs are within
  1e-4;
* against the JAX ``generate(graph, backend="quant")``, its graph made by
  the JAX passes under the same config with the port's ``a_scale`` copied
  in: outputs within the JAX package's ``_quant_atol`` (yolov3-tiny at
  every design, its codes the JAX package's bit for bit; yolov8n at W8A8,
  per group and mixed);
* ``AcceleratorReplica(acc, device=[...], backend="quant")`` and
  ``Deployment(acc, tensor_parallel=2, backend="quant")`` serve them;
* ``place_sharded``'s blocks are the JAX ``_guard`` blocks of each
  QTensor child (packed W4 and per-channel W8; per tensor, a scale kept
  whole); ``gather`` and a checkpoint round trip (read by the JAX package
  too) are bit-equal.

Hazards pinned: a per-group weight code layout, which the JAX plan cuts
along its group axis, stays whole and runs once on position 0 (equal to
the unsharded call where the reference's ``dequantize`` is defined, an
axis-0 layout); a float weight quantized on the fly at a per-tensor
``wq`` is quantized whole and then cut (per-channel: cut first, the
same codes).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.ckpt import checkpoint as jckpt
from repro.core import codegen as jcg
from repro.core import passes as jpasses
from repro.core import quant as jquant
from repro.dist import sharding as jsh
from repro.models import yolo as jyolo
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.convert import params_from_numpy
from repro_torch.core import codegen as tcg
from repro_torch.core import quant as tquant
from repro_torch.dist import sharding as tsh
from repro_torch.kernels import ref as tref
from repro_torch.models import yolo as tyolo
from repro_torch.roofline import hw as thw
from repro_torch.roofline import trace
from repro_torch.serve import AcceleratorReplica, Deployment, DetectRequest

from _port_memory import release_memory  # noqa: F401

ARCHS = ("yolov3-tiny", "yolov8n")
MODES = {"w8a16": dict(backend="quant", w_bits=8, a_bits=16),
         "w8a8": dict(backend="quant", w_bits=8, a_bits=8),
         "w4a8": dict(backend="quant", w_bits=4, a_bits=8),
         "per_group": dict(backend="quant", w_bits=8, a_bits=8),
         "mixed": dict(bits="mixed", search_evals=12)}
IMG, BATCH, TP = 64, 2, ("cpu", "cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
# the ZCU104 with a 400-DSP budget, as tests/test_torch_quant_compile.py
_TINY = dict(name="zcu104-400dsp", dsp=400, bram36=312, uram=96,
             lut=230_400, f_clk=200e6, ddr_bw=135e9 / 8)
TDEV = thw.FpgaDevice(**_TINY)


def _quant_atol(bits: int, out_scale: float) -> float:
    """``tests/test_backends.py:_quant_atol``."""
    return 16.0 * 2.0 ** -bits * out_scale


def _np_params(graph, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for n in graph.topo_order():
        if n.op == "conv":
            K, C, F = n.geom("K"), n.geom("C"), n.geom("F")
            w = np.clip(rng.normal(size=(K, K, C, F)), -2.0, 2.0)
            out[n.name] = {"w": (1.5 * w / np.sqrt(K * K * C)
                                 ).astype(np.float32),
                           "b": rng.normal(0.0, 0.1, F).astype(np.float32)}
    return out


def _x(seed, n=BATCH):
    return np.random.default_rng(seed).normal(
        0.0, 1.0, size=(n, IMG, IMG, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _design(arch: str, mode: str):
    """(the port's design, its numpy parameters)."""
    np_params = _np_params(jyolo.build(arch, IMG).graph, ARCHS.index(arch))
    acc = tcore.compile(
        tyolo.build(arch, IMG),
        tcore.CompileConfig(device=TDEV, batch_size=BATCH, calib_frames=1,
                            accuracy_probe=False, **MODES[mode]),
        params=params_from_numpy(np_params, device="cpu"),
        torch_device="cpu")
    if mode == "per_group":
        scales = tcg.calibrate_activation_scales(
            acc.graph, params_from_numpy(np_params, device="cpu"),
            torch.from_numpy(_x(9)), granularity="per_group", group_size=16)
        assert scales and all(isinstance(s, tuple) for s in scales.values())
    return acc, np_params


@functools.lru_cache(maxsize=None)
def _jax_design(arch: str, mode: str):
    """The JAX package's graph for the port's design (its passes under
    the same config; a mixed design as its per-node map) with the port's
    ``a_scale`` copied in, and its quantized parameters (yolov3-tiny's
    from the JAX package's ``quantize_params``)."""
    acc, np_params = _design(arch, mode)
    kw = MODES[mode]
    if mode == "mixed":
        kw = dict(bits={k: tuple(v) for k, v in
                        acc.report["mixed_assignment"].items()})
    graph = jpasses.PassManager(jcore.CompileConfig(**kw).pipeline(),
                                verify_each=False).run(
        jyolo.build(arch, IMG).graph)
    for n in graph.nodes.values():
        tn = acc.graph.nodes[n.name]
        assert n.attrs.get("w_bits") == tn.attrs.get("w_bits"), n.name
        if "a_scale" in tn.attrs:
            n.attrs["a_scale"] = tn.attrs["a_scale"]
    if arch == "yolov3-tiny":
        params = jpasses.AssignWordlengths.quantize_params(
            graph, jax.tree_util.tree_map(jnp.asarray, np_params))
    else:       # the port's codes (equal to the JAX package's for these
        # designs, tests/test_torch_quant_compile.py): the JAX package
        # quantizes yolov8n's 63 convs eagerly in ~20 s
        params = {k: {"w": jquant.QTensor(
            q=jnp.asarray(p["w"].q.numpy()),
            scale=jnp.asarray(p["w"].scale.numpy()),
            zero=jnp.asarray(p["w"].zero.numpy()), bits=p["w"].bits,
            shape=p["w"].shape, packed=p["w"].packed),
            "b": jnp.asarray(p["b"].numpy())}
            for k, p in acc.params.items()}
    return graph, params


class _Tape:
    """``base``'s lowering with each conv's integer results recorded by
    node, once a position: the weight codes (K, N) of a quantized conv,
    and an A8 conv's int8 activation codes and int32 accumulators, from
    the plain versions the CPU runs (``kernels/ref.py``)."""
    name = "tape"

    def __init__(self, base, monkeypatch):
        self.base, self.node, self.rec = base, None, {}
        qmm, qmm_a8 = _PLAIN

        def qmatmul(x, wq, *a, **kw):
            self.rec.setdefault(self.node, []).append({"w": wq})
            return qmm(x, wq, *a, **kw)

        def qmatmul_a8(x, wq, *a, **kw):
            self.rec.setdefault(self.node, []).append(
                {"w": wq, "x": x, "acc": tref.int_matmul(x, wq)})
            return qmm_a8(x, wq, *a, **kw)
        monkeypatch.setattr(tref, "qmatmul", qmatmul)
        monkeypatch.setattr(tref, "qmatmul_a8", qmatmul_a8)

    def conv(self, x, p, node, res=None, **kw):
        self.node = node.name
        return self.base.conv(x, p, node, res, **kw)

    def __getattr__(self, item):
        return getattr(self.base, item)


_PLAIN = (tref.qmatmul, tref.qmatmul_a8)


def _run(acc, params, table, x):
    with torch.inference_mode():
        return tcg.generate(acc.graph, backend=table)(
            params, torch.from_numpy(x))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_matches_one_device(arch, mode, monkeypatch):
    acc, _ = _design(arch, mode)
    x = _x(1)
    one_tape = _Tape(tcg.get_backend("quant"), monkeypatch)
    one = _run(acc, acc.params, one_tape, x)
    tp_tape = _Tape(tcg.get_backend("quant"), monkeypatch)
    placed = tsh.place_sharded(acc.params, TP)
    tp = _run(acc, placed, tcg.TensorParallel(tp_tape), x)
    for a, b in zip(tp, one):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    convs = [n for n in acc.graph.topo_order() if n.op == "conv"]
    assert set(one_tape.rec) == set(tp_tape.rec) == {n.name for n in convs}
    sharded = 0
    for n in convs:
        want, got = one_tape.rec[n.name], tp_tape.rec[n.name]
        sharded += n.geom("F") % 2 == 0
        assert len(want) == 1 and len(got) == (2 if n.geom("F") % 2 == 0
                                               else 1), n.name
        assert torch.equal(torch.cat([g["w"] for g in got], -1),
                           want[0]["w"]), n.name
        if "acc" in want[0]:
            assert all(torch.equal(g["x"], want[0]["x"]) for g in got)
            assert torch.equal(torch.cat([g["acc"] for g in got], -1),
                               want[0]["acc"]), n.name
    assert sharded > 0
    if mode in ("w8a8", "w4a8", "per_group"):
        assert all("acc" in r[0] for r in one_tape.rec.values())


# yolov8n's W8A16 and W4A8 executors take the JAX package 15–18 s each
# to jit; their one-device executors are held to JAX in
# test_torch_quant_compile.py, and TP to one device above. yolov3-tiny's
# codes are the JAX package's own, compared bit for bit.
@pytest.mark.parametrize("arch, mode", [("yolov3-tiny", m) for m in MODES]
                         + [("yolov8n", m) for m in ("w8a8", "per_group",
                                                    "mixed")])
def test_tp_matches_jax(arch, mode):
    acc, _ = _design(arch, mode)
    jgraph, jparams = _jax_design(arch, mode)
    for name, p in acc.params.items():
        assert jgraph.nodes[name].attrs["wq"].bits == p["w"].bits
        jw, tw = jparams[name]["w"], p["w"]
        assert tw.packed == jw.packed and tw.shape == tuple(jw.shape)
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    x = _x(2)
    got = _run(acc, tsh.place_sharded(acc.params, TP),
               tcg.TensorParallel(tcg.get_backend("quant")), x)
    want = jax.jit(jcg.generate(jgraph, backend="quant"))(jparams,
                                                           jnp.asarray(x))
    a_bits = min(int(n.attrs.get("a_bits", 16))
                 for n in acc.graph.nodes.values() if n.op == "conv")
    scale = max(float(jnp.max(jnp.abs(w))) for w in want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=_quant_atol(a_bits, scale))


def _infer(replica, imgs):
    reqs = [DetectRequest(uid=i, image=im) for i, im in enumerate(imgs)]
    replica.complete(replica.dispatch(reqs))
    return [r.outputs for r in reqs]


@pytest.mark.parametrize("mode", MODES)
def test_replica_and_deployment_serve(mode):
    acc, _ = _design("yolov3-tiny", mode)
    imgs = _x(3)
    one = _infer(AcceleratorReplica(acc, device="cpu", backend="quant"),
                 imgs)
    rep = AcceleratorReplica(acc, device=list(TP), backend="quant")
    assert isinstance(rep.params[next(iter(acc.params))]["w"],
                      tsh.ShardedTensor)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = _infer(rep, imgs)
    for g, w in zip(got, one):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, **TOL)
    sharded = [n for n in acc.graph.topo_order()
               if n.op == "conv" and n.geom("F") % 2 == 0]
    nbytes = sum(BATCH * int(np.prod(acc.graph.streams[n.outputs[0]].shape))
                 * 4 for n in sharded)
    assert trace.collective_bytes(prof) == {"all-gather": nbytes,
                                            "total": nbytes}
    with Deployment(acc, replicas=2, tensor_parallel=2, devices=["cpu"] * 4,
                    backend="quant", prefetch=False) as dep:
        assert [r.positions for r in dep.replicas] == [(0, 1), (2, 3)]
        for i in range(4):
            assert dep.submit(DetectRequest(uid=i, image=imgs[i % BATCH]))
        done = dep.run()
    assert [r.uid for r in done] == list(range(4))
    for r in done:
        for a, b in zip(r.outputs, one[r.uid % BATCH]):
            np.testing.assert_allclose(a, b, **TOL)


def _blocks(child, spec, n=2):
    """The blocks of ``child`` (an array) that a ``model`` axis of ``n``
    positions holds under ``spec``, as ``jax.device_put`` cuts them."""
    out = []
    for i in range(n):
        sl = tuple(slice(i * d // n, (i + 1) * d // n) if ax == "model"
                   else slice(None) for d, ax in zip(child.shape, spec))
        out.append(child[sl])
    return out


@pytest.mark.parametrize("scheme", ("w4_packed", "w8_per_channel",
                                    "w8_per_tensor"))
def test_placed_blocks_are_the_jax_guard_blocks(scheme):
    """Each position's QTensor block is, child by child (codes, scale,
    zero), the block the JAX package's ``conv_tp_plan`` + ``_guard`` give
    that child of the JAX QTensor (its shape from ``jax.eval_shape``);
    the bias likewise."""
    mode = "w4a8" if scheme == "w4_packed" else "w8a16"
    acc, np_params = _design("yolov3-tiny", mode)
    _, jparams = _jax_design("yolov3-tiny", mode)
    tparams = acc.params
    if scheme == "w8_per_tensor":
        tparams = {k: {"w": tquant.quantize(torch.from_numpy(v["w"]),
                                            tquant.QuantConfig(bits=8)),
                       "b": torch.from_numpy(v["b"])}
                   for k, v in np_params.items()}
        jparams = jax.eval_shape(lambda p: jquant.quantize_tree(
            p, jquant.QuantConfig(bits=8),
            cfg_fn=lambda path, x: jquant.QuantConfig(bits=8)),
            jax.tree_util.tree_map(jnp.asarray, np_params))
    mesh = type("M", (), {"shape": {"model": 2}})()
    plan = jsh.conv_tp_plan()
    placed = tsh.place_sharded(tparams, TP)
    cut = 0
    for name, jp in jparams.items():
        for part, jchild in (("q", jp["w"].q), ("scale", jp["w"].scale),
                             ("zero", jp["w"].zero), ("b", jp["b"])):
            path = f"['{name}']['b']" if part == "b" \
                else f"['{name}']['w'][<flat index 0>]"
            spec = tuple(jsh._guard(jchild.shape, plan.spec_for(
                path, len(jchild.shape)), mesh))
            whole = tparams[name]["b"] if part == "b" \
                else getattr(tparams[name]["w"], part)
            assert tuple(whole.shape) == tuple(jchild.shape), (name, part)
            st = placed[name]["b" if part == "b" else "w"]
            for i, want in enumerate(_blocks(whole, spec)):
                got = st.shard(i) if part == "b" \
                    else getattr(st.shard(i), part)
                assert torch.equal(got, want), (name, part, i)
            cut += part == "q" and "model" in spec
    assert cut > 0


def test_per_group_weights_stay_whole():
    """The hazard: the JAX plan cuts a per-group code layout (blocks, g)
    along g, which is not a filter slice; the port keeps ``w`` and ``b``
    whole and runs the conv once on position 0. Where the reference's
    ``dequantize`` is defined (an axis-0 layout) both give the unsharded
    call: TP within 1e-4 of one device and of the JAX quant executor."""
    acc, np_params = _design("yolov3-tiny", "w8a16")
    jgraph, jparams = _jax_design("yolov3-tiny", "w8a16")
    cfg = dict(bits=8, granularity="per_group", axis=0, group_size=16)
    even = [n.name for n in acc.graph.topo_order() if n.op == "conv"
            and n.geom("F") % 2 == 0]
    grouped = even[:3]                      # the rest per channel
    tq, jq = dict(acc.params), dict(jparams)
    for k in grouped:
        w = np_params[k]["w"]
        tq[k] = dict(tq[k], w=tquant.quantize(torch.from_numpy(w),
                                              tquant.QuantConfig(**cfg)))
        jq[k] = dict(jq[k], w=jquant.quantize(jnp.asarray(w),
                                              jquant.QuantConfig(**cfg)))
    mesh = type("M", (), {"shape": {"model": 2}})()
    jq0 = jq[grouped[0]]["w"].q
    assert jq0.shape[-1] == 16 and jsh._guard(
        jq0.shape, jsh.conv_tp_plan().spec_for("['w'][<flat index 0>]", 2),
        mesh) == jsh.PartitionSpec(None, "model")
    placed = tsh.place_sharded(tq, TP)
    for k in grouped:
        assert not tquant.cuts_by_filter(tq[k]["w"])
        for leaf in ("w", "b"):
            assert tuple(placed[k][leaf].spec) == (), (k, leaf)
        assert placed[k]["w"].shard(0) is placed[k]["w"].shard(1)
    assert tuple(placed[even[3]]["w"].spec) == (None, None, None, "model")
    x = _x(4)
    tp = _run(acc, placed, tcg.TensorParallel(tcg.get_backend("quant")), x)
    one = _run(acc, tq, "quant", x)
    want = jax.jit(jcg.generate(jgraph, backend="quant"))(jq, jnp.asarray(x))
    for a, b, c in zip(tp, one, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)


class _Blocks:
    """The quant lowering table, recording the weight each conv call
    quantizes or receives."""
    name = "blocks"

    def __init__(self):
        self.base, self.seen = tcg.get_backend("quant"), {}

    def conv(self, x, p, node, res=None, **kw):
        w = p["w"]
        cfg = self.base.weight_quant(node, w)
        self.seen.setdefault(node.name, []).append(
            tquant.quantize(w, cfg) if cfg is not None else w)
        return self.base.conv(x, p, node, res, **kw)

    def __getattr__(self, item):
        return getattr(self.base, item)


@pytest.mark.parametrize("granularity", ("per_tensor", "per_channel"))
def test_float_weights_quantized_on_the_fly(granularity):
    """A float weight reaching ``QuantBackend`` is quantized at its
    node's ``wq`` on every call. Under TP each position's codes and
    scales are the whole tensor's quantization, cut: per channel (one
    scale a filter) quantizing each block gives exactly that; per tensor
    the whole tensor is quantized first, as GSPMD keeps its one scale,
    and a block's own scale would differ."""
    acc, np_params = _design("yolov3-tiny", "w8a16")
    graph = copy.deepcopy(acc.graph)
    qc = tquant.QuantConfig(bits=8, granularity=granularity, axis=-1)
    for n in graph.nodes.values():
        if n.op == "conv":
            n.attrs["wq"] = qc
    fp = params_from_numpy(np_params, device="cpu")
    for p in fp.values():           # halves of unequal range
        p["w"][..., :p["w"].shape[-1] // 2] *= 0.5
    rec = _Blocks()
    x = torch.from_numpy(_x(5))
    with torch.inference_mode():
        tp = tcg.generate(graph, backend=tcg.TensorParallel(rec))(
            tsh.place_sharded(fp, TP), x)
        one = tcg.generate(graph, backend="quant")(fp, x)
    for a, b in zip(tp, one):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    differs = 0
    for name, blocks in rec.seen.items():
        if len(blocks) == 1:
            continue
        whole = tquant.quantize(fp[name]["w"], qc)
        F = whole.shape[-1]
        for i, blk in enumerate(blocks):
            want = tquant.filter_block(whole, slice(i * F // 2,
                                                    (i + 1) * F // 2))
            for part in ("q", "scale", "zero"):
                assert torch.equal(getattr(blk, part), getattr(want, part))
            own = tquant.quantize(fp[name]["w"][..., i * F // 2:
                                                (i + 1) * F // 2], qc)
            differs += not torch.equal(own.q, want.q)
    assert (differs > 0) == (granularity == "per_tensor")


@pytest.mark.parametrize("mode", MODES)
def test_gather_and_checkpoint_round_trip(mode, tmp_path):
    """Each placed weight gathers bit-equal to the unsharded QTensor; a
    sharded save writes what an unsharded save writes, restores
    bit-equal (whole, and laid out again by ``place_sharded``'s specs),
    and the JAX package's ``restore`` reads it into its own design."""
    acc, _ = _design("yolov3-tiny", mode)
    placed = tsh.place_sharded(acc.params, TP)
    for k, p in acc.params.items():
        g = placed[k]["w"].gather()
        assert (g.shape, g.bits, g.packed) == (p["w"].shape, p["w"].bits,
                                               p["w"].packed)
        for part in ("q", "scale", "zero"):
            assert torch.equal(getattr(g, part), getattr(p["w"], part))
        assert torch.equal(placed[k]["b"].gather(), p["b"])
    tckpt.save(tmp_path / "sharded", 1, placed)
    tckpt.save(tmp_path / "whole", 1, acc.params)
    a = np.load(tmp_path / "sharded" / "step_00000001" / "arrays.npz")
    b = np.load(tmp_path / "whole" / "step_00000001" / "arrays.npz")
    assert sorted(a) == sorted(b) and any(k.endswith("|w|0") for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    back, extras = tckpt.restore(tmp_path / "sharded", acc.params)
    assert extras == {"step": 1}
    mesh = tsh.tp_mesh(TP)
    again, _ = tckpt.restore(tmp_path / "sharded", acc.params,
                             shardings=tsh.tree_specs(acc.params, mesh,
                                                      tsh.conv_tp_plan()))
    for k, p in acc.params.items():
        for tree in (back, {kk: {"w": v["w"].gather()}
                            for kk, v in again.items()}):
            for part in ("q", "scale", "zero"):
                assert torch.equal(getattr(tree[k]["w"], part),
                                   getattr(p["w"], part)), (k, part)
    _, jparams = _jax_design("yolov3-tiny", mode)
    jback, _ = jckpt.restore(tmp_path / "sharded", jparams)
    for k, p in acc.params.items():
        np.testing.assert_array_equal(np.asarray(jback[k]["w"].q),
                                      p["w"].q.numpy())
        np.testing.assert_array_equal(np.asarray(jback[k]["w"].scale),
                                      p["w"].scale.numpy())


def test_tp_table_runs_pools_unfused():
    """``TensorParallel.fuses_pool`` is False: a conv that the quant
    backend runs with its maxpool fused runs the maxpool as its own node
    under TP, with the same result."""
    acc, _ = _design("yolov3-tiny", "w8a8")
    fused = [n for n in acc.graph.topo_order()
             if n.op == "conv" and n.attrs.get("fuse_pool")]
    assert fused and all(tcg.get_backend("quant").fuses_pool(n)
                         for n in fused)
    assert not any(tcg.TensorParallel(tcg.get_backend("quant")).fuses_pool(n)
                   for n in fused)
