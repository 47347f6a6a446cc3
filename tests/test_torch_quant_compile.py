"""The port's quantized toolflow against the JAX package's, on the CPU.

One parameter set made with numpy drives both sides (``params_from_numpy``
for the port). For yolov3-tiny, yolov5n and yolov8n at img 64, compiled
with ``backend="quant"`` at W8A16, W8A8 and W4A8, the port must give:
the same pass log and node attrs (``wq``, ``w_bits``, ``a_bits``; the
``a_scale`` values come from calibration batches drawn by two different
generators, so they are compared on one shared numpy batch instead);
the same design report (floats to 1e-9) apart from the two
accuracy-probe keys, which only need to be finite and ≥ 0; the same
design-rule check; the same lowering per conv; and, with the JAX graph's
``a_scale`` copied in, executor outputs within the JAX package's
``_quant_atol(a_bits, out_scale)`` of ``generate(g, backend="quant")``
(16·2^-bits of the output range: an activation code may round the other
way where the float inputs differ in the last bit).

The mixed-precision search on the ``fused_chain`` graph of
``test_mixed_precision.py`` must walk in the same order to the same
front (bytes equal, deltas within rtol 2e-3), and quantized serving
through ``Deployment`` and the ``DetectionEngine`` shim must match.
"""
import copy
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import codegen as jcg
from repro.core import dse as jdse
from repro.core import ir as jir
from repro.core import passes as jpasses
from repro.models import yolo as jyolo
from repro.roofline import hw as jhw
from repro.serve import Deployment as JDeployment
from repro.serve import DetectRequest as JRequest
from repro_torch.convert import params_from_numpy
from repro_torch.core import codegen as tcg
from repro_torch.core import dse as tdse
from repro_torch.core import ir as tir
from repro_torch.core import passes as tpasses
from repro_torch.data.synthetic import ImageStream
from repro_torch.models import yolo as tyolo
from repro_torch.roofline import hw as thw
from repro_torch.serve import Deployment, DetectRequest
from repro_torch.serve.detection import DetectionEngine

from _port_memory import release_memory  # noqa: F401

MODELS = ["yolov3-tiny", "yolov5n", "yolov8n"]
MODES = {"w8a16": (8, 16), "w8a8": (8, 8), "w4a8": (4, 8)}
IMG = 64
PROBE_KEYS = ("quant_max_abs_delta", "quant_mean_rel_delta")
# The ZCU104 with a 400-DSP budget: Algorithm 1 then takes a few dozen
# steps instead of thousands (the DSE is not what these tests check, and
# both sides must see the same device).
_TINY = dict(name="zcu104-400dsp", dsp=400, bram36=312, uram=96,
             lut=230_400, f_clk=200e6, ddr_bw=135e9 / 8)
JDEV, TDEV = jhw.FpgaDevice(**_TINY), thw.FpgaDevice(**_TINY)


def _quant_atol(bits: int, out_scale: float) -> float:
    """``tests/test_backends.py:_quant_atol``."""
    return 16.0 * 2.0 ** -bits * out_scale


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "__dataclass_fields__"):
        return {k: _plain(getattr(v, k)) for k in v.__dataclass_fields__}
    return v


def _attrs(g, drop=("a_scale",)):
    return {n.name: (n.op, list(n.inputs), list(n.outputs),
                     _plain({k: v for k, v in n.attrs.items()
                             if k not in drop}))
            for n in g.nodes.values()}


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


def _jparams(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


class _Counting:
    """Records the lowering ``select_lowering`` picks for each node."""

    def select_lowering(self, node, w):
        path = super().select_lowering(node, w)
        self.taken[node.name] = path
        return path


class JCounting(_Counting, jcg.QuantBackend):
    def __init__(self):
        object.__setattr__(self, "taken", {})


class TCounting(_Counting, tcg.QuantBackend):
    def __init__(self):
        object.__setattr__(self, "taken", {})


@pytest.fixture(scope="module", params=[(m, mode) for m in MODELS
                                        for mode in MODES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    name, mode = request.param
    w_bits, a_bits = MODES[mode]
    jm, tm = jyolo.build(name, IMG), tyolo.build(name, IMG)
    np_params = _np_params(jm.graph, MODELS.index(name))
    # one calibration frame and a one-frame test input: the JAX side's
    # jitted node executors are then shared by calibration, probe and test
    cfg = dict(backend="quant", w_bits=w_bits, a_bits=a_bits, batch_size=2,
               calib_frames=1)
    jacc = jcore.compile(jm, jcore.CompileConfig(device=JDEV, **cfg),
                         params=_jparams(np_params))
    tacc = tcore.compile(tm, tcore.CompileConfig(device=TDEV, **cfg),
                         params=params_from_numpy(np_params, device="cpu"),
                         torch_device="cpu")
    x = np.random.default_rng(7).normal(
        0.0, 1.0, size=(1, IMG, IMG, 3)).astype(np.float32)
    return dict(name=name, a_bits=a_bits, np_params=np_params, jacc=jacc,
                tacc=tacc, x=x)


def test_quant_compile_graph_and_pass_log_match(pair):
    jacc, tacc = pair["jacc"], pair["tacc"]
    assert _attrs(tacc.graph) == _attrs(jacc.graph)
    assert tacc.pass_log == jacc.pass_log
    for n in jacc.graph.nodes.values():
        tn = tacc.graph.nodes[n.name]
        assert ("a_scale" in tn.attrs) == ("a_scale" in n.attrs), n.name
        if "w_bits" in n.attrs and not n.attrs.get("fused"):
            assert tn.attrs["wq"].bits == n.attrs["wq"].bits
    w = [p["w"] for p in tacc.params.values()]
    assert w and all(isinstance(v, tcore.toolflow.QTensor) for v in w)


def test_quant_report_and_drc_match(pair):
    jr, tr = pair["jacc"].report, pair["tacc"].report
    assert set(tr) == set(jr)
    for k, v in jr.items():
        if k in PROBE_KEYS:
            assert math.isfinite(tr[k]) and tr[k] >= 0, k
        elif isinstance(v, float):
            assert tr[k] == pytest.approx(v, rel=1e-9, abs=1e-12), k
        else:
            assert tr[k] == v, k
    assert tr["check"]["errors"] == 0
    assert tcore.check_accelerator(pair["tacc"]).summary() == \
        jcore.check_accelerator(pair["jacc"]).summary()


def test_quant_lowering_and_outputs_match(pair):
    jacc, tacc, x = pair["jacc"], pair["tacc"], pair["x"]
    g = copy.deepcopy(tacc.graph)
    for n in jacc.graph.nodes.values():
        if "a_scale" in n.attrs:
            g.nodes[n.name].attrs["a_scale"] = n.attrs["a_scale"]
    jb, tb = JCounting(), TCounting()
    want = jcg.generate(jacc.graph, backend=jb)(jacc.params, jnp.asarray(x))
    with torch.inference_mode():
        got = tcg.generate(g, backend=tb)(tacc.params, torch.from_numpy(x))
    assert tb.taken == jb.taken
    expect = "int8-wa" if pair["a_bits"] <= 8 else "int8-w"
    assert set(tb.taken.values()) == {expect}
    assert len(got) == len(want)
    scale = max(float(jnp.max(jnp.abs(w))) for w in want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=_quant_atol(pair["a_bits"], scale))


@pytest.fixture(scope="module")
def calib_graphs():
    """yolov8n at img 64 with every dense conv at W8A8, one numpy
    parameter set and one numpy calibration batch."""
    wl = dict(default=(8, 8))
    jg = jpasses.PassManager(jpasses.default_pipeline() + [
        jpasses.AssignWordlengths(**wl)]).run(
        jyolo.build("yolov8n", IMG).graph)
    tg = tpasses.PassManager(tpasses.default_pipeline() + [
        tpasses.AssignWordlengths(**wl)]).run(
        tyolo.build("yolov8n", IMG).graph)
    p = _np_params(jg, 2)
    x = np.random.default_rng(8).normal(size=(1, IMG, IMG, 3)
                                        ).astype(np.float32)
    return jg, tg, p, x


@pytest.mark.parametrize("granularity", ["per_tensor", "per_group"])
def test_calibrated_scales_match_on_one_batch(calib_graphs, granularity):
    """The measured input ranges agree to rtol 2e-5 (float32 convs in
    another order, up to 63 deep; 7e-6 measured on these three
    builders); the scales computed from one set of ranges are
    bit-equal. The JAX side gets writable copies of its ranges: its
    per-group path assigns into ``np.asarray`` of a JAX array, which is
    read-only (ROADMAP.md, reference hazards)."""
    jg, tg, p, x = calib_graphs
    per_ch = granularity == "per_group"
    jr = jcg.calibrate_activation_ranges(jg, _jparams(p), jnp.asarray(x),
                                         per_channel=per_ch)
    tr = tcg.calibrate_activation_ranges(
        tg, params_from_numpy(p, device="cpu"), torch.from_numpy(x),
        per_channel=per_ch)
    assert tr.keys() == jr.keys() and len(jr) == 63
    for k, v in jr.items():
        assert type(tr[k]) is type(v) or per_ch
        np.testing.assert_allclose(np.asarray(tr[k]), np.asarray(v),
                                   rtol=2e-5, err_msg=k)
    ranges = {k: (v if isinstance(v, float) else np.array(v))
              for k, v in jr.items()}
    kw = dict(granularity=granularity, group_size=16)
    js = jcg.calibrate_activation_scales(
        copy.deepcopy(jg), None, None, ranges=dict(ranges), **kw)
    ts = tcg.calibrate_activation_scales(
        copy.deepcopy(tg), None, None,
        ranges={k: (v if isinstance(v, float) else v.copy())
                for k, v in ranges.items()}, **kw)
    assert ts.keys() == js.keys() and len(js) == 63
    for k, v in js.items():
        assert type(ts[k]) is type(v)
        assert ts[k] == v, k


# --------------------------------------------------------------------------
# the mixed-precision search on test_mixed_precision.py's fused_chain
# --------------------------------------------------------------------------

def _chain_graph(ir, img=16, chans=(8, 12, 16)):
    """``test_mixed_precision.py:_chain_graph``, built with either IR."""
    g = ir.Graph(name="chain")
    g.add_stream("in", (img, img, 3))
    g.inputs.append("in")
    src, C = "in", 3
    for i, F in enumerate(chans):
        g.add_stream(f"c{i}_raw", (img, img, F))
        g.add_node(f"conv{i}", "conv", [src], [f"c{i}_raw"], H=img, W=img,
                   C=C, F=F, K=3, stride=1, groups=1, W_in=img,
                   act="identity")
        g.add_stream(f"c{i}", (img, img, F))
        g.add_node(f"act{i}", "relu", [f"c{i}_raw"], [f"c{i}"])
        src, C = f"c{i}", F
    g.add_stream("skip_raw", (img, img, chans[-1]))
    g.add_node("skipconv", "conv", ["c1"], ["skip_raw"], H=img, W=img,
               C=chans[1], F=chans[-1], K=1, stride=1, groups=1, W_in=img,
               act="identity")
    g.add_stream("sum", (img, img, chans[-1]))
    g.add_node("addres", "add", ["c2", "skip_raw"], ["sum"])
    g.outputs.append("sum")
    g.validate()
    return g


@pytest.fixture(scope="module")
def chains():
    jg = jpasses.PassManager(jpasses.fusion_pipeline()).run(
        _chain_graph(jir))
    tg = tpasses.PassManager(tpasses.fusion_pipeline()).run(
        _chain_graph(tir))
    p = _np_params(jg, 3)
    x = np.random.default_rng(5).normal(size=(2, 16, 16, 3)
                                        ).astype(np.float32)
    return jg, tg, p, x


def test_mixed_search_walks_to_the_same_front(chains):
    jg, tg, p, x = chains
    want = jdse.mixed_precision_search(jg, _jparams(p), jnp.asarray(x))
    got = tdse.mixed_precision_search(tg, params_from_numpy(p, device="cpu"),
                                      torch.from_numpy(x))
    assert got.evals == want.evals
    assert [t.label for t in got.trajectory] == \
        [t.label for t in want.trajectory]
    assert [t.label for t in got.front] == [t.label for t in want.front]
    for a, b in zip(got.trajectory, want.trajectory):
        assert a.assignment == b.assignment
        assert a.weight_stream_bytes == b.weight_stream_bytes
        # an A8 code that rounds the other way (its float input differs
        # in the last bit) moves a delta by ~1e-3 relative: 1.05e-3 at
        # worst on this walk, 4e-6 or less at every other point
        assert a.accuracy_delta == pytest.approx(b.accuracy_delta,
                                                 rel=2e-3, abs=1e-9)
    for k, v in want.ranges.items():
        assert got.ranges[k] == pytest.approx(v, rel=1e-6)
    assert sorted(got.sensitivity, key=lambda n: (got.sensitivity[n], n)) \
        == sorted(want.sensitivity, key=lambda n: (want.sensitivity[n], n))


def test_compile_bits_map_picks_the_same_lowerings(chains):
    jg, tg, p, x = chains
    bmap = {"conv0": (8, 16), "conv1": (8, 8), "conv2": (4, 8)}
    jacc = jcore.compile(jg, jcore.CompileConfig(bits=bmap, device=JDEV),
                         params=_jparams(p))
    tacc = tcore.compile(tg, tcore.CompileConfig(bits=bmap, device=TDEV),
                         params=params_from_numpy(p, device="cpu"),
                         torch_device="cpu")
    assert tcore.CompileConfig(bits=bmap).execution_backend() == "quant"
    jb, tb = JCounting(), TCounting()
    jcg.generate(jacc.graph, backend=jb)(jacc.params, jnp.asarray(x))
    with torch.inference_mode():
        tcg.generate(tacc.graph, backend=tb)(tacc.params,
                                             torch.from_numpy(x))
    assert tb.taken == jb.taken == {"conv0": "int8-w", "conv1": "int8-wa",
                                    "conv2": "int8-wa",
                                    "skipconv": "int8-w"}
    assert tacc.params["conv2"]["w"].packed
    assert tacc.report["wordlengths"] == jacc.report["wordlengths"]


def test_compile_mixed_reports_a_front():
    """``compile(bits="mixed")`` on the port: the report carries the
    chosen assignment, a front whose first point is the float design,
    and a delta within the budget."""
    tm = tyolo.build("yolov3-tiny", 32)
    acc = tcore.compile(tm, tcore.CompileConfig(bits="mixed",
                                                search_evals=12,
                                                calib_frames=1,
                                                device=TDEV),
                        torch_device="cpu")
    r = acc.report
    assert r["bits"] == "mixed" and r["search_evals"] == 12
    assert r["pareto_front"][0]["label"] == "float"
    assert 0.0 <= r["mixed_accuracy_delta"] <= r["accuracy_budget"]
    outs = acc.forward(torch.zeros((1, 32, 32, 3)))
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_compile_mixed_float_design_runs_the_kernels(chains):
    """A budget that only the float design meets ships the float design
    on the ``auto`` lowering table — the kernels on the card, the plain
    versions only for CPU tensors — never on ``ref``, which would run
    the plain versions on CUDA tensors too."""
    _, tg, p, x = chains
    acc = tcore.compile(tg, tcore.CompileConfig(bits="mixed",
                                                accuracy_budget=0.0,
                                                device=TDEV),
                        params=params_from_numpy(p, device="cpu"),
                        torch_device="cpu")
    assert acc.report["mixed_assignment"] == {}
    assert acc.executor_backend == "auto"
    want = tcg.generate(tg, backend="ref")(params_from_numpy(p, device="cpu"),
                                           torch.from_numpy(x))
    for a, b in zip(acc.forward(torch.from_numpy(x)), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _chip_smoke():
    """``chip_smoke.py`` at the repository root, imported by path (its
    module level needs no card)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("bits", ("mixed@0.05", "mixed@0.2", "W4A8"))
def test_plain_compile_design_equals_compile(chains, monkeypatch, bits):
    """``chip_smoke.py`` makes its quant_w4a8 and mixed designs with
    ``compile`` under ``plain_compile``: the activation ranges measured
    on ``"ref"`` and the mixed search's trials on
    ``QuantBackend(dispatch="ref")``, whatever ``compile`` passes. On the
    CPU, where the defaults run the plain versions too, that is
    ``compile``'s own design: the same report (assignment, front,
    accuracy probe) and every node's attributes (wordlengths, activation
    scales) equal. Both functions are handed the plain tables and are
    restored after. ``mixed@0.05`` is W8A16 throughout, ``mixed@0.2``
    and ``W4A8`` write four scales."""
    _, tg, p, _ = chains
    cs = _chip_smoke()
    cfg = tcore.CompileConfig(bits="mixed", accuracy_budget=float(
        bits[6:]), device=TDEV) if bits.startswith("mixed") \
        else tcore.CompileConfig(backend="quant", w_bits=4, a_bits=8,
                                 device=TDEV)

    def design():
        return tcore.compile(tg, cfg,
                             params=params_from_numpy(p, device="cpu"),
                             torch_device="cpu")
    want = design()
    seen: list = []
    calibrate, search = (tcg.calibrate_activation_scales,
                         tdse.mixed_precision_search)

    def spy_calibrate(*args, **kw):
        seen.append(("calibrate", kw.get("backend")))
        return calibrate(*args, **kw)

    def spy_search(*args, **kw):
        seen.append(("search", kw.get("backend")))
        return search(*args, **kw)
    monkeypatch.setattr(tcg, "calibrate_activation_scales", spy_calibrate)
    monkeypatch.setattr(tdse, "mixed_precision_search", spy_search)
    table = tcg.QuantBackend(name="quant_ref", dispatch="ref")
    with cs.plain_compile(tcg, tdse, table):
        got = design()
    assert tcg.calibrate_activation_scales is spy_calibrate
    assert tdse.mixed_precision_search is spy_search
    if bits == "W4A8":
        assert seen == [("calibrate", "ref")]
    else:                           # the search's trials, then compile's
        assert seen[0] == ("search", table) and len(seen) > 2
        assert set(seen[1:]) == {("calibrate", "ref")}
    assert got.report == want.report
    scaled = 0
    for name, node in want.graph.nodes.items():
        assert got.graph.nodes[name].attrs == node.attrs, name
        scaled += "a_scale" in node.attrs
    assert scaled == (0 if bits == "mixed@0.05" else 4)

# --------------------------------------------------------------------------
# serving a quantized accelerator
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    jm = jyolo.build("yolov3-tiny", IMG)
    np_params = _np_params(jm.graph, 9)
    cfg = dict(backend="quant", batch_size=4, replicas=2,
               accuracy_probe=False)
    jacc = jcore.compile(jm, jcore.CompileConfig(device=JDEV, **cfg),
                         params=_jparams(np_params))
    tacc = tcore.compile(tyolo.build("yolov3-tiny", IMG),
                         tcore.CompileConfig(device=TDEV, **cfg),
                         params=params_from_numpy(np_params, device="cpu"),
                         torch_device="cpu")
    return jacc, tacc


def test_quant_deployment_matches_jax(served):
    jacc, tacc = served
    imgs = list(ImageStream(IMG, 4, seed=2).frames(10))
    with Deployment(tacc, replicas=2, devices=["cpu"],
                    backend="quant") as dep:
        for i, im in enumerate(imgs):
            assert dep.submit(DetectRequest(uid=i, image=im))
        got = dep.run()
    with JDeployment(jacc, devices=jax.devices("cpu")) as jdep:
        for i, im in enumerate(imgs):
            assert jdep.submit(JRequest(uid=i, image=jnp.asarray(im)))
        want = jdep.run()
    assert [r.uid for r in got] == [r.uid for r in want] == list(range(10))
    scale = max(float(np.abs(np.asarray(o)).max())
                for r in want for o in r.outputs)
    for g, w in zip(got, want):
        assert g.done and len(g.outputs) == len(w.outputs) == 2
        for a, b in zip(g.outputs, w.outputs):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=_quant_atol(8, scale))


def test_detection_engine_backend_override(served):
    _, tacc = served
    img = np.random.default_rng(4).normal(size=(IMG, IMG, 3)
                                          ).astype(np.float32)
    with pytest.warns(DeprecationWarning):
        eng = DetectionEngine(tacc, batch_size=2, backend="ref",
                              devices=["cpu"])
    assert eng.submit(DetectRequest(uid=0, image=img))
    done = eng.run()
    eng.close()
    assert len(done) == 1 and done[0].done
    assert eng.stats["frames"] == 1 and eng.stats["padded_slots"] == 1
    # the ref override dequantizes the same codes into a float conv:
    # float32 sums in another order (outputs up to ~7 here)
    qo = tacc.forward(torch.from_numpy(img[None]))
    for a, b in zip(done[0].outputs, qo):
        np.testing.assert_allclose(a, b[0].numpy(), atol=1e-4, rtol=1e-4)
