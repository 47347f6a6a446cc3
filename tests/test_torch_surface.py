"""Every public name of the JAX package has its counterpart in the port.

Read with ``ast`` only: the surface tests import neither package. For
every module of ``src/repro/`` (``__init__.py`` files included), every
public top-level function, class and constant, and every public method
of those classes, exists under the same name and of the same kind in
the same module of ``src/repro_torch/`` (``test_names``), and the
parameters of every public function and method are among its
counterpart's (``test_parameters``), or the difference stands in one of
the tables of cuts below with its reason. ``ROADMAP.md`` ("Cuts still
in the port") states the same reasons. A name is private where it starts
with ``_``.

Each entry of the tables must still hold (``test_cut_is_current``): the
name or parameter is in the JAX package and not in the port. A cut that
gets ported must leave the table.

``QTensor.dtype`` and ``QTensor.nbytes_packed`` are held to the JAX
package's on the same numpy weights at the end; those tests import both
packages.
"""
import ast
import functools
from pathlib import Path

import numpy as np
import pytest

from _port_memory import release_memory  # noqa: F401

SRC = Path(__file__).resolve().parent.parent / "src"
JAX_PKG, PORT = SRC / "repro", SRC / "repro_torch"

PYTREE = "JAX's pytree protocol; a torch tensor needs none"
GENERATOR = "the port draws from a torch.Generator, not a JAX PRNG key"
TILES = ("a Pallas tiling hint or interpret mode: the port takes no "
         "tiling hints (ROADMAP.md) and its kernels plan their own tiles")
XLA_KNOB = "an XLA scheduling knob; the port runs eagerly"

MODULE_CUTS = {
    "roofline/hlo.py": ("roofline/trace.py", "reads XLA's HLO; its "
                        "counterpart reads a torch.profiler trace"),
}

NAME_CUTS = {
    ("core/buffers.py", "SoftwareFifo.tree_flatten"): PYTREE,
    ("core/buffers.py", "SoftwareFifo.tree_unflatten"): PYTREE,
    ("core/quant.py", "QTensor.tree_flatten"): PYTREE,
    ("core/quant.py", "QTensor.tree_unflatten"): PYTREE,
    ("core/dse.py", "tpu_stage_latency"):
        "no TPU figure enters the port; stage_latency on H100_SXM is its "
        "counterpart",
    ("roofline/hw.py", "TpuChip"):
        "no TPU figure enters the port; GpuChip is its counterpart",
    ("roofline/hw.py", "TPU_V5E"):
        "no TPU figure enters the port; H100_SXM is its entry",
    ("kernels/attention.py", "NEG_INF"):
        "the mask value lives in the CUDA source (csrc/attention.cu)",
    ("kernels/decode_attention.py", "NEG_INF"):
        "the mask value lives in the CUDA source "
        "(csrc/decode_attention.cu)",
    ("models/lm.py", "NO_WINDOW"):
        "a layer's window is None or an int in layer_windows",
    ("models/lm.py", "window_array"): "becomes layer_windows",
    ("nn/flash.py", "flash_mha"):
        "an XLA-native stand-in for kernel #11; the port calls the kernel",
    ("nn/flash.py", "decode_grouped"):
        "an XLA-native stand-in for kernel #12; the port calls the kernel",
}

PARAM_CUTS = {
    ("core/codegen.py", "init_params"): (("key",), GENERATOR),
    ("core/toolflow.py", "compile"): (("key",), GENERATOR),
    ("core/toolflow.py", "compile_model"): (("key",), GENERATOR),
    ("models/lm.py", "init_params"): (("key",), GENERATOR),
    ("models/yolo.py", "YoloModel.init"): (("key",), GENERATOR),
    ("nn/attention.py", "init"): (("key",), GENERATOR),
    ("nn/layers.py", "trunc_normal"): (("key",), GENERATOR),
    ("nn/layers.py", "fan_in_init"): (("key",), GENERATOR),
    ("nn/layers.py", "linear_init"): (("key",), GENERATOR),
    ("nn/layers.py", "embed_init"): (("key",), GENERATOR),
    ("nn/layers.py", "mlp_init"): (("key",), GENERATOR),
    ("nn/moe.py", "init"): (("key",), GENERATOR),
    ("nn/ssm.py", "init"): (("key",), GENERATOR),
    ("kernels/attention.py", "mha"): (("tq", "tk", "interpret"), TILES),
    ("kernels/conv2d.py", "conv2d"): (("th", "tf", "interpret"), TILES),
    ("kernels/decode_attention.py", "decode_attention"):
        (("ts", "interpret"), TILES),
    ("kernels/maxpool.py", "maxpool2d"): (("th", "interpret"), TILES),
    ("kernels/pointwise.py", "pointwise"): (("block", "interpret"), TILES),
    ("kernels/pointwise.py", "rmsnorm"): (("tr", "interpret"), TILES),
    ("kernels/qmatmul.py", "qmatmul"):
        (("tm", "tk", "tn", "interpret"), TILES),
    ("kernels/qmatmul.py", "qmatmul_a8"):
        (("out_dtype", "tm", "tn", "interpret"), TILES),
    ("kernels/resize.py", "resize_nearest"): (("th", "interpret"), TILES),
    ("kernels/ssd_scan.py", "ssd_scan"): (("tc", "th", "interpret"), TILES),
    **{("kernels/ops.py", fn): (("**tiles",), TILES) for fn in (
        "conv2d", "maxpool2d", "resize_nearest", "qmatmul", "qmatmul_a8",
        "mha", "decode_attention", "ssd_scan", "pointwise", "rmsnorm")},
    ("kernels/ops.py", "channel_concat"):
        (("backend",), "the JAX function deletes it unread"),
    ("kernels/ops.py", "channel_split"):
        (("backend",), "the JAX function deletes it unread"),
    ("nn/attention.py", "forward"): (("chunk",), XLA_KNOB),
    ("nn/attention.py", "prefill"): (("chunk",), XLA_KNOB),
    ("nn/ssm.py", "ssd_chunked"): (("unroll",), XLA_KNOB),
    ("roofline/analysis.py", "kernel_roofline"):
        (("int8",), 'becomes math="int8" (or "fp32", "tf32", "bf16")'),
    ("kernels/ref.py", "conv2d"):
        (("padding", "groups"), "no lowering reaches them (SAME, dense "
         "only); codegen refuses groups != 1 in both packages"),
    ("kernels/ref.py", "maxpool2d"):
        (("padding",), "no lowering reaches it (SAME only)"),
}


def _params(fn) -> list:
    a = fn.args
    out = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        out.append("*" + a.vararg.arg)
    if a.kwarg:
        out.append("**" + a.kwarg.arg)
    return [p for p in out if p not in ("self", "cls")]


@functools.lru_cache(maxsize=None)
def surface(path: Path) -> dict:
    """{public name: (kind, parameters)} of a module: top-level functions
    and classes, the public methods of those classes (``Class.method``)
    and the names that top-level assignments bind."""
    out: dict = {}
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, funcs) and not node.name.startswith("_"):
            out[node.name] = ("function", _params(node))
        elif isinstance(node, ast.ClassDef) \
                and not node.name.startswith("_"):
            out[node.name] = ("class", None)
            for m in node.body:
                if isinstance(m, funcs) and not m.name.startswith("_"):
                    out[f"{node.name}.{m.name}"] = ("function", _params(m))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in [t] if isinstance(t, ast.Name) \
                        else getattr(t, "elts", []):
                    if isinstance(n, ast.Name) \
                            and not n.id.startswith("_"):
                        out.setdefault(n.id, ("constant", None))
    return out


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))
PORTED = [m for m in MODULES if m not in MODULE_CUTS]


def _both(module: str) -> tuple:
    return surface(JAX_PKG / module), surface(PORT / module)


def test_every_module_is_read():
    assert len(MODULES) == 67
    assert {"core/toolflow.py", "core/quant.py", "kernels/ops.py",
            "dist/sharding.py", "launch/dryrun.py"} <= set(MODULES)


@pytest.mark.parametrize("module", PORTED)
def test_names(module):
    """Every public name of the module has a counterpart of its kind."""
    assert (PORT / module).exists(), f"{module} has no counterpart"
    jax_names, port_names = _both(module)
    missing = {name: kind for name, (kind, _) in jax_names.items()
               if (module, name) not in NAME_CUTS
               and (name not in port_names or port_names[name][0] != kind)}
    assert not missing, (f"{module}: public names with no counterpart "
                         f"and no listed cut: {missing}")


@pytest.mark.parametrize("module", PORTED)
def test_parameters(module):
    """The parameters of every public function and method are among its
    counterpart's."""
    jax_names, port_names = _both(module)
    missing = {}
    for name, (kind, params) in jax_names.items():
        if kind != "function" or name not in port_names:
            continue
        cut = PARAM_CUTS.get((module, name), ((), ""))[0]
        lost = [p for p in params
                if p not in port_names[name][1] and p not in cut]
        if lost:
            missing[name] = lost
    assert not missing, (f"{module}: parameters with no counterpart and "
                         f"no listed cut: {missing}")


CUT_ENTRIES = ([("module", m) for m in MODULE_CUTS]
               + [("name", k) for k in NAME_CUTS]
               + [("parameters", k) for k in PARAM_CUTS])


@pytest.mark.parametrize("kind,entry", CUT_ENTRIES,
                         ids=[f"{k}:{e if isinstance(e, str) else ':'.join(e)}"
                              for k, e in CUT_ENTRIES])
def test_cut_is_current(kind, entry):
    """A listed cut is still a cut: in the JAX package, not in the port,
    with a reason."""
    if kind == "module":
        counterpart, reason = MODULE_CUTS[entry]
        assert reason and (JAX_PKG / entry).exists()
        assert not (PORT / entry).exists() and (PORT / counterpart).exists()
        return
    module, name = entry
    jax_names, port_names = _both(module)
    assert name in jax_names
    if kind == "name":
        assert NAME_CUTS[entry]
        assert name not in port_names
        return
    params, reason = PARAM_CUTS[entry]
    assert reason and name in port_names
    for p in params:
        assert p in jax_names[name][1], f"{name}: {p} not in the JAX package"
        assert p not in port_names[name][1], f"{name}: {p} is ported"


def _weights():
    return np.random.default_rng(5).normal(
        0.0, 0.3, size=(3, 3, 16, 24)).astype(np.float32)


LAYOUTS = {
    "int8_per_channel": dict(bits=8, granularity="per_channel"),
    "int16": dict(bits=16),
    "int4_packed": dict(bits=4, granularity="per_channel", pack=True),
    "per_group_axis0": dict(bits=8, granularity="per_group", axis=0,
                            group_size=16),
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_qtensor_dtype_and_nbytes_packed_match_jax(layout):
    """``QTensor.dtype`` and ``QTensor.nbytes_packed`` equal the JAX
    package's on the same weights, with the same codes underneath."""
    import jax.numpy as jnp
    import torch
    from repro.core import quant as jq
    from repro_torch.core import quant as tq

    w = _weights()
    jt = jq.quantize(jnp.asarray(w), jq.QuantConfig(**LAYOUTS[layout]))
    tt = tq.quantize(torch.from_numpy(w), tq.QuantConfig(**LAYOUTS[layout]))
    assert tt.packed == jt.packed == (layout == "int4_packed")
    assert str(tt.dtype) == f"torch.{jnp.dtype(jt.dtype).name}"
    assert tt.dtype == tt.q.dtype
    assert tt.nbytes_packed == jt.nbytes_packed
    assert tt.code_nbytes == jt.code_nbytes
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
