"""The port stands alone: it imports neither JAX nor the JAX package,
its entry points refuse to fall back to the CPU, and what is not ported
yet (the double-buffered K sweep, tensor parallelism, the moe, vlm and
encdec LM families) raises ``NotImplementedError``."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import repro_torch.core as tcore
from repro_torch.configs import registry
from repro_torch.loadgen import OpenLoopHarness, PoissonArrivals
from repro_torch.models import lm, yolo
from repro_torch.serve import Deployment, LmReplica
from repro_torch.serve.engine import Engine

PKG = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _banned(mod: str) -> bool:
    return mod == "jax" or mod.startswith("jax.") or mod == "repro" \
        or mod.startswith("repro.")


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    names = {str(f.relative_to(PKG)) for f in files}
    assert {"kernels/qmatmul.py", "serve/detection.py",
            "check/__main__.py", "models/lm.py", "nn/attention.py",
            "serve/engine.py", "configs/registry.py", "nn/ssm.py",
            "kernels/ssd_scan.py", "loadgen/harness.py"} <= names
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _banned(n)]
            assert not bad, f"{f.relative_to(PKG)} imports {bad}"


def test_import_compile_and_run_load_no_jax():
    code = textwrap.dedent("""
        import sys, torch
        import repro_torch
        import repro_torch.core as core
        import repro_torch.check.__main__
        import repro_torch.loadgen
        from repro_torch.models import yolo
        from repro_torch.serve import Deployment, DetectRequest
        from repro_torch.serve.detection import DetectionEngine
        acc = core.compile(yolo.build("yolov3-tiny", 32),
                           core.CompileConfig(batch_size=2),
                           torch_device="cpu")
        outs = acc.forward(torch.zeros(2, 32, 32, 3))
        assert len(outs) == 2
        qacc = core.compile(yolo.build("yolov3-tiny", 32),
                            core.CompileConfig(backend="quant", w_bits=4,
                                               a_bits=8, batch_size=2),
                            torch_device="cpu")
        outs = qacc.forward(torch.ones(2, 32, 32, 3))
        assert len(outs) == 2 and "quant_mean_rel_delta" in qacc.report
        from repro_torch.configs import registry
        from repro_torch.models import lm
        from repro_torch.serve.engine import Engine, Request
        cfg = registry.reduced("granite-3-8b")
        params = lm.init_params(cfg, torch.Generator(), device="cpu")
        eng = Engine(cfg, params, max_batch=2, cache_size=16, device="cpu")
        eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
        assert len(eng.run()[0].out_tokens) == 2
        from repro_torch.kernels import ops, ssd_scan
        from repro_torch.nn import ssm
        for name in ("mamba2-130m", "zamba2-1.2b"):
            cfg = registry.reduced(name)
            params = lm.init_params(cfg, torch.Generator(), device="cpu")
            eng = Engine(cfg, params, max_batch=2, cache_size=16,
                         device="cpu")
            eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
            assert len(eng.run()[0].out_tokens) == 2
        bad = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax") or m == "repro"
                     or m.startswith("repro."))
        print("BANNED", bad)
    """)
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BANNED []" in out.stdout, out.stdout


@pytest.fixture(scope="module")
def cpu_acc():
    return tcore.compile(yolo.build("yolov3-tiny", 32),
                         tcore.CompileConfig(batch_size=2),
                         torch_device="cpu")


def test_entry_points_refuse_silent_cpu(monkeypatch, cpu_acc):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPU"):
        tcore.compile(yolo.build("yolov3-tiny", 32))
    with pytest.raises(RuntimeError, match="CPU"):
        Deployment(cpu_acc)
    for clock in ("model", "wall"):
        with pytest.raises(RuntimeError, match="CPU"):
            OpenLoopHarness(cpu_acc, step_ms=10.0).run(
                PoissonArrivals(rate=100.0, seed=0), 0.05, clock=clock)
    with pytest.raises(RuntimeError):
        tcore.compile(yolo.build("yolov3-tiny", 32), torch_device="cuda")
    cfg = registry.reduced("granite-3-8b")
    params = lm.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CPU"):
        LmReplica(cfg, params)
    with pytest.raises(RuntimeError, match="CPU"):
        Engine(cfg, params)


def test_unported_paths_raise(cpu_acc):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Deployment(cpu_acc, devices=["cpu"], tensor_parallel=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LmReplica(registry.reduced("qwen3-moe-30b-a3b"), {}, device="cpu")
