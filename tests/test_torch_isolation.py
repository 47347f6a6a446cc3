"""The port stands alone: it imports neither JAX nor the JAX package,
its entry points refuse to fall back to the CPU, and what is not ported
yet raises ``NotImplementedError``."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import repro_torch.core as tcore
from repro_torch.models import yolo
from repro_torch.serve import Deployment, LmReplica

PKG = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _banned(mod: str) -> bool:
    return mod == "jax" or mod.startswith("jax.") or mod == "repro" \
        or mod.startswith("repro.")


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
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
        from repro_torch.models import yolo
        from repro_torch.serve import Deployment, DetectRequest
        acc = core.compile(yolo.build("yolov3-tiny", 32),
                           core.CompileConfig(batch_size=2),
                           torch_device="cpu")
        outs = acc.forward(torch.zeros(2, 32, 32, 3))
        assert len(outs) == 2
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
    with pytest.raises(RuntimeError):
        tcore.compile(yolo.build("yolov3-tiny", 32), torch_device="cuda")


def test_unported_paths_raise(cpu_acc):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcore.CompileConfig(backend="quant")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcore.CompileConfig(bits="mixed")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcore.CompileConfig(bits={"conv1": (8, 8)})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Deployment(cpu_acc, devices=["cpu"], tensor_parallel=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LmReplica(None, None)
