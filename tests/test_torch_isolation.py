"""The port stands alone: it imports neither JAX nor the JAX package
(the training modules included: a short CPU training run with a
checkpoint, a tensor-parallel forward, a quantized tensor-parallel
replica and the checkpoint of its sharded weights, a pipelined call, a
sharded LM train step, a sharded moe train step and the dry run import
neither), its entry points refuse to fall back to the CPU (the train
loop's and the mesh's too), and what is not ported (the dry run's
``--opt``, whose reference plan is undefined) raises
``NotImplementedError``."""
import ast
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import repro_torch.core as tcore
from repro_torch.configs import registry
from repro_torch.ckpt import checkpoint
from repro_torch.core.buffers import SoftwareFifo
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.loadgen import OpenLoopHarness, PoissonArrivals
from repro_torch.models import lm, yolo
from repro_torch.serve import Deployment, LmReplica
from repro_torch.serve.engine import Engine
from repro_torch.train.loop import TrainConfig, init_state, train

from _port_memory import release_memory  # noqa: F401

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
            "kernels/ssd_scan.py", "loadgen/harness.py", "nn/flash.py",
            "nn/moe.py", "kernels/autograd.py", "optim/optimizers.py",
            "launch/steps.py", "ckpt/checkpoint.py", "train/loop.py",
            "train/remat.py", "tree.py", "roofline/analysis.py",
            "roofline/trace.py", "roofline/hw.py", "launch/mesh.py",
            "dist/sharding.py", "core/pipeline.py", "dist/spmd.py",
            "launch/dryrun.py"} <= names
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
        import tempfile
        from repro_torch.ckpt import checkpoint
        from repro_torch.core.buffers import SoftwareFifo
        from repro_torch.data.synthetic import TokenStream
        from repro_torch.launch import steps
        from repro_torch.optim import optimizers
        from repro_torch.train import remat
        from repro_torch.train.loop import TrainConfig, train
        with tempfile.TemporaryDirectory() as d:
            out = train(registry.reduced("granite-3-8b"),
                        TrainConfig(steps=2, batch=2, seq_len=8,
                                    microbatches=2, ckpt_dir=d,
                                    ckpt_every=1, log_every=0),
                        device="cpu")
            assert len(out["loss_history"]) == 2
            assert checkpoint.latest_step(d) == 2
        from repro_torch.core import dse, pipeline
        from repro_torch.dist import sharding
        from repro_torch.launch import mesh
        from repro_torch.roofline import analysis, trace
        with Deployment(acc, replicas=1, tensor_parallel=2,
                        devices=["cpu", "cpu"], prefetch=False) as dep:
            dep.submit(DetectRequest(uid=0, image=torch.zeros(32, 32, 3)
                                     .numpy()))
            assert dep.run()[0].done
        m = mesh.make_mesh((2,), ("stage",), devices=["cpu", "cpu"])
        y = pipeline.pipeline_infer(lambda p, x: x @ p, torch.ones(2, 4, 4),
                                    torch.ones(3, 1, 4), m)
        assert y.shape == (3, 1, 4)
        plan = dse.partition_stages(acc.graph, 2)
        assert dse.stage_latency(plan)["interval_s"] > 0
        cfg = registry.get("granite-3-8b")
        from repro_torch.configs.base import SHAPES
        assert analysis.model_flops(cfg, SHAPES["train_4k"]) > 0
        assert steps.param_shardings(cfg, mesh.make_production_mesh())
        from repro_torch.dist import spmd
        from repro_torch.launch import dryrun
        cfg = registry.reduced("granite-3-8b")
        params = lm.init_params(cfg, torch.Generator(), device="cpu")
        m = mesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
        sp = steps.place_params(params, m, cfg=cfg)
        opt = optimizers.adamw()
        toks = torch.ones((1, 2, 8), dtype=torch.int32)
        sp, st, met = steps.make_train_step(cfg, opt, 1)(
            sp, steps.init_opt_state(opt, sp, cfg), 0,
            {"tokens": toks, "labels": toks})
        assert spmd.is_sharded(sp) and float(met["loss"]) > 0
        cfg = registry.reduced("llama4-maverick-400b-a17b")
        params = lm.init_params(cfg, torch.Generator(), device="cpu")
        sp = steps.place_params(params, m, cfg=cfg)
        sp, st, met = steps.make_train_step(cfg, opt, 1)(
            sp, steps.init_opt_state(opt, sp, cfg), 0,
            {"tokens": toks, "labels": toks})
        assert spmd.is_sharded(sp) and float(met["loss"]) > 0
        with Deployment(qacc, replicas=1, tensor_parallel=2,
                        devices=["cpu", "cpu"], backend="quant",
                        prefetch=False) as dep:
            dep.submit(DetectRequest(uid=0, image=torch.zeros(32, 32, 3)
                                     .numpy()))
            assert dep.run()[0].done
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save(d, 1, sharding.place_sharded(qacc.params,
                                                         ["cpu", "cpu"]))
            back, _ = checkpoint.restore(d, qacc.params)
            assert all(torch.equal(back[k]["w"].q, v["w"].q)
                       for k, v in qacc.params.items())
        rec = dryrun.lower_cell(registry.get("granite-3-8b"),
                                SHAPES["decode_32k"],
                                mesh.make_production_mesh())
        assert rec["memory"]["per_position"]["total"] > 0
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
    tc = TrainConfig(steps=1, batch=2, seq_len=8, log_every=0)
    with pytest.raises(RuntimeError, match="CPU"):
        train(cfg, tc)
    with pytest.raises(RuntimeError, match="CPU"):
        init_state(cfg, tc)
    with pytest.raises(RuntimeError, match="CPU"):
        SoftwareFifo.create(2, 4)


def test_unported_paths_raise(cpu_acc, tmp_path):
    """The dry run's ``--opt`` (the reference's ``plan_for_opt`` is
    undefined) raises ``NotImplementedError``; the sharded hybrid,
    encdec and int8-cache steps run, their eval metrics those of the
    unsharded step."""
    from repro_torch.launch import dryrun
    with pytest.raises(NotImplementedError):
        dryrun.main(["--opt", "--arch", "granite-3-8b", "--shape",
                     "train_4k", "--out", str(tmp_path)])
    toks = torch.ones((2, 4), dtype=torch.int32)
    for name in ("zamba2-1.2b", "seamless-m4t-medium", "kv8"):
        cfg = registry.reduced("granite-3-8b" if name == "kv8" else name)
        if name == "kv8":
            cfg = dataclasses.replace(cfg, kv_bits=8)
        params = lm.init_params(cfg, torch.Generator(), device="cpu")
        sp = steps.place_params(params, make_mesh(
            (1, 2), ("data", "model"), devices=["cpu", "cpu"]), cfg=cfg)
        batch = {"tokens": toks, "labels": toks}
        if cfg.is_encdec:
            batch["src_embeds"] = torch.ones((2, 3, cfg.d_model))
        got = steps.make_eval_step(cfg)(sp, batch)
        want = steps.make_eval_step(cfg)(params, batch)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-4, name


def test_mesh_refuses_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPU"):
        make_mesh((1,), ("model",))
