"""Tensor-parallel replicas and the streaming pipeline on the card
(``-m gpu``; every test skips without one, and the file imports no JAX).

Every position names a visible card (wrapping over ``cuda_devices()``:
with one card, all name cuda:0). A tensor-parallel forward of yolov8n at
160 launches the conv kernel (#1) once a position for each sharded conv
and agrees with the one-device forward within 1e-4; a reduced granite
stack pipelined over 4 stages launches #6 and #11 as the sequential
layer loop does and agrees with it within 1e-4; both label their
transfers with the bytes ``roofline.trace`` reads back.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as core
from repro_torch.configs import registry
from repro_torch.core import codegen, pipeline
from repro_torch.data.synthetic import ImageStream
from repro_torch.dist import sharding
from repro_torch.kernels import attention, conv2d
from repro_torch.kernels import pointwise as tpw
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm, yolo
from repro_torch.roofline import trace
from repro_torch.serve import AcceleratorReplica, Deployment, DetectRequest
from repro_torch.serve.deployment import step_fn_for, tp_backend

from _port_memory import release_memory  # noqa: F401


@pytest.fixture
def devs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's tp and pipeline "
                    "paths run these at full width there)")
    from repro_torch.device import cuda_devices
    return cuda_devices()


def _positions(devs, n):
    return [devs[i % len(devs)] for i in range(n)]


@pytest.fixture
def acc(devs):
    model = yolo.build("yolov8n", 160)
    params = codegen.init_params(model.graph,
                                 torch.Generator().manual_seed(0))
    for p in params.values():
        p["w"] *= 1.75
    return core.compile(model, core.CompileConfig(batch_size=2),
                        params=params, torch_device=devs[0])


@pytest.mark.gpu
def test_tp_forward_matches_one_device(devs, acc):
    x = torch.from_numpy(ImageStream(160, 2, seed=1).batch_at(0)).to(devs[0])
    convs = [acc.graph.nodes[n] for n in codegen.launch_nodes(acc.graph)
             if acc.graph.nodes[n].op == "conv"]
    sharded = [n for n in convs if n.geom("F") % 2 == 0]
    step = step_fn_for(acc, tp_backend(None))
    placed = sharding.place_sharded(acc.params, _positions(devs, 2))
    want = acc.forward(x)
    before = conv2d.launches.value
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = step(placed, x)
        torch.cuda.synchronize()
    assert conv2d.launches.value - before == \
        2 * len(sharded) + len(convs) - len(sharded)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    nbytes = sum(2 * int(np.prod(acc.graph.streams[n.outputs[0]].shape)) * 4
                 for n in sharded)
    assert trace.collective_bytes(prof) == {"all-gather": nbytes,
                                            "total": nbytes}


@pytest.mark.gpu
def test_tp_deployment_serves_on_the_card(devs, acc):
    imgs = list(ImageStream(160, 2, seed=2).frames(6))
    with Deployment(acc, replicas=2, tensor_parallel=2,
                    devices=devs) as dep:
        for i, im in enumerate(imgs):
            assert dep.submit(DetectRequest(uid=i, image=im))
        done = dep.run()
    assert sum(r.done for r in done) == 6
    one = AcceleratorReplica(acc, device=devs[0])
    reqs = [DetectRequest(uid=i, image=imgs[i]) for i in range(2)]
    one.complete(one.dispatch(reqs))
    for r, w in zip(done[:2], reqs):
        for a, b in zip(r.outputs, w.outputs):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_pipelined_granite_stage_matches_sequential(devs):
    # the reduced config at a head width the attention kernel takes
    cfg = dataclasses.replace(registry.reduced("granite-3-8b"), n_layers=4,
                              d_model=256, n_heads=4, n_kv_heads=2,
                              head_dim=64, d_ff=384)
    dev = devs[0]
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    n_micro, n_stages = 5, 4
    L = cfg.n_layers
    x = torch.randn(n_micro, 1, 32, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    mesh = mesh_lib.make_mesh((n_stages,), ("stage",),
                              devices=_positions(devs, n_stages))
    stages = pipeline.stack_stages(params["layers"], n_stages, L)
    with torch.inference_mode():
        n6, n11 = tpw.rmsnorm_launches.value, attention.launches.value
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = pipeline.pipeline_infer(
                lambda p, h: lm.dense_layers(cfg, p, h), stages, x, mesh)
            torch.cuda.synchronize()
        assert tpw.rmsnorm_launches.value - n6 == 2 * L * n_micro
        assert attention.launches.value - n11 == L * n_micro
        want = torch.stack([lm.dense_layers(cfg, params["layers"], x[i])
                            for i in range(n_micro)])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    mb = 32 * cfg.d_model * 4
    assert trace.collective_bytes(prof) == {
        "collective-permute": n_micro * (n_stages - 1) * mb,
        "all-reduce": n_micro * mb, "total": n_micro * n_stages * mb}
