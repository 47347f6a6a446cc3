"""The port's streaming pipeline (``core/pipeline.py``) and stage
partitioner (``core/dse.py``) against the JAX package's, on the CPU.

``pipeline_infer`` over four positions of one CPU device equals the
sequential layer loop and the JAX package's sequential scan within 1e-5
(L 8, D 16, 4 stages, 6 microbatches: the JAX package's own test), runs
each stage once a microbatch, and labels one ``collective-permute`` a
stage-to-stage send and one ``all-reduce`` for the outputs; a reduced
granite stack pipelined over 2 stages equals its layer loop.
``partition_stages`` gives the JAX package's boundaries and stage work
on yolov5n at 320; ``stack_stages``, ``pipeline_latency_model`` and the
stage-latency model (under a ``GpuChip`` holding the TPU v5e figures)
give the JAX package's numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dse as jdse
from repro.core import pipeline as jpl
from repro.models import yolo as jyolo
from repro.roofline import hw as jhw
from repro_torch.configs import registry as treg
from repro_torch.core import dse as tdse
from repro_torch.core import pipeline as tpl
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm
from repro_torch.models import yolo as tyolo
from repro_torch.roofline import hw as thw
from repro_torch.roofline import trace

from _port_memory import release_memory  # noqa: F401

L, D, S, N_MICRO, MB = 8, 16, 4, 6, 2


def _weights():
    rng = np.random.default_rng(0)
    return ((rng.standard_normal((L, D, D)) * 0.2).astype(np.float32),
            rng.standard_normal((N_MICRO, MB, D)).astype(np.float32))


def _stage_fn(calls):
    def stage_fn(p, x):
        calls.append(int(p.shape[0]))
        for w in p:
            x = torch.tanh(x @ w)
        return x
    return stage_fn


def test_pipeline_equals_sequential_and_jax():
    ws, x = _weights()
    mesh = tmesh.make_mesh((S,), ("stage",), devices=["cpu"] * S)
    calls = []
    tw, tx = torch.from_numpy(ws), torch.from_numpy(x)
    stages = tpl.stack_stages(tw, S, L)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = tpl.pipeline_infer(_stage_fn(calls), stages, tx, mesh)
    assert got.shape == (N_MICRO, MB, D) and got.device == tx.device
    # every stage runs once a microbatch: no garbage ticks
    assert calls == [L // S] * (S * N_MICRO)
    seq = torch.stack([_stage_fn([])(tw, tx[i]) for i in range(N_MICRO)])
    torch.testing.assert_close(got, seq, atol=1e-5, rtol=0)

    def jseq(x1):
        h, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x1,
                            jnp.asarray(ws))
        return h
    want = np.asarray(jax.vmap(jseq)(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    mb_bytes = MB * D * 4
    assert trace.collective_bytes(prof) == {
        "collective-permute": N_MICRO * (S - 1) * mb_bytes,
        "all-reduce": N_MICRO * mb_bytes,
        "total": N_MICRO * S * mb_bytes}
    assert trace.collective_count(prof) == N_MICRO * (S - 1) + 1


def test_pipeline_on_a_stage_axis_of_a_2d_mesh():
    ws, x = _weights()
    mesh = tmesh.make_mesh((2, S), ("model", "stage"),
                           devices=["cpu"] * (2 * S))
    assert len(tpl.stage_devices(mesh)) == S
    got = tpl.pipeline_infer(_stage_fn([]), tpl.stack_stages(
        torch.from_numpy(ws), S, L), torch.from_numpy(x), mesh)
    want = torch.stack([_stage_fn([])(torch.from_numpy(ws),
                                      torch.from_numpy(x)[i])
                        for i in range(N_MICRO)])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_stack_stages_matches_jax():
    ws, _ = _weights()
    tree = {"a": ws, "b": {"c": ws[:, :3]}}
    want = jpl.stack_stages(jax.tree_util.tree_map(jnp.asarray, tree), 2, L)
    got = tpl.stack_stages({"a": torch.from_numpy(ws),
                            "b": {"c": torch.from_numpy(ws[:, :3])}}, 2, L)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))
    with pytest.raises(AssertionError):
        tpl.stack_stages(torch.from_numpy(ws), [["x"], ["y", "z"]], L)
    with pytest.raises(AssertionError):
        tpl.stack_stages(torch.from_numpy(ws), 3, L)


def test_granite_stack_pipelined_equals_its_layer_loop():
    cfg = treg.reduced("granite-3-8b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    x = torch.randn(3, 1, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    mesh = tmesh.make_mesh((2,), ("stage",), devices=["cpu"] * 2)
    with torch.inference_mode():
        got = tpl.pipeline_infer(
            lambda p, h: lm.dense_layers(cfg, p, h),
            tpl.stack_stages(params["layers"], 2, cfg.n_layers), x, mesh)
        want = torch.stack([lm.dense_layers(cfg, params["layers"], x[i])
                            for i in range(3)])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4, 8])
def test_partition_stages_matches_jax(n_stages):
    tg = tyolo.build("yolov5n", 320).graph
    jg = jyolo.build("yolov5n", 320).graph
    got = tdse.partition_stages(tg, n_stages)
    want = jdse.partition_stages(jg, n_stages)
    assert got.boundaries == want.boundaries
    assert got.stage_flops == want.stage_flops
    assert got.imbalance == want.imbalance
    assert got.num_stages == want.num_stages == n_stages


def test_stage_latency_matches_jax_and_h100():
    tg = tyolo.build("yolov5n", 320).graph
    jg = jyolo.build("yolov5n", 320).graph
    tplan, jplan = tdse.partition_stages(tg, 4), jdse.partition_stages(jg, 4)
    v5e = jhw.TPU_V5E
    chip = thw.GpuChip(
        name=v5e.name, peak_fp32_flops=1.0, peak_tf32_flops=1.0,
        peak_bf16_flops=v5e.peak_bf16_flops, peak_int8_ops=v5e.peak_int8_ops,
        hbm_bytes=v5e.hbm_bytes, hbm_bw=v5e.hbm_bw,
        nvlink_bw_per_link=v5e.ici_bw_per_link, nvlink_links=v5e.ici_links,
        sm_count=1, smem_per_sm=v5e.vmem_bytes, l2_bytes=0)
    for nbytes in (None, [10**9, 10**6, 10**7, 10**8]):
        assert tdse.stage_latency(tplan, chip, nbytes, math="bf16") == \
            jdse.tpu_stage_latency(jplan, v5e, nbytes)
    got = tdse.stage_latency(tplan)       # the H100, fp32
    assert got["stage_s"] == [2 * f / 67e12 for f in tplan.stage_flops]
    assert got["interval_s"] == max(got["stage_s"])
    assert tdse.stage_latency(tplan, math="tf32")["interval_s"] == \
        2 * max(tplan.stage_flops) / 495e12


def test_pipeline_latency_model_matches_jax():
    for costs, n in (([1.0, 2.0, 1.5], 10), ([0.25] * 4, 8), ([3.0], 1)):
        assert tpl.pipeline_latency_model(costs, n) == \
            jpl.pipeline_latency_model(costs, n)
    lat = tpl.pipeline_latency_model([1.0, 2.0, 1.5], n_micro=10)
    assert lat["interval_s"] == 2.0 and lat["total_s"] == 4.5 + 9 * 2.0
