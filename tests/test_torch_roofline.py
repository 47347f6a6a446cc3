"""The port's roofline (``repro_torch.roofline``) against the JAX
package's, on the CPU.

The analytic work and byte models (``analytic_flops``, ``model_flops``,
``analytic_bytes``, ``analytic_memory_per_chip``,
``analytic_collective_bytes``) are copies: they must equal the JAX
functions exactly, for every registry config, every shape cell and the
meshes 16×16, 2×16×16 and 2×4. ``kernel_roofline`` and ``Roofline``
take a ``GpuChip``; under one built from the JAX package's TPU v5e
numbers (bf16 for its peak) they give the JAX package's results. The
H100 entry holds the four peaks every bound of ``chip_smoke.py`` reads,
and ``roofline.trace`` reads labelled transfers back out of a
``torch.profiler`` trace.
"""
import dataclasses

import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.roofline import analysis as ja
from repro.roofline import hlo as jhlo
from repro.roofline import hw as jhw
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.roofline import analysis as ta
from repro_torch.roofline import hw as thw
from repro_torch.roofline import trace

from _port_memory import release_memory  # noqa: F401

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4})

# A GpuChip holding the JAX package's TPU v5e figures, so that the two
# packages' rooflines can be held to each other (bf16 is its peak).
V5E = jhw.TPU_V5E
V5E_AS_GPU = thw.GpuChip(
    name=V5E.name, peak_fp32_flops=V5E.peak_bf16_flops / 4,
    peak_tf32_flops=V5E.peak_bf16_flops / 2,
    peak_bf16_flops=V5E.peak_bf16_flops, peak_int8_ops=V5E.peak_int8_ops,
    hbm_bytes=V5E.hbm_bytes, hbm_bw=V5E.hbm_bw,
    nvlink_bw_per_link=V5E.ici_bw_per_link, nvlink_links=V5E.ici_links,
    sm_count=1, smem_per_sm=V5E.vmem_bytes, l2_bytes=0)


@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_analytic_models_equal_jax(arch):
    tcfg, jcfg = treg.get(arch), jreg.get(arch)
    assert sorted(TSHAPES) == sorted(JSHAPES)
    for name in TSHAPES:
        tc, jc = TSHAPES[name], JSHAPES[name]
        assert ta.analytic_flops(tcfg, tc) == ja.analytic_flops(jcfg, jc)
        assert ta.model_flops(tcfg, tc) == ja.model_flops(jcfg, jc)
        for mb in (1, 4):
            assert ta.analytic_bytes(tcfg, tc, n_microbatches=mb) == \
                ja.analytic_bytes(jcfg, jc, n_microbatches=mb)
        assert ta.analytic_bytes(tcfg, tc, param_bytes=4, kv_bytes=1) == \
            ja.analytic_bytes(jcfg, jc, param_bytes=4, kv_bytes=1)
        for mesh in MESHES:
            for opt in ("adamw", "int8_adamw", "adafactor", "sgd"):
                assert ta.analytic_memory_per_chip(
                    tcfg, tc, mesh, n_microbatches=4, optimizer=opt) == \
                    ja.analytic_memory_per_chip(jcfg, jc, mesh,
                                                n_microbatches=4,
                                                optimizer=opt)
            for kw in ({}, {"n_microbatches": 8, "param_bytes": 4},
                       {"shard_experts": False}, {"tp_active": False}):
                assert ta.analytic_collective_bytes(tcfg, tc, mesh, **kw) \
                    == ja.analytic_collective_bytes(jcfg, jc, mesh, **kw)


def test_remat_group_memory_equal_jax():
    """The ``group`` remat branch of the memory model."""
    for group in (None, 4):
        tcfg = dataclasses.replace(treg.get("granite-3-8b"), remat="group",
                                   remat_group=group)
        jcfg = dataclasses.replace(jreg.get("granite-3-8b"), remat="group",
                                   remat_group=group)
        for mesh in MESHES:
            assert ta.analytic_memory_per_chip(
                tcfg, TSHAPES["train_4k"], mesh, n_microbatches=2) == \
                ja.analytic_memory_per_chip(jcfg, JSHAPES["train_4k"], mesh,
                                            n_microbatches=2)


@pytest.mark.parametrize("flops,nbytes", [(1e9, 1e6), (1e6, 1e9), (0.0, 1.0),
                                          (3.3e12, 7.7e8)])
def test_kernel_roofline_equals_jax_on_its_chip(flops, nbytes):
    assert ta.kernel_roofline(flops, nbytes, V5E_AS_GPU, math="bf16") == \
        ja.kernel_roofline(flops, nbytes, V5E)
    assert ta.kernel_roofline(flops, nbytes, V5E_AS_GPU, math="int8") == \
        ja.kernel_roofline(flops, nbytes, V5E, int8=True)


def test_roofline_equals_jax_on_its_chip():
    for kw in ({}, {"compute_chips": 16}):
        for args in ((1e15, 1e12, 1e10, 256), (5e12, 3e11, 0.0, 4)):
            got = ta.Roofline(*args, chip=V5E_AS_GPU, math="bf16", **kw)
            want = ja.Roofline(*args, chip=V5E, **kw)
            assert got.as_dict() == want.as_dict()
            assert got.bottleneck == want.bottleneck


def test_h100_entry_holds_the_bounds_peaks():
    chip = thw.H100_SXM
    assert thw.DEFAULT_CHIP is chip
    assert (chip.peak("fp32"), chip.peak("tf32"), chip.peak("int8"),
            chip.hbm_bw) == (67e12, 495e12, 1979e12, 3.35e12)
    assert chip.peak("bf16") == chip.peak_bf16_flops
    with pytest.raises(ValueError):
        chip.peak("fp8")
    # a three-pass TF32 route: 3·flops at the TF32 peak
    r = ta.kernel_roofline(2e9, 1e6, math="tf32", passes=3)
    assert r["t_compute_s"] == 3 * 2e9 / 495e12
    assert r["bound_s"] == r["t_compute_s"] and r["bottleneck"] == "compute"
    r = ta.kernel_roofline(1e6, 3.35e9)
    assert r["t_memory_s"] == 1e-3 and r["bottleneck"] == "memory"
    assert ta.peak_share(67e12, 1.0) == 1.0
    assert ta.peak_share(67e12, 1.0, chips=2) == 0.5


def test_production_mesh_is_a_plan():
    m = tmesh.make_production_mesh()
    assert dict(m.shape) == {"data": 16, "model": 16} and m.devices is None
    m = tmesh.make_production_mesh(multi_pod=True)
    assert list(m.shape.items()) == [("pod", 2), ("data", 16),
                                     ("model", 16)]
    with pytest.raises(ValueError):
        m.device_list()
    # the analytic models read a plan's axis sizes as the JAX mesh's
    cfg, cell = treg.get("granite-3-8b"), TSHAPES["train_4k"]
    assert ta.analytic_collective_bytes(cfg, cell, m.shape) == \
        ja.analytic_collective_bytes(jreg.get("granite-3-8b"),
                                     JSHAPES["train_4k"],
                                     {"pod": 2, "data": 16, "model": 16})


def test_trace_reads_labelled_transfers():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        x = torch.ones(4, 8)
        with trace.transfer("all-gather", x.numel() * 4):
            torch.cat([x, x])
        for _ in range(3):
            with trace.transfer("collective-permute", 96):
                x.clone()
    assert trace.collective_bytes(prof) == {
        "all-gather": 128, "collective-permute": 288, "total": 416}
    assert trace.collective_count(prof) == 4
    names = [trace.label("all-reduce", 8), "aten::cat", trace.label(
        "all-reduce", 4)]
    assert trace.collective_bytes(names) == {"all-reduce": 12, "total": 12}
    assert trace.collective_count([]) == 0
    assert trace.collective_bytes([]) == {"total": 0}
    with pytest.raises(ValueError):
        trace.label("broadcast", 4)
    assert trace.COLLECTIVES == jhlo.COLLECTIVES
