"""Tensor-parallel quantized YOLO replicas and the sharded moe family on
the card (``-m gpu``; every test skips without one, and the file imports
no JAX).

Positions wrap over ``cuda_devices()`` (one card: both name cuda:0).
yolov8n at 160 compiled at W8A16, W4A8 (packed), W8A8 recalibrated with
per-group activation scales and the per-layer mix of ``bits="mixed"``,
run through ``codegen.TensorParallel`` over ``QuantBackend`` on
``place_sharded`` parameters:

* each position's kernel (#7, #8, #9) on its filter block within 1e-4
  of the plain version of the same block on the same input, and within
  1e-4 of the one-device kernel conv, launching once a position;
* the tensor-parallel forward against the one-device forward: every
  conv within 1e-4 of one device's on one device's input, and the
  outputs bit-equal for packed W4A8 (exact int32 sums, the same
  epilogue a column), within 1e-4 for the designs with float
  activations, and within the JAX package's ``_quant_atol`` at 8 bits
  for per-group scales (their f32 fold follows each position's plan);
* ``AcceleratorReplica(acc, device=[d, d], backend="quant")`` serves.

llama4's grouped layout (a dense layer, then an MoE layer with a shared
expert) at a kernel-shaped reduced size over (2, 2) and (1, 2): a loss,
a train step, a prefill and three decode steps through the kernels
within 1e-4 of the plain versions and of the unsharded calls, with #6,
#11 and #12 counted a position.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as core
from repro_torch.configs import registry
from repro_torch.core import codegen
from repro_torch.core.toolflow import place
from repro_torch.data.synthetic import ImageStream
from repro_torch.dist import sharding, spmd
from repro_torch.kernels import attention, decode_attention, ops
from repro_torch.kernels import pointwise as tpw
from repro_torch.kernels import qmatmul
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import lm, yolo
from repro_torch.optim import optimizers
from repro_torch.serve import AcceleratorReplica, DetectRequest
from repro_torch.tree import flatten_with_path

from _port_memory import release_memory  # noqa: F401

TOL = 1e-4
IMG, BATCH = 160, 2
MODES = {"w8a16": dict(backend="quant", w_bits=8, a_bits=16),
         "w4a8": dict(backend="quant", w_bits=4, a_bits=8),
         "per_group": dict(backend="quant", w_bits=8, a_bits=8),
         "mixed": dict(bits="mixed", search_evals=12, calib_frames=1)}
KERNEL = {"w8a16": qmatmul.qmatmul.launches,
          "w4a8": qmatmul.qmatmul_a8.launches,
          "per_group": qmatmul.qmatmul_a8_grouped.launches,
          "mixed": qmatmul.qmatmul.launches}


@pytest.fixture
def devs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's tp and sharded "
                    "paths run these at full width there)")
    from repro_torch.device import cuda_devices
    return cuda_devices()


def _design(devs, mode):
    model = yolo.build("yolov8n", IMG)
    params = codegen.init_params(model.graph,
                                 torch.Generator().manual_seed(0))
    for p in params.values():
        p["w"] *= 1.75
    acc = core.compile(model, core.CompileConfig(batch_size=BATCH,
                                                 **MODES[mode]),
                       params=params, torch_device=devs[0])
    if mode == "per_group":
        codegen.calibrate_activation_scales(
            acc.graph, place(params, devs[0]), torch.from_numpy(
                ImageStream(IMG, BATCH, seed=9).batch_at(0)).to(devs[0]),
            granularity="per_group", group_size=16)
    return acc


class _Twice:
    """A one-device table that runs each conv through ``a`` and ``b``
    (tensor-parallel tables over the placed parameters, or ``b`` on one
    device) on the same input, records the worst difference, and passes
    ``b``'s result on."""
    name = "twice"

    def __init__(self, a, b, placed, b_placed):
        self.a, self.b = a, b
        self.placed, self.b_placed = placed, b_placed
        self.worst, self.convs = 0.0, 0

    def fuses_pool(self, node):
        return False

    def conv(self, x, p, node, res=None, **kw):
        want = self.b.conv(x, self.placed[node.name] if self.b_placed
                           else p, node, res)
        got = self.a.conv(x, self.placed[node.name], node, res)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL,
                                   msg=lambda m: f"{node.name}: {m}")
        self.worst = max(self.worst, float((got - want).abs().max()))
        self.convs += 1
        return want

    def __getattr__(self, item):
        return getattr(self.b, item)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_shard_kernels_match_plain_and_one_device(devs, mode):
    acc = _design(devs, mode)
    pos = [devs[i % len(devs)] for i in range(2)]
    placed = sharding.place_sharded(acc.params, pos)
    kern = codegen.get_backend("quant")
    plain = codegen.QuantBackend(name="quant_ref", dispatch="ref")
    x = torch.from_numpy(ImageStream(IMG, BATCH, seed=1).batch_at(0)).to(
        devs[0])
    counter = KERNEL[mode]
    counter.reset()
    cmp = _Twice(codegen.TensorParallel(kern), codegen.TensorParallel(plain),
                 placed, True)
    acc.forward(x, backend=cmp)
    convs = [n for n in acc.graph.topo_order() if n.op == "conv"]
    cut = sum(n.geom("F") % 2 == 0 for n in convs)
    assert cmp.convs == len(convs) and cut > 0
    if mode != "per_group":         # unaligned groups take #7 instead
        assert counter.value == 2 * cut + len(convs) - cut
    one = _Twice(codegen.TensorParallel(kern), kern, placed, False)
    acc.forward(x, backend=one)
    assert one.convs == len(convs)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_tp_forward_matches_one_device(devs, mode):
    acc = _design(devs, mode)
    pos = [devs[i % len(devs)] for i in range(2)]
    imgs = ImageStream(IMG, BATCH, seed=2).batch_at(0)
    rep = AcceleratorReplica(acc, device=pos, backend="quant")
    reqs = [DetectRequest(uid=i, image=im) for i, im in enumerate(imgs)]
    rep.complete(rep.dispatch(reqs))
    one = [o.cpu().numpy() for o in acc.forward(
        torch.from_numpy(imgs).to(devs[0]), backend="quant")]
    top = max(float(np.abs(o).max()) for o in one)
    for j, r in enumerate(reqs):
        for got, want in zip(r.outputs, one):
            if mode == "w4a8":
                np.testing.assert_array_equal(got, want[j])
            elif mode == "per_group":
                np.testing.assert_allclose(got, want[j], rtol=0,
                                           atol=16 * 2.0 ** -8 * top)
            else:
                np.testing.assert_allclose(got, want[j], atol=TOL, rtol=TOL)


# llama4's grouped layout, kernel-shaped: heads of 64, d 256
def _llama4():
    cfg = registry.reduced("llama4-maverick-400b-a17b")
    return dataclasses.replace(
        cfg, d_model=256, head_dim=64, d_ff=384, remat="full",
        moe=dataclasses.replace(cfg.moe, d_model=256, d_ff=128,
                                shared_d_ff=128))


COUNTERS = {"rmsnorm": tpw.rmsnorm_launches, "mha": attention.launches,
            "decode_attention": decode_attention.launches}


def _counts():
    return {k: c.value for k, c in COUNTERS.items()}


def _zero():
    for c in COUNTERS.values():
        c.reset()


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _plain(fn):
    ops.set_default_backend("ref")
    try:
        return fn()
    finally:
        ops.set_default_backend("auto")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ((2, 2), (1, 2)), ids=str)
def test_llama4_grouped_sharded_kernels_match(devs, shape):
    cfg = _llama4()
    dev = devs[0]
    n, L = shape[0] * shape[1], cfg.n_layers
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    assert set(params["layers"]) == {"dense", "moe"}
    mesh = mesh_lib.make_mesh(shape, ("data", "model"),
                              devices=[devs[i % len(devs)] for i in range(n)])
    sp = steps.place_params(params, mesh, cfg=cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 64), generator=g, device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    with torch.no_grad():
        _zero()
        loss_k = spmd.loss_fn(sp, cfg, batch)[0]
        assert _counts() == {"rmsnorm": n * L * 2 + n, "mha": n * L,
                             "decode_attention": 0}
        loss_p = _plain(lambda: spmd.loss_fn(sp, cfg, batch)[0])
        loss_u = lm.loss_fn(params, cfg, batch)[0]
    assert abs(float(loss_k - loss_p)) <= TOL * abs(float(loss_p))
    assert abs(float(loss_k - loss_u)) <= TOL * abs(float(loss_u))
    opt = optimizers.adamw(lr=1e-3)
    step = steps.make_train_step(cfg, opt, 2)
    mb = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
    _zero()
    p_k, s_k, m_k = step(sp, steps.init_opt_state(opt, sp, cfg), 0, mb)
    assert _counts()["mha"] == 2 * 2 * n * L       # 2 microbatches, remat
    p_u, s_u, m_u = step(params, opt.init(params), 0, mb)
    assert abs(float(m_k["loss"] - m_u["loss"])) <= TOL * float(m_u["loss"])
    gu = dict(flatten_with_path(s_u["m"]))
    for path, st in flatten_with_path(s_k["m"]):
        assert _rel(st.gather(), gu[path]) <= TOL, path
    pf, dc = steps.make_prefill_step(cfg, 68), steps.make_decode_step(cfg)
    pb = {"tokens": toks}
    l_k, c_k = pf(sp, pb)
    l_p, c_p = _plain(lambda: pf(sp, pb))
    l_u, c_u = pf(params, pb)
    assert _rel(l_k, l_p) <= TOL and _rel(l_k, l_u) <= TOL
    for s in range(3):
        tok = torch.full((4,), 7 + s, dtype=torch.int32, device=dev)
        _zero()
        l_k, c_k = dc(sp, tok, c_k)
        assert _counts() == {"rmsnorm": n * L * 2 + n, "mha": 0,
                             "decode_attention": n * L}
        l_p, c_p = _plain(lambda: dc(sp, tok, c_p))
        l_u, c_u = dc(params, tok, c_u)
        assert _rel(l_k, l_p) <= TOL and _rel(l_k, l_u) <= TOL, s
