"""The port's ``Deployment`` against the JAX package's, on the CPU:
the same accelerator (one parameter set, W8 storage) served through two
CPU replicas at batch 4, with a padded last batch. Outputs agree to
1e-4 (float32 convs summed in another order) and the serving counters
are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import codegen as jcg
from repro.data.synthetic import ImageStream as JImageStream
from repro.models import yolo as jyolo
from repro.serve import Deployment as JDeployment
from repro.serve import DetectRequest as JRequest
from repro_torch.convert import params_from_numpy
from repro_torch.data.synthetic import ImageStream
from repro_torch.models import yolo as tyolo
from repro_torch.serve import Deployment, DetectRequest

IMG, N_REQ, BATCH = 64, 10, 4


@pytest.fixture(scope="module")
def accs():
    jm = jyolo.build("yolov3-tiny", IMG)
    jp = jax.jit(lambda k: jcg.init_params(jm.graph, k))(
        jax.random.PRNGKey(3))
    cfg = dict(batch_size=BATCH, replicas=2)
    jacc = jcore.compile(jm, jcore.CompileConfig(**cfg), params=jp)
    tacc = tcore.compile(tyolo.build("yolov3-tiny", IMG),
                         tcore.CompileConfig(**cfg),
                         params=params_from_numpy(
                             jax.tree_util.tree_map(np.asarray, jp)),
                         torch_device="cpu")
    return jacc, tacc


def test_image_stream_matches_jax():
    a, b = ImageStream(IMG, 3, seed=5), JImageStream(IMG, 3, seed=5)
    np.testing.assert_array_equal(a.batch_at(2), b.batch_at(2))


def test_deployment_matches_jax(accs):
    jacc, tacc = accs
    imgs = list(ImageStream(IMG, BATCH, seed=1).frames(N_REQ))
    with Deployment(tacc, devices=["cpu"]) as dep:
        assert len(dep.replicas) == 2
        for i, im in enumerate(imgs):
            assert dep.submit(DetectRequest(uid=i, image=im))
        got = dep.run()
        tstats = dict(dep.stats)
    with JDeployment(jacc, devices=jax.devices("cpu")) as jdep:
        for i, im in enumerate(imgs):
            assert jdep.submit(JRequest(uid=i, image=jnp.asarray(im)))
        want = jdep.run()
        jstats = dict(jdep.stats)
    assert [r.uid for r in got] == [r.uid for r in want] == \
        list(range(N_REQ))
    assert all(r.done for r in got)
    for g, w in zip(got, want):
        assert len(g.outputs) == len(w.outputs) == 2
        for a, b in zip(g.outputs, w.outputs):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4,
                                       rtol=1e-4)
    for k in ("frames", "batches", "padded_slots"):
        assert tstats[k] == jstats[k], k
    assert tstats["frames"] == N_REQ and tstats["padded_slots"] == 2
