"""The port's checkpoints and train loop on the CPU: save/restore
identity, atomic publish and gc, the shape check; kill → restart resumes
bit-exact; a step that raises is retried; and a checkpoint of a
params-and-adamw tree crosses between the packages bit for bit, both
ways (the JAX package's ``ckpt.save`` restored by the port, the port's
restored by the JAX package's ``ckpt.restore``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.optim import optimizers as topt
from repro_torch.train import loop
from repro_torch.train.loop import TrainConfig, train
from repro_torch.tree import flatten_with_path, tree_map

from _port_memory import release_memory  # noqa: F401


def _flat(tree) -> dict:
    return {"|".join(map(str, path)): leaf
            for path, leaf in flatten_with_path(tree)}


def tree_eq(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return set(fa) == set(fb) and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k])
        for k in fa)


def test_save_restore_identity(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((2,), dtype=torch.int32),
                       "q": torch.tensor([-127, 3], dtype=torch.int8)},
            "seq": [torch.zeros(1), torch.full((2, 2), 7.0)]}
    ck.save(tmp_path, 5, tree, extras={"note": "x"})
    template = tree_map(torch.empty_like, tree)
    out, extras = ck.restore(tmp_path, template)
    assert tree_eq(tree, out)
    assert extras["step"] == 5 and extras["note"] == "x"
    manifest = json.loads((tmp_path / "step_00000005" /
                           "manifest.json").read_text())
    assert manifest["keys"] == sorted(["a", "nested|b", "nested|q",
                                       "seq|0", "seq|1"])
    assert manifest["dtypes"]["nested|q"] == "int8"


def test_atomic_publish_and_gc(tmp_path):
    tree = {"a": torch.zeros((4,))}
    (tmp_path / "step_00000009.tmp").mkdir(parents=True)   # a crashed write
    for s in range(6):
        ck.save(tmp_path, s, tree, keep=3)
    steps = sorted(p.name for p in tmp_path.glob("step_*")
                   if not p.name.endswith(".tmp"))
    assert steps == ["step_00000003", "step_00000004", "step_00000005"]
    assert ck.latest_step(tmp_path) == 5
    assert ck.latest_step(tmp_path / "absent") is None


def test_restore_validates(tmp_path):
    ck.save(tmp_path, 0, {"a": torch.zeros((4,))})
    with pytest.raises(ValueError):
        ck.restore(tmp_path, {"a": torch.zeros((5,))})
    with pytest.raises(KeyError):
        ck.restore(tmp_path, {"b": torch.zeros((4,))})
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path / "none", {"a": torch.zeros((4,))})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ck.restore(tmp_path, {"a": torch.zeros((4,))}, shardings={})


def test_kill_restart_resumes_bit_exact(tmp_path):
    """6 straight steps ≡ 3 steps + simulated crash + restore + 3 steps,
    every loss bit-equal (the loader cursor from the manifest)."""
    cfg = registry.reduced("mamba2-130m")
    kw = dict(batch=4, seq_len=16, log_every=0, seed=7, microbatches=2)
    full = train(cfg, TrainConfig(steps=6, ckpt_dir=None, **kw),
                 device="cpu")
    train(cfg, TrainConfig(steps=3, ckpt_dir=str(tmp_path), ckpt_every=3,
                           **kw), device="cpu")
    assert ck.latest_step(tmp_path) == 3
    _, extras = ck.restore(tmp_path, {})
    assert extras == {"loader_index": 3, "step": 3}
    resumed = train(cfg, TrainConfig(steps=6, ckpt_dir=str(tmp_path),
                                     ckpt_every=3, **kw), device="cpu")
    assert full["loss_history"][3:] == resumed["loss_history"]
    assert tree_eq(full["final_state"].params,
                   resumed["final_state"].params)


def test_failed_step_is_retried(monkeypatch):
    """A step that raises is retried from the last good state; the
    losses are those of a run without the fault."""
    cfg = registry.reduced("granite-3-8b")
    tc = TrainConfig(steps=3, batch=2, seq_len=8, log_every=0, seed=1)
    want = train(cfg, tc, device="cpu")["loss_history"]
    real = tsteps.make_train_step
    faults = [1]

    def flaky(*a, **kw):
        step = real(*a, **kw)

        def run(params, opt_state, i, batch):
            if i == 1 and faults:
                faults.pop()
                step(params, opt_state, i, batch)   # runs, then fails
                raise RuntimeError("device lost")
            return step(params, opt_state, i, batch)
        return run
    monkeypatch.setattr(loop.steps_lib, "make_train_step", flaky)
    assert train(cfg, tc, device="cpu")["loss_history"] == want
    faults.append(1)
    with pytest.raises(RuntimeError, match="device lost"):
        train(cfg, TrainConfig(steps=3, batch=2, seq_len=8, log_every=0,
                               seed=1, max_retries=0), device="cpu")


def _params_and_adamw():
    cfg = jreg.reduced("granite-3-8b")
    jp = jlm.init_params(cfg, jax.random.PRNGKey(2))
    opt = jopt.adamw(lr=1e-3)
    js = opt.init(jp)
    # a non-trivial state: one update on numpy gradients
    rng = np.random.default_rng(0)
    jg = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), jp)
    _, js = opt.update(jg, js, jp, jnp.int32(0))
    return {"params": jp, "opt": js}


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jt = _params_and_adamw()
    jck.save(tmp_path, 4, jt, extras={"loader_index": 4})
    tp = lm_params_from_numpy(jt["params"], device="cpu")
    template = {"params": tp, "opt": topt.adamw().init(tp)}
    got, extras = ck.restore(tmp_path, template)
    assert extras == {"loader_index": 4, "step": 4}
    want = jax.tree_util.tree_flatten_with_path(jt)[0]
    flat = _flat(got)
    assert len(flat) == len(want)
    for path, leaf in want:
        key = "|".join(str(k.key) for k in path)
        np.testing.assert_array_equal(flat[key].numpy(), np.asarray(leaf))
        assert flat[key].dtype == torch.float32


def test_port_checkpoint_restores_into_jax(tmp_path):
    jt = _params_and_adamw()
    tt = tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree_util.
                  tree_map(np.asarray, jt))
    # an int8_adamw state crosses too: codes and scales
    tt["opt8"] = topt.int8_adamw().init(tt["params"])
    ck.save(tmp_path, 2, tt, extras={"loader_index": 2})
    jtmpl = dict(jt, opt8=jopt.int8_adamw().init(jt["params"]))
    got, extras = jck.restore(tmp_path, jax.eval_shape(lambda: jtmpl))
    assert extras["step"] == 2 and extras["loader_index"] == 2
    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        key = "|".join(str(k.key) for k in path)
        want = _flat(tt)[key]
        assert np.asarray(leaf).dtype == want.numpy().dtype, key
        np.testing.assert_array_equal(np.asarray(leaf), want.numpy())
