"""The port's training path against the JAX package, on the CPU.

Parameters come from the JAX package's ``lm.init_params`` and reach the
port through ``convert.lm_params_from_numpy``; tokens, labels (some
masked, < 0), patch embeddings and source frames come from numpy with a
fixed seed. For the reduced dense, moe, ssm, hybrid, vlm and encdec
configs: three ``make_train_step`` steps (adamw, two microbatches:
each step's ``loss_fn`` loss, tokens and grad_norm; every gradient leaf
of the first; every updated parameter and moment), each within atol =
rtol = 1e-4 of the JAX package. The four remat modes give equal gradients and recompute
what they say (RMSNorm calls counted); ``policy_from_buffer_plan`` saves
ON tags and recomputes OFF ones (the tag's calls in backward counted).
The autograd Functions of ``kernels/autograd.py`` (on a CPU tensor the
wrappers run the plain versions, so they run here too) give the plain
version's gradients. ``TokenStream`` batches equal the JAX package's bit
for bit, and ``SoftwareFifo`` moves the same chunks as the JAX version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from repro.configs import registry as jreg
from repro.core import buffers as jbuf
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import buffers as tbuf
from repro_torch.core import ir as tir
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import autograd as tgrad
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.train import remat as tremat
from repro_torch.tree import flatten_with_path

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {"dense": "granite-3-8b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-1.2b",
            "vlm": "llava-next-34b", "encdec": "seamless-m4t-medium"}


def _jflat(tree) -> dict:
    return {"|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree) -> dict:
    return {"|".join(map(str, path)): leaf.detach().numpy()
            for path, leaf in flatten_with_path(tree)}


def _close_trees(got, want, **tol):
    g, w = _tflat(got), _jflat(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **(tol or TOL))


def _batch(cfg, B, T, seed, src_len=10):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    b["labels"][:, -2:] = -1                       # masked positions
    if cfg.family == "vlm":
        b["embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["src_embeds"] = rng.standard_normal(
            (B, src_len, cfg.d_model)).astype(np.float32)
    return b


def _model(name, **replace):
    jc, tc = jreg.reduced(name), treg.reduced(name)
    if replace:
        jc = dataclasses.replace(jc, **replace)
        tc = dataclasses.replace(tc, **replace)
    jp = jlm.init_params(jc, jax.random.PRNGKey(4))
    return jc, tc, jp, lm_params_from_numpy(jp, device="cpu")


def _microbatched(b: dict, n: int) -> dict:
    return {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
            for k, v in b.items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_grads_and_train_steps_match_jax(family):
    """Three adamw steps over two microbatches (one jitted JAX step a
    family): each step's loss (the microbatches' mean of ``loss_fn``),
    token count and grad_norm; after step 0 every gradient leaf (the
    first moment is (1 - b1) x the clipped gradient, read back on both
    sides); after step 2 every parameter and moment."""
    jc, tc, jp, tp = _model(FAMILIES[family])
    b1 = 0.9
    jo, to = jopt.adamw(lr=1e-3, b1=b1), topt.adamw(lr=1e-3, b1=b1)
    jstep = jax.jit(jsteps.make_train_step(jc, jo, 2))
    tstep = tsteps.make_train_step(tc, to, 2)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        mb = _microbatched(_batch(jc, 4, 16, seed=10 + i), 2)
        jp, js, jmet = jstep(jp, js, jnp.int32(i),
                             {k: jnp.asarray(v) for k, v in mb.items()})
        tp, ts, tmet = tstep(tp, ts, i,
                             {k: torch.from_numpy(v) for k, v in mb.items()})
        for key in ("loss", "tokens", "grad_norm"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       err_msg=f"step {i} {key}", **TOL)
        assert float(tmet["tokens"]) == 2 * 14
        if i == 0:
            _close_trees(tlm.tree_map(lambda m: m / (1 - b1), ts["m"]),
                         jax.tree_util.tree_map(lambda m: m / (1 - b1),
                                                js["m"]))
    _close_trees(tp, jp)
    _close_trees(ts, js)


def test_grads_of_is_autograd_of_loss_fn():
    """``launch.steps.grads_of``: the gradient of ``lm.loss_fn`` for every
    leaf (zeros where the loss does not reach), its metrics detached."""
    _, tc, _, tp = _model("qwen3-moe-30b-a3b")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tc, 2, 16, 4).items()}
    grads, metrics = tsteps.grads_of(tp, tc, tb)
    pg = tlm.tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss, _ = tlm.loss_fn(pg, tc, tb)
    loss.backward()
    want = dict(flatten_with_path(pg))
    for path, g in flatten_with_path(grads):
        w = want[path].grad
        assert torch.equal(g, torch.zeros_like(g) if w is None else w), path
    assert float(metrics["loss"]) == loss.item()
    assert not any(v.requires_grad for v in metrics.values())


def _count_rmsnorm(monkeypatch):
    calls = []

    def counted(x, g, *, eps=1e-6, backend=None):
        calls.append(1)
        return ref.rmsnorm(x, g, eps)
    monkeypatch.setattr(ops, "rmsnorm", counted)
    return calls


@pytest.mark.parametrize("name,layers", [("granite-3-8b", 4),
                                         ("mamba2-130m", 2),
                                         ("seamless-m4t-medium", 4)])
def test_remat_modes_give_equal_grads(monkeypatch, name, layers):
    """Equal gradients under none/full/dots/group, and what each
    recomputes, by RMSNorm calls: full and dots run every checkpointed
    layer's again in backward (dots reruns its region under the policy,
    which keeps only the matmuls' outputs), group runs a grouped layer's
    again within its group's recompute."""
    _, tc, _, tp = _model(name, n_layers=layers)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tc, 2, 16, 5).items()}
    calls = _count_rmsnorm(monkeypatch)
    grads, counts = {}, {}
    for mode in ("none", "full", "dots", "group"):
        calls.clear()
        g, m = tsteps.grads_of(tp, dataclasses.replace(tc, remat=mode), tb)
        grads[mode], counts[mode] = _tflat(g), len(calls)
    for mode in ("full", "dots", "group"):
        for k, v in grads["none"].items():
            np.testing.assert_array_equal(grads[mode][k], v, err_msg=k)
    # RMSNorm calls a recompute of the decoder (or Mamba) stack and of
    # the encoder's
    stack, enc = {"granite-3-8b": (2 * layers, 0),
                  "mamba2-130m": (2 * layers, 0),
                  "seamless-m4t-medium": (3 * layers, 2 * 2)}[name]
    fwd = counts["none"]
    assert counts["full"] == counts["dots"] == fwd + stack + enc
    # group: the attention families' stack in groups, a layer once more
    # inside its group (how many torch's nested checkpoint stops early
    # for is its own); full elsewhere (the Mamba stack, the encoder)
    if name == "mamba2-130m":
        assert counts["group"] == counts["full"]
    else:
        assert counts["full"] < counts["group"] <= fwd + 2 * stack + enc


def test_remat_inference_is_unchanged():
    """Under no_grad/inference_mode remat is off: the logits of every
    mode equal the unremat'd forward's bit for bit."""
    _, tc, _, tp = _model("granite-3-8b", n_layers=4)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tc, 2, 16, 6).items()}
    with torch.inference_mode():
        want, _ = tlm.forward(tp, tc, tb)
        for mode in ("full", "dots", "group"):
            got, _ = tlm.forward(tp, dataclasses.replace(tc, remat=mode), tb)
            assert torch.equal(got, want)


def _two_branch_graph():
    """stem → (long path: 2 convs) + (skip edge) → add (the JAX
    package's ``tests/test_remat_policy.py`` graph)."""
    g = tir.Graph(name="resid")
    g.add_stream("in", (8, 8, 4))
    g.inputs.append("in")
    g.add_stream("s", (8, 8, 4))
    g.add_node("stem", "conv", ["in"], ["s"], H=8, W=8, C=4, F=4, K=3,
               groups=1, W_in=8)
    g.add_stream("a", (8, 8, 4))
    g.add_node("conv_a", "conv", ["s"], ["a"], H=8, W=8, C=4, F=4, K=3,
               groups=1, W_in=8)
    g.add_stream("b", (8, 8, 4))
    g.add_node("conv_b", "conv", ["a"], ["b"], H=8, W=8, C=4, F=4, K=3,
               groups=1, W_in=8)
    g.add_stream("out", (8, 8, 4))
    g.add_node("add", "add", ["b", "s"], ["out"], H=8, W=8, C=4)
    g.outputs.append("out")
    g.validate()
    return g


class _CountTags(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.repro_torch.checkpoint_name.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_policy_saves_on_recomputes_off():
    g = _two_branch_graph()
    bufs = g.skip_buffers()
    assert bufs
    plan_off = tbuf.allocate_buffers(g, avail_bytes=0)
    plan_on = tbuf.allocate_buffers(g, avail_bytes=10 ** 9)
    assert tremat.spill_fraction(plan_off) == 1.0
    assert tremat.spill_fraction(plan_on) == 0.0
    edge_to_name = {b.edge: "skip" for b in bufs}

    def f(x, w):
        h = tremat.checkpoint_name(torch.tanh(x @ w), "skip")
        return torch.sum(h * h)

    grads = []
    for plan, recomputed in ((plan_on, 0), (plan_off, 1)):
        policy = tremat.policy_from_buffer_plan(plan, edge_to_name)
        assert policy.saved == ({"skip"} if plan is plan_on else set())
        x = torch.ones((4, 4), requires_grad=True)
        w = torch.full((4, 4), 0.1, requires_grad=True)
        y = checkpoint(f, x, w, use_reentrant=False,
                       context_fn=tremat.context_fn(policy))
        with _CountTags() as count:
            y.backward()
        assert count.n == recomputed
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])
    assert torch.isfinite(grads[0]).all()


def _grad_pair(fn_kernel, fn_plain, inputs, seed=0):
    """Gradients of a random projection of each output, through the
    autograd Function and through the plain version."""
    got_in = [t.clone().requires_grad_(t.is_floating_point()) for t in inputs]
    want_in = [t.clone().requires_grad_(t.is_floating_point())
               for t in inputs]
    out_k, out_p = fn_kernel(*got_in), fn_plain(*want_in)
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    gen = torch.Generator().manual_seed(seed)
    proj = [torch.randn(o.shape, generator=gen) for o in out_p]
    sk = sum((o * p).sum() for o, p in zip(out_k, proj))
    sp = sum((o * p).sum() for o, p in zip(out_p, proj))
    for a, b in zip(torch.autograd.grad(sk, got_in),
                    torch.autograd.grad(sp, want_in)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_autograd_functions_give_the_plain_gradients():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 32, generator=gen)
    g = torch.randn(32, generator=gen) * 0.1
    _grad_pair(lambda a, b: tgrad.RmsNorm.apply(a, b, 1e-6),
               lambda a, b: ref.rmsnorm(a, b, 1e-6), [x, g])
    q = torch.randn(2, 7, 4, 16, generator=gen)
    k = torch.randn(2, 9, 2, 16, generator=gen)
    v = torch.randn(2, 9, 2, 16, generator=gen)
    for causal, window, softcap in ((True, None, None), (True, 3, None),
                                    (True, None, 5.0), (False, None, None)):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=None)
        _grad_pair(lambda a, b, c: tgrad.Mha.apply(a, b, c, *kw.values()),
                   lambda a, b, c: ref.mha(a, b, c, **kw), [q, k, v])
    Bt, T, H, P, G, N = 2, 20, 4, 16, 2, 16
    xs = torch.randn(Bt, T, H, P, generator=gen)
    dt = torch.rand(Bt, T, H, generator=gen) * 0.5 + 0.01
    A = -torch.rand(H, generator=gen) - 0.1
    Bm = torch.randn(Bt, T, G, N, generator=gen)
    Cm = torch.randn(Bt, T, G, N, generator=gen)
    h0 = torch.randn(Bt, H, N, P, generator=gen)
    _grad_pair(lambda *a: tgrad.SsdScan.apply(*a),
               lambda *a: ref.ssd_chunked(*a[:5], h0=a[5]),
               [xs, dt, A, Bm, Cm, h0])
    _grad_pair(lambda *a: tgrad.SsdScan.apply(*a, None),
               lambda *a: ref.ssd_chunked(*a),
               [xs, dt, A, Bm, Cm])


def test_ops_route_to_the_functions_only_on_cuda_with_grad():
    """On a CPU tensor ``ops`` runs the plain version, grad or not; the
    routing predicate needs grad enabled and an operand requiring it."""
    x = torch.ones(2, 8, requires_grad=True)
    assert tgrad.wants_grad(x, None)
    with torch.no_grad():
        assert not tgrad.wants_grad(x)
    with torch.inference_mode():
        assert not tgrad.wants_grad(x)
    assert not tgrad.wants_grad(x.detach(), torch.zeros(8))
    y = ops.rmsnorm(x, torch.zeros(8))
    assert y.grad_fn is not None and "RmsNorm" not in type(
        y.grad_fn).__name__


@pytest.mark.parametrize("seed,index,microbatches", [
    (0, 0, 1), (0, 5, 2), (3, 17, 4), (11, 2, 1)])
def test_token_stream_is_bit_equal(seed, index, microbatches):
    kw = dict(vocab=8192, seq_len=33, batch=8, seed=seed,
              microbatches=microbatches)
    want = jsyn.TokenStream(**kw).batch_at(index)
    got = tsyn.TokenStream(**kw).batch_at(index)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            (microbatches, 8 // microbatches, 33)
        np.testing.assert_array_equal(got[k], want[k])


def test_software_fifo_matches_jax():
    """Pushes and pops through wrap, a push when full and pops when
    empty: the same chunks, head, tail and size as the JAX version."""
    rng = np.random.default_rng(0)
    jf = jbuf.SoftwareFifo.create(3, 4)
    tf = tbuf.SoftwareFifo.create(3, 4, device="cpu")
    ops_seq = "pppoopppppooooopop"        # p push, o pop
    for i, op in enumerate(ops_seq):
        if op == "p":
            chunk = rng.standard_normal(4).astype(np.float32)
            jf = jf.push(jnp.asarray(chunk))
            tf = tf.push(torch.from_numpy(chunk))
        else:
            jo, jf = jf.pop()
            to, tf = tf.pop()
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert (tf.head, tf.tail, tf.size) == (int(jf.head), int(jf.tail),
                                               int(jf.size)), i
        np.testing.assert_array_equal(tf.buf.numpy(), np.asarray(jf.buf))


def test_software_fifo_is_functional():
    f0 = tbuf.SoftwareFifo.create(2, 3, device="cpu")
    f1 = f0.push(torch.ones(3))
    assert f0.size == 0 and torch.equal(f0.buf, torch.zeros(2, 3))
    out, f2 = f1.pop()
    assert torch.equal(out, torch.ones(3)) and f1.size == 1 and f2.size == 0
