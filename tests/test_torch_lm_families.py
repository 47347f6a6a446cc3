"""The port's vlm and encdec LM families and the dense int8 KV cache
(``kv_bits=8``) against the JAX package, on the CPU.

Parameters come from the JAX package's ``lm.init_params`` and reach the
port through ``convert.lm_params_from_numpy``; tokens, patch embeddings
(``embeds``) and source frames (``src_embeds``) come from numpy with a
fixed seed. llava-next (vlm: the patch embeddings before the tokens) and
seamless-m4t (encdec: a bidirectional encoder, cross-attention, the
``xk``/``xv`` cache): ``forward``, ``prefill`` and three ``decode_step``
calls within atol 1e-4 of the JAX package. ``nn/flash.py``:
``quantize_kv_rows`` bit-exact (codes and scales) on identical inputs;
``decode_grouped_q8`` within 1e-5 of the JAX function, with and without
a window and a softcap. granite-3-8b with ``kv_bits=8``: prefill logits
within 1e-4, the int8 cache's codes within one code of the JAX
package's (the share that differs printed), its scales within 1e-5,
and each decode step's logits within the JAX package's own bound for
the int8 cache (mean relative difference below 0.05,
``tests/test_quantized_serving.py:46-48``), here against the JAX
package's int8 decode; ``Engine`` serves it from int8 slots.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.nn import flash as jflash
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.nn import flash as tflash
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import Request as TRequest

from _port_memory import release_memory  # noqa: F401

TOL = dict(atol=1e-4, rtol=0)
# the JAX package's bound for the int8 cache's decode logits
Q8_MEAN_REL = 0.05


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _batch(cfg, B, T, seed, src_len=10):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.family == "vlm":
        b["embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["src_embeds"] = rng.standard_normal(
            (B, src_len, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _model(name, **replace):
    jc, tc = jreg.reduced(name), treg.reduced(name)
    if replace:
        jc = dataclasses.replace(jc, **replace)
        tc = dataclasses.replace(tc, **replace)
    jp = jlm.init_params(jc, jax.random.PRNGKey(4))
    return jc, tc, jp, lm_params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("name", ["llava-next-34b", "seamless-m4t-medium"])
def test_family_matches_jax(name):
    """forward; prefill (logits and cache, the encdec ``xk``/``xv``
    included); three greedy decode steps (logits, cache, lengths)."""
    jc, tc, jp, tp = _model(name)
    jb, tb = _batch(jc, 2, 11, seed=0)
    want, _ = jlm.forward(jp, jc, jb)
    got, aux = tlm.forward(tp, tc, tb)
    assert got.shape == want.shape and aux == {}
    _close(got, want)
    jl, jcache = jlm.prefill(jp, jc, jb, 32)
    tl, tcache = tlm.prefill(tp, tc, tb, 32)
    assert set(tcache) == set(jcache)
    _close(tl, jl)
    for key in tcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        _close(tcache[key], jcache[key])
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jcache = jlm.decode_step(jp, jc, jnp.asarray(nxt), jcache)
        tl, tcache = tlm.decode_step(tp, tc, torch.from_numpy(nxt), tcache)
        _close(tl, jl)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])
        np.testing.assert_array_equal(tcache["len"].numpy(), jcache["len"])


def test_quantize_kv_rows_is_bit_exact():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    x[0, 3] = 0.0                              # amax 0: the 1e-8 floor
    x[1, 5, 1] *= 1e-9
    x[1, 2, 0, :4] = [127.0, -127.0, 63.5, -0.5]   # halves: to even
    jq, js = jflash.quantize_kv_rows(jnp.asarray(x))
    tq, ts = tflash.quantize_kv_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None),
                                            (None, 20.0)])
def test_decode_grouped_q8_matches_jax(window, softcap):
    rng = np.random.default_rng(8)
    B, S, Hq, Hkv, D = 3, 24, 8, 2, 16
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kv = rng.standard_normal((2, B, S, Hkv, D)).astype(np.float32)
    kq, ks = jflash.quantize_kv_rows(jnp.asarray(kv[0]))
    vq, vs = jflash.quantize_kv_rows(jnp.asarray(kv[1]))
    lens = np.array([1, 13, 24], np.int32)
    want = jflash.decode_grouped_q8(jnp.asarray(q), kq, ks, vq, vs,
                                    jnp.asarray(lens), window=window,
                                    softcap=softcap)
    t = [torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)]
    got = tflash.decode_grouped_q8(torch.from_numpy(q), *t,
                                   torch.from_numpy(lens), window=window,
                                   softcap=softcap)
    _close(got, want, atol=1e-5, rtol=0)


def test_int8_kv_cache_matches_jax():
    """granite-3-8b at ``kv_bits=8``: prefill logits, the cache's codes
    (within one code; the share that differs printed) and scales, then
    three greedy steps within the JAX package's int8 bound."""
    jc, tc, jp, tp = _model("granite-3-8b", kv_bits=8)
    jb, tb = _batch(jc, 2, 24, seed=9)
    jl, jcache = jlm.prefill(jp, jc, jb, 32)
    tl, tcache = tlm.prefill(tp, tc, tb, 32)
    _close(tl, jl)

    def codes_and_scales():
        for k in ("k", "v"):
            assert tcache[k].dtype == torch.int8
            d = np.abs(tcache[k].numpy().astype(np.int32)
                       - np.asarray(jcache[k], np.int32))
            assert d.max() <= 1, k
            print(f"{k}: {np.count_nonzero(d)} of {d.size} codes differ "
                  f"({np.count_nonzero(d) / d.size:.2e})")
            np.testing.assert_allclose(tcache[k + "_s"].numpy(),
                                       np.asarray(jcache[k + "_s"]),
                                       rtol=1e-5, atol=0)

    codes_and_scales()
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jcache = jlm.decode_step(jp, jc, jnp.asarray(nxt), jcache)
        tl, tcache = tlm.decode_step(tp, tc, torch.from_numpy(nxt), tcache)
        want = np.asarray(jl)
        rel = np.abs(tl.numpy() - want).mean() / (np.abs(want).mean() + 1e-9)
        assert rel < Q8_MEAN_REL, rel
        codes_and_scales()


def test_engine_serves_int8_slots():
    """``Engine`` at ``kv_bits=8``: int8 slot codes with float32 scales,
    a prefilled row installed into its slot, the tokens those of the
    port's own prefill and decode."""
    tc = dataclasses.replace(treg.reduced("granite-3-8b"), kv_bits=8)
    tp = tlm.init_params(tc, torch.Generator().manual_seed(1), device="cpu")
    eng = TEngine(tc, tp, max_batch=2, cache_size=32, device="cpu")
    cache = eng.cache
    assert cache["k"].dtype == torch.int8 and cache["v"].dtype == torch.int8
    assert cache["k_s"].shape == cache["k"].shape[:-1]
    prompt = [3, 1, 4, 1, 5, 9, 2]
    eng.submit(TRequest(uid=0, prompt=prompt, max_new_tokens=4))
    done = eng.run()
    eng.close()
    toks = torch.tensor([prompt], dtype=torch.int32)
    logits, c = tlm.prefill(tp, tc, {"tokens": toks}, 32)
    want = [int(logits.argmax(-1))]
    for _ in range(3):
        logits, c = tlm.decode_step(
            tp, tc, torch.tensor(want[-1:], dtype=torch.int32), c)
        want.append(int(logits.argmax(-1)))
    assert done[0].out_tokens == want
    n = len(prompt) + 3            # the slot's rows: a 2-row step's
    slot = eng.cache                # k/v may differ in the last bits
    for k in ("k", "v"):
        d = (slot[k][:, 0, :n].to(torch.int32) - c[k][:, 0, :n]).abs()
        assert int(d.max()) <= 1
        torch.testing.assert_close(slot[k + "_s"][:, 0, :n],
                                   c[k + "_s"][:, 0, :n], rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", sorted(treg.ARCHS) + ["granite-3-8b@kv8"])
def test_kernel_operands_are_contiguous(monkeypatch, name):
    """Every operand the model hands a kernel wrapper (#6, #11, #12, #13)
    in a two-row prefill and two decode steps is a contiguous tensor,
    as the CUDA kernels require (on the CPU the wrappers run their plain
    versions, which would take any layout)."""
    from repro_torch.kernels import attention, decode_attention, pointwise
    from repro_torch.kernels import ssd_scan
    calls = []

    def strict(mod, fn):
        f = getattr(mod, fn)

        def g(*args, **kw):
            for t in list(args) + list(kw.values()):
                if isinstance(t, torch.Tensor):
                    assert t.is_contiguous(), (fn, tuple(t.shape),
                                               t.stride())
            calls.append(fn)
            return f(*args, **kw)
        monkeypatch.setattr(mod, fn, g)

    strict(attention, "mha")
    strict(decode_attention, "decode_attention")
    strict(pointwise, "rmsnorm")
    strict(ssd_scan, "ssd_scan")
    arch = name.split("@")[0]
    extra = {"kv_bits": 8} if name.endswith("@kv8") else {}
    jc, tc, _, tp = _model(arch, **extra)
    _, tb = _batch(jc, 2, 7, seed=3, src_len=6)
    logits, cache = tlm.prefill(tp, tc, tb, 24)
    for _ in range(2):
        logits, cache = tlm.decode_step(
            tp, tc, logits.argmax(-1).to(torch.int32), cache)
    assert "rmsnorm" in calls
    assert bool(torch.isfinite(logits).all())
