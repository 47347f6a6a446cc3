"""Gradients through the forward kernels: one ``torch.autograd.Function``
each for RMSNorm (#6), attention (#11) and the SSD scan (#13).

``forward`` launches the CUDA kernel (through its wrapper, on detached
operands) and saves the operands. ``backward`` recomputes the plain
version (``ref.rmsnorm``, ``ref.mha``, ``ref.ssd_chunked``) under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it: the
port's counterpart of the JAX package's training path, which XLA
differentiates through the same plain functions (the JAX package has no
backward kernel). There is no fallback: a kernel that does not build or
launch raises out of ``forward``.

``ops.rmsnorm``/``ops.mha``/``ops.ssd_scan`` route here only for an
operand on a CUDA device, with grad enabled and an operand that requires
grad; every other call (serving, ``torch.inference_mode()``,
``backend="ref"``) is unchanged. The wrappers themselves still refuse an
operand that requires grad (``_build.check_no_grad``). On a CPU tensor
the wrappers run the plain version, so these Functions also run (and
are tested) on the CPU.

The backward recomputations are module-level functions
(``rmsnorm_backward``, ``mha_backward``, ``ssd_scan_backward``) so that
a profiler can label each one's time (``chip_smoke.py``'s train path).
"""
from __future__ import annotations

import torch

from . import attention as _attn
from . import pointwise as _pw
from . import ref
from . import ssd_scan as _ssd


def _leaves_for_grad(ctx, tensors):
    """Detached copies (views, no data copy) of the saved operands, each
    requiring grad where ``forward``'s input needed one."""
    return [None if t is None else
            t.detach().requires_grad_(bool(need))
            for t, need in zip(tensors, ctx.needs_input_grad)]


def _grads(outputs, inputs, grad_outputs) -> list:
    """``torch.autograd.grad`` of ``outputs`` for the inputs that require
    grad; None for the rest."""
    want = [t for t in inputs if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad(outputs, want, grad_outputs,
                                   allow_unused=True) if want else ())
    return [next(got) if t is not None and t.requires_grad else None
            for t in inputs]


def rmsnorm_backward(ctx, gy):
    x, g = _leaves_for_grad(ctx, ctx.saved_tensors)
    with torch.enable_grad():
        y = ref.rmsnorm(x, g, ctx.eps)
        gx, gg = _grads(y, (x, g), gy)
    return gx, gg, None


class RmsNorm(torch.autograd.Function):
    """Kernel #6 forward, the plain version's backward."""

    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, g)
        return _pw.rmsnorm(x.detach(), g.detach(), eps)

    @staticmethod
    def backward(ctx, gy):
        return rmsnorm_backward(ctx, gy)


def mha_backward(ctx, go):
    q, k, v = _leaves_for_grad(ctx, ctx.saved_tensors)
    with torch.enable_grad():
        o = ref.mha(q, k, v, **ctx.kw)
        gq, gk, gv = _grads(o, (q, k, v), go)
    return gq, gk, gv, None, None, None, None


class Mha(torch.autograd.Function):
    """Kernel #11 forward, the plain version's backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        ctx.save_for_backward(q, k, v)
        return _attn.mha(q.detach(), k.detach(), v.detach(), **ctx.kw)

    @staticmethod
    def backward(ctx, go):
        return mha_backward(ctx, go)


def ssd_scan_backward(ctx, gy, gs):
    ins = _leaves_for_grad(ctx, ctx.saved_tensors[:5]
                           + ((ctx.saved_tensors[5],) if ctx.has_h0
                              else (None,)))
    with torch.enable_grad():
        y, s = ref.ssd_chunked(*ins[:5], h0=ins[5])
        return tuple(_grads((y, s), ins, (gy, gs)))


class SsdScan(torch.autograd.Function):
    """Kernel #13 forward (y and the final state), the plain version's
    backward (the gradients of x, dt, A, B, C and h0, from those of y
    and of the state)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0):
        ctx.has_h0 = h0 is not None
        ctx.save_for_backward(x, dt, A, B, C,
                              *((h0,) if h0 is not None else ()))
        return _ssd.ssd_scan(*(t.detach() for t in (x, dt, A, B, C)),
                             h0=h0.detach() if h0 is not None else None)

    @staticmethod
    def backward(ctx, gy, gs):
        return ssd_scan_backward(ctx, gy, gs)


def wants_grad(*tensors) -> bool:
    """Grad is enabled and an operand requires it."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)
