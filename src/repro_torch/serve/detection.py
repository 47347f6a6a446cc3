"""Deprecated detection entry point — a thin shim over the unified
serving API (``serve/deployment.py``), copied from the JAX package's
``serve/detection.py``.

``DetectionEngine`` is exactly a one-replica ``Deployment`` with a
``FixedBatch`` scheduler and prefetch OFF (dispatch-then-block), with
the historical stats keys (``rejected`` counts once per request). New
code should construct ``Deployment`` directly — ``Deployment(acc,
replicas=N)`` gets multi-replica fan-out and double-buffered prefetch;
``slo_ms=`` swaps in deadline-aware admission.

``DetectRequest`` is re-exported from the deployment module so existing
imports keep working.
"""
from __future__ import annotations

import warnings

from .deployment import Deployment, DetectRequest, FixedBatch  # noqa: F401


class DetectionEngine:
    """Deprecated shim: run a compiled ``core.toolflow.Accelerator``
    over queued images in fixed-size batches (one synchronous replica,
    optionally on an overridden executor ``backend``)."""

    def __init__(self, acc, *, batch_size: int | None = None,
                 queue_limit: int = 64, backend: str | None = None,
                 devices=None):
        warnings.warn(
            "DetectionEngine is deprecated; use "
            "repro_torch.serve.Deployment(acc, ...) — same queue "
            "semantics, plus replicas/prefetch/SLO admission",
            DeprecationWarning, stacklevel=2)
        self.acc = acc
        self.backend = backend
        # Scheduler pinned explicitly: the old engine was FIFO-only, so
        # the shim must NOT inherit an SloAdmission default from the
        # accelerator's CompileConfig(slo_ms=...).
        self._dep = Deployment(acc, replicas=1, batch_size=batch_size,
                               scheduler=FixedBatch(queue_limit=queue_limit),
                               backend=backend, prefetch=False,
                               devices=devices)
        self.batch_size = self._dep.batch_size
        self.queue_limit = queue_limit

    # ------------------------------------------------------------------ API
    def submit(self, req: DetectRequest) -> bool:
        """Admit a request; returns False (back-pressure) when full."""
        return self._dep.submit(req)

    def run(self, max_batches: int = 10_000) -> list[DetectRequest]:
        """Drain the queue in fixed-size batches; returns finished
        requests in completion order."""
        return self._dep.run(max_batches)

    def run_stream(self, stream, n_batches: int = 1) -> list[DetectRequest]:
        """Pump ``n_batches`` of an ImageStream through the engine."""
        return self._dep.run_stream(stream, n_batches)

    def close(self) -> None:
        self._dep.close()

    def latency_stats(self) -> dict:
        """Measured per-batch service percentiles (deployment window)."""
        return self._dep.latency_stats()

    @property
    def queue(self):
        return self._dep.scheduler.queue

    @property
    def stats(self) -> dict:
        """The historical four-counter dict (rejections counted once
        per request, not once per submit retry)."""
        s = self._dep.stats
        return {k: s[k] for k in ("frames", "batches", "padded_slots",
                                  "rejected")}
