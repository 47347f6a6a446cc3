"""Deprecated LM serving entry point — a thin shim over the unified
serving API (``serve/deployment.py``), copied from the JAX package's
``serve/engine.py``.

The continuous-batching internals (fixed decode batch of ``max_batch``
slots, per-slot KV cache rows, prefill-into-free-slot admission,
immediate slot reuse) live in ``deployment.LmReplica``; ``Engine`` is
exactly a one-replica ``Deployment`` with a ``ContinuousBatch``
scheduler. New code should construct the Deployment directly:

    Deployment(replicas=[LmReplica(cfg, params, max_batch=4)],
               scheduler=ContinuousBatch())

``device=None`` is ``cuda:0`` and raises without CUDA, as every entry
point of the port does; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..configs.base import ModelCfg
from .deployment import ContinuousBatch, Deployment, LmReplica


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0        # 0 → greedy
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Deprecated shim: continuous batching over static shapes,
    expressed as ``Deployment(LmReplica, ContinuousBatch)``."""

    def __init__(self, cfg: ModelCfg, params: Any, *, max_batch: int = 4,
                 cache_size: int = 256, seed: int = 0, device=None):
        self.cfg = cfg
        self.max_batch = max_batch
        self.cache_size = cache_size
        self._replica = LmReplica(cfg, params, max_batch=max_batch,
                                  cache_size=cache_size, seed=seed,
                                  device=device)
        self.params = self._replica.params
        # prefetch=False: one stateful max_inflight=1 replica is joined
        # right after each dispatch, so a worker thread buys nothing.
        self._dep = Deployment(replicas=[self._replica],
                               scheduler=ContinuousBatch(),
                               prefetch=False)

    # ------------------------------------------------------------------ API
    def submit(self, req: Request) -> None:
        self._dep.submit(req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        return self._dep.run(max_steps)

    def close(self) -> None:
        self._dep.close()

    # Legacy attribute views (the old engine exposed its internals)
    @property
    def queue(self):
        return self._dep.scheduler.queue

    @property
    def slots(self):
        return self._replica.slots

    @property
    def cache(self):
        return self._replica.cache
