"""Unified serving front-end: one ``Deployment`` over every workload.

SATAY's streaming designs only pay off when frames arrive at the
datapath as fast as the pipeline can drain them (paper §IV-B: the
steady-state interval is worthless if the host feeds the accelerator
synchronously and idles it between batches). System-level scheduling —
not the datapath — is what bounds real-time throughput in deployed FPGA
CNN systems, so the serving layer is structured as three separable
roles that every workload (vision detection, LM decoding) shares:

* **Scheduler** — admission + batch formation. ``FixedBatch`` (FIFO,
  queue-limit back-pressure), ``ContinuousBatch`` (pop up to the
  replica's free capacity — the vLLM-style slot feed), and
  ``SloAdmission`` (per-request deadline, earliest-deadline-first
  reorder, reject at admission when the costed completion estimate
  misses the deadline — the cost defaults to the DSE design report's
  ``batched_latency_ms``, paper §IV-B fill + B·interval).
* **Replica** — one placed copy of a compiled workload.
  ``AcceleratorReplica`` wraps a ``core.toolflow.Accelerator`` with a
  pinned executor backend, parameters copied onto its device, a pinned
  host staging buffer and its own CUDA stream.
* **Deployment** — fans scheduler batches across N replicas with
  double-buffered async prefetch: each replica gets a dedicated
  single-worker dispatch thread (what a real multi-accelerator host
  runs — one feeder per device), so the NEXT batch is assembled
  host-side and copied ahead of dispatch while the device is still
  executing the current one, and N replicas execute concurrently (CUDA
  launches are asynchronous, so the worker overlaps the output copies of
  step k with the device execution of step k+1). Up to ``max_inflight``
  steps queue per replica — the double buffer. With ``prefetch=False``
  every step runs inline and blocks — the old synchronous engine path,
  kept as the ablation baseline.

A torch port of the JAX package's ``serve/deployment.py``. A
tensor-parallel replica (``AcceleratorReplica(device=[d0, d1])``,
``Deployment(tensor_parallel=k)``) serves the float backends; the
quantized ones raise ``NotImplementedError`` there.

Rejections are counted ONCE per request: a request that bounces off a
full queue, drains under back-pressure, and is resubmitted is one
rejected admission, not one per retry (the old engine inflated the
stat on every retry and never surfaced it).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from collections import deque
from concurrent.futures import (FIRST_COMPLETED, Future,
                                ThreadPoolExecutor, wait)
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from ..core import codegen
from ..dist import sharding as sharding_lib
from ..device import cuda_devices, resolve_device
from .autoscale import Autoscaler
from .dispatch import make_dispatch
from .faults import (FaultPlan, FaultyReplica, HealthPolicy, ReplicaCrashed,
                     ReplicaHealth, ReplicaStalled, TransientFault)


@dataclasses.dataclass
class DetectRequest:
    """A single-frame detection request (the vision workload's unit of
    admission). ``slo_ms`` overrides the scheduler's default SLO;
    ``expired`` marks an admitted request dropped at batch formation
    because it could no longer meet its deadline."""
    uid: int
    image: np.ndarray                       # (S, S, C) float32
    outputs: list[np.ndarray] | None = None  # detect-head maps, per scale
    done: bool = False
    slo_ms: float | None = None
    expired: bool = False
    failed: bool = False                    # retry budget exhausted on faults


def _count_rejection(stats: dict, req) -> None:
    """Count a rejection once per request, not once per submit retry.
    Request types that refuse attribute writes (slotted/frozen) fall
    back to an ``id()``-keyed seen-set kept on the stats dict under an
    underscore key — underscore keys are filtered out of every
    snapshot/ledger view, so the count-once contract holds for ALL
    request types without leaking bookkeeping into the stats."""
    if getattr(req, "_rejection_counted", False):
        return
    try:
        req._rejection_counted = True
    except AttributeError:              # slotted/frozen request types
        seen = stats.setdefault("_rejected_seen", set())
        if id(req) in seen:
            return
        seen.add(id(req))
    stats["rejected"] += 1


def _public_stats(stats: dict) -> dict:
    """A scheduler's stats without underscore-keyed bookkeeping."""
    return {k: v for k, v in stats.items()
            if not str(k).startswith("_")}


# --------------------------------------------------------------------------
# Schedulers: admission + batch formation
# --------------------------------------------------------------------------

@runtime_checkable
class Scheduler(Protocol):
    """Admission + batch formation. ``submit`` returns False on
    rejection (back-pressure); ``next_batch(capacity)`` hands the
    deployment up to ``capacity`` requests to run together. ``now`` is
    an injectable clock reading (seconds) so deadline policies are
    testable without wall-time."""
    stats: dict

    def submit(self, req, now: float | None = None) -> bool: ...
    def next_batch(self, capacity: int,
                   now: float | None = None) -> list: ...
    def __len__(self) -> int: ...


class FixedBatch:
    """FIFO admission with queue-limit back-pressure (``None`` =
    unbounded); batches are whatever the replica's static batch size
    asks for (short batches pad at dispatch)."""

    def __init__(self, queue_limit: int | None = 64):
        self.queue_limit = queue_limit
        self.queue: deque = deque()
        self.stats = {"admitted": 0, "rejected": 0}

    def submit(self, req, now: float | None = None) -> bool:
        if self.queue_limit is not None \
                and len(self.queue) >= self.queue_limit:
            _count_rejection(self.stats, req)
            return False
        self.queue.append(req)
        self.stats["admitted"] += 1
        return True

    def next_batch(self, capacity: int, now: float | None = None) -> list:
        n = min(capacity, len(self.queue))
        return [self.queue.popleft() for _ in range(n)]

    def requeue(self, reqs: list, now: float | None = None) -> None:
        """Re-admit requests bounced by a replica fault, at the FRONT
        (they are the oldest work) and WITHOUT admission accounting —
        they were admitted once already; re-counting would break the
        ``admitted == completed + expired + failed`` ledger."""
        self.queue.extendleft(reversed(reqs))

    def __len__(self) -> int:
        return len(self.queue)


class ContinuousBatch(FixedBatch):
    """FixedBatch with an unbounded default — the slot-based
    continuous-batching feed (the LM engine historically accepted
    everything). Batch formation pops exactly as many requests as the
    replica has free slots, so finished slots refill next step with no
    head-of-line blocking."""

    def __init__(self, queue_limit: int | None = None):
        super().__init__(queue_limit=queue_limit)


class SloAdmission:
    """Deadline-aware admission: reject-or-reorder under a latency SLO.

    Each request is stamped ``deadline = arrival + slo_ms`` (the
    request's own ``slo_ms`` attribute wins over the scheduler
    default). At admission the completion time is estimated as the
    number of batches queued ahead — including the request's own —
    times the per-batch step cost; a request whose estimate misses its
    deadline is rejected immediately (back-pressure to the client), so
    the tail latency of ADMITTED requests stays under the SLO by
    construction. The queue is kept in earliest-deadline-first order
    (the "reorder" half), and at batch formation any admitted request
    that can no longer finish one step before its deadline is dropped
    as ``expired`` rather than served late.

    ``step_ms`` is the cost model: ``from_report`` reads it off a
    ``dse.design_report`` dict (``batched_latency_ms`` — the paper's
    §IV-B ``fill + B·interval`` for one admission batch), which is how
    the compile-time DSE prices the serving-time SLO. ``replicas``
    replicas drain that many batches concurrently, so the estimate
    divides the queue's batch count across them (matching the report's
    ``sharded_fps`` linear-scaling claim) — ``Deployment`` passes its
    actual replica count when it builds the default scheduler.

    ``measured_latency`` optionally grounds the model in reality: a
    callable returning the deployment's MEASURED p99 batch latency in
    ms (``Deployment.latency_stats``) or ``None`` while there are too
    few samples. When it returns a number, the per-batch cost used for
    admission and expiry is ``max(step_ms, p99)`` — an analytic
    estimate that turned out optimistic stops admitting requests the
    real fleet cannot serve in time.
    """

    def __init__(self, slo_ms: float, step_ms: float = 1.0, *,
                 batch_size: int = 1, replicas: int = 1,
                 queue_limit: int | None = 256, clock=time.monotonic,
                 measured_latency: Callable[[], float | None] | None = None):
        self.slo_ms = float(slo_ms)
        self.step_ms = float(step_ms)
        self.batch_size = max(int(batch_size), 1)
        self.replicas = max(int(replicas), 1)
        self.queue_limit = queue_limit
        self.clock = clock
        self.measured_latency = measured_latency
        self.queue: list = []           # (deadline, seq, req) heap
        self._seq = itertools.count()
        self.stats = {"admitted": 0, "rejected": 0, "expired": 0}

    @classmethod
    def from_report(cls, report: dict, slo_ms: float, **kw):
        """Cost the admission estimate from a design report: one
        admission batch costs ``batched_latency_ms`` (fill + B·interval,
        paper §IV-B) at the report's ``batch_size`` and ``replicas``."""
        kw.setdefault("batch_size", report.get("batch_size", 1))
        kw.setdefault("replicas", report.get("replicas", 1))
        return cls(slo_ms, step_ms=report["batched_latency_ms"], **kw)

    def _now(self, now: float | None) -> float:
        return self.clock() if now is None else now

    def _step_cost_ms(self) -> float:
        """Model estimate, floored by the measured p99 when wired."""
        if self.measured_latency is not None:
            m = self.measured_latency()
            if m is not None:
                return max(self.step_ms, float(m))
        return self.step_ms

    def submit(self, req, now: float | None = None) -> bool:
        now = self._now(now)
        if self.queue_limit is not None \
                and len(self.queue) >= self.queue_limit:
            _count_rejection(self.stats, req)
            return False
        slo = getattr(req, "slo_ms", None)
        deadline = now + (self.slo_ms if slo is None else slo) / 1e3
        batches_ahead = len(self.queue) // self.batch_size + 1
        rounds = -(-batches_ahead // self.replicas)    # replicas drain
        eta = now + rounds * self._step_cost_ms() / 1e3  # concurrently
        if eta > deadline:
            _count_rejection(self.stats, req)
            return False
        try:                        # remember the admission deadline so a
            req._deadline = deadline    # fault-requeue preserves EDF order
        except AttributeError:
            pass
        heapq.heappush(self.queue, (deadline, next(self._seq), req))
        self.stats["admitted"] += 1
        return True

    def next_batch(self, capacity: int, now: float | None = None) -> list:
        now = self._now(now)
        step_s = self._step_cost_ms() / 1e3
        out: list = []
        while self.queue and len(out) < capacity:
            deadline, _, req = heapq.heappop(self.queue)
            if now + step_s > deadline:
                self.stats["expired"] += 1
                try:
                    req.expired = True
                except AttributeError:
                    pass
                continue                # dropped, never served late
            out.append(req)
        return out

    def requeue(self, reqs: list, now: float | None = None) -> None:
        """Re-admit fault-bounced requests without re-counting
        admission. The deadline stamped at admission is preserved
        (EDF order restores itself on the heap); a request whose
        deadline has passed by now will be expired at the next
        ``next_batch`` — normal expiry accounting, never silent loss."""
        now = self._now(now)
        for req in reqs:
            deadline = getattr(req, "_deadline", None)
            if deadline is None:
                slo = getattr(req, "slo_ms", None)
                deadline = now + (self.slo_ms if slo is None else slo) / 1e3
            heapq.heappush(self.queue, (deadline, next(self._seq), req))

    def __len__(self) -> int:
        return len(self.queue)


# --------------------------------------------------------------------------
# Replicas: one placed copy of a compiled workload
# --------------------------------------------------------------------------

@runtime_checkable
class Replica(Protocol):
    """One worker the deployment dispatches batches to. ``dispatch``
    must NOT block on device results (CUDA launches are async); ``complete``
    blocks and finalises the requests of one in-flight step.
    ``max_inflight`` bounds the per-replica double buffer (stateless
    vision replicas take 2 under prefetch; the stateful LM replica is
    strictly 1 — its KV cache carries between steps)."""
    index: int
    max_inflight: int

    def capacity(self) -> int: ...
    def has_work(self) -> bool: ...
    def dispatch(self, batch: list) -> Any: ...
    def complete(self, handle: Any) -> list: ...


class AcceleratorReplica:
    """A compiled ``Accelerator`` pinned to one torch device and one
    executor backend. Parameters are placed through
    ``dist/sharding.tree_specs`` on a degenerate one-position mesh
    (``sharding.place_replicated``) — the same divisibility-guarded plan
    machinery the launchers use.

    ``device`` may also be a SEQUENCE of devices: the replica then
    spans a tensor-parallel mesh of that many positions (``positions``,
    which may name one device more than once) — parameters are placed
    under ``sharding.conv_tp_plan`` (conv out-channels sharded on the
    ``model`` axis, divisibility-guarded, ``sharding.place_sharded``),
    inputs land on position 0's device, and the executor runs through
    ``codegen.TensorParallel``: each sharded conv once per position,
    then an all-gather. Float backends only: a quantized backend raises
    ``NotImplementedError``.

    On a CUDA device each replica owns a CUDA stream: ``assemble`` copies
    the batch into a pinned host tensor and issues a ``non_blocking``
    host-to-device copy on that stream, ``execute`` runs the step on the
    same stream and records a CUDA event, and ``complete`` synchronises
    that event before copying the outputs to the host. On the CPU every
    step is synchronous."""

    def __init__(self, acc, *, batch_size: int | None = None,
                 device=None, backend: str | None = None, index: int = 0,
                 prefetch: bool = True, step_fn=None, params=None,
                 positions: tuple | None = None):
        self.acc = acc
        self.index = index
        self.batch_size = batch_size or getattr(
            getattr(acc, "cfg", None), "batch_size", None) or 1
        self.backend = backend if backend is not None else getattr(
            getattr(acc, "cfg", None), "backend", None)
        if isinstance(device, (list, tuple)) and len(device) > 1:
            self.devices: list | None = [resolve_device(d) for d in device]
            self.positions = tuple(positions) if positions is not None \
                else tuple(range(len(self.devices)))
            self.device = self.devices[0]   # inputs, replicated streams
            be = codegen.get_backend(self.backend)
            if not isinstance(be, codegen.KernelBackend) \
                    or isinstance(be, codegen.QuantBackend):
                raise NotImplementedError(
                    "a tensor-parallel replica serves the float backends "
                    "only (ROADMAP.md, cuts: quantized tensor parallelism)")
        else:
            if isinstance(device, (list, tuple)):
                device = device[0] if device else None
            self.devices = None
            self.positions = (0,)
            self.device = resolve_device(
                device if device is not None
                else getattr(acc, "torch_device", None))
        if params is None:              # placed copies are shareable per
            params = acc.params         # device — Deployment passes them in
            if self.devices is not None:
                params = sharding_lib.place_sharded(params, self.devices)
            else:
                params = sharding_lib.place_replicated(params, self.device)
        self.params = params
        self._stream = None
        if self.device.type == "cuda":
            # the placement copies ran on the default stream; the
            # replica's stream must not read the params before they land
            for d in self.devices or [self.device]:
                torch.cuda.synchronize(d)
            self._stream = torch.cuda.Stream(self.device)
        if step_fn is None:
            step_fn = step_fn_for(acc, tp_backend(self.backend)
                                  if self.devices else self.backend)
        self._step = step_fn
        self.max_inflight = 2 if prefetch else 1
        self.stats = {"frames": 0, "batches": 0, "padded_slots": 0,
                      "busy_s": 0.0}

    def capacity(self) -> int:
        return self.batch_size

    def has_work(self) -> bool:
        return False                    # stateless: work == queued batches

    def assemble(self, batch: list):
        """Host-side half of a step: stack + pad to the static shape and
        start the copy onto this replica's device. Stateless, so the
        deployment runs it on the CALLER thread — that is the prefetch:
        batch k+1 is assembled while the worker still blocks on k."""
        if not batch:
            return None
        x = np.stack([r.image for r in batch]).astype(np.float32,
                                                      copy=False)
        n_pad = self.batch_size - len(batch)
        if n_pad > 0:                   # static shape: pad the tail
            x = np.concatenate(
                [x, np.zeros((n_pad,) + x.shape[1:], x.dtype)])
        host = torch.from_numpy(x)
        if self._stream is None:
            return (batch, max(n_pad, 0), host.to(self.device))
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        with torch.cuda.stream(self._stream):
            xd = pinned.to(self.device, non_blocking=True)
        return (batch, max(n_pad, 0), xd)

    def execute(self, prepared):
        """Device half: issue the step WITHOUT blocking; on CUDA the
        returned handle carries the event recorded after the step."""
        if prepared is None:
            return None
        batch, n_pad, xd = prepared
        if self._stream is None:
            return (batch, n_pad, self._step(self.params, xd), None)
        with torch.cuda.stream(self._stream):
            outs = self._step(self.params, xd)
            done = torch.cuda.Event()
            done.record(self._stream)
        return (batch, n_pad, outs, done)

    def dispatch(self, batch: list):
        return self.execute(self.assemble(batch))

    def complete(self, handle) -> list:
        """Block on one in-flight step; padded slots are dropped (their
        rows are never copied out)."""
        if handle is None:
            return []
        batch, n_pad, outs, done = handle
        if done is not None:
            done.synchronize()
        host = [o[:len(batch)].cpu().numpy() for o in outs]
        for i, req in enumerate(batch):
            req.outputs = [h[i] for h in host]
            req.done = True
        self.stats["frames"] += len(batch)
        self.stats["batches"] += 1
        self.stats["padded_slots"] += n_pad
        return list(batch)


def make_step_fn(graph, backend=None):
    """One ``(params, x) -> outputs`` executor for ``graph`` with
    ``backend`` pinned, run under ``torch.inference_mode()``. Shared
    across a deployment's replicas."""
    executor = codegen.generate(graph, backend=backend)

    def step(p, x):
        with torch.inference_mode():
            return executor(p, x)
    return step


def tp_backend(backend=None):
    """The tensor-parallel lowering table over ``backend`` (a name or a
    float ``KernelBackend``; None is ``auto``)."""
    return codegen.TensorParallel(codegen.get_backend(backend))


def step_fn_for(acc, backend=None):
    """``make_step_fn`` memoised on the accelerator per backend."""
    cache = getattr(acc, "_step_fns", None)
    if cache is None:
        cache = acc._step_fns = {}
    try:
        fn = cache.get(backend)
        if fn is None:
            fn = cache[backend] = make_step_fn(acc.graph, backend)
        return fn
    except TypeError:                   # unhashable Backend instance
        return make_step_fn(acc.graph, backend)


def _host(x) -> np.ndarray:
    """Logits as float32 numpy (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


class LmReplica:
    """Continuous-batching LM worker: the decode slots + KV cache behind
    the Replica protocol. ``dispatch(admitted)`` prefills the newly
    admitted requests into free slots and issues ONE decode step
    (CUDA launches are async); ``complete`` blocks on the logits,
    samples, and frees finished slots immediately. Stateful, so
    ``max_inflight`` is 1.

    ``device=None`` is ``cuda:0`` (``RuntimeError`` without CUDA); the
    parameters are copied there unless they already live there. Prefill
    and decode run under ``torch.inference_mode()``; the cache's
    ``len`` stays a device tensor that the attention kernels read on
    the card (one small host-to-device copy per step, no host sync).
    A prefilled row's cache leaves (``k``/``v``, with ``kv_bits=8`` int8
    codes and their ``k_s``/``v_s`` scales; or ``conv``/``ssm`` and the
    shared block's ``sk``/``sv``; all layer-stacked) go into the slot at
    ``[:, slot]``, in the slot cache's dtype. Admission passes only the
    tokens to ``prefill``, as the JAX package's does, so a vlm (which
    needs ``embeds``) or encdec (``src_embeds``) model raises
    ``KeyError`` there as it does in the JAX package."""

    max_inflight = 1

    def __init__(self, cfg, params, *, max_batch: int = 4,
                 cache_size: int = 256, seed: int = 0, device=None,
                 index: int = 0):
        from ..models import lm         # deferred: vision path stays light
        self._lm = lm
        self.cfg = cfg
        self.max_batch = max_batch
        self.cache_size = cache_size
        self.index = index
        self.device = resolve_device(device)
        self.params = lm.split_layers(lm.place(params, self.device), cfg)
        self.rng = np.random.default_rng(seed)
        self.slots: list = [None] * max_batch
        with torch.inference_mode():
            self.cache = lm.init_cache(cfg, max_batch, cache_size,
                                       torch.float32, device=self.device)
        self._row_len = np.zeros(max_batch, np.int32)
        self.stats = {"frames": 0, "batches": 0, "padded_slots": 0,
                      "busy_s": 0.0}

    def capacity(self) -> int:
        return sum(s is None for s in self.slots)

    def has_work(self) -> bool:
        return any(s is not None for s in self.slots)

    # ------------------------------------------------------------ internals
    def _prefill1(self, params, batch):
        with torch.inference_mode():
            return self._lm.prefill(params, self.cfg, batch, self.cache_size)

    def _decode(self, params, tokens, cache):
        with torch.inference_mode():
            return self._lm.decode_step(params, self.cfg, tokens, cache)

    def _admit_one(self, req) -> None:
        slot = self.slots.index(None)
        toks = torch.tensor(req.prompt, dtype=torch.int32,
                            device=self.device)[None]
        logits, row_cache = self._prefill1(self.params, {"tokens": toks})
        req.out_tokens.append(self._sample(logits[0], req))
        self._install_row(slot, row_cache, len(req.prompt))
        self.slots[slot] = req

    def _install_row(self, slot: int, row_cache: dict, plen: int) -> None:
        with torch.inference_mode():
            for k, dst in self.cache.items():
                if k == "len":
                    continue
                src = row_cache[k]
                if dst.ndim >= 2 and src.shape[0] == dst.shape[0]:
                    # stacked-layer leaves: batch axis is 1
                    dst[:, slot] = src[:, 0].to(dst.dtype)
                else:
                    dst[slot] = src[0].to(dst.dtype)
        # the prefill-emitted token is NOT in the cache yet: the next
        # decode_step writes it at position `len` (= prompt length)
        self._row_len[slot] = plen
        self._upload_len()

    def _upload_len(self) -> None:
        self.cache["len"] = torch.from_numpy(self._row_len.copy()).to(
            self.device)

    def _sample(self, logits, req) -> int:
        logits = _host(logits)
        if req.temperature <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / req.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    # ------------------------------------------------------------- protocol
    def dispatch(self, admitted: list):
        for req in admitted:
            self._admit_one(req)
        if not self.has_work():
            return None
        last = np.zeros(self.max_batch, np.int32)
        for i, req in enumerate(self.slots):
            if req is not None:
                last[i] = req.out_tokens[-1]
        self._upload_len()
        logits, self.cache = self._decode(
            self.params, torch.from_numpy(last).to(self.device), self.cache)
        return logits                   # not waited for: launches are async

    def complete(self, logits) -> list:
        if logits is None:
            return []
        finished: list = []
        logits_np = _host(logits)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.out_tokens.append(self._sample(logits_np[i], req))
            self._row_len[i] += 1
            full = self._row_len[i] >= self.cache_size - 1
            if len(req.out_tokens) >= req.max_new_tokens or full:
                req.done = True
                finished.append(req)
                self.slots[i] = None
                self._row_len[i] = 0    # slot freed immediately
        self.stats["frames"] += len(finished)
        self.stats["batches"] += 1
        return finished


# --------------------------------------------------------------------------
# Deployment: fan batches across replicas with async prefetch
# --------------------------------------------------------------------------

class _Done:
    """Future-like wrapper for a step that already ran inline. Carries
    either a value or the exception the inline step raised — faults on
    the synchronous (``prefetch=False``) path must flow through the
    same ``_harvest`` fault handling as worker-thread futures."""

    def __init__(self, value=None, exc: BaseException | None = None):
        self._value = value
        self._exc = exc

    def result(self):
        if self._exc is not None:
            raise self._exc
        return self._value

    def done(self) -> bool:
        return True


_MEASURED = object()    # autoscale_tick default: use the measured p99


@dataclasses.dataclass
class _Step:
    """One in-flight dispatch: enough context to retry or fail its
    requests when the future resolves to a fault instead of results."""
    seq: int
    fut: Any
    batch: list
    issued_wall: float                  # time.monotonic() at dispatch
    aborted: bool = False               # watchdog already fired abort()
    probe: bool = False                 # probation probe: EWMA-excluded


class StatsView(dict):
    """The deployment's aggregate counters, as a plain mapping — with
    one extension: CALLING the view (``dep.stats()``) returns the full
    observability snapshot (queue-depth high-water mark, per-replica
    busy fractions, the measured latency window). Existing code that
    indexes ``dep.stats["frames"]`` keeps working unchanged."""

    def __init__(self, data: dict, snapshot):
        super().__init__(data)
        self._snapshot = snapshot

    def __call__(self) -> dict:
        return self._snapshot()


class Deployment:
    """The one serving front-end. Build it from a compiled
    ``Accelerator`` (vision) or from an explicit replica list (any
    workload, e.g. ``LmReplica`` for continuous-batching decode):

        dep = Deployment(acc, replicas=2)                  # vision
        dep = Deployment(replicas=[LmReplica(cfg, params)],
                         scheduler=ContinuousBatch())      # LM

    ``replicas``/``slo_ms``/``batch_size`` default from the
    accelerator's ``CompileConfig`` (``core.toolflow``), so
    ``compile(model, CompileConfig(replicas=2, slo_ms=8.0))`` yields an
    accelerator whose ``Deployment(acc)`` comes up sharded 2-wide
    behind an ``SloAdmission`` scheduler costed from its own design
    report. Replicas round-robin over ``devices`` (default: every CUDA
    device; ``RuntimeError`` without one — pass ``devices=["cpu"]`` for
    the CPU); more replicas than devices is a supported
    fallback — they share devices and still overlap host work with
    device work. With ``tensor_parallel=k`` each replica spans a group
    of k consecutive positions of ``devices`` (groups wrap past its
    end; ``AcceleratorReplica``'s tensor-parallel mesh), and each group
    holds one placed copy of the parameters.

    ``run`` keeps up to ``max_inflight`` steps in flight per replica
    (double-buffered prefetch): every replica owns ONE dispatch-worker
    thread, steps queue on it depth-``max_inflight``, batch k+1 is
    assembled and copied while the device executes batch k.
    The join is PER REPLICA: each replica's in-flight steps are
    harvested the moment its own oldest step completes, so a fleet
    mixing UNEQUAL step times (one float + one quant replica — a mixed
    wordlength fleet) never head-of-line blocks on the slow member: the
    fast replica's buffer frees and it keeps draining the shared queue
    while the slow one is still executing. The returned list stays in
    dispatch order (deterministic), which costs nothing — ordering is
    applied to finished results, not to the joins. ``prefetch=False``
    runs every step inline — the old synchronous engine.

    Per-batch service times (execution start→completion, on ``clock``)
    are recorded per replica; ``latency_stats()`` exposes the measured
    p50/p95/p99 histogram, and ``gate_measured_p99=True`` feeds the
    measured p99 back into the default ``SloAdmission``'s cost model so
    admission stops trusting an optimistic analytic estimate.
    """

    def __init__(self, acc=None, *, replicas=None, scheduler=None,
                 devices=None, backend: str | None = None,
                 prefetch: bool = True, batch_size: int | None = None,
                 slo_ms: float | None = None, queue_limit: int = 64,
                 clock=time.monotonic, gate_measured_p99: bool = False,
                 min_latency_samples: int = 5, latency_window: int = 256,
                 fault_plan: FaultPlan | None = None, retry_budget: int = 2,
                 watchdog_s: float | None = 30.0,
                 health: HealthPolicy | None = None,
                 dispatch=None, autoscaler: Autoscaler | None = None,
                 replica_factory=None, tensor_parallel: int = 1):
        self.prefetch = prefetch
        self._clock = clock
        self._img_shape: tuple[int, ...] | None = None
        # Sliding histogram window: bounded memory on long-lived hosts,
        # O(window) percentile cost on the admission hot path, and old
        # outliers age out instead of poisoning the p99 forever.
        self._latencies: deque = deque(maxlen=int(latency_window))
        self._warmed: set = set()       # replica indices past batch 1
        self.min_latency_samples = int(min_latency_samples)
        self._queue_hwm = 0             # deepest the queue ever got
        self._t_first: float | None = None   # first dispatch (clock)
        self._t_last: float | None = None    # latest harvest (clock)
        cfg = getattr(acc, "cfg", None)
        if isinstance(replicas, (list, tuple)):
            self.replicas: list = list(replicas)
            self.batch_size = batch_size or max(
                r.capacity() for r in self.replicas)
            self._replica_factory = replica_factory
        else:
            if acc is None:
                raise ValueError("Deployment needs an Accelerator or an "
                                 "explicit replica list")
            n = int(replicas or getattr(cfg, "replicas", None) or 1)
            self.batch_size = batch_size or getattr(
                cfg, "batch_size", None) or 1
            devs = [resolve_device(d) for d in devices] \
                if devices is not None else cuda_devices()
            be = backend if backend is not None \
                else getattr(cfg, "backend", None)
            tp = max(int(tensor_parallel), 1)
            step_fn = step_fn_for(acc, tp_backend(be) if tp > 1 else be)
            placed: dict = {}           # one placed param copy per group
            deploy_batch = self.batch_size

            def _make_replica(i: int):
                # replica i spans positions i·tp .. i·tp + tp - 1 of
                # ``devs`` (conv out-channels sharded over the 'model'
                # axis where tp > 1), wrapping past its end
                g = tuple((i * tp + j) % len(devs) for j in range(tp))
                gd = tuple(devs[j] for j in g)
                if gd not in placed:
                    placed[gd] = (
                        sharding_lib.place_sharded(acc.params, list(gd))
                        if len(gd) > 1 else
                        sharding_lib.place_replicated(acc.params, gd[0]))
                return AcceleratorReplica(
                    acc, batch_size=deploy_batch,
                    device=list(gd) if len(gd) > 1 else gd[0],
                    backend=backend, index=i, prefetch=prefetch,
                    step_fn=step_fn, params=placed[gd], positions=g)

            self.replicas = [_make_replica(i) for i in range(n)]
            self._replica_factory = replica_factory or _make_replica
        if slo_ms is None:
            slo_ms = getattr(cfg, "slo_ms", None)
        self.slo_ms = slo_ms
        if scheduler is None:
            measured = self._measured_p99 if gate_measured_p99 else None
            if slo_ms is not None and acc is not None:
                scheduler = SloAdmission.from_report(
                    acc.report, slo_ms, replicas=len(self.replicas),
                    queue_limit=queue_limit, clock=clock,
                    measured_latency=measured)
            elif slo_ms is not None:
                scheduler = SloAdmission(slo_ms, batch_size=self.batch_size,
                                         replicas=len(self.replicas),
                                         queue_limit=queue_limit,
                                         clock=clock,
                                         measured_latency=measured)
            else:
                scheduler = FixedBatch(queue_limit=queue_limit)
        self.scheduler = scheduler
        # ------------------------------------------------ fault tolerance
        # Injection: wrap every replica in the plan's per-index event
        # schedule. Health: one state machine per replica drives
        # dispatch; the retry budget caps how many times a fault may
        # bounce one request before it is marked failed (never lost:
        # admitted == completed + expired + failed).
        if fault_plan is not None:
            self.replicas = [
                FaultyReplica(r, fault_plan.events_for(r.index),
                              clock=clock,
                              watchdog_s=watchdog_s
                              if watchdog_s is not None else 1.0)
                for r in self.replicas]
        self._fault_plan = fault_plan   # reused when autoscaling spawns
        self.retry_budget = max(int(retry_budget), 0)
        self.watchdog_s = None if watchdog_s is None else float(watchdog_s)
        self._policy = health or HealthPolicy()
        self._health = {id(r): ReplicaHealth(self._policy)
                        for r in self.replicas}
        # id(req)-keyed fault-retry counts; popped on completion/failure.
        # (Entries for requests that expire after a requeue linger until
        # overwritten — bounded by the expired count, accepted.)
        self._retry_counts: dict[int, int] = {}
        self._ledger = {"faults": 0, "by_kind": {}, "retries": 0,
                        "redispatched": 0, "failed_requests": 0,
                        "dropped": 0, "ejections": 0, "recoveries": 0,
                        "watchdog_fires": 0, "abandoned_steps": 0}
        self._leaked: list = []         # watchdog-abandoned workers
        # Dispatch policy: throughput-weighted EWMA order by default
        # ("rr" keeps the pre-elastic rotating cursor as the ablation
        # baseline); see serve/dispatch.py.
        self._dispatch = make_dispatch(dispatch)
        # Autoscaler: explicit object, or defaulted from the compile
        # config's elastic knobs (CompileConfig(autoscale=True,
        # min_replicas=, max_replicas=)).
        if autoscaler is None and getattr(cfg, "autoscale", False):
            autoscaler = Autoscaler(
                min_replicas=getattr(cfg, "min_replicas", 1),
                max_replicas=getattr(cfg, "max_replicas", None)
                or max(len(self.replicas),
                       getattr(cfg, "min_replicas", 1)))
        self._autoscaler = autoscaler
        self._retired: list = []        # scaled-down replicas (stats kept)
        self._next_index = 1 + max(
            (r.index for r in self.replicas), default=-1)
        self._scale_events: list = []   # (clock t, live count) on change
        self._des_seq = 0               # step_replica() sequence numbers
        # One dispatch-worker thread per replica: serialises that
        # replica's steps (stateful LM replicas stay correct) while
        # replicas run concurrently and host assembly overlaps device
        # execution. No workers → every step runs inline (synchronous).
        self._workers = {
            id(r): ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"replica{r.index}")
            for r in self.replicas} if prefetch else {}

    # ------------------------------------------------------------------ API
    def submit(self, req, now: float | None = None) -> bool:
        """Admit a request; returns False (back-pressure) on rejection.
        Image requests are checked against the deployment's static
        geometry (the compiled executor serves ONE shape)."""
        img = getattr(req, "image", None)
        if img is not None:
            limit = getattr(self.scheduler, "queue_limit", None)
            if limit is not None and len(self.scheduler) >= limit:
                return self.scheduler.submit(req, now)   # plain reject
            if self._img_shape is not None \
                    and tuple(img.shape) != self._img_shape:
                raise ValueError(
                    f"image shape {img.shape} != deployment shape "
                    f"{self._img_shape} (static geometry)")
        ok = self.scheduler.submit(req, now)
        if ok:
            self._queue_hwm = max(self._queue_hwm, len(self.scheduler))
            if img is not None and self._img_shape is None:
                # latch geometry from ADMITTED requests only — a rejected
                # first frame must not poison the deployment's shape
                self._img_shape = tuple(img.shape)
        return ok

    def run(self, max_steps: int = 10_000,
            max_steps_per_replica: int | None = None) -> list:
        """Serve until the queue and every replica drain (or
        ``max_steps`` dispatches). Returns finished requests in
        dispatch order (deterministic regardless of which replica
        finished first).

        ``max_steps_per_replica`` additionally caps how many batches
        each replica may serve in this call — the discrete-event
        harness uses 1 so one call is one FLEET ROUND whose capacity is
        the number of LIVE replicas (a dead replica's share must not
        silently migrate to the survivor within the same round, or a
        kill would cost nothing in model time).

        The join is per replica: each replica's steps complete FIFO on
        its own worker, and a completed head is harvested immediately —
        a slow replica never blocks a fast one's buffer (the
        heterogeneous-fleet requirement). Only when nothing can be
        dispatched and nothing has completed does the loop block, and
        then on WHICHEVER replica head finishes first, not on a global
        FIFO.

        Replica faults never escape and never hang this loop: a step
        whose future resolves to an exception has its requests retried
        on surviving replicas (up to ``retry_budget`` bounces each,
        then ``failed=True`` — accounted, not lost), the per-replica
        health machine gates dispatch (ejected replicas sit out a
        cooldown, then get ONE probation batch), ``_wait_any`` runs a
        watchdog that aborts — then abandons — a wedged head, and a
        queue stranded with no live capacity is failed out rather than
        spun on."""
        inflight = {id(r): deque() for r in self.replicas}  # _Step queues
        results: dict[int, list] = {}    # dispatch seq → finished reqs
        per = {id(r): 0 for r in self.replicas}   # steps served this call
        seq = steps = 0
        while True:
            progressed = False
            if self._autoscaler is not None:
                self._autoscale_inflight(inflight, per)
            if steps < max_steps:
                now = self._clock()
                for r in self._replica_order():
                    q = inflight[id(r)]
                    if max_steps_per_replica is not None \
                            and per[id(r)] >= max_steps_per_replica:
                        continue
                    if len(q) >= r.max_inflight \
                            or not self._health[id(r)].can_dispatch(now):
                        continue
                    cap = r.capacity()
                    batch = self.scheduler.next_batch(cap) \
                        if cap > 0 else []
                    if not batch and not (r.has_work() and not q):
                        continue
                    q.append(_Step(seq, self._issue(r, batch), batch,
                                   time.monotonic(),
                                   probe=self._health[id(r)].probing(now)))
                    per[id(r)] += 1
                    seq += 1
                    steps += 1
                    progressed = True
                    if steps >= max_steps:
                        break
            if self.prefetch and self._dispatch.steals_enabled \
                    and len(self.scheduler) == 0:
                progressed |= self._steal_tail(inflight)
            harvested = self._harvest(inflight, results)
            if progressed or harvested:
                continue
            if any(inflight.values()):
                self._wait_any(inflight, results)  # block on the FIRST
                continue                 # head to finish, fleet-wide
            if len(self.scheduler) > 0 and steps < max_steps:
                if max_steps_per_replica is not None \
                        and any(n >= max_steps_per_replica
                                for n in per.values()):
                    break                # round budget spent: next round
                # queued work but nothing dispatchable: wait out the
                # nearest cooldown, or fail the stranded queue when no
                # replica can ever come back (liveness over limbo)
                if self._await_capacity():
                    continue
                self._fail_stranded(results, seq)
                seq += 1
            break
        return [req for _, batch in sorted(results.items())
                for req in batch]

    def _finish_step(self, r, step: _Step, results: dict,
                     record_timing: bool = True) -> bool:
        """Resolve ONE completed step: route faults, advance the
        replica's health machine, and (unless the caller charges
        service time itself via ``note_service`` — the model-clock
        harness, where inline steps measure dt=0) account the measured
        duration into busy time, the latency window and the dispatch
        EWMA. Returns True when the step succeeded."""
        try:
            dt, reqs = step.fut.result()
        except Exception as exc:            # noqa: BLE001 — replica fault
            self._on_fault(r, step, exc, results)
            return False
        if self._health[id(r)].on_success():
            self._ledger["recoveries"] += 1
            self._sync_capacity()
        self._t_last = self._clock()
        if record_timing:
            r.stats["busy_s"] = r.stats.get("busy_s", 0.0) + dt
            if r.index in self._warmed:
                self._latencies.append((r.index, dt))
                self._dispatch.record(r.index, dt, probe=step.probe)
            else:
                # Each replica's FIRST batch carries one-off costs
                # (kernel build and load, allocator warm-up), not
                # service time; recording it would wedge
                # a measured-p99 gate (rejected traffic generates
                # no new samples to decay the outlier) and poison
                # the dispatch weight the same way.
                self._warmed.add(r.index)
        for req in reqs:
            self._retry_counts.pop(id(req), None)
        results[step.seq] = reqs
        return True

    def _harvest(self, inflight: dict, results: dict) -> bool:
        """Pop every COMPLETED head step, per replica, without
        blocking. Steps on one replica finish FIFO (single worker), so
        only heads need checking. A head that resolved to an exception
        — injected fault or a real replica bug, any ``Exception`` — is
        routed to fault handling instead of propagating: one bad
        replica must not kill the fleet's serve loop."""
        got = False
        for r in self.replicas:
            q = inflight.get(id(r))
            if q is None:
                continue
            while q and q[0].fut.done():
                self._finish_step(r, q.popleft(), results)
                got = True
        return got

    def _wait_any(self, inflight: dict, results: dict) -> None:
        """Block until SOME replica head completes — but never forever:
        after ``watchdog_s`` with no completion, every head older than
        the watchdog is declared stalled. First strike calls the
        replica's ``abort()`` (a cooperative unwedge — the blocked step
        raises ``ReplicaStalled`` and flows through normal fault
        handling); a head still wedged one watchdog period after its
        abort — or a replica with no ``abort`` — is ABANDONED: its
        requests are retried/failed, its worker is leaked (shut down
        without joining at ``close``), and the replica is dead."""
        heads = [q[0].fut for q in inflight.values() if q]
        real = [f for f in heads if isinstance(f, Future)]
        if len(real) != len(heads) or not real:
            return                          # inline _Done steps: no block
        done, _ = wait(real, timeout=self.watchdog_s,
                       return_when=FIRST_COMPLETED)
        if done or self.watchdog_s is None:
            return
        now_w = time.monotonic()
        for r in list(self.replicas):
            q = inflight[id(r)]
            if not q:
                continue
            step = q[0]
            if not isinstance(step.fut, Future) or step.fut.done():
                continue
            age = now_w - step.issued_wall
            if age < self.watchdog_s:
                continue
            abort = getattr(r, "abort", None)
            if not step.aborted and abort is not None:
                self._ledger["watchdog_fires"] += 1
                step.aborted = True
                abort()
            elif step.aborted and age < 2.0 * self.watchdog_s:
                pass                        # give the abort time to land
            else:
                if not step.aborted:
                    self._ledger["watchdog_fires"] += 1
                self._abandon(r, q, results)

    def _on_fault(self, r, step: _Step, exc: BaseException,
                  results: dict) -> None:
        """One failed step: classify + record it, advance the replica's
        health machine, and retry-or-fail the batch's requests."""
        kind = ("crash" if isinstance(exc, ReplicaCrashed)
                else "stall" if isinstance(exc, ReplicaStalled)
                else "transient" if isinstance(exc, TransientFault)
                else type(exc).__name__)
        led = self._ledger
        led["faults"] += 1
        led["by_kind"][kind] = led["by_kind"].get(kind, 0) + 1
        if isinstance(exc, ReplicaStalled) and not step.aborted:
            # model-clock stalls never pass through the real watchdog
            # in _wait_any; the simulated watchdog verdict counts too
            led["watchdog_fires"] += 1
        h = self._health[id(r)]
        if h.on_fault(self._clock(), fatal=isinstance(exc, ReplicaCrashed),
                      eject=isinstance(exc, ReplicaStalled)):
            led["ejections"] += 1
        self._sync_capacity()
        self._requeue_or_fail(step.batch, step.seq, results)

    def _requeue_or_fail(self, batch: list, seq: int,
                         results: dict) -> None:
        """Route a faulted batch's requests: back onto the scheduler
        (no admission re-count) while each request's retry budget
        lasts, else ``failed=True`` and surfaced in the results — the
        ``admitted == completed + expired + failed`` ledger invariant."""
        retry: list = []
        failed: list = []
        requeue = getattr(self.scheduler, "requeue", None)
        for req in batch:
            n = self._retry_counts.get(id(req), 0)
            if requeue is not None and n < self.retry_budget:
                self._retry_counts[id(req)] = n + 1
                self._ledger["retries"] += 1
                retry.append(req)
            else:
                self._retry_counts.pop(id(req), None)
                try:
                    req.failed = True
                except AttributeError:
                    pass
                self._ledger["failed_requests"] += 1
                failed.append(req)
        if retry:
            requeue(retry)
            self._ledger["redispatched"] += len(retry)
        if failed:
            results[seq] = failed           # surfaced with done=False

    def _abandon(self, r, q: deque, results: dict) -> None:
        """Give up on a wedged replica: account every step stuck on it,
        mark it dead (never dispatched again), and leak its worker —
        ``close()`` shuts the leaked worker down without joining, so a
        genuinely stuck thread cannot hang shutdown either."""
        h = self._health[id(r)]
        if h.on_fault(self._clock(), fatal=True):
            self._ledger["ejections"] += 1
        led = self._ledger
        led["faults"] += 1
        led["by_kind"]["stall"] = led["by_kind"].get("stall", 0) + 1
        self._sync_capacity()
        while q:
            step = q.popleft()
            led["abandoned_steps"] += 1
            self._requeue_or_fail(step.batch, step.seq, results)
        worker = self._workers.pop(id(r), None)
        if worker is not None:
            self._leaked.append(worker)

    def _sync_capacity(self) -> None:
        """Keep the scheduler's ETA model honest as capacity shrinks
        and recovers: ``SloAdmission.replicas`` tracks the LIVE fleet
        (not dead, not sitting out an ejection cooldown), floored at 1
        so the estimate stays finite. Autoscaling spawns/retires flow
        through here too — the same sync path the health machine uses."""
        n = sum(1 for r in self.replicas if self._health[id(r)].live)
        if hasattr(self.scheduler, "replicas"):
            self.scheduler.replicas = max(n, 1)

    def _await_capacity(self) -> bool:
        """Queued work, nothing in flight, nothing dispatchable: sleep
        until the nearest ejected replica's cooldown expires (model
        clocks are advanced deterministically; wall clocks nap and
        re-check). False when no replica can ever come back."""
        now = self._clock()
        nxt = [h.next_available(now) for h in self._health.values()]
        nxt = [t for t in nxt if t is not None]
        if not nxt:
            return False
        target = min(nxt)
        if target <= now:
            return True
        if hasattr(self._clock, "advance"):
            self._clock.advance(target - now)
        else:
            time.sleep(min(target - now, 0.05))
        return True

    def _fail_stranded(self, results: dict, seq: int) -> None:
        """No live capacity will ever serve the queue: drain it through
        the scheduler (its own expiry accounting applies) and fail the
        rest — every admitted request stays accounted."""
        stranded: list = []
        while len(self.scheduler) > 0:
            got = self.scheduler.next_batch(len(self.scheduler))
            if not got:
                break                       # all remaining expired
            stranded.extend(got)
        for req in stranded:
            self._retry_counts.pop(id(req), None)
            try:
                req.failed = True
            except AttributeError:
                pass
            self._ledger["failed_requests"] += 1
        if stranded:
            results[seq] = stranded

    def latency_stats(self) -> dict:
        """Measured per-batch service times (execution start →
        completion on the deployment clock, excluding worker-queue
        wait), fleet-wide over the last ``latency_window`` batches:
        count, mean and p50/p95/p99 in ms. Each replica's first batch
        (one-off warm-up costs) is excluded, and ``None`` percentiles are
        returned until ``min_latency_samples`` batches have completed —
        the measured-p99 admission gate stays silent (model-only) until
        the histogram means something."""
        lat = sorted(t for _, t in self._latencies)
        n = len(lat)
        if n < self.min_latency_samples:
            return {"n": n, "mean_ms": None, "p50_ms": None,
                    "p95_ms": None, "p99_ms": None}

        def pct(p: float) -> float:
            return lat[min(n - 1, int(p / 100.0 * n))] * 1e3

        return {"n": n, "mean_ms": sum(lat) / n * 1e3,
                "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99)}

    def _measured_p99(self) -> float | None:
        return self.latency_stats()["p99_ms"]

    def _issue(self, r, batch: list):
        """Start one step (dispatch → block → finalise requests) on the
        replica's worker thread; inline when prefetch is off. Returns a
        future-like whose ``result()`` is the finished-request list.

        Stateless replicas expose ``assemble``/``execute`` halves: the
        host half (stack + pad + host-to-device copy) runs HERE on the
        caller thread — overlapped with the worker blocking on the
        previous step — and only the device half queues on the worker.
        Stateful replicas (LM: prefill mutates the cache) keep the
        whole step on their worker. The future resolves to
        ``(service_seconds, finished_requests)``: the duration is
        measured ENTIRELY on the worker, start-of-execution to
        completion — not queued-at (depth-2 prefetch would double-count
        the pipelining) and not harvested-at (the main loop may be a
        whole dispatch pass late) — so the measured-p99 admission gate
        sees true per-batch service time."""
        if self._t_first is None:
            self._t_first = self._clock()
        worker = self._workers.get(id(r))
        if worker is None:
            t0 = self._clock()
            try:
                done = r.complete(r.dispatch(batch))
            except Exception as exc:    # noqa: BLE001 — harvested as fault
                return _Done(exc=exc)
            return _Done((self._clock() - t0, done))

        def timed(step):
            def run():
                t0 = self._clock()
                out = step()
                return (self._clock() - t0, out)
            return run

        assemble = getattr(r, "assemble", None)   # stateless split?
        if assemble is not None:
            try:
                prepared = assemble(batch)  # caller thread: the prefetch
            except Exception as exc:    # noqa: BLE001 — harvested as fault
                return _Done(exc=exc)
            return worker.submit(
                timed(lambda: r.complete(r.execute(prepared))))
        return worker.submit(timed(lambda: r.complete(r.dispatch(batch))))

    def run_stream(self, stream, n_batches: int = 1) -> list:
        """Pump ``n_batches`` of an ``ImageStream`` through the
        deployment, draining under back-pressure (the adapter the
        examples/benchmarks drive). A request still rejected after a
        drain stays rejected — deadline-based admission (SloAdmission)
        does not change its verdict on an empty queue, so retrying
        forever would spin."""
        uid = 0
        finished: list = []
        for b in range(n_batches):
            for img in stream.batch_at(b):
                req = DetectRequest(uid=uid, image=np.asarray(img))
                uid += 1
                if not self.submit(req):
                    finished.extend(self.run())
                    if not self.submit(req):
                        # rejected even on an empty queue: surface the
                        # drop (done=False + dropped stat), don't lose it
                        self._ledger["dropped"] += 1
                        finished.append(req)
            finished.extend(self.run())
        return finished

    def close(self) -> None:
        """Join the per-replica dispatch workers. Long-lived hosts that
        build Deployments per model/reconfiguration should close (or
        use the context manager) so idle threads don't accumulate.
        Workers the watchdog abandoned are shut down WITHOUT joining —
        a genuinely wedged thread must not hang shutdown."""
        for w in self._workers.values():
            w.shutdown(wait=True)
        for w in self._leaked:
            w.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def stats(self) -> StatsView:
        """Aggregate per-replica serving counters + scheduler admission
        counters (``rejected`` counts once per request). The returned
        mapping is also CALLABLE — ``dep.stats()`` yields the full
        observability snapshot (queue-depth high-water mark, busy
        fractions, latency window); see ``StatsView``."""
        agg = {"frames": 0, "batches": 0, "padded_slots": 0}
        for r in self.replicas + self._retired:
            for k in agg:               # retired replicas' completed work
                agg[k] += r.stats.get(k, 0)   # stays in the ledger
        sched = self.scheduler.stats
        agg["rejected"] = sched.get("rejected", 0)
        agg["expired"] = sched.get("expired", 0)
        agg["failed"] = self._ledger["failed_requests"]
        agg["dropped"] = self._ledger["dropped"]
        agg["replicas"] = len(self.replicas)
        agg["retired_replicas"] = len(self._retired)
        agg["per_replica_frames"] = [r.stats.get("frames", 0)
                                     for r in self.replicas]
        return StatsView(agg, self._observability_snapshot)

    def _observability_snapshot(self) -> dict:
        """Everything a load harness or dashboard needs in one read:
        the aggregate counters, the scheduler's admission ledger, the
        queue's current/high-water depth, the measured latency window
        (``latency_stats``), and per-replica service accounting — each
        replica's batches/frames plus its busy fraction (cumulative
        measured service time over the deployment's first-dispatch →
        last-harvest window, on the deployment clock)."""
        snap = dict(self.stats)         # the aggregate counters
        snap["admitted"] = self.scheduler.stats.get("admitted", 0)
        snap["scheduler"] = _public_stats(self.scheduler.stats)
        snap["queue_depth"] = len(self.scheduler)
        snap["queue_depth_hwm"] = self._queue_hwm
        snap["latency"] = self.latency_stats()
        # the failure ledger: faults observed, retries/redispatches,
        # ejections/recoveries, watchdog activity, per-replica health
        faults = {k: (dict(v) if isinstance(v, dict) else v)
                  for k, v in self._ledger.items()}
        snap["faults"] = faults
        snap["health"] = {r.index: self._health[id(r)].snapshot()
                          for r in self.replicas}
        # dispatch-policy view: per-replica EWMA weight + steal counts
        # (satellite: benchmarks/tests assert on this directly)
        snap["dispatch"] = self._dispatch.snapshot(self.replicas)
        if self._autoscaler is not None:
            snap["autoscaler"] = self._autoscaler.snapshot()
        snap["scale_events"] = list(self._scale_events)
        snap["retired"] = [{"index": r.index,
                            "batches": r.stats.get("batches", 0),
                            "frames": r.stats.get("frames", 0),
                            "busy_s": r.stats.get("busy_s", 0.0)}
                           for r in self._retired]
        elapsed = None
        if self._t_first is not None and self._t_last is not None:
            elapsed = max(self._t_last - self._t_first, 0.0)
        snap["elapsed_s"] = elapsed
        per = []
        for r in self.replicas:
            busy = r.stats.get("busy_s", 0.0)
            per.append({
                "index": r.index,
                "batches": r.stats.get("batches", 0),
                "frames": r.stats.get("frames", 0),
                "padded_slots": r.stats.get("padded_slots", 0),
                "busy_s": busy,
                "busy_frac": busy / elapsed if elapsed else None,
                "health": self._health[id(r)].state,
                "injected": dict(getattr(r, "injected", None) or {}),
            })
        snap["per_replica"] = per
        return snap

    # ------------------------------------------------------------ internals
    def _replica_order(self) -> list:
        """Dispatch order under the policy (``serve/dispatch.py``).
        Health gates the weights: an ejected or dead replica carries
        weight 0 and sorts last — its only legitimate batch is the
        probation probe ``can_dispatch`` lets through."""
        return self._dispatch.order(
            self.replicas,
            weight_of=lambda r: 1.0 if self._health[id(r)].live else 0.0)

    def dispatch_order(self, now: float | None = None) -> list:
        """Policy dispatch order over the replicas that may take a
        batch NOW (health-gated). The discrete-event harness binds
        free capacity in this order; ``run`` uses the same order."""
        now = self._clock() if now is None else now
        return [r for r in self._replica_order()
                if self._health[id(r)].can_dispatch(now)]

    def _steal_tail(self, inflight: dict) -> bool:
        """Work stealing: with the shared queue EMPTY, an idle replica
        steals the deepest backlog's not-yet-started tail step. Only a
        tail whose future cancels cleanly is stolen — each replica's
        single worker runs steps FIFO, so a cancellable tail provably
        has not begun executing and no batch ever runs twice. The
        re-issue keeps the original dispatch ``seq``: results stay in
        dispatch order, the ledger never notices."""
        now = self._clock()
        idle = [r for r in self.replicas
                if not inflight.get(id(r))
                and self._health[id(r)].can_dispatch(now)]
        if not idle:
            return False
        victim = None
        for r in self.replicas:
            q = inflight.get(id(r))
            if q is not None and len(q) >= 2 and (
                    victim is None or len(q) > len(inflight[id(victim)])):
                victim = r
        if victim is None:
            return False
        q = inflight[id(victim)]
        step = q[-1]
        if not isinstance(step.fut, Future) or not step.fut.cancel():
            return False            # tail already executing: leave it
        q.pop()
        thief = idle[0]
        inflight[id(thief)].append(
            _Step(step.seq, self._issue(thief, step.batch), step.batch,
                  time.monotonic(),
                  probe=self._health[id(thief)].probing(now)))
        self._dispatch.record_steal(thief.index)
        return True

    # --------------------------------------------- elastic fleet operations
    def note_service(self, r, service_s: float, *,
                     probe: bool = False) -> None:
        """Charge a replica's per-batch service time from OUTSIDE the
        worker-side timer. The model-clock discrete-event harness runs
        steps inline (dt measures 0 on a model clock) and computes each
        step's MODELED cost; charging it here keeps the busy fractions,
        the latency window and the dispatch EWMA honest on model time.
        Probes are excluded from the EWMA, exactly like measured ones."""
        r.stats["busy_s"] = r.stats.get("busy_s", 0.0) + service_s
        self._latencies.append((r.index, service_s))
        self._dispatch.record(r.index, service_s, probe=probe)
        self._t_last = self._clock()

    def form_batch(self, r, now: float | None = None) -> list:
        """Pop up to one replica-batch from the scheduler (the DES
        harness binds batches to replicas ahead of executing them)."""
        cap = r.capacity()
        return self.scheduler.next_batch(cap, now) if cap > 0 else []

    def step_replica(self, r, batch: list | None = None,
                     now: float | None = None):
        """Execute ONE step on ``r`` for the discrete-event harness:
        forms a batch when none is bound, runs it through the normal
        issue → fault/health/ledger path, and returns
        ``(finished_requests, ok, probe)`` — ``ok`` False means the
        step faulted (requests were retried or failed, not lost) and
        ``probe`` marks a probation batch the harness must exclude
        when it charges modeled service time via ``note_service``."""
        now = self._clock() if now is None else now
        if batch is None:
            batch = self.form_batch(r, now)
        if not batch and not r.has_work():
            return [], True, False
        probe = self._health[id(r)].probing(now)
        step = _Step(self._des_seq, self._issue(r, batch), batch,
                     time.monotonic(), probe=probe)
        self._des_seq += 1
        results: dict = {}
        ok = self._finish_step(r, step, results, record_timing=False)
        reqs = [req for _, got in sorted(results.items()) for req in got]
        return reqs, ok, probe

    def spawn_replica(self):
        """Scale-up: build one replica through the deployment's
        replica factory (same placement path as construction), wrap it
        in the fault plan's schedule for its NEW index, register its
        health machine + dispatch worker, and sync the scheduler's ETA
        model. Returns the replica, or ``None`` without a factory
        (explicit replica lists opt in by passing one)."""
        if self._replica_factory is None:
            return None
        i = self._next_index
        self._next_index += 1
        r = self._replica_factory(i)
        try:
            r.index = i
        except AttributeError:
            pass
        if self._fault_plan is not None:
            r = FaultyReplica(r, self._fault_plan.events_for(i),
                              clock=self._clock,
                              watchdog_s=self.watchdog_s
                              if self.watchdog_s is not None else 1.0)
        self.replicas.append(r)
        self._health[id(r)] = ReplicaHealth(self._policy)
        if self.prefetch:
            self._workers[id(r)] = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"replica{i}")
        self._sync_capacity()
        self._scale_events.append((self._clock(), len(self.replicas)))
        return r

    def retire_replica(self, r) -> bool:
        """Scale-down: remove an IDLE replica from the dispatch set.
        Its stats move to the retired list — the aggregates keep
        counting its completed frames, so ``admitted == completed +
        expired + failed`` holds through every scale event — and its
        dispatch-estimator state is dropped (the index may be reused
        by a later spawn with different placement). Refuses to retire
        the last replica."""
        if r not in self.replicas or len(self.replicas) <= 1:
            return False
        self.replicas.remove(r)
        self._retired.append(r)
        self._health.pop(id(r), None)
        self._dispatch.forget(r.index)
        worker = self._workers.pop(id(r), None)
        if worker is not None:
            worker.shutdown(wait=True)      # idle: the join is instant
        self._sync_capacity()
        self._scale_events.append((self._clock(), len(self.replicas)))
        return True

    def autoscale_tick(self, now: float | None = None, *,
                       busy_ids: set | frozenset | tuple = (),
                       p99_ms=_MEASURED) -> int:
        """One autoscaler decision, applied: spawn toward a higher
        target, retire an idle live replica toward a lower one (never
        one in ``busy_ids`` — a replica with bound or in-flight work
        is not retirable, so no batch is ever stranded). Returns the
        signed replica-count delta actually applied. ``p99_ms``
        defaults to the deployment's measured p99; the model-clock
        harness passes its own windowed measurement."""
        if self._autoscaler is None:
            return 0
        now = self._clock() if now is None else now
        live = [r for r in self.replicas if self._health[id(r)].live]
        if p99_ms is _MEASURED:
            p99_ms = self.latency_stats()["p99_ms"]
        target = self._autoscaler.decide(
            now, queue_depth=len(self.scheduler), live=len(live),
            batch_size=self.batch_size, p99_ms=p99_ms,
            slo_ms=self.slo_ms)
        if target > len(live):
            return 1 if self.spawn_replica() is not None else 0
        if target < len(live):
            for r in reversed(live):
                if id(r) not in busy_ids and self.retire_replica(r):
                    return -1
        return 0

    def _autoscale_inflight(self, inflight: dict, per: dict) -> None:
        """Run one autoscale decision inside the serve loop, keeping
        the loop's per-replica bookkeeping in step with the fleet:
        spawned replicas get queues/counters, retired replicas (always
        idle — their ``inflight`` queue was empty) drop theirs."""
        busy = {rid for rid, q in inflight.items() if q}
        self.autoscale_tick(busy_ids=busy)
        for r in self.replicas:
            inflight.setdefault(id(r), deque())
            per.setdefault(id(r), 0)
        live = {id(r) for r in self.replicas}
        for rid in [k for k in inflight if k not in live]:
            if not inflight[rid]:
                del inflight[rid]
                per.pop(rid, None)
