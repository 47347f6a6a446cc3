"""Seeded, clock-agnostic arrival-process generators.

SATAY's deployment regime is *sustained* camera traffic at the edge:
requests arrive on the world's schedule, not the server's. A closed
benchmark loop (submit a batch, wait, submit the next) can never expose
queueing, overload, or tail-latency behaviour, because the offered load
adapts to the service rate by construction. These generators produce
the other half of an OPEN-loop experiment: a fixed schedule of request
timestamps that does not care whether the server keeps up.

Every process is a pure function of its parameters and ``seed`` —
``schedule(duration_s)`` returns the identical arrival list on every
call, on every machine — and emits plain model-time floats (seconds
from epoch 0). Nothing here touches a real clock: the harness decides
whether those timestamps are replayed against a fake model clock
(deterministic tests / CI) or the wall clock (canary runs).

Processes
---------
* ``ConstantArrivals``        — fixed interarrival ``1/rate`` (the
  pathological best case: zero burstiness).
* ``PoissonArrivals``         — i.i.d. exponential interarrivals, the
  standard memoryless open-loop workload model.
* ``DiurnalPoissonArrivals``  — inhomogeneous Poisson whose rate swings
  sinusoidally between ``base_rate`` (trough, at t = 0) and
  ``peak_rate`` once per ``period_s`` (a compressed day), realised by
  thinning a homogeneous ``peak_rate`` stream.
* ``OnOffBurstArrivals``      — Markov-modulated on/off traffic:
  Poisson at ``rate_on`` inside each ``on_s`` window, ``rate_off``
  (default silent) in the ``off_s`` gaps — camera clusters waking
  together.

Each arrival optionally carries an absolute deadline (``t + slo_ms``),
which is how the harness hands per-request SLOs to ``SloAdmission``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: arrival timestamp and optional absolute
    deadline, both in model seconds from epoch 0."""
    uid: int
    t: float
    deadline: float | None = None


class ArrivalProcess:
    """Base: subclasses implement ``_times(duration_s)`` yielding
    monotone timestamps in ``[0, duration_s)``; ``schedule`` wraps them
    into ``Arrival`` records with deadlines."""

    seed: int = 0

    def mean_rate(self) -> float:
        """Long-run offered load in requests/second."""
        raise NotImplementedError

    def _times(self, duration_s: float) -> list[float]:
        raise NotImplementedError

    def schedule(self, duration_s: float, *, slo_ms: float | None = None,
                 start_uid: int = 0) -> list[Arrival]:
        """The full arrival schedule for one run — deterministic per
        (process parameters, seed): calling twice returns the identical
        list."""
        slo_s = None if slo_ms is None else slo_ms / 1e3
        return [Arrival(uid=start_uid + i, t=t,
                        deadline=None if slo_s is None else t + slo_s)
                for i, t in enumerate(self._times(float(duration_s)))]

    def describe(self) -> dict:
        """JSON-able parameter record for benchmark artifacts."""
        d = {"process": type(self).__name__}
        if dataclasses.is_dataclass(self):
            d.update(dataclasses.asdict(self))
        d["mean_rate_rps"] = self.mean_rate()
        return d


@dataclasses.dataclass(frozen=True)
class ConstantArrivals(ArrivalProcess):
    """Deterministic fixed-interval arrivals at ``rate`` req/s (the
    first arrival lands one interarrival in, matching the stochastic
    processes' expected start)."""
    rate: float
    seed: int = 0                       # unused; uniform interface

    def mean_rate(self) -> float:
        return self.rate

    def _times(self, duration_s: float) -> list[float]:
        gap = 1.0 / self.rate
        n = int(math.floor(duration_s / gap + 1e-9))
        return [gap * (i + 1) for i in range(n) if gap * (i + 1) < duration_s]


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process: i.i.d. Exp(rate) interarrivals."""
    rate: float
    seed: int = 0

    def mean_rate(self) -> float:
        return self.rate

    def _times(self, duration_s: float) -> list[float]:
        rng = np.random.default_rng((int(self.seed), 0xA221))
        out, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / self.rate)
            if t >= duration_s:
                return out
            out.append(t)


@dataclasses.dataclass(frozen=True)
class DiurnalPoissonArrivals(ArrivalProcess):
    """Inhomogeneous Poisson with a sinusoidal day: the instantaneous
    rate is ``base`` at t = 0 (trough), ``peak`` at ``period_s / 2``,
    back to ``base`` at ``period_s``. Realised by thinning a
    homogeneous ``peak_rate`` stream (Lewis–Shedler), so the sample
    path is exact, not binned."""
    base_rate: float
    peak_rate: float
    period_s: float
    seed: int = 0

    def __post_init__(self):
        if self.peak_rate < self.base_rate:
            raise ValueError("peak_rate must be >= base_rate")

    def mean_rate(self) -> float:
        return 0.5 * (self.base_rate + self.peak_rate)

    def rate_at(self, t: float) -> float:
        swing = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.period_s))
        return self.base_rate + (self.peak_rate - self.base_rate) * swing

    def _times(self, duration_s: float) -> list[float]:
        rng = np.random.default_rng((int(self.seed), 0xD1E1))
        out, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / self.peak_rate)
            if t >= duration_s:
                return out
            if rng.uniform() * self.peak_rate <= self.rate_at(t):
                out.append(t)


class GroupedArrivals(ArrivalProcess):
    """Capture-group traffic: every event of ``inner`` delivers
    ``group`` simultaneous requests (consecutive uids, same timestamp
    and deadline) — a camera handing the host ``batch_size`` frames
    per capture interval, the workload a batch-B streaming design is
    provisioned for. Grouping matters to DISPATCH benchmarks: with
    single-frame Poisson arrivals a deployment binds fragmented
    1-frame batches whose padding waste swamps any policy effect;
    grouped arrivals keep batches full so the comparison isolates
    replica CHOICE."""

    def __init__(self, inner: ArrivalProcess, group: int):
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        self.inner = inner
        self.group = int(group)
        self.seed = inner.seed

    def mean_rate(self) -> float:
        return self.inner.mean_rate() * self.group

    def _times(self, duration_s: float) -> list[float]:
        return [t for t in self.inner._times(duration_s)
                for _ in range(self.group)]

    def describe(self) -> dict:
        return {"process": type(self).__name__, "group": self.group,
                "inner": self.inner.describe(),
                "mean_rate_rps": self.mean_rate()}


@dataclasses.dataclass(frozen=True)
class OnOffBurstArrivals(ArrivalProcess):
    """On/off burst traffic: alternating ``on_s`` windows of Poisson
    arrivals at ``rate_on`` and ``off_s`` windows at ``rate_off``
    (default silent). The duty cycle is ``on_s / (on_s + off_s)``; the
    long-run mean rate is the duty-weighted average."""
    rate_on: float
    on_s: float
    off_s: float
    rate_off: float = 0.0
    seed: int = 0

    @property
    def duty_cycle(self) -> float:
        return self.on_s / (self.on_s + self.off_s)

    def mean_rate(self) -> float:
        return (self.rate_on * self.on_s + self.rate_off * self.off_s) \
            / (self.on_s + self.off_s)

    def _times(self, duration_s: float) -> list[float]:
        rng = np.random.default_rng((int(self.seed), 0xB125))
        out: list[float] = []
        cycle_start = 0.0
        while cycle_start < duration_s:
            for rate, w0, w1 in (
                    (self.rate_on, cycle_start, cycle_start + self.on_s),
                    (self.rate_off, cycle_start + self.on_s,
                     cycle_start + self.on_s + self.off_s)):
                if rate <= 0.0:
                    continue
                t = w0
                while True:
                    t += rng.exponential(1.0 / rate)
                    if t >= min(w1, duration_s):
                        break
                    out.append(t)
            cycle_start += self.on_s + self.off_s
        return out
