"""Deterministic fault injection + replica health for the serving tier.

SATAY's target deployments are always-on edge hosts (autonomous
vehicles, real-time tracking) where an accelerator fault is a routine
operating condition, not an exceptional one: the serving host must
degrade and recover, never crash or hang. This module supplies the two
halves the ``Deployment`` needs for that:

* **Injection** — a seeded ``FaultPlan`` (the same
  ``np.random.default_rng((seed, salt))`` idiom as
  ``loadgen/arrival.py``) compiled into ``FaultyReplica``, a wrapper
  satisfying the ``Replica`` protocol that raises/delays at scheduled
  (replica, step-index or model-time) points. A plan replays
  bit-identically: same seed, same faults, on any machine — which is
  what makes chaos scenarios ratchet-gateable on the model clock.
* **Health** — ``ReplicaHealth``, the per-replica state machine the
  deployment's dispatcher consults: ``healthy`` → ``degraded`` after
  ``degrade_after`` consecutive faults → ``ejected`` after
  ``eject_after`` (or immediately on a crash/stall), with a
  ``cooldown_s`` probation window after which ONE trial batch is
  re-admitted — success recovers the replica, another fault restarts
  the cooldown. A crashed (or watchdog-abandoned) replica is ``dead``:
  never dispatched again.

Fault kinds (``FaultEvent.kind``):

* ``crash``     — the step raises ``ReplicaCrashed`` and the replica is
  dead from then on (every later step raises too).
* ``transient`` — ``burst`` consecutive steps raise ``TransientFault``,
  then the replica serves normally again (a recoverable error burst).
* ``latency``   — ``burst`` consecutive steps take ``delay_s`` longer
  (model clocks are advanced; wall clocks actually sleep). No error is
  raised — the spike surfaces in the measured service histogram.
* ``stall``     — the step never completes on its own. Under a model
  clock the stall is modeled deterministically: the clock advances by
  the watchdog grace and ``ReplicaStalled`` raises (the watchdog
  verdict, replayable). Under a wall clock the step genuinely blocks
  until the deployment's ``_wait_any`` watchdog calls ``abort()`` (or
  a bounded safety timeout expires). Permanent: later probes fail
  fast.

Exceptions deliberately form a small hierarchy (``ReplicaFault``) so
the deployment can classify severity, but the deployment treats ANY
exception escaping a replica step as a fault — a real kernel bug on one
replica must not take down the fleet either.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

FAULT_KINDS = ("crash", "transient", "latency", "stall")

# per-kind rng salts, mirroring loadgen/arrival.py's (seed, salt) idiom
_SALTS = {"crash": 0xFC01, "transient": 0xFC02,
          "latency": 0xFC03, "stall": 0xFC04}


class ReplicaFault(RuntimeError):
    """Base class for injected (and classified) replica step faults."""


class TransientFault(ReplicaFault):
    """A recoverable error burst: the step failed, the replica lives."""


class ReplicaCrashed(ReplicaFault):
    """The replica is permanently dead; no later step can succeed."""


class ReplicaStalled(ReplicaFault):
    """A step that never completed on its own — the watchdog verdict."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault on one replica, anchored either to that
    replica's ``step`` index (0-based dispatch count) or to absolute
    model-time ``t`` (fires at the first step at or after ``t``)."""
    replica: int
    kind: str
    step: int | None = None
    t: float | None = None
    burst: int = 1
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")
        if (self.step is None) == (self.t is None):
            raise ValueError("FaultEvent anchors to exactly one of "
                             "step= or t=")
        if self.burst < 1:
            raise ValueError("burst must be >= 1")
        if self.kind == "latency" and self.delay_s <= 0.0:
            raise ValueError("latency events need delay_s > 0")


class FaultPlan:
    """An immutable, seeded schedule of ``FaultEvent``s across a fleet.

    Build explicitly (``FaultPlan([FaultEvent(replica=0, step=12,
    kind="crash")])``) for scripted scenarios, or ``generate`` a random
    plan — a pure function of its parameters and ``seed``, so the same
    call yields the identical plan on every machine (bit-identical
    chaos replay under the model clock)."""

    def __init__(self, events=(), *, seed: int = 0):
        self.events = tuple(sorted(
            events, key=lambda e: (e.replica,
                                   e.t if e.t is not None else -1.0,
                                   e.step if e.step is not None else -1)))
        self.seed = int(seed)

    def __eq__(self, other):
        return isinstance(other, FaultPlan) and self.events == other.events

    def __hash__(self):
        return hash(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def events_for(self, replica: int) -> list[FaultEvent]:
        return [e for e in self.events if e.replica == replica]

    def describe(self) -> dict:
        """JSON-able record for benchmark artifacts."""
        return {"seed": self.seed, "n_events": len(self.events),
                "events": [dataclasses.asdict(e) for e in self.events]}

    @classmethod
    def generate(cls, seed: int, *, replicas: int, horizon_steps: int,
                 p_transient: float = 0.0, p_latency: float = 0.0,
                 p_crash: float = 0.0, p_stall: float = 0.0,
                 max_burst: int = 3, delay_s: float = 0.01) -> "FaultPlan":
        """Draw a random plan: per (kind, replica, step) Bernoulli at
        the kind's rate, one rng per kind seeded ``(seed, salt)``.
        Crash/stall are terminal, so at most one per replica (the first
        draw wins). Transient bursts draw a length in
        ``[1, max_burst]``; latency spikes draw ``Exp(delay_s)``."""
        events: list[FaultEvent] = []
        for kind, p in (("transient", p_transient), ("latency", p_latency),
                        ("crash", p_crash), ("stall", p_stall)):
            if p <= 0.0:
                continue
            rng = np.random.default_rng((int(seed), _SALTS[kind]))
            for r in range(int(replicas)):
                for k in range(int(horizon_steps)):
                    if rng.random() >= p:
                        continue
                    if kind == "transient":
                        events.append(FaultEvent(
                            replica=r, kind=kind, step=k,
                            burst=1 + int(rng.integers(0, max_burst))))
                    elif kind == "latency":
                        events.append(FaultEvent(
                            replica=r, kind=kind, step=k,
                            delay_s=float(rng.exponential(delay_s))
                            + 1e-6))
                    else:               # crash/stall: terminal, first wins
                        events.append(FaultEvent(replica=r, kind=kind,
                                                 step=k))
                        break
        return cls(events, seed=seed)


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Knobs of the per-replica health state machine."""
    degrade_after: int = 1      # consecutive faults -> degraded
    eject_after: int = 3        # consecutive faults -> ejected
    cooldown_s: float = 1.0     # ejection -> probation re-admit delay


class ReplicaHealth:
    """healthy → degraded → ejected (cooldown, probation) per replica.

    The deployment drives it: ``on_fault`` on every failed step (with
    ``fatal=True`` for crashes, ``eject=True`` for stalls),
    ``on_success`` on every completed one. ``can_dispatch(now)`` is
    what the dispatch loop consults — an ejected replica becomes
    dispatchable again once its cooldown elapses (the probation probe);
    the probe's outcome either recovers it or restarts the cooldown.
    ``dead`` replicas are out of the fleet for good."""

    HEALTHY, DEGRADED, EJECTED = "healthy", "degraded", "ejected"

    def __init__(self, policy: HealthPolicy | None = None):
        self.policy = policy or HealthPolicy()
        self.state = self.HEALTHY
        self.dead = False
        self.faults = 0
        self.consecutive_faults = 0
        self.ejected_at: float | None = None

    def on_success(self) -> bool:
        """Record a completed step; True when this was a probation
        probe succeeding — a RECOVERY."""
        recovered = self.state == self.EJECTED and not self.dead
        self.consecutive_faults = 0
        if not self.dead:
            self.state = self.HEALTHY
            self.ejected_at = None
        return recovered

    def on_fault(self, now: float, *, fatal: bool = False,
                 eject: bool = False) -> bool:
        """Record a failed step; True when a cooldown (re)starts — an
        EJECTION (including a failed probation probe re-ejecting)."""
        self.faults += 1
        self.consecutive_faults += 1
        if fatal:
            self.dead = True
        if (fatal or eject or self.state == self.EJECTED
                or self.consecutive_faults >= self.policy.eject_after):
            self.state = self.EJECTED
            self.ejected_at = now
            return True
        if self.consecutive_faults >= self.policy.degrade_after:
            self.state = self.DEGRADED
        return False

    def can_dispatch(self, now: float) -> bool:
        if self.dead:
            return False
        if self.state != self.EJECTED:
            return True
        return (self.ejected_at is not None
                and now - self.ejected_at >= self.policy.cooldown_s)

    @property
    def live(self) -> bool:
        """Counts toward fleet capacity: not dead, not sitting out an
        ejection cooldown. The deployment's ``_sync_capacity`` (the
        ``SloAdmission`` ETA model) and the autoscaler's notion of
        current fleet size both use THIS — an ejected replica must
        neither admit traffic it can't serve nor block a scale-up that
        would actually restore capacity."""
        return not self.dead and self.state != self.EJECTED

    def probing(self, now: float) -> bool:
        """True when the next dispatched batch would be the probation
        probe (ejected, cooldown elapsed). The weighted dispatcher
        checks this at dispatch time and excludes the probe's service
        time from the EWMA — a probe runs on a possibly-degraded
        replica and must not skew the weight its recovery is about to
        re-enable."""
        return (self.state == self.EJECTED and not self.dead
                and self.can_dispatch(now))

    def next_available(self, now: float) -> float | None:
        """When this replica can next take a batch: ``None`` if never
        (dead), else an absolute clock time (``now`` if already able)."""
        if self.dead:
            return None
        if self.can_dispatch(now):
            return now
        return self.ejected_at + self.policy.cooldown_s

    def snapshot(self) -> dict:
        return {"state": self.state, "dead": self.dead,
                "faults": self.faults,
                "consecutive_faults": self.consecutive_faults,
                "ejected_at": self.ejected_at}


class FaultyReplica:
    """A ``Replica`` wrapper that injects a ``FaultPlan``'s events for
    its inner replica's index. Everything not intercepted forwards to
    the wrapped replica (stats, capacity, the assemble/execute split),
    so the deployment cannot tell the difference until a fault fires.

    Injection happens once per step, at the device half (``execute``
    for split stateless replicas, ``dispatch`` otherwise) — the host
    assemble half never faults, matching the failure domain of a real
    accelerator. ``clock`` decides how time-anchored events and stalls
    behave: a clock with ``advance`` (the model clock) is advanced
    deterministically; a bare wall clock really sleeps/blocks.
    """

    def __init__(self, inner, events, *, clock=None,
                 watchdog_s: float = 1.0, stall_block_s: float | None = None):
        self.inner = inner
        if isinstance(events, FaultPlan):
            events = events.events_for(inner.index)
        self._events = list(events)
        self._clock = clock
        self.watchdog_s = float(watchdog_s)
        # safety valve for real blocking stalls: never wedge a worker
        # longer than this even if no watchdog ever aborts us
        self.stall_block_s = (max(4.0 * self.watchdog_s, 0.5)
                              if stall_block_s is None
                              else float(stall_block_s))
        self._steps = 0
        self._dead = False
        self._stalled = False
        self._latched: dict[int, int] = {}      # event id -> start step
        self._abort = threading.Event()
        self.injected = {k: 0 for k in FAULT_KINDS}
        if not hasattr(inner, "assemble"):
            # hide the split-step protocol when the inner replica is
            # stateful (the deployment probes with getattr)
            self.assemble = None

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    # ------------------------------------------------------------ injection
    def _now(self) -> float | None:
        return None if self._clock is None else self._clock()

    def _active(self, k: int, now: float | None):
        """Events whose fire window covers step ``k`` (time-anchored
        events latch their window at the first step at/after ``t``)."""
        for ev in self._events:
            start = self._latched.get(id(ev))
            if start is None:
                if ev.step is not None and k >= ev.step:
                    start = ev.step
                elif (ev.t is not None and now is not None
                        and now >= ev.t):
                    start = k
                else:
                    continue
                self._latched[id(ev)] = start
            if ev.kind in ("crash", "stall"):
                if k >= start:          # permanent from the start step
                    yield ev
            elif start <= k < start + ev.burst:
                yield ev

    def _fire(self) -> None:
        """Evaluate the plan at the start of one step. Raises the
        step's fault (if any); latency spikes delay and return."""
        k = self._steps
        self._steps += 1
        if self._dead:
            raise ReplicaCrashed(
                f"replica {self.index} is dead (injected)")
        if self._stalled:
            # the watchdog already declared us; probes fail fast
            raise ReplicaStalled(
                f"replica {self.index} is stalled (injected)")
        delay = 0.0
        fire = None
        for ev in self._active(k, self._now()):
            if ev.kind == "latency":
                delay = max(delay, ev.delay_s)
            elif fire is None or ev.kind == "crash":   # crash wins
                fire = ev
        if delay > 0.0:
            self.injected["latency"] += 1
            self._delay(delay)
        if fire is None:
            return
        self.injected[fire.kind] += 1
        if fire.kind == "crash":
            self._dead = True
            raise ReplicaCrashed(
                f"replica {self.index} crashed at step {k} (injected)")
        if fire.kind == "transient":
            raise TransientFault(
                f"replica {self.index} transient fault at step {k} "
                f"(injected)")
        # stall: permanent — model the watchdog deterministically on a
        # model clock, genuinely block until aborted on a wall clock
        self._stalled = True
        if self._clock is not None and hasattr(self._clock, "advance"):
            self._clock.advance(self.watchdog_s)
        else:
            self._abort.wait(timeout=self.stall_block_s)
        raise ReplicaStalled(
            f"replica {self.index} stalled at step {k} (injected)")

    def _delay(self, delay_s: float) -> None:
        if self._clock is not None and hasattr(self._clock, "advance"):
            self._clock.advance(delay_s)
        else:
            time.sleep(delay_s)

    # ------------------------------------------------------------- protocol
    def assemble(self, batch):          # shadowed by None when inner lacks it
        return self.inner.assemble(batch)

    def execute(self, prepared):
        self._fire()
        return self.inner.execute(prepared)

    def dispatch(self, batch):
        if getattr(self, "assemble", None) is not None:
            # split replica: one fire per step, at the device half
            return self.execute(self.inner.assemble(batch))
        self._fire()
        return self.inner.dispatch(batch)

    def complete(self, handle):
        return self.inner.complete(handle)

    def abort(self) -> None:
        """Unwedge a blocking stall (the deployment watchdog calls
        this); the blocked step raises ``ReplicaStalled`` promptly."""
        self._abort.set()
