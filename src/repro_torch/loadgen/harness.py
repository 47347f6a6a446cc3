"""Open-loop load-generation harness over a multi-replica Deployment.

The closed loop every serving benchmark ran until now (submit a batch,
wait for it, submit the next) measures the server at the server's own
pace — offered load equals service rate by construction, so queueing,
overload and tail latency are invisible. This harness is the open-loop
complement, in the launch / wait / harvest / assert shape of cluster
regression harnesses: **launch** a fresh multi-replica ``Deployment``,
**inject** requests on a pre-computed arrival schedule (a request that
is rejected is dropped on time and NEVER resubmitted — true open loop,
no back-pressure to the generator), **wait** until the horizon passes
and the backlog drains, then **harvest** per-request outcomes into a
``LoadResult``.

Two clocks, one code path:

* ``clock="model"`` — a discrete-event replay on a fake clock. Model
  time advances event-to-event (arrival or service-round completion);
  one fleet-wide service round costs ``step_ms`` of model time (the
  DSE design report's ``batched_latency_ms`` by default — the paper's
  §IV-B ``fill + B·interval``) and serves up to one batch per replica.
  The real executors still run (outputs are real detections),
  but admission, expiry, queueing and latency are all measured on the
  model clock, so results are exactly reproducible: same seed, same
  schedule, same counters, on any machine. This is what tests and the
  BENCH artifact use.
* ``clock="wall"`` — the canary mode: the schedule is replayed against
  the wall clock (sleep until each arrival), service rounds block for
  their real duration, and latency is wall time. Arrivals that come
  due while a round is executing are submitted late; the harness
  records the worst submit lag so the run is honest about its own
  injection jitter.

The saturation sweep (``sweep``) runs one fresh Deployment per offered
load level (counters and the latency window must not leak across
levels; the step function is memoised on the accelerator, so replicas
re-place parameters but never rebuild it) and returns the goodput /
latency / drop curve plus the identified knee.

A torch port of the JAX package's ``loadgen/harness.py``. The one
difference is ``devices``: it is handed to every ``Deployment`` the
harness builds, and ``None`` means every CUDA device, as it does for
``Deployment``. Without CUDA a run then raises ``RuntimeError`` before
it serves a request; pass ``devices=["cpu"]`` to serve on the CPU.
"""
from __future__ import annotations

import time
from collections import deque


from ..data.synthetic import ImageStream
from ..serve import (Autoscaler, Deployment, DetectRequest, FixedBatch,
                     HealthPolicy, SloAdmission)
from .arrival import ArrivalProcess, PoissonArrivals
from .metrics import (LoadResult, find_knee, percentile, summarize,
                      windowed_on_time)

DEFAULT_LEVELS = (0.5, 0.75, 1.0, 1.5, 2.0)   # × fleet capacity


class ModelClock:
    """The injectable fake clock: plain mutable seconds."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class OpenLoopHarness:
    """Drive one compiled accelerator with open-loop offered load.

    ``step_ms`` is the modeled fleet round cost (defaults to the
    accelerator's design report ``batched_latency_ms``); with
    ``replicas`` replicas of ``batch_size`` each, the fleet's nominal
    capacity is ``replicas * batch_size / step_s`` requests/second —
    the x-axis anchor every sweep level is expressed against.

    ``slo_ms`` selects deadline-aware admission (``SloAdmission`` on
    the run's clock — reject at submit when the queue-depth ETA misses
    the deadline, expire at batch formation rather than serve late);
    ``slo_ms=None`` falls back to a FIFO queue with ``queue_limit``
    back-pressure as the only drop mechanism.

    ``fault_plan`` injects a seeded chaos schedule
    (``serve.faults.FaultPlan``) into every run's deployment — on the
    model clock the WHOLE chaos scenario replays bit-identically.
    ``retry_budget`` caps fault re-dispatches per request; the
    deployment watchdog is priced in fleet rounds (``watchdog_steps`` ×
    the modeled step cost), so stall detection scales with the design
    instead of being a wall-time constant.

    ``devices`` is passed to every run's ``Deployment`` (``None``: the
    CUDA devices; ``RuntimeError`` without one).
    """

    def __init__(self, acc, *, replicas: int = 2,
                 batch_size: int | None = None, backend: str | None = None,
                 slo_ms: float | None = None, step_ms: float | None = None,
                 queue_limit: int | None = None, frame_pool: int = 16,
                 seed: int = 0, fault_plan=None, retry_budget: int = 2,
                 watchdog_steps: float = 4.0, health=None,
                 devices=None):
        self.acc = acc
        self.devices = devices
        self.replicas = int(replicas)
        self.fault_plan = fault_plan
        self.retry_budget = int(retry_budget)
        self.watchdog_steps = float(watchdog_steps)
        self.health = health
        cfg = getattr(acc, "cfg", None)
        self.batch_size = int(batch_size or
                              getattr(cfg, "batch_size", None) or 1)
        self.backend = backend
        if step_ms is None:
            step_ms = float(acc.report["batched_latency_ms"])
        self.step_ms = float(step_ms)
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.queue_limit = queue_limit
        # per-request frame geometry = the compiled design's input stream
        img = acc.graph.streams[acc.graph.inputs[0]].shape[0]
        # a small cycled pool of synthetic frames: request uid i carries
        # frame pool[i % frame_pool], so runs of any length reuse a
        # bounded amount of host memory and stay deterministic
        self._frames = list(ImageStream(int(img), batch=frame_pool,
                                        seed=seed).frames(frame_pool))
        self._warmed = False

    # ------------------------------------------------------------ capacity
    @property
    def step_s(self) -> float:
        return self.step_ms / 1e3

    def capacity_rps(self) -> float:
        """Nominal fleet service capacity at the modeled round cost."""
        return self.replicas * self.batch_size / self.step_s

    # ---------------------------------------------------------- deployment
    def _make_deployment(self, clock, *, faults: bool = True,
                         **extra) -> Deployment:
        if self.slo_ms is not None:
            sched = SloAdmission(self.slo_ms, step_ms=self.step_ms,
                                 batch_size=self.batch_size,
                                 replicas=self.replicas,
                                 queue_limit=self.queue_limit, clock=clock)
        else:
            sched = FixedBatch(queue_limit=self.queue_limit
                               if self.queue_limit is not None else 256)
        return Deployment(self.acc, replicas=self.replicas,
                          batch_size=self.batch_size, backend=self.backend,
                          devices=self.devices, scheduler=sched,
                          prefetch=False, clock=clock,
                          fault_plan=self.fault_plan if faults else None,
                          retry_budget=self.retry_budget,
                          watchdog_s=self.watchdog_steps * self.step_s,
                          # cooldown priced in fleet rounds, like the
                          # watchdog: 1s of wall-default would park a
                          # replica for hundreds of model rounds
                          health=self.health
                          or HealthPolicy(cooldown_s=8.0 * self.step_s),
                          **extra)

    def _request(self, arrival) -> DetectRequest:
        return DetectRequest(uid=arrival.uid,
                             image=self._frames[arrival.uid
                                                % len(self._frames)])

    def _warmup(self) -> None:
        """Run one batch before the first wall-clock run, so that it
        does not bill one-off costs (the kernels' build and load, their
        shared-memory opt-in, the pinned staging buffer) to its first
        batch."""
        if self._warmed:
            return
        clock = ModelClock()
        with self._make_deployment(clock, faults=False) as dep:
            for i in range(self.batch_size):
                dep.submit(DetectRequest(uid=i, image=self._frames[0]),
                           now=0.0)
            dep.run()
        self._warmed = True

    # ------------------------------------------------------------- running
    def run(self, process: ArrivalProcess, duration_s: float, *,
            clock: str = "model") -> LoadResult:
        """One open-loop run: inject ``process``'s schedule for
        ``duration_s``, drain, harvest."""
        if clock == "model":
            return self._run_model(process, duration_s)
        if clock == "wall":
            return self._run_wall(process, duration_s)
        raise ValueError(f"clock must be 'model' or 'wall', got {clock!r}")

    def _run_model(self, process: ArrivalProcess,
                   duration_s: float) -> LoadResult:
        """Discrete-event replay on the fake clock. Service rounds are
        fleet-synchronous: whenever the fleet is idle and the queue is
        non-empty, batch formation happens NOW (so ``SloAdmission``
        expiry math sees the true start time), the real executors run
        (instantaneously in model time), and the results materialise
        one ``step_ms`` later on the model clock."""
        clock = ModelClock(0.0)
        arrivals = deque(process.schedule(duration_s, slo_ms=self.slo_ms))
        n_offered = len(arrivals)
        deadlines = {a.uid: a.deadline for a in arrivals}
        t_arr = {a.uid: a.t for a in arrivals}
        completions: list[float] = []
        on_deadline = 0
        rounds = 0
        pending: tuple[float, list] | None = None   # (end_t, finished)
        with self._make_deployment(clock) as dep:
            while arrivals or len(dep.scheduler) or pending:
                if pending is None and len(dep.scheduler) > 0:
                    # one fleet round: each LIVE replica serves at most
                    # one batch (a killed replica's capacity is GONE,
                    # not absorbed by the survivor for free)
                    done = dep.run(max_steps=self.replicas,
                                   max_steps_per_replica=1)
                    pending = (clock.t + self.step_s, done)
                    rounds += 1
                events = []
                if pending is not None:
                    events.append(("round", pending[0]))
                if arrivals:
                    events.append(("arrival", arrivals[0].t))
                if not events:
                    break
                kind, t = min(events, key=lambda e: e[1])
                clock.t = max(clock.t, t)
                if kind == "arrival":
                    a = arrivals.popleft()
                    dep.submit(self._request(a), now=a.t)  # drop-on-time:
                    continue                               # no retry
                end_t, done = pending
                pending = None
                for req in done:
                    if not getattr(req, "done", False):
                        continue        # failed=True: accounted, not served
                    completions.append(end_t - t_arr[req.uid])
                    dl = deadlines[req.uid]
                    if dl is None or end_t <= dl + 1e-9:
                        on_deadline += 1
            snap = dep.stats()
            makespan = clock.t
        util = snap["batches"] / (rounds * self.replicas) if rounds else None
        return summarize(
            offered_rps=process.mean_rate(), duration_s=duration_s,
            makespan_s=makespan,
            n_offered=n_offered, sched_stats=dict(snap["scheduler"]),
            completions_s=completions, on_deadline=on_deadline,
            batches=snap["batches"], utilization=util, clock="model",
            process=process.describe(), failed=snap["failed"],
            extras={"slo_ms": self.slo_ms, "step_ms": self.step_ms,
                    "capacity_rps": self.capacity_rps(),
                    "rounds": rounds,
                    "queue_depth_hwm": snap["queue_depth_hwm"],
                    "faults": snap["faults"]})

    def _run_wall(self, process: ArrivalProcess,
                  duration_s: float) -> LoadResult:
        """Canary replay against the wall clock. Service rounds block
        for their real duration, so arrivals that come due mid-round
        are submitted late — ``max_submit_lag_ms`` records the worst
        injection jitter instead of pretending it away."""
        self._warmup()
        t0 = time.monotonic()
        clock = time.monotonic             # scheduler deadlines: wall time
        arrivals = deque(process.schedule(duration_s, slo_ms=self.slo_ms))
        n_offered = len(arrivals)
        sched_t = {a.uid: a.t for a in arrivals}
        deadlines = {a.uid: a.deadline for a in arrivals}
        completions: list[float] = []
        on_deadline = 0
        rounds = 0
        max_lag = 0.0

        def rel() -> float:
            return time.monotonic() - t0

        with self._make_deployment(clock) as dep:
            def serve_round() -> None:
                nonlocal rounds, on_deadline
                done = dep.run(max_steps=self.replicas,
                               max_steps_per_replica=1)
                rounds += 1
                tc = rel()
                for req in done:
                    if not getattr(req, "done", False):
                        continue        # failed=True: accounted, not served
                    completions.append(tc - sched_t[req.uid])
                    dl = deadlines[req.uid]
                    if dl is None or tc <= dl:
                        on_deadline += 1

            while arrivals:
                wait_s = arrivals[0].t - rel()
                if wait_s <= 0:
                    a = arrivals.popleft()
                    max_lag = max(max_lag, rel() - a.t)
                    dep.submit(self._request(a))      # open loop: no retry
                elif len(dep.scheduler) > 0 and wait_s > self.step_s / 2:
                    serve_round()      # a round fits before the arrival
                else:
                    time.sleep(min(wait_s, 1e-3))
            while len(dep.scheduler) > 0:              # drain the backlog
                serve_round()
            snap = dep.stats()
            makespan = rel()
        util = snap["batches"] / (rounds * self.replicas) if rounds else None
        return summarize(
            offered_rps=process.mean_rate(), duration_s=duration_s,
            makespan_s=makespan,
            n_offered=n_offered, sched_stats=dict(snap["scheduler"]),
            completions_s=completions, on_deadline=on_deadline,
            batches=snap["batches"], utilization=util, clock="wall",
            process=process.describe(), failed=snap["failed"],
            extras={"slo_ms": self.slo_ms, "step_ms": self.step_ms,
                    "capacity_rps": self.capacity_rps(),
                    "rounds": rounds, "max_submit_lag_ms": max_lag * 1e3,
                    "queue_depth_hwm": snap["queue_depth_hwm"],
                    "measured_latency": snap["latency"],
                    "faults": snap["faults"]})

    # --------------------------------------------------------------- sweep
    def sweep(self, *, levels: tuple[float, ...] = DEFAULT_LEVELS,
              duration_s: float | None = None, rounds: int = 32,
              seed: int = 0, clock: str = "model",
              process_for=None) -> tuple[list[LoadResult], dict]:
        """The saturation experiment: one fresh deployment per offered
        load level (``levels`` are multiples of ``capacity_rps()``),
        Poisson arrivals by default (``process_for(rate_rps, seed)``
        overrides). ``duration_s`` defaults to ``rounds`` fleet service
        rounds of model time, so the experiment length scales with the
        modeled step cost rather than being a magic constant. Returns
        the ordered results and the identified knee."""
        if duration_s is None:
            duration_s = rounds * self.step_s
        if process_for is None:
            def process_for(rate_rps, seed):
                return PoissonArrivals(rate=rate_rps, seed=seed)
        results = []
        for lvl in levels:
            proc = process_for(lvl * self.capacity_rps(), seed)
            res = self.run(proc, duration_s, clock=clock)
            res.extras["level"] = lvl
            results.append(res)
        return results, find_knee(results)


class ElasticHarness(OpenLoopHarness):
    """Per-replica discrete-event simulation over an ELASTIC fleet.

    ``OpenLoopHarness._run_model`` is fleet-synchronous — one round
    costs one ``step_ms`` and every live replica serves one batch — so
    it cannot express the two things this PR is about: replicas with
    UNEQUAL modeled service times (a float W16 replica is DDR
    weight-stream-bound at roughly half a quant W8 replica's batched
    fps) and a fleet whose SIZE changes mid-run. This subclass keeps
    the same request/admission/ledger machinery but gives every
    replica its own service clock:

    * each replica executes at most one batch at a time and may hold
      one BOUND (formed, not yet started) batch — the eager double
      buffer a ``max_inflight=2`` deployment really runs. Binding
      follows ``Deployment.dispatch_order`` (the dispatch policy):
      round-robin binds by count and parks batches behind the slow
      replica; weighted binds by measured speed.
    * with the shared queue empty, an idle replica STEALS the deepest
      pending backlog's bound batch (policies opt in via
      ``steals_enabled`` — round-robin, the ablation baseline, does
      not steal).
    * modeled per-batch cost is ``step_ms_by_index[replica.index]``
      (default ``step_ms``), charged through
      ``Deployment.note_service`` so busy fractions, the latency
      window and the dispatch EWMA all see model time (inline steps
      measure dt=0 on a model clock — somebody has to pay).
    * ``autoscale`` (an ``Autoscaler(**kwargs)`` dict, built fresh per
      run) ticks at every event with the harness's windowed p99;
      spawns/retires flow through the deployment's factory path, and a
      replica with bound or executing work is never retired — the
      ``admitted == completed + expired + failed`` ledger holds
      through every scale event.

    Results gain ``windows`` (per-window on-time fractions — the
    time-varying-load verdict ``find_knee`` cannot give), the
    ``dispatch`` snapshot, and the scale-event timeline. Model clock
    only: the wall path already measures real heterogeneity.
    """

    def __init__(self, acc, *, dispatch: str = "weighted",
                 step_ms_by_index: dict | None = None,
                 autoscale: dict | None = None, **kw):
        super().__init__(acc, **kw)
        self.dispatch = dispatch
        self.step_ms_by_index = {int(k): float(v) for k, v in
                                 (step_ms_by_index or {}).items()}
        self.autoscale = dict(autoscale) if autoscale is not None else None

    def capacity_rps(self) -> float:
        """Heterogeneous nominal capacity: each replica contributes its
        own ``batch_size / service_time`` (the homogeneous formula is
        the special case)."""
        svc = [self.step_ms_by_index.get(i, self.step_ms) / 1e3
               for i in range(self.replicas)]
        return self.batch_size * sum(1.0 / s for s in svc)

    def _make_deployment(self, clock, *, faults: bool = True, **extra):
        extra.setdefault("dispatch", self.dispatch)
        extra.setdefault("slo_ms", self.slo_ms)
        if self.autoscale is not None:
            # fresh autoscaler per run: cooldown state and decision
            # counters must not leak across sweep levels
            extra.setdefault("autoscaler", Autoscaler(**self.autoscale))
        return super()._make_deployment(clock, faults=faults, **extra)

    def _svc_s(self, r) -> float:
        return self.step_ms_by_index.get(r.index, self.step_ms) / 1e3

    def run(self, process: ArrivalProcess, duration_s: float, *,
            clock: str = "model", window_s: float | None = None):
        if clock != "model":
            raise ValueError("ElasticHarness is model-clock only "
                             "(use OpenLoopHarness for wall canaries)")
        return self.run_elastic(process, duration_s, window_s=window_s)

    def run_elastic(self, process: ArrivalProcess, duration_s: float, *,
                    window_s: float | None = None) -> LoadResult:
        clock = ModelClock(0.0)
        arrivals = deque(process.schedule(duration_s, slo_ms=self.slo_ms))
        n_offered = len(arrivals)
        deadlines = {a.uid: a.deadline for a in arrivals}
        t_arr = {a.uid: a.t for a in arrivals}
        completions: list[float] = []
        on_deadline = 0
        outcome: list[tuple[float, bool]] = []   # (arrival_t, on_time)
        done_uids: set[int] = set()
        recent: deque = deque(maxlen=32)         # windowed p99 feed
        batches = steals = 0
        with self._make_deployment(clock) as dep:
            executing: dict = {}    # id(r) -> (end_t, finished requests)
            bound: dict = {}        # id(r) -> deque of bound batches
            while True:
                now = clock.t
                # -- autoscale on current observables (windowed p99)
                if self.autoscale is not None:
                    busy = set(executing) | {rid for rid, q
                                             in bound.items() if q}
                    p99 = None
                    if len(recent) >= 5:
                        p99 = percentile(sorted(recent), 99) * 1e3
                    dep.autoscale_tick(now, busy_ids=busy, p99_ms=p99)
                    live = {id(r) for r in dep.replicas}
                    for rid in [k for k in bound
                                if k not in live and not bound[k]]:
                        del bound[rid]      # retired replicas were idle
                # -- bind free slots in dispatch-policy order,
                # breadth-first: every free replica gets one batch
                # before any replica gets its second (the real run()
                # loop's one-batch-per-replica-per-pass shape), so the
                # policy order decides only the CONTESTED batches
                order = dep.dispatch_order(now)
                while len(dep.scheduler) > 0:
                    bound_any = False
                    for r in order:
                        if len(dep.scheduler) == 0:
                            break
                        q = bound.setdefault(id(r), deque())
                        if (1 if id(r) in executing else 0) + len(q) >= 2:
                            continue
                        batch = dep.form_batch(r, now)
                        if not batch:
                            continue        # drained or all expired
                        q.append(batch)
                        bound_any = True
                    if not bound_any:
                        break
                # -- steal: queue empty, idle replica vs pending backlog
                if len(dep.scheduler) == 0 \
                        and dep._dispatch.steals_enabled:
                    for thief in order:
                        if id(thief) in executing or bound.get(id(thief)):
                            continue
                        victim = max(
                            (q for rid, q in bound.items()
                             if q and rid != id(thief)),
                            key=len, default=None)
                        if victim is None:
                            break
                        bound.setdefault(id(thief), deque()).append(
                            victim.popleft())
                        dep._dispatch.record_steal(thief.index)
                        steals += 1
                # -- start execution on every free replica with work
                for r in dep.replicas:
                    q = bound.get(id(r))
                    if id(r) in executing or not q:
                        continue
                    reqs, ok, probe = dep.step_replica(r, q.popleft(), now)
                    dt = self._svc_s(r)
                    executing[id(r)] = (now + dt, reqs)
                    batches += 1
                    if ok:
                        dep.note_service(r, dt, probe=probe)
                # -- next event: earliest completion or next arrival
                ev = []
                if executing:
                    rid_done, (t_done, _) = min(
                        executing.items(), key=lambda kv: kv[1][0])
                    ev.append(("done", t_done))
                if arrivals:
                    ev.append(("arrival", arrivals[0].t))
                if not ev:
                    if len(dep.scheduler) > 0:
                        if dep._await_capacity():
                            continue        # a cooldown will expire
                        dep._fail_stranded({}, 0)   # accounted, not lost
                    break
                kind, t = min(ev, key=lambda e: e[1])
                clock.t = max(clock.t, t)
                if kind == "arrival":
                    a = arrivals.popleft()
                    dep.submit(self._request(a), now=a.t)  # open loop
                    continue
                end_t, reqs = executing.pop(rid_done)
                for req in reqs:
                    if not getattr(req, "done", False):
                        continue    # failed=True: accounted, not served
                    lat = end_t - t_arr[req.uid]
                    completions.append(lat)
                    recent.append(lat)
                    dl = deadlines[req.uid]
                    ok_dl = dl is None or end_t <= dl + 1e-9
                    if ok_dl:
                        on_deadline += 1
                    outcome.append((t_arr[req.uid], ok_dl))
                    done_uids.add(req.uid)
            snap = dep.stats()
            makespan = clock.t
        for uid, ta in t_arr.items():       # everything not completed on
            if uid not in done_uids:        # time is a windowed miss
                outcome.append((ta, False))
        window_s = window_s or 8.0 * self.step_s
        windows = windowed_on_time(outcome, window_s,
                                   duration_s=duration_s)
        return summarize(
            offered_rps=process.mean_rate(), duration_s=duration_s,
            makespan_s=makespan, n_offered=n_offered,
            sched_stats=dict(snap["scheduler"]),
            completions_s=completions, on_deadline=on_deadline,
            batches=snap["batches"], utilization=None, clock="model",
            process=process.describe(), failed=snap["failed"],
            extras={"slo_ms": self.slo_ms, "step_ms": self.step_ms,
                    "step_ms_by_index": dict(self.step_ms_by_index),
                    "capacity_rps": self.capacity_rps(),
                    "dispatch": snap["dispatch"],
                    "steals": steals,
                    "scale_events": list(snap["scale_events"]),
                    "replicas_final": snap["replicas"],
                    "replicas_hwm": max(
                        [n for _, n in snap["scale_events"]]
                        or [snap["replicas"]]),
                    "per_replica_frames": snap["per_replica_frames"],
                    "retired": snap["retired"],
                    "window_s": window_s,
                    "windows": windows,
                    "queue_depth_hwm": snap["queue_depth_hwm"],
                    "faults": snap["faults"]})
