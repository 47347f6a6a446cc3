"""Open-loop run metrics: goodput, latency percentiles, saturation.

Vocabulary (used consistently across the harness, benchmarks and
tests/README.md):

* **offered load** — the arrival process's request rate, independent of
  whether the server keeps up (the open-loop axis).
* **goodput**      — ON-DEADLINE completions per second of the offered
  window. Late completions and drops contribute zero; this is the
  number a real-time detection service actually delivers.
* **saturation curve** — goodput (y) vs offered load (x). Linear at
  low load (everything offered is served), bends at the **knee**, and
  flattens at the service capacity — past the knee added offered load
  only converts to rejections/expiries and queueing latency.
"""
from __future__ import annotations

import dataclasses


def percentile(sorted_vals: list[float], p: float) -> float:
    """Nearest-rank percentile of an ascending list (the same
    convention ``Deployment.latency_stats`` uses)."""
    n = len(sorted_vals)
    if n == 0:
        raise ValueError("percentile of empty list")
    return sorted_vals[min(n - 1, int(p / 100.0 * n))]


def latency_summary(latencies_s: list[float]) -> dict:
    """p50/p95/p99/mean in milliseconds (``None`` when no samples)."""
    lat = sorted(latencies_s)
    if not lat:
        return {"n": 0, "mean_ms": None, "p50_ms": None,
                "p95_ms": None, "p99_ms": None}
    return {
        "n": len(lat),
        "mean_ms": sum(lat) / len(lat) * 1e3,
        "p50_ms": percentile(lat, 50) * 1e3,
        "p95_ms": percentile(lat, 95) * 1e3,
        "p99_ms": percentile(lat, 99) * 1e3,
    }


@dataclasses.dataclass
class LoadResult:
    """Harvested outcome of ONE open-loop run at one offered load."""
    offered_rps: float              # the process's NOMINAL mean rate
    offered_rps_measured: float     # n_offered / duration (the sample)
    duration_s: float               # offered window (model or wall)
    makespan_s: float               # offered window + backlog drain
    n_offered: int                  # requests the schedule injected
    admitted: int
    rejected: int                   # dropped at admission (open loop:
    expired: int                    # never resubmitted) / at formation
    failed: int                     # replica faults, retry budget spent
    completed: int                  # requests that finished execution
    on_deadline: int                # ... and met their deadline
    goodput_rps: float              # on_deadline / makespan — sustained
    on_time_frac: float             # on_deadline / n_offered
    rejected_rate: float            # rejected / max(n_offered, 1)
    latency: dict                   # latency_summary() of completions
    batches: int                    # service batches executed
    utilization: float | None      # served batches / fleet capacity
    clock: str                      # "model" | "wall"
    process: dict                   # arrival.describe()
    extras: dict = dataclasses.field(default_factory=dict)

    def to_row(self) -> dict:
        row = dataclasses.asdict(self)
        row.update(row.pop("extras"))
        return row


def summarize(*, offered_rps: float, duration_s: float,
              makespan_s: float | None, n_offered: int,
              sched_stats: dict, completions_s: list[float],
              on_deadline: int, batches: int,
              utilization: float | None, clock: str,
              process: dict, failed: int = 0,
              extras: dict | None = None) -> LoadResult:
    """Fold raw harvest state into a ``LoadResult``. Goodput divides by
    the MAKESPAN (offered window plus the drain of whatever backlog the
    admission policy allowed to build), not the offered window — drain
    completions would otherwise inflate goodput past the fleet's
    physical capacity on short runs. ``failed`` counts requests a
    replica fault bounced past their retry budget; every admitted
    request lands in exactly one bucket:
    ``admitted == completed + expired + failed``."""
    makespan = max(duration_s, makespan_s or duration_s)
    return LoadResult(
        offered_rps=offered_rps,
        offered_rps_measured=n_offered / duration_s if duration_s else 0.0,
        duration_s=duration_s,
        makespan_s=makespan,
        n_offered=n_offered,
        admitted=sched_stats.get("admitted", 0),
        rejected=sched_stats.get("rejected", 0),
        expired=sched_stats.get("expired", 0),
        failed=int(failed),
        completed=len(completions_s),
        on_deadline=on_deadline,
        goodput_rps=on_deadline / makespan if makespan > 0 else 0.0,
        on_time_frac=on_deadline / max(n_offered, 1),
        rejected_rate=sched_stats.get("rejected", 0) / max(n_offered, 1),
        latency=latency_summary(completions_s),
        batches=batches,
        utilization=utilization,
        clock=clock,
        process=process,
        extras=extras or {},
    )


def monotone_nondecreasing(vals: list[float], tol: float = 0.0) -> bool:
    """True when the sequence never drops by more than ``tol``."""
    return all(b >= a - tol for a, b in zip(vals, vals[1:]))


def windowed_on_time(events: list[tuple[float, bool]],
                     window_s: float,
                     duration_s: float | None = None) -> list[dict]:
    """Per-window on-time fraction for a TIME-VARYING offered load.

    ``find_knee`` assumes monotone offered levels — one on-time
    fraction per level, levels ordered by rate. A diurnal or burst run
    has ONE level whose rate swings inside the window, so a run-wide
    fraction hides exactly the transient the autoscale ramp must be
    judged on. This variant buckets per-request outcomes
    ``(arrival_t, on_time)`` into fixed windows of ``window_s``
    seconds and reports each window's offered count, on-time count and
    fraction — a principled pass criterion for ramp rows: every window
    OUTSIDE declared scale transients must clear the floor, rather
    than the average smearing a bad minute across a good hour.

    Windows with no arrivals report ``on_time_frac=None`` (no
    evidence, not a pass). ``duration_s`` pads trailing empty windows
    so a run that stopped serving early still shows its silence.
    """
    if window_s <= 0.0:
        raise ValueError(f"window_s must be positive, got {window_s}")
    span = max((t for t, _ in events), default=0.0)
    if duration_s is not None:
        span = max(span, duration_s)
    n_win = max(int(span / window_s) + (1 if span % window_s else 0), 1)
    offered = [0] * n_win
    on_time = [0] * n_win
    for t, ok in events:
        i = min(int(t / window_s), n_win - 1)
        offered[i] += 1
        on_time[i] += 1 if ok else 0
    return [{
        "t0_s": i * window_s,
        "t1_s": (i + 1) * window_s,
        "offered": offered[i],
        "on_time": on_time[i],
        "on_time_frac": (on_time[i] / offered[i]) if offered[i] else None,
    } for i in range(n_win)]


def ramp_ok(windows: list[dict], floor: float,
            transient_windows: set[int] | frozenset[int] = frozenset(),
            ) -> bool:
    """True when every NON-EMPTY window outside the declared scale
    transients clears ``floor`` — the autoscale ramp row's verdict."""
    return all(
        w["on_time_frac"] is None or w["on_time_frac"] >= floor
        for i, w in enumerate(windows) if i not in transient_windows)


def find_knee(results: list[LoadResult],
              efficiency_floor: float = 0.9) -> dict:
    """Locate the saturation knee of a sweep (results ordered by
    offered load): the HIGHEST offered load whose ON-TIME FRACTION
    (on-deadline completions / offered requests — robust to the
    Poisson sampling noise a short window puts on the nominal rate)
    still clears ``efficiency_floor``. Past the knee the curve has
    bent — added offered load converts to drops and queueing, not
    goodput. Also reports the goodput peak across the sweep and
    whether the sweep actually drove the fleet past the knee
    (``saturated`` — a sweep whose top level still sits on the linear
    ramp can't claim a knee)."""
    if not results:
        raise ValueError("find_knee needs at least one LoadResult")
    eff = [(r.offered_rps, r.on_time_frac) for r in results]
    linear = [rate for rate, e in eff if e >= efficiency_floor]
    knee_rps = max(linear) if linear else results[0].offered_rps
    peak = max(r.goodput_rps for r in results)
    return {
        "knee_offered_rps": knee_rps,
        "knee_is_top_level": knee_rps == results[-1].offered_rps,
        "saturated": any(e < efficiency_floor for _, e in eff),
        "goodput_peak_rps": peak,
        "efficiency_floor": efficiency_floor,
        "on_time_frac_by_level": [round(e, 4) for _, e in eff],
    }
