"""Dispatch policies: which replica gets the next batch.

SATAY's streaming engines only hit their reported interval when the
host keeps every engine fed; with a HETEROGENEOUS fleet (one float +
one quant replica — different measured service times) a blind
round-robin cursor starves the fast member and queues on the slow one.
The ``Deployment`` delegates replica ordering to one of these policy
objects:

* ``RoundRobinDispatch`` — the pre-elastic behaviour, kept as the
  ablation baseline: rotate the starting point so replicas share load
  evenly *by count*, regardless of speed.
* ``WeightedDispatch`` — throughput-weighted: each replica's measured
  per-batch service time (the same worker-side measurement
  ``Deployment.latency_stats`` histograms, first JIT batch excluded)
  is folded into a per-replica EWMA, and dispatch order follows smooth
  weighted round-robin over ``weight = 1 / ewma`` — a replica that is
  2x faster receives ~2x the batches, deterministically (nginx's SWRR:
  no randomness, no starvation). Until a replica has a measurement it
  carries the neutral weight 1.0, so a cold fleet behaves exactly like
  round-robin. Work-stealing rides on top in the deployment: when a
  replica goes idle with an empty shared queue, it steals the deepest
  backlog's not-yet-started tail batch (``steals`` counts them here).

Health composition (PR 7): the deployment multiplies a replica's
weight by 0 when its ``ReplicaHealth`` is ejected or dead, and a
probation probe's service time is NOT recorded — a probe runs after a
cooldown on a possibly-degraded replica and would skew the EWMA the
recovery decision is about to depend on.
"""
from __future__ import annotations


class RoundRobinDispatch:
    """Rotate the dispatch starting point (the pre-elastic ``_rr``
    cursor, as a policy object). Speed-blind by design — the ablation
    baseline the weighted policy is benchmarked against."""

    name = "rr"
    steals_enabled = False

    def __init__(self):
        self._rr = 0
        self.steals: dict[int, int] = {}

    def order(self, replicas: list, weight_of=None) -> list:
        n = len(replicas)
        if n == 0:
            return []
        order = [replicas[(self._rr + i) % n] for i in range(n)]
        self._rr = (self._rr + 1) % n
        return order

    def record(self, index: int, service_s: float, *,
               probe: bool = False) -> None:
        pass                            # speed-blind

    def weight(self, index: int) -> float:
        return 1.0

    def record_steal(self, index: int) -> None:
        self.steals[index] = self.steals.get(index, 0) + 1

    def forget(self, index: int) -> None:
        self.steals.pop(index, None)

    def snapshot(self, replicas: list) -> dict:
        return {
            "policy": self.name,
            "per_replica": {
                r.index: {"weight": 1.0, "ewma_ms": None,
                          "steals": self.steals.get(r.index, 0)}
                for r in replicas},
        }


class WeightedDispatch:
    """Throughput-weighted dispatch: per-replica service-time EWMA →
    smooth weighted round-robin order.

    ``alpha`` is the EWMA update fraction (higher = faster adaptation,
    noisier weight). ``record`` is fed by the deployment from the same
    worker-side measurement as ``latency_stats`` (wall runs) or from
    the harness's modeled per-replica step cost (model-clock runs);
    probation probes are excluded (``probe=True``).

    SWRR (``order``): every replica accumulates ``current += weight``
    each pick; the largest ``current`` is picked and docked by the
    weight total. Deterministic, starvation-free, and the long-run pick
    share of each replica converges to ``weight / sum(weights)``.
    ``weight_of`` lets the caller gate weights externally (health: an
    ejected replica contributes weight 0 and sorts last).
    """

    name = "weighted"
    steals_enabled = True

    def __init__(self, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.ewma_s: dict[int, float] = {}
        self.steals: dict[int, int] = {}
        self._credit: dict[int, float] = {}

    # ------------------------------------------------------------- estimator
    def record(self, index: int, service_s: float, *,
               probe: bool = False) -> None:
        if probe or service_s <= 0.0:
            return                      # probes must not skew the EWMA
        prev = self.ewma_s.get(index)
        self.ewma_s[index] = service_s if prev is None else \
            (1.0 - self.alpha) * prev + self.alpha * service_s

    def weight(self, index: int) -> float:
        """1/EWMA normalised so an UNMEASURED replica's neutral 1.0
        means "as fast as the fleet's fastest measured member" — cold
        replicas get probed promptly rather than starved or flooded."""
        ewma = self.ewma_s.get(index)
        if ewma is None or ewma <= 0.0:
            return 1.0
        fastest = min(self.ewma_s.values())
        return fastest / ewma

    # ----------------------------------------------------------------- order
    def order(self, replicas: list, weight_of=None) -> list:
        """Smooth weighted round-robin over the live weights: ONE SWRR
        advance per call — every replica earns its weight, the largest
        credit becomes the head and pays back the weight total — so
        across calls the head slot interleaves deterministically in
        weight proportion (w=1 vs w=0.5 heads F,S,F,F,S,F,...: the 2x
        faster replica leads 2/3 of the time, the slower one is never
        starved). The tail is the rest by descending credit. Weight-0
        replicas (health-gated) earn nothing and sink to the back —
        still present, because the deployment's own ``can_dispatch``
        gate is the authority on whether they may take a probe batch."""
        if not replicas:
            return []
        w = {}
        for r in replicas:
            wt = self.weight(r.index)
            if weight_of is not None:
                wt *= weight_of(r)
            w[id(r)] = max(wt, 0.0)
        total = sum(w.values())
        if total <= 0.0:
            return list(replicas)
        for r in replicas:
            self._credit[id(r)] = self._credit.get(id(r), 0.0) + w[id(r)]
        head = None
        for r in replicas:                  # first max: deterministic ties
            if head is None or self._credit[id(r)] > \
                    self._credit[id(head)] + 1e-12:
                head = r
        self._credit[id(head)] -= total
        rest = sorted((r for r in replicas if r is not head),
                      key=lambda r: -self._credit[id(r)])  # stable sort
        return [head] + rest

    # ----------------------------------------------------------- bookkeeping
    def record_steal(self, index: int) -> None:
        self.steals[index] = self.steals.get(index, 0) + 1

    def forget(self, index: int) -> None:
        """Drop a retired replica's estimator state (its index may be
        reused by a later spawn with different placement)."""
        self.ewma_s.pop(index, None)
        self.steals.pop(index, None)

    def snapshot(self, replicas: list) -> dict:
        ew = {r.index: self.ewma_s.get(r.index) for r in replicas}
        return {
            "policy": self.name,
            "alpha": self.alpha,
            "per_replica": {
                r.index: {
                    "weight": self.weight(r.index),
                    "ewma_ms": None if ew[r.index] is None
                    else ew[r.index] * 1e3,
                    "steals": self.steals.get(r.index, 0)}
                for r in replicas},
        }


def make_dispatch(policy):
    """Normalise the ``Deployment(dispatch=...)`` knob: a policy
    object passes through; ``"rr"`` / ``"weighted"`` construct one."""
    if policy is None or policy == "weighted":
        return WeightedDispatch()
    if policy == "rr":
        return RoundRobinDispatch()
    if hasattr(policy, "order") and hasattr(policy, "record"):
        return policy
    raise ValueError(f"dispatch must be 'rr', 'weighted' or a policy "
                     f"object, got {policy!r}")
