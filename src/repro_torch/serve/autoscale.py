"""Queue-driven autoscaling policy for the serving fleet.

SATAY's deployments are reconfigurable by definition — a partial
bitstream away from more or fewer engines — but the serving tier (PR
4/5/7) ran a FIXED replica count: nobody reacted when the diurnal
camera swing doubled the arrival rate or when the trough left half the
fleet idle. ``Autoscaler`` is the missing policy object: a pure
decision function from observable load to a target replica count, kept
deliberately clock-agnostic so the SAME policy is deterministic on the
model clock (tests, BENCH artifacts) and live on the wall clock.

Decision inputs (all on the deployment clock):

* ``queue_depth`` in units of fleet round capacity — ``depth /
  (live * batch_size)`` is how many full service rounds of backlog are
  waiting. Above ``up_backlog_rounds`` → scale up; below
  ``down_backlog_rounds`` (with the p99 healthy) → scale down.
* measured p99 vs ``slo_ms`` — when the deployment's measured p99
  exceeds ``slo_ms * p99_headroom`` the fleet is too slow even if the
  queue looks shallow (slow-replica pileups), so scale up.

The target is clamped to ``[min_replicas, max_replicas]`` ALWAYS — the
property tests hold this invariant over arbitrary input sequences —
and moves one replica per decision (no thundering herds), with
``cooldown_s`` between scaling actions so in-flight effects of the
last action are observable before the next.

The ``Deployment`` applies the decision: spawn goes through its
replica factory (placement + health registration + ``SloAdmission``
ETA sync, exactly the path PR 7's ejection machinery drives);
scale-down retires only an IDLE replica and drains it first, so the
``admitted == completed + expired + failed`` ledger holds through
every scale event.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Autoscaler:
    """Hysteresis thresholds + bounds; ``decide`` is pure given the
    observed inputs and the instance's cooldown state."""

    min_replicas: int = 1
    max_replicas: int = 4
    up_backlog_rounds: float = 1.5      # queue rounds that trigger +1
    down_backlog_rounds: float = 0.25   # queue rounds that allow -1
    p99_headroom: float = 1.0           # p99 > slo_ms*headroom -> +1
    cooldown_s: float = 0.0             # min clock time between actions

    def __post_init__(self):
        self.min_replicas = max(int(self.min_replicas), 1)
        self.max_replicas = max(int(self.max_replicas), self.min_replicas)
        self._last_action_t: float | None = None
        self.decisions = 0
        self.scale_ups = 0
        self.scale_downs = 0

    def decide(self, now: float, *, queue_depth: int, live: int,
               batch_size: int, p99_ms: float | None,
               slo_ms: float | None) -> int:
        """Target replica count for the observed state. Always within
        ``[min_replicas, max_replicas]``; at most one step from
        ``live`` per call; identical inputs (and cooldown history)
        give identical outputs — bit-identical on a model clock."""
        self.decisions += 1
        live = max(int(live), 1)
        target = min(max(live, self.min_replicas), self.max_replicas)
        if self._last_action_t is not None and self.cooldown_s > 0.0 \
                and now - self._last_action_t < self.cooldown_s:
            return target
        rounds = queue_depth / max(live * max(batch_size, 1), 1)
        slow = (p99_ms is not None and slo_ms is not None
                and p99_ms > slo_ms * self.p99_headroom)
        if (rounds > self.up_backlog_rounds or slow) \
                and target < self.max_replicas:
            target += 1
            self.scale_ups += 1
            self._last_action_t = now
        elif rounds < self.down_backlog_rounds and not slow \
                and target > self.min_replicas:
            target -= 1
            self.scale_downs += 1
            self._last_action_t = now
        return target

    def snapshot(self) -> dict:
        return {"min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "decisions": self.decisions,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "last_action_t": self._last_action_t}
