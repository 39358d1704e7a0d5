"""Cross-replica admission/dispatch: the management core's role, lifted
across a replica fleet.

The router is deliberately wall-clock-free and stateless between calls:
every decision is a pure function of the replicas' current
`Server.network_status` dicts, so a run is exactly reproducible (the
deterministic tie-break is part of the contract, not an afterthought).

Replica ranking, per submission for network `n`:

  * a replica is **eligible** when it would actually execute the request:
    not shed, breaker not open, not departing (a staged mode switch that
    drops `n` — submissions routed there would race the drain), and its
    bounded queue not full;
  * eligible replicas are ranked by **WCET headroom** — the network's
    effective deadline minus the response bound scaled by the backlog the
    request would see (`bound * (1 + ceil(depth / slots))` extra
    hyperperiod batches queued ahead of it) — most headroom first, then by
    raw queue depth, then by replica index (the tie-break);
  * with **no** eligible replica, the request goes to the least-loaded
    non-full replica anyway: a shed/open-breaker replica resolves it
    terminally ("degraded") immediately, which preserves the
    every-ticket-terminal invariant instead of erroring the caller;
  * with every queue full, `NoReplicaError` (a `BackpressureError`): the
    cluster is genuinely saturated and the caller owns retry.
"""

from __future__ import annotations

import math

from ..serve.runtime import BackpressureError


class NoReplicaError(BackpressureError):
    """Every replica's bounded queue is full — cluster-wide backpressure."""


class Router:
    """WCET-headroom replica selection over `Server.network_status` dicts.

    `pick` takes the statuses in replica-index order and returns the
    chosen index; `explain` returns the full ranking for telemetry."""

    @staticmethod
    def headroom(status: dict) -> float:
        """Modeled seconds of deadline slack a new request would have on
        this replica, given the backlog already queued ahead of it.
        -inf when the network has no bound there (shed from the report)."""
        bound = status.get("bound_s")
        if bound is None:
            return -math.inf
        slots = max(status.get("slots", 1), 1)
        backlog = math.ceil(status.get("queue_depth", 0) / slots)
        return status["deadline_s"] - bound * (1 + backlog)

    @staticmethod
    def eligible(status: dict) -> bool:
        return (not status.get("shed", False)
                and not status.get("breaker_open", False)
                and not status.get("departing", False)
                and status.get("queue_depth", 0)
                < status.get("queue_capacity", 0))

    @classmethod
    def rank(cls, statuses: list[dict]) -> list[tuple]:
        """Sort key per replica: eligible replicas first, most headroom
        first, shallower queue first, lowest index last word."""
        keys = []
        for idx, s in enumerate(statuses):
            keys.append((not cls.eligible(s), -cls.headroom(s),
                         s.get("queue_depth", 0), idx))
        return sorted(keys)

    @classmethod
    def pick(cls, network: str, statuses: list[dict]) -> int:
        """Index of the replica that should take one request for
        `network`. Raises `NoReplicaError` when every queue is full."""
        if not statuses:
            raise NoReplicaError(f"no replicas to route {network!r} to")
        ranked = cls.rank(statuses)
        ineligible, _, _, best = ranked[0]
        if not ineligible:
            return best
        # nobody would execute it; hand it to the least-loaded replica
        # with queue room so it resolves terminally (degraded) — full
        # queues cannot even do that
        open_slots = [(s.get("queue_depth", 0), idx)
                      for idx, s in enumerate(statuses)
                      if s.get("queue_depth", 0)
                      < s.get("queue_capacity", 0)
                      or s.get("shed", False)
                      or s.get("breaker_open", False)]
        if not open_slots:
            raise NoReplicaError(
                f"all {len(statuses)} replica queues are full for "
                f"{network!r}; cluster saturated")
        return min(open_slots)[1]

    @classmethod
    def explain(cls, network: str, statuses: list[dict]) -> list[dict]:
        """The ranking as telemetry rows (replica, eligible, headroom,
        queue depth), in dispatch-preference order."""
        rows = []
        for ineligible, neg_head, depth, idx in cls.rank(statuses):
            rows.append({"replica": idx, "network": network,
                         "eligible": not ineligible,
                         "headroom_s": -neg_head,
                         "queue_depth": depth})
        return rows
