"""Deadline telemetry: the ONE place run-time deadline accounting lives.

Every serving surface in this repo enforces the same scheme — a WCET bound
from the compiler pipeline, scaled into wall-clock time by a measured (or
pinned) machine-speed ratio, with a slack factor for host jitter — but it
used to be re-implemented inline by `PredictableEngine.generate` and
`MultiModelEngine.run_hyperperiod`, each with its own calibration and its
own counters.  `DeadlineMonitor` extracts that logic once:

  * **calibration** — the ratio between host wall time and modeled machine
    time is measured on the first real execution (latency / bound) unless
    pinned up front (`speed_ratio=` / `pin()`), so deadline budgets are
    meaningful on any host without configuration;
  * **accounting** — per-network check/miss counters, a bounded latency
    reservoir for percentiles, and log2-bucket latency histograms;
  * **verdicts** — `check()` returns a `DeadlineVerdict` (count-affecting),
    `judge()` the same verdict without touching the counters (used for
    per-request deadlines layered on top of the schedule-level check);
  * **telemetry** — `snapshot()` (machine-readable) and `summary()`
    (human-readable table).

"Designing Neural Networks for Real-Time Systems" (Pearce et al., 2020)
motivates keeping the per-inference deadline verdict a first-class output
rather than a log line; this module is that output's single source.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque


@dataclasses.dataclass(frozen=True)
class DeadlineVerdict:
    """One deadline decision: did this execution meet its budget?

    `response_bound_s` and `deadline_s` are in *modeled machine* seconds
    (the compiler's time base); `latency_s` and `budget_s` are host
    wall-clock seconds — `budget_s = deadline_s * speed_ratio * slack`.

    `outcome` records the terminal disposition of the request the verdict
    belongs to: "served" (it executed; `met` says whether in budget),
    "degraded" (resolved without executing — shed network, open circuit
    breaker, or exhausted retries), or "dropped" (evicted from a bounded
    queue). Non-"served" outcomes always carry `met=False`: a request the
    system declined is by definition not a met deadline.
    """

    network: str
    latency_s: float                 # measured host wall time
    response_bound_s: float          # WCET response bound (model time)
    deadline_s: float                # effective deadline (model time)
    budget_s: float                  # wall-clock budget the latency is held to
    met: bool
    outcome: str = "served"          # "served" | "degraded" | "dropped"

    @property
    def missed(self) -> bool:
        return not self.met


class DeadlineMonitor:
    """Speed-ratio calibration + per-network deadline accounting.

    One monitor instance is shared by everything that times executions of
    the same serving surface, so the calibration is done once and the
    counters compose across networks.
    """

    def __init__(self, speed_ratio: float | None = None,
                 slack_factor: float = 1.5, max_samples: int = 4096):
        self.slack_factor = slack_factor
        self.max_samples = max_samples
        self._ratio = speed_ratio
        self.pinned = speed_ratio is not None    # configured vs measured
        self.checks: dict[str, int] = {}
        self.misses: dict[str, int] = {}
        self._lat: dict[str, deque] = {}
        self._hist: dict[str, dict[int, int]] = {}
        # per-network sustained-occupancy accounting (continuous batching):
        # (sum of occupied slots, observations, slot capacity)
        self._occ: dict[str, list] = {}
        # per-network resilience event counters (sheds, restores, retries,
        # breaker transitions, mode switches, stragglers) — one home, so
        # degraded-mode behavior is first-class telemetry like misses are
        self.events: dict[str, dict[str, int]] = {}
        # rolling met/missed window per network for recent_miss_rate()
        self._met: dict[str, deque] = {}

    # -- calibration ---------------------------------------------------------
    @property
    def speed_ratio(self) -> float | None:
        """Host-seconds per modeled-machine-second; None until calibrated."""
        return self._ratio

    def pin(self, speed_ratio: float | None) -> None:
        """Pin the speed ratio (None re-arms calibration on the next check)."""
        self._ratio = speed_ratio
        self.pinned = speed_ratio is not None

    def calibrate(self, latency_s: float, bound_s: float) -> float:
        """Set the ratio from one real measurement if not already known."""
        if self._ratio is None:
            self._ratio = latency_s / max(bound_s, 1e-12)
        return self._ratio

    def reset(self, *, recalibrate: bool = False) -> None:
        """Zero all counters/histograms (e.g. after a warmup phase).
        recalibrate=True also forgets a measured (not pinned) ratio."""
        self.checks.clear()
        self.misses.clear()
        self._lat.clear()
        self._hist.clear()
        # occupancy accumulators reset with everything else: a stale _occ
        # would blend pre-reset occupancy into post-warmup telemetry
        self._occ.clear()
        self.events.clear()
        self._met.clear()
        if recalibrate and not self.pinned:
            self._ratio = None

    def budget(self, deadline_s: float) -> float | None:
        """Wall-clock budget for a model-time deadline; None if uncalibrated."""
        if self._ratio is None:
            return None
        return deadline_s * self._ratio * self.slack_factor

    # -- verdicts ------------------------------------------------------------
    def judge(self, network: str, latency_s: float, bound_s: float,
              deadline_s: float | None = None) -> DeadlineVerdict:
        """Verdict WITHOUT counting — for per-request deadlines layered on
        top of the schedule-level `check`. Calibrates if needed (against the
        response bound, never the request deadline)."""
        ratio = self.calibrate(latency_s, bound_s)
        deadline = bound_s if deadline_s is None else deadline_s
        budget = deadline * ratio * self.slack_factor
        return DeadlineVerdict(network=network, latency_s=latency_s,
                               response_bound_s=bound_s, deadline_s=deadline,
                               budget_s=budget, met=latency_s <= budget)

    def check(self, network: str, latency_s: float, bound_s: float,
              deadline_s: float | None = None) -> DeadlineVerdict:
        """Count one enforcement check for `network` and return the verdict.

        Default deadline is the WCET response bound itself (the paper's
        enforcement: actual time must stay within the scaled bound)."""
        v = self.judge(network, latency_s, bound_s, deadline_s)
        self.checks[network] = self.checks.get(network, 0) + 1
        if not v.met:
            self.misses[network] = self.misses.get(network, 0) + 1
        lat = self._lat.setdefault(network, deque(maxlen=self.max_samples))
        lat.append(latency_s)
        met = self._met.setdefault(network, deque(maxlen=self.max_samples))
        met.append(v.met)
        bucket = self._bucket(latency_s)
        hist = self._hist.setdefault(network, {})
        hist[bucket] = hist.get(bucket, 0) + 1
        return v

    # -- resilience events ----------------------------------------------------
    def record_event(self, network: str, kind: str, n: int = 1) -> None:
        """Count one resilience event for `network` — "shed", "restore",
        "retry", "breaker_open", "breaker_half_open", "breaker_close",
        "mode_switch", "straggler", ... Free-form kinds compose: the
        counters surface in `snapshot()["events"]` next to the deadline
        accounting, so degraded operation is visible where misses are."""
        per_net = self.events.setdefault(network, {})
        per_net[kind] = per_net.get(kind, 0) + n

    def event_count(self, kind: str, network: str | None = None) -> int:
        """Total count of one event kind (across networks by default)."""
        if network is not None:
            return self.events.get(network, {}).get(kind, 0)
        return sum(per.get(kind, 0) for per in self.events.values())

    # -- occupancy (continuous batching) -------------------------------------
    def record_occupancy(self, network: str, occupied: int,
                         capacity: int) -> None:
        """Record one decode step's slot occupancy for `network`. The mean
        over a window is the *sustained* occupancy the admission story in
        `core.wcet.sustained_occupancy` reasons about — occupancy near 1.0
        with a rising queue means the slot pool is saturated."""
        if not 0 <= occupied <= capacity:
            raise ValueError(f"occupied={occupied} not in [0, {capacity}]")
        acc = self._occ.setdefault(network, [0, 0, capacity])
        acc[0] += occupied
        acc[1] += 1
        acc[2] = capacity

    def mean_occupancy(self, network: str) -> float:
        """Mean occupied-slot fraction over all recorded decode steps."""
        acc = self._occ.get(network)
        if not acc or not acc[1] or not acc[2]:
            return 0.0
        return acc[0] / (acc[1] * acc[2])

    # -- aggregation ---------------------------------------------------------
    def merge(self, other: "DeadlineMonitor") -> "DeadlineMonitor":
        """Fold `other`'s accounting into this monitor (in place).

        Built for cross-replica telemetry (`repro_torch.cluster.ClusterServer`):
        each replica keeps its own monitor, and the fleet snapshot is the
        merge of all of them. Checks/misses/histograms/events add; the
        latency and met/missed reservoirs extend (bounded by this monitor's
        `max_samples`, newest samples win); occupancy sums and observation
        counts add, which keeps `mean_occupancy` the true overall mean.
        Slot capacities must agree when both sides observed a network —
        replicas of the same bundle can't disagree on a slot pool size.
        Calibration: a monitor with no ratio adopts the other's; otherwise
        its own (pinned or measured) ratio is kept. Returns self.
        """
        for name, n in other.checks.items():
            self.checks[name] = self.checks.get(name, 0) + n
        for name, n in other.misses.items():
            self.misses[name] = self.misses.get(name, 0) + n
        for name, vals in other._lat.items():
            lat = self._lat.setdefault(
                name, deque(maxlen=self.max_samples))
            lat.extend(vals)
        for name, flags in other._met.items():
            met = self._met.setdefault(
                name, deque(maxlen=self.max_samples))
            met.extend(flags)
        for name, hist in other._hist.items():
            mine = self._hist.setdefault(name, {})
            for bucket, n in hist.items():
                mine[bucket] = mine.get(bucket, 0) + n
        for name, acc in other._occ.items():
            mine = self._occ.get(name)
            if mine is None:
                self._occ[name] = list(acc)
            else:
                if mine[2] != acc[2]:
                    raise ValueError(
                        f"cannot merge occupancy for {name!r}: slot "
                        f"capacities differ ({mine[2]} vs {acc[2]})")
                mine[0] += acc[0]
                mine[1] += acc[1]
        for name, per in other.events.items():
            mine_ev = self.events.setdefault(name, {})
            for kind, n in per.items():
                mine_ev[kind] = mine_ev.get(kind, 0) + n
        if self._ratio is None and other._ratio is not None:
            self._ratio = other._ratio
        return self

    # -- telemetry -----------------------------------------------------------
    @staticmethod
    def _bucket(latency_s: float) -> int:
        """log2 bucket index over microseconds (bucket b covers
        [2^b, 2^(b+1)) us); 0 collects everything below 1 us."""
        us = latency_s * 1e6
        return max(0, int(math.floor(math.log2(us)))) if us >= 1.0 else 0

    @staticmethod
    def bucket_label(bucket: int) -> str:
        return f"[{2 ** bucket}us,{2 ** (bucket + 1)}us)"

    @staticmethod
    def _percentile(sorted_vals: list[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1,
                  max(0, math.ceil(q * len(sorted_vals)) - 1))
        return sorted_vals[idx]

    def miss_rate(self, network: str) -> float:
        checks = self.checks.get(network, 0)
        return self.misses.get(network, 0) / checks if checks else 0.0

    def recent_miss_rate(self, network: str, window: int = 32) -> float:
        """Miss rate over the last `window` checks of `network` only.

        The cumulative `miss_rate` is sticky — one bad burst dominates it
        long after conditions recover — so hysteretic policies (overload
        shedding, breaker recovery) key off this windowed rate instead."""
        met = self._met.get(network)
        if not met:
            return 0.0
        tail = list(met)[-window:]
        return sum(1 for m in tail if not m) / len(tail)

    def snapshot(self) -> dict:
        """Machine-readable telemetry: calibration + per-network stats."""
        networks = {}
        for name in self.checks.keys() | self._occ.keys():
            vals = sorted(self._lat.get(name, ()))
            networks[name] = {
                "checks": self.checks.get(name, 0),
                "misses": self.misses.get(name, 0),
                "miss_rate": self.miss_rate(name),
                "p50_s": self._percentile(vals, 0.50),
                "p99_s": self._percentile(vals, 0.99),
                "max_s": vals[-1] if vals else 0.0,
                "mean_s": sum(vals) / len(vals) if vals else 0.0,
                "histogram": {self.bucket_label(b): c for b, c in
                              sorted(self._hist.get(name, {}).items())},
            }
            if name in self._occ:
                networks[name]["mean_occupancy"] = self.mean_occupancy(name)
                networks[name]["slot_capacity"] = self._occ[name][2]
        return {"speed_ratio": self._ratio,
                "slack_factor": self.slack_factor,
                "networks": networks,
                "events": {n: dict(per) for n, per in self.events.items()}}

    def summary(self) -> str:
        snap = self.snapshot()
        ratio = snap["speed_ratio"]
        lines = [f"DeadlineMonitor[speed_ratio="
                 f"{'uncalibrated' if ratio is None else f'{ratio:.3g}'}, "
                 f"slack x{self.slack_factor:g}]"]
        for name, s in sorted(snap["networks"].items()):
            occ = (f"  occ={s['mean_occupancy']:.1%}"
                   f"/{s['slot_capacity']} slots"
                   if "mean_occupancy" in s else "")
            lines.append(
                f"  {name:<14} checks={s['checks']:<6} "
                f"misses={s['misses']:<5} ({s['miss_rate']:.1%})  "
                f"p50={s['p50_s'] * 1e3:.3f} ms  "
                f"p99={s['p99_s'] * 1e3:.3f} ms  "
                f"max={s['max_s'] * 1e3:.3f} ms{occ}")
        if len(lines) == 1:
            lines.append("  (no checks recorded)")
        for name, per in sorted(snap["events"].items()):
            pairs = " ".join(f"{k}={v}" for k, v in sorted(per.items()))
            lines.append(f"  {name:<14} events: {pairs}")
        return "\n".join(lines)
