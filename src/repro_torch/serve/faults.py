"""Fault injection + recovery for the serving runtime.

The paper's guarantee is conditional: the static schedule bounds response
times *provided every executor call completes within its WCET*. A real
deployment sees the other cases — executor crashes, hung calls, latency
spikes — and a server that merely propagates them loses every queued
request behind the fault. This module gives `repro_torch.serve.Server` the
recovery half of `train/fault.py`'s story (same `InjectedFailure`, same
`StragglerWatchdog`), applied to serving:

  * `FaultPlan` / `FaultInjector` — a *seeded* plan of injected faults
    ("fail" raises `InjectedFailure`, "timeout" raises `InjectedTimeout`,
    "spike" inflates the measured latency), drawn one decision per
    executor call in a deterministic order, so a chaos run is exactly
    reproducible from its seed (the `chaos` tests rely on this). A
    raising fault raises before the executor runs, so no device state
    changes and a retry re-runs the same call on the same device;
  * `RetryPolicy` — bounded retry-with-backoff per serving job: transient
    faults are retried inside the job before any ticket is given up on;
  * `CircuitBreaker` — per-network closed -> open (after N *consecutive*
    failed jobs) -> half-open (after a cooldown measured in job releases,
    deterministic under test) -> closed on a successful probe. While
    open, the network operates degraded: its requests resolve immediately
    with a degraded `DeadlineVerdict` instead of queueing behind a broken
    executor. Every transition is counted in `DeadlineMonitor.events`.

Cooldown is measured in *job releases* of the broken network, not wall
time: the hyperperiod program is the server's clock, which keeps breaker
behavior identical across host speeds — the same determinism argument the
WCET machinery makes for deadlines.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..train.fault import InjectedFailure, StragglerReport, StragglerWatchdog
from .monitor import DeadlineMonitor

__all__ = ["FaultPlan", "FaultInjector", "InjectedFailure",
           "InjectedTimeout", "RetryPolicy", "CircuitBreaker",
           "BreakerPolicy", "StragglerReport", "StragglerWatchdog"]


class InjectedTimeout(InjectedFailure):
    """An injected hung executor call (the watchdog-timeout flavor)."""


# -- seeded fault plans -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded description of the faults to inject into executor calls.

    Per call, ONE uniform draw partitions [0, 1) into fail / timeout /
    spike / healthy ranges, so rates compose and the whole injection
    sequence is a pure function of `seed` and the call order. `networks`
    restricts injection to the named networks (None injects everywhere) —
    chaos scenarios typically fault the low-criticality networks and
    assert the high-criticality ones stay clean.
    """

    seed: int = 0
    fail_rate: float = 0.0               # raise InjectedFailure
    timeout_rate: float = 0.0            # raise InjectedTimeout
    spike_rate: float = 0.0              # inflate measured latency
    spike_factor: float = 8.0            # dt multiplier for "spike" draws
    networks: tuple[str, ...] | None = None

    def __post_init__(self):
        for name in ("fail_rate", "timeout_rate", "spike_rate"):
            rate = getattr(self, name)
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        total = self.fail_rate + self.timeout_rate + self.spike_rate
        if total > 1.0:
            raise ValueError(f"fault rates sum to {total} > 1")
        if self.spike_factor < 1.0:
            raise ValueError(f"spike_factor must be >= 1, "
                             f"got {self.spike_factor}")

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)


class FaultInjector:
    """Draws the plan's faults, one decision per executor call."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self.injected = {"fail": 0, "timeout": 0, "spike": 0}

    def draw(self, network: str) -> str | None:
        """The fault (if any) for this call: "fail", "timeout", "spike",
        or None. Networks outside the plan never consume a draw, so
        adding a healthy network does not perturb the fault sequence."""
        plan = self.plan
        if plan.networks is not None and network not in plan.networks:
            return None
        u = float(self._rng.random())
        if u < plan.fail_rate:
            kind = "fail"
        elif u < plan.fail_rate + plan.timeout_rate:
            kind = "timeout"
        elif u < plan.fail_rate + plan.timeout_rate + plan.spike_rate:
            kind = "spike"
        else:
            return None
        self.injected[kind] += 1
        return kind

    def before_call(self, network: str) -> str | None:
        """Apply one draw at an executor-call site: raising faults raise
        here; a "spike" is returned for the caller to inflate its measured
        latency by `plan.spike_factor`."""
        kind = self.draw(network)
        if kind == "fail":
            raise InjectedFailure(f"injected executor failure ({network})")
        if kind == "timeout":
            raise InjectedTimeout(f"injected executor timeout ({network})")
        return kind


# -- bounded retry ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-backoff for one serving job.

    A job attempts at most `1 + max_retries` executions; retry k waits
    `backoff_s * backoff_factor**(k-1)` host seconds first (0 by default —
    the serving loop is synchronous, so tests and benchmarks keep backoff
    at zero and only the retry *count* matters)."""

    max_retries: int = 2
    backoff_s: float = 0.0
    backoff_factor: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")

    def backoff(self, retry: int) -> float:
        """Backoff before the retry-th re-attempt (retry >= 1)."""
        return self.backoff_s * self.backoff_factor ** (retry - 1)


# -- per-network circuit breaker ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    threshold: int = 3                   # consecutive failed jobs to trip
    cooldown_jobs: int = 4               # open releases before half-open

    def __post_init__(self):
        if self.threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {self.threshold}")
        if self.cooldown_jobs < 1:
            raise ValueError(f"cooldown_jobs must be >= 1, "
                             f"got {self.cooldown_jobs}")


class CircuitBreaker:
    """Per-network failure isolation: closed -> open -> half-open -> closed.

    `on_release()` is consulted once per job release of the network and
    returns the action for that job: "run" (closed), "skip" (open —
    operate degraded), or "probe" (half-open — let ONE job through; its
    outcome decides recovery). `record_success`/`record_failure` feed the
    job outcomes back. Transitions are appended to `.transitions` and
    counted in the shared `DeadlineMonitor` as breaker_open /
    breaker_half_open / breaker_close events.
    """

    def __init__(self, network: str, policy: BreakerPolicy | None = None,
                 monitor: DeadlineMonitor | None = None):
        self.network = network
        self.policy = policy or BreakerPolicy()
        self.monitor = monitor
        self.state = "closed"
        self.consecutive_failures = 0
        self.transitions: list[tuple[str, str]] = []
        self._cooldown = 0

    def _to(self, state: str) -> None:
        if state == self.state:
            return
        self.transitions.append((self.state, state))
        self.state = state
        self._cooldown = 0
        if self.monitor is not None:
            kind = {"open": "breaker_open", "half_open": "breaker_half_open",
                    "closed": "breaker_close"}[state]
            self.monitor.record_event(self.network, kind)

    def on_release(self) -> str:
        """The action for this job release: "run" | "skip" | "probe"."""
        if self.state == "closed":
            return "run"
        if self.state == "open":
            self._cooldown += 1
            if self._cooldown >= self.policy.cooldown_jobs:
                self._to("half_open")
                return "probe"
            return "skip"
        return "probe"                   # half_open

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state != "closed":
            self._to("closed")

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == "half_open":
            self._to("open")             # failed probe: back to cooldown
        elif (self.state == "closed"
              and self.consecutive_failures >= self.policy.threshold):
            self._to("open")

    @property
    def degraded(self) -> bool:
        """True while requests should resolve degraded instead of queue."""
        return self.state != "closed"

    def summary(self) -> str:
        return (f"CircuitBreaker[{self.network}: {self.state}, "
                f"{self.consecutive_failures} consecutive failures, "
                f"{len(self.transitions)} transitions]")
