"""Fault tolerance: failure injection + recovery, straggler watchdog,
elastic re-meshing. The serving runtime's recovery layer
(`repro_torch.serve.faults`) shares the first two.

  * `InjectedFailure` — the exception a fault plan raises to simulate an
    executor or node loss;
  * checkpoint/restart — `run_with_recovery` wraps the step loop; any
    RuntimeError (a lost device or rank surfaces as one in torch) triggers
    a restore from the last committed checkpoint and a replay of the data
    to the restored step (the pipeline is stateless and seekable, see
    repro_torch.data). With several ranks, every rank restores the same
    step (the checkpoint manager's collective save ends in a barrier);
  * straggler mitigation — the paper's core property applied to repeated
    work: a statically scheduled step has a WCET bound; `StragglerWatchdog`
    flags steps exceeding `deadline = margin x rolling median`, the same
    bound composition used by `repro_torch.core.wcet`. The policy hook
    records and (optionally) raises;
  * elastic scaling — `elastic_remesh` re-places the (possibly resharded)
    state on the current mesh through the checkpoint manager's `shardings`
    argument: scale-down and scale-up are both "restore onto a different
    mesh".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from .checkpoint import CheckpointManager


class InjectedFailure(RuntimeError):
    """Raised by tests/benchmarks to simulate a node loss."""


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration_s: float
    deadline_s: float


class StragglerWatchdog:
    """Flags steps that exceed a WCET-style deadline."""

    def __init__(self, margin: float = 2.0, warmup: int = 3,
                 on_straggler: Callable[[StragglerReport], None]
                 | None = None):
        self.margin = margin
        self.warmup = warmup
        self.durations: list[float] = []
        self.reports: list[StragglerReport] = []
        self.on_straggler = on_straggler

    def observe(self, step: int, duration_s: float) -> bool:
        """Returns True if this step was a straggler."""
        is_straggler = False
        if len(self.durations) >= self.warmup:
            med = sorted(self.durations)[len(self.durations) // 2]
            deadline = self.margin * med
            if duration_s > deadline:
                rep = StragglerReport(step, duration_s, deadline)
                self.reports.append(rep)
                if self.on_straggler:
                    self.on_straggler(rep)
                is_straggler = True
        self.durations.append(duration_s)
        if len(self.durations) > 64:
            self.durations.pop(0)
        return is_straggler


def run_with_recovery(step_fn: Callable[[Any, int], Any], state: Any,
                      num_steps: int, ckpt: CheckpointManager,
                      save_every: int = 10,
                      watchdog: StragglerWatchdog | None = None,
                      max_restarts: int = 3,
                      fail_at: dict[int, Exception] | None = None):
    """Run `state = step_fn(state, step)` with checkpoint/restart.

    fail_at: {step: exception} — failure injection for tests/benches.
    Returns (state, history) where history records restarts/stragglers.
    """
    history = {"restarts": 0, "stragglers": 0, "completed": 0}
    start = ckpt.latest_step()
    step = 0 if start is None else start + 1
    if start is not None:
        state, _ = ckpt.restore(state, start)
    initial = state
    injected = dict(fail_at or {})

    while step < num_steps:
        try:
            if step in injected:
                raise injected.pop(step)
            t0 = time.perf_counter()
            state = step_fn(state, step)
            dt = time.perf_counter() - t0
            if watchdog is not None and watchdog.observe(step, dt):
                history["stragglers"] += 1
            if (step + 1) % save_every == 0 or step + 1 == num_steps:
                ckpt.save(step, state)
            history["completed"] += 1
            step += 1
        except (RuntimeError, InjectedFailure):
            history["restarts"] += 1
            if history["restarts"] > max_restarts:
                raise
            # an async save still in flight lands first, so the restart
            # takes the newest checkpoint (the JAX package reads LATEST
            # before it lands and may replay from an older one)
            ckpt.wait()
            last = ckpt.latest_step()
            if last is None:
                # restart from scratch: from the initial state (the JAX
                # package keeps the failed run's state here)
                state, step = initial, 0
            else:
                state, _ = ckpt.restore(state, last)
                step = last + 1
    ckpt.wait()
    return state, history


def elastic_remesh(ckpt: CheckpointManager, like: Any,
                   make_shardings: Callable[[Any], Any],
                   step: int | None = None):
    """Restore state onto the *current* mesh (scale up or down).

    make_shardings(like) builds the tree of `distribution.NamedSharding`
    for the new mesh — the same `param_shardings`/`zero1_shardings` rules,
    evaluated against whatever mesh the surviving ranks form; each rank
    keeps its slice.
    """
    shardings = make_shardings(like)
    return ckpt.restore(like, step=step, shardings=shardings)
