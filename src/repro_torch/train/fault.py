"""Fault tolerance: failure injection and the straggler watchdog.

The serving half of the JAX package's `train/fault.py`, which the serving
runtime's recovery layer (`repro_torch.serve.faults`) shares:

  * `InjectedFailure` — the exception a fault plan raises to simulate an
    executor or node loss;
  * straggler mitigation — the paper's core property applied to repeated
    work: a statically scheduled step has a WCET bound; `StragglerWatchdog`
    flags steps exceeding `deadline = margin x rolling median`, the same
    bound composition used by `repro_torch.core.wcet`. The policy hook
    records and (optionally) raises.

Checkpoint/restart (`run_with_recovery`) and elastic re-meshing
(`elastic_remesh`) need the training checkpoint manager, which waits for
its port (ROADMAP.md, queue 1, item 15): both raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

_TRAINING_ITEM = ("training checkpoints wait for their port "
                  "(ROADMAP.md, queue 1, item 15)")


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


def run_with_recovery(*args, **kwargs):
    """Checkpoint/restart around a training step loop (not ported yet)."""
    raise NotImplementedError(f"run_with_recovery: {_TRAINING_ITEM}")


def elastic_remesh(*args, **kwargs):
    """Restore training state onto the current device set (not ported
    yet)."""
    raise NotImplementedError(f"elastic_remesh: {_TRAINING_ITEM}")
