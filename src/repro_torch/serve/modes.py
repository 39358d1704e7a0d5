"""Atomic mode changes: swap a `Server`'s whole taskset at a hyperperiod
boundary.

Real-time deployments are *modal* — an ADAS stack runs one taskset on the
highway (detector fast, parking assist off) and another in a parking lot
(parking network on, detector slowed). The real-time-systems literature is
strict about how the swap may happen: a mode change in the middle of the
schedule voids every response-time bound, because the old mode's in-flight
jobs and the new mode's releases would share the (single) DMA channel in
an order no analysis covered. This module implements the classic
*synchronous mode-change protocol* on top of the hyperperiod program:

  1. `Server.switch_mode(mode)` admission-checks the INCOMING mode first —
     the candidate taskset is compiled and analyzed off to the side
     (`prepare_mode`), and an unschedulable or uncompilable mode raises
     without touching the serving state (same atomic-rollback contract as
     `Server.register`);
  2. the prepared mode is *staged*; the old mode keeps executing — every
     remaining job of the current hyperperiod runs under the old schedule
     and drains its queued tickets under the old bounds;
  3. exactly at the hyperperiod boundary the server swaps: networks
     present in both modes carry their request queues over, tickets of
     departing networks resolve terminally (outcome "dropped" — never
     left hanging), and the timeline restarts on the new hyperperiod
     program with the absolute clock carried forward.

Decode networks (`register_decode`) are not expressible as `ModeNetwork`
rows — their engines hold device state that cannot be re-admitted
mid-stream; re-register them after the switch (the same rule bundles
follow after `Server.load`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable


class ModeChangeError(RuntimeError):
    """Invalid mode definition (duplicate names, empty mode, ...)."""


@dataclasses.dataclass(frozen=True)
class ModeNetwork:
    """One network row of a mode — the `Server.register` argument set as
    declarative data, so whole modes are comparable and serializable."""

    name: str
    net: object                          # Graph | ModelConfig
    period_s: float
    deadline_s: float | None = None
    criticality: int = 0
    step_fn: Callable | None = None
    slots: int = 1
    params: dict | None = None
    batch: int = 1
    cache_len: int = 256
    max_layers: int | None = 4


@dataclasses.dataclass(frozen=True)
class Mode:
    """A named taskset configuration (e.g. "highway", "parking")."""

    name: str
    networks: tuple[ModeNetwork, ...]

    def __post_init__(self):
        if not self.networks:
            raise ModeChangeError(f"mode {self.name!r} has no networks")
        names = [n.name for n in self.networks]
        if len(set(names)) != len(names):
            raise ModeChangeError(
                f"mode {self.name!r} has duplicate network names: {names}")

    def network_names(self) -> list[str]:
        return [n.name for n in self.networks]


@dataclasses.dataclass
class StagedMode:
    """A fully prepared (analyzed + compiled) mode awaiting its boundary."""

    mode: Mode
    nets: dict                           # name -> runtime._Network, ready
    report: object                       # TasksetReport (schedulable)
    compiled: object                     # CompiledTaskset


def prepare_mode(server, mode: Mode) -> StagedMode:
    """Admission-check and pre-build `mode` for `server` WITHOUT touching
    its serving state.

    Runs the full hyperperiod analysis over the candidate taskset and
    compiles a Deployment + batched runner for every executable network on
    the server's backend and device (`server.device`: a staged mode runs
    where the server serves, never on another device) — all failure cases
    (unschedulable verdict, un-partitionable graph, lowering error) raise
    here, before anything is staged, so the switch itself can never
    half-apply. Returns the `StagedMode` the server applies at the next
    hyperperiod boundary.
    """
    from ..core.taskset import NetworkSpec
    from ..core.wcet import analyze_taskset
    from ..core.compiled import supports_graph
    from ..compiler import compile as compile_deployment
    from .runtime import (AdmissionError, RequestQueue, _Network, _as_graph,
                          _primed_runner)

    nets: dict[str, _Network] = {}
    for row in mode.networks:
        if row.slots < 1:
            raise ModeChangeError(
                f"mode {mode.name!r}: slots must be >= 1 for {row.name!r}")
        graph = _as_graph(row.net, row.name, batch=row.batch,
                          cache_len=row.cache_len, max_layers=row.max_layers)
        nets[row.name] = _Network(
            spec=NetworkSpec(row.name, graph, row.period_s, row.deadline_s,
                             criticality=row.criticality),
            slots=row.slots, step_fn=row.step_fn, params=row.params,
            queue=RequestQueue(row.name, server.queue_capacity,
                               server.queue_policy))

    specs = [st.spec for st in nets.values()]
    report, compiled = analyze_taskset(specs, server.machine,
                                       server.num_cores,
                                       arbitration=server.arbitration)
    if not report.schedulable:
        raise AdmissionError(
            f"mode {mode.name!r} is not schedulable on "
            f"{server.machine.name}:\n{report.summary()}", report=report)

    for name, st in nets.items():
        if st.step_fn is not None or not supports_graph(st.spec.graph):
            continue
        st.deployment = compile_deployment(
            st.spec.graph, server.machine, backend=server.backend,
            params=st.params, num_cores=server.num_cores,
            arbitration=server.arbitration,
            backend_options=server.backend_options, device=server.device)
        st.runner = _primed_runner(st.deployment, server.backend, st.slots)
    return StagedMode(mode=mode, nets=nets, report=report, compiled=compiled)
