"""Compositional WCET analysis (paper Abstract + §III).

"the WCET estimate of the overall system can be obtained from the subtask
WCET estimates, data transfer times, and access times of the shared memory in
conjunction with the schedule calculated by the compiler."

The per-subtask WCET comes from the deterministic hardware model (repro_torch.hw) —
the stand-in for the paper's external static WCET analyzer. The total system
WCET is the makespan of the static schedule built from those bounds; because
the schedule guarantees interference-freedom (exclusive DMA channel,
private scratchpads), replaying it with any actual times <= the bounds can
never exceed the WCET makespan. `tests/test_schedule_properties.py` checks
this compositionality property with hypothesis.
"""

from __future__ import annotations

import dataclasses

from .graph import Graph
from .partition import Partitioner, Subtask
from .mapping import Mapping, map_reverse_affinity
from .schedule import StaticSchedule, compute_schedule, validate_schedule
from .taskset import (CompiledTaskset, NetworkSpec, compile_taskset,
                      schedule_taskset)
from ..hw import HardwareModel


@dataclasses.dataclass
class WCETReport:
    graph_name: str
    hw_name: str
    num_cores: int
    num_subtasks: int
    wcet_total_s: float                  # == schedule makespan (the bound)
    compute_bound_s: float               # max per-core compute WCET sum
    dma_bound_s: float                   # total DMA busy time (1 channel)
    critical_path_s: float               # dependency-chain lower bound
    dma_utilization: float
    compute_utilization: float
    bytes_moved: int
    bytes_saved_reuse: int
    per_op_wcet: dict[str, float]

    def dominant_term(self) -> str:
        if self.dma_bound_s >= self.compute_bound_s:
            return "memory (DMA channel)"
        return "compute (worker cores)"

    def summary(self) -> str:
        return (
            f"WCET[{self.graph_name} on {self.hw_name} x{self.num_cores}] "
            f"total={self.wcet_total_s*1e3:.3f} ms  "
            f"(compute-bound {self.compute_bound_s*1e3:.3f} ms, "
            f"dma-bound {self.dma_bound_s*1e3:.3f} ms, "
            f"crit-path {self.critical_path_s*1e3:.3f} ms; "
            f"dominant: {self.dominant_term()}; "
            f"dma util {self.dma_utilization:.1%}, "
            f"core util {self.compute_utilization:.1%}, "
            f"reuse saved {self.bytes_saved_reuse/1e6:.2f} MB)")


def subtask_wcet(st: Subtask, hw: HardwareModel) -> float:
    return hw.wcet_compute_s(st.flops, st.int8)


def critical_path(subtasks: list[Subtask], hw: HardwareModel) -> float:
    """Longest dependency chain of compute WCETs (pure compute chain).

    A true lower bound on any schedule's makespan (for any core count,
    any DMA bandwidth, and any mapping — same-core residency can elide
    every transfer, so transfer times must NOT be added here), used to
    judge schedule quality.
    """
    memo: dict[int, float] = {}
    for st in sorted(subtasks, key=lambda s: s.sid):
        best_dep = max((memo[d] for d in st.deps), default=0.0)
        memo[st.sid] = best_dep + subtask_wcet(st, hw)
    return max(memo.values()) if memo else 0.0


def report_from_schedule(graph: Graph, hw: HardwareModel,
                         subtasks: list[Subtask], mapping: Mapping,
                         sched: StaticSchedule) -> WCETReport:
    """WCET report for an already-computed (subtasks, mapping, schedule).

    The analysis half of `analyze`, factored out so callers that already
    hold the pipeline artifacts — the staged pass pipeline in
    `repro_torch.compiler`, ablation sweeps re-scheduling one mapping — derive
    the bound without re-running partition/map/schedule."""
    busy = sched.core_busy()
    per_op: dict[str, float] = {}
    by_id = {st.sid: st for st in subtasks}
    for slot in sched.compute:
        op = by_id[slot.sid].op_name
        per_op[op] = per_op.get(op, 0.0) + (slot.end - slot.start)

    return WCETReport(
        graph_name=graph.name,
        hw_name=hw.name,
        num_cores=mapping.num_cores,
        num_subtasks=len(subtasks),
        wcet_total_s=sched.makespan,
        compute_bound_s=max(busy) if busy else 0.0,
        dma_bound_s=sched.dma_busy(),
        critical_path_s=critical_path(subtasks, hw),
        dma_utilization=sched.dma_utilization(),
        compute_utilization=sched.compute_utilization(),
        bytes_moved=sched.bytes_moved,
        bytes_saved_reuse=sched.bytes_saved_reuse,
        per_op_wcet=per_op,
    )


def analyze(graph: Graph, hw: HardwareModel,
            num_cores: int | None = None,
            mapping: Mapping | None = None,
            arbitration: str = "static",
            validate: bool = True) -> tuple[WCETReport, StaticSchedule,
                                            list[Subtask], Mapping]:
    """Full paper pipeline: partition -> map -> schedule -> WCET bound.

    Equivalent to running the staged pass pipeline of `repro_torch.compiler`
    through its wcet stage; retained as the analysis-only entry point
    (no params, no lowering — LM decode graphs with analysis-only op
    kinds are fine here)."""
    part = Partitioner(hw)
    subtasks = part.partition(graph)
    if mapping is None:
        mapping = map_reverse_affinity(subtasks, hw, num_cores)
    sched = compute_schedule(subtasks, mapping, hw, wcet=True,
                             arbitration=arbitration)
    if validate:
        validate_schedule(sched, subtasks, mapping)
    report = report_from_schedule(graph, hw, subtasks, mapping, sched)
    return report, sched, subtasks, mapping


# -- multi-network taskset analysis ------------------------------------------

@dataclasses.dataclass
class NetworkVerdict:
    """Per-network schedulability result over the hyperperiod."""

    name: str
    period_s: float
    deadline_s: float
    n_jobs: int
    response_bound_s: float              # max job response (WCET times)
    num_subtasks: int                    # per job
    criticality: int = 0                 # from NetworkSpec (shed order)

    @property
    def schedulable(self) -> bool:
        return self.response_bound_s <= self.deadline_s * (1 + 1e-9)

    @property
    def slack_s(self) -> float:
        return self.deadline_s - self.response_bound_s

    def row(self) -> str:
        return (f"{self.name:<14}{1.0 / self.period_s:>8.1f} Hz  "
                f"D={self.deadline_s * 1e3:7.2f} ms  "
                f"R={self.response_bound_s * 1e3:7.2f} ms  "
                f"slack={self.slack_s * 1e3:+8.2f} ms  "
                f"crit={self.criticality}  "
                f"{'OK' if self.schedulable else 'MISS'}")


@dataclasses.dataclass
class TasksetReport:
    """Hyperperiod-level WCET analysis of a multi-network taskset.

    `schedulable` requires (a) every network's worst-case response bound to
    meet its deadline and (b) the whole hyperperiod program to drain within
    the hyperperiod (`fits_hyperperiod`), so the management-core program can
    loop back-to-back without the next hyperperiod's DMA colliding with a
    still-running tail.
    """

    hw_name: str
    num_cores: int
    hyperperiod_s: float
    networks: list[NetworkVerdict]
    makespan_s: float
    dma_utilization: float
    compute_utilization: float
    total_subtasks: int
    total_jobs: int

    @property
    def fits_hyperperiod(self) -> bool:
        return self.makespan_s <= self.hyperperiod_s * (1 + 1e-9)

    @property
    def schedulable(self) -> bool:
        return self.fits_hyperperiod and all(n.schedulable
                                             for n in self.networks)

    def verdict_of(self, network: str) -> NetworkVerdict:
        """The per-network verdict by name (KeyError lists what exists)."""
        for n in self.networks:
            if n.name == network:
                return n
        raise KeyError(f"no network {network!r} in this taskset "
                       f"(analyzed: {sorted(n.name for n in self.networks)})")

    def bound(self, network: str) -> float:
        """Per-job WCET response bound for `network` — the budget every job
        of that network is held to at run time (serving runtime + engines
        look bounds up here instead of re-deriving them)."""
        return self.verdict_of(network).response_bound_s

    @property
    def response_bounds(self) -> dict[str, float]:
        """All per-network response bounds, keyed by network name."""
        return {n.name: n.response_bound_s for n in self.networks}

    def shed_order(self) -> list[str]:
        """Network names in degraded-mode shedding order: lowest
        criticality first, largest response bound first within a level
        (shedding the heaviest job frees the most schedule), name as the
        deterministic tiebreak. The serving runtime sheds from the front
        of this list and restores from the back."""
        return [n.name for n in sorted(
            self.networks,
            key=lambda n: (n.criticality, -n.response_bound_s, n.name))]

    def summary(self) -> str:
        lines = [
            f"Taskset[{len(self.networks)} nets on {self.hw_name} "
            f"x{self.num_cores}] H={self.hyperperiod_s * 1e3:.2f} ms  "
            f"makespan={self.makespan_s * 1e3:.2f} ms  "
            f"({self.total_jobs} jobs, {self.total_subtasks} subtasks; "
            f"dma util {self.dma_utilization:.1%}, "
            f"core util {self.compute_utilization:.1%})"]
        lines += ["  " + n.row() for n in self.networks]
        lines.append(f"  verdict: "
                     f"{'SCHEDULABLE' if self.schedulable else 'NOT SCHEDULABLE'}"
                     + ("" if self.fits_hyperperiod
                        else " (hyperperiod overrun)"))
        return "\n".join(lines)


def analyze_taskset(specs: list[NetworkSpec], hw: HardwareModel,
                    num_cores: int | None = None,
                    arbitration: str = "static",
                    validate: bool = True
                    ) -> tuple[TasksetReport, CompiledTaskset]:
    """Multi-network pipeline: compile the hyperperiod job set, schedule it
    on the shared DMA channel + worker cores with WCET times, and derive
    per-network response-time bounds and a schedulability verdict."""
    compiled = compile_taskset(specs, hw, num_cores)
    sched = schedule_taskset(compiled, hw, wcet=True, arbitration=arbitration)
    if validate:
        validate_schedule(sched, compiled.subtasks, compiled.mapping,
                          release=compiled.release)

    verdicts = []
    for i, spec in enumerate(compiled.specs):
        jobs = compiled.jobs_of(spec.name)
        verdicts.append(NetworkVerdict(
            name=spec.name, period_s=spec.period_s, deadline_s=spec.deadline,
            n_jobs=len(jobs),
            response_bound_s=max(j.response for j in jobs),
            num_subtasks=len(jobs[0].sids),
            criticality=spec.criticality))

    report = TasksetReport(
        hw_name=hw.name, num_cores=compiled.mapping.num_cores,
        hyperperiod_s=compiled.hyperperiod_s, networks=verdicts,
        makespan_s=sched.makespan,
        dma_utilization=sched.dma_utilization(),
        compute_utilization=sched.compute_utilization(),
        total_subtasks=len(compiled.subtasks),
        total_jobs=len(compiled.jobs))
    return report, compiled


@dataclasses.dataclass(frozen=True)
class SustainedServeVerdict:
    """Admission verdict for a *continuous-batching* decode network.

    Release-batched networks are admitted per hyperperiod job; a continuous
    decode loop instead holds `slots` batch slots and runs one slot-batched
    decode step per period, so the right admission question is *sustained
    slot occupancy*: can the slot pool absorb the offered token load with
    the per-step WCET bound still inside the period?

      token capacity  = slots / period_s            [tokens/s]
      offered load    = arrival_rps * tokens_per_request
      occupancy       = offered / capacity          (must be <= 1)
      step_fits       = step_bound_s <= period_s

    Occupancy above 1 means requests pile up in the queue without bound;
    a step bound above the period means even an empty queue falls behind.
    Both must hold for `schedulable`.
    """

    network: str
    slots: int
    period_s: float                      # one decode step per period
    step_bound_s: float                  # WCET bound of the slot-batched step
    arrival_rps: float                   # offered request arrival rate
    tokens_per_request: float            # mean decode tokens per request

    @property
    def token_capacity_tps(self) -> float:
        return self.slots / self.period_s

    @property
    def offered_load_tps(self) -> float:
        return self.arrival_rps * self.tokens_per_request

    @property
    def occupancy(self) -> float:
        """Long-run fraction of the slot pool the offered load keeps busy."""
        return self.offered_load_tps / self.token_capacity_tps

    @property
    def step_fits(self) -> bool:
        return self.step_bound_s <= self.period_s * (1 + 1e-9)

    @property
    def schedulable(self) -> bool:
        return self.step_fits and self.occupancy <= 1.0 + 1e-9

    def summary(self) -> str:
        return (
            f"Sustained[{self.network}: {self.slots} slots @ "
            f"{1.0 / self.period_s:.1f} steps/s] "
            f"capacity={self.token_capacity_tps:.1f} tok/s  "
            f"offered={self.offered_load_tps:.1f} tok/s  "
            f"occupancy={self.occupancy:.1%}  "
            f"step R={self.step_bound_s * 1e3:.2f} ms "
            f"{'fits' if self.step_fits else 'OVERRUNS'} "
            f"P={self.period_s * 1e3:.2f} ms  "
            f"{'SUSTAINABLE' if self.schedulable else 'NOT SUSTAINABLE'}")


def sustained_occupancy(network: str, *, slots: int, period_s: float,
                        step_bound_s: float, arrival_rps: float,
                        tokens_per_request: float) -> SustainedServeVerdict:
    """Sustained-occupancy admission check for a continuous decode loop
    (see `SustainedServeVerdict`). Raises on non-positive inputs."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    for name, val in (("period_s", period_s),
                      ("step_bound_s", step_bound_s),
                      ("tokens_per_request", tokens_per_request)):
        if val <= 0:
            raise ValueError(f"{name} must be > 0, got {val}")
    if arrival_rps < 0:
        raise ValueError(f"arrival_rps must be >= 0, got {arrival_rps}")
    return SustainedServeVerdict(
        network=network, slots=slots, period_s=period_s,
        step_bound_s=step_bound_s, arrival_rps=arrival_rps,
        tokens_per_request=tokens_per_request)
