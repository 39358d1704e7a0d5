"""Multi-network hyperperiod scheduling (taskset level).

The paper schedules ONE network at a time, but its motivating deployments
(automated driving) run several networks at different rates on the same
shared-memory fabric — e.g. an object detector @ 30 Hz, a lane-keeper
@ 100 Hz and a speech interface @ 10 Hz. This module lifts the single-
network compiler to a periodic *taskset*:

  1. each network is partitioned and mapped exactly as before (per-network
     subtask sets and core affinities are reused for every job);
  2. the hyperperiod H = lcm(periods) is computed exactly (rational
     arithmetic, so 1/30 s and 1/100 s compose to 1/10 s);
  3. every job release inside H instantiates a fresh copy of the network's
     subtasks, released at k * period;
  4. the merged job set is handed to the event-driven list scheduler
     (`compute_schedule`) with per-subtask release times, producing ONE
     static management-core program over the hyperperiod that interleaves
     all networks on the single DMA channel and the shared worker cores
     while preserving each network's topological order;
  5. per-job response times read off the schedule give per-network WCET
     response bounds; `repro_torch.core.wcet.analyze_taskset` turns them into a
     schedulability verdict.

Because the merged schedule inherits the single-network guarantees
(exclusive DMA channel, private scratchpads, WCET-margined times), the
per-network response bounds are compositional in exactly the paper's
sense: replaying the hyperperiod program with any actual times <= the
WCETs can never increase any job's response time.

Tensor names are prefixed per *network* (not per job), so weight tiles
stay LRU-resident across consecutive jobs of the same network but are
never aliased between different networks.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

from .graph import Graph
from .mapping import Mapping, map_reverse_affinity
from .partition import Partitioner, Subtask
from .schedule import StaticSchedule, compute_schedule
from ..hw import HardwareModel


class TasksetError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """One periodic network: release a job every `period_s` seconds.

    `criticality` ranks networks for degraded-mode operation (higher =
    more critical): under overload the serving runtime sheds the
    lowest-criticality networks first and restores them last, so the
    high-criticality set keeps its deadline guarantees. It does not
    affect the schedule itself — every admitted network gets the same
    interference-free WCET treatment."""

    name: str
    graph: Graph
    period_s: float
    deadline_s: float | None = None      # None -> implicit deadline = period
    criticality: int = 0                 # higher sheds later under overload

    @property
    def deadline(self) -> float:
        return self.deadline_s if self.deadline_s is not None else self.period_s


@dataclasses.dataclass
class Job:
    """One release of one network inside the hyperperiod."""

    network: str
    net_idx: int
    job_idx: int
    release: float
    abs_deadline: float
    sids: list[int]                      # global sids of this job's subtasks
    finish: float = 0.0                  # filled in after scheduling

    @property
    def response(self) -> float:
        return self.finish - self.release


@dataclasses.dataclass
class CompiledTaskset:
    """Merged job set ready for (or annotated with) the hyperperiod schedule."""

    specs: list[NetworkSpec]
    hyperperiod_s: float
    jobs: list[Job]
    subtasks: list[Subtask]              # merged, globally renumbered
    mapping: Mapping
    release: dict[int, float]            # global sid -> job release time
    schedule: StaticSchedule | None = None
    # per-network schedule templates (prefixed subtasks + standalone mapping),
    # shared by every job instance and reusable by the compiled executor
    templates: dict[str, tuple[list[Subtask], Mapping]] = \
        dataclasses.field(default_factory=dict)

    def jobs_of(self, network: str) -> list[Job]:
        return [j for j in self.jobs if j.network == network]

    def response_bound(self, network: str) -> float:
        return max(j.response for j in self.jobs_of(network))


def hyperperiod(periods: list[float]) -> float:
    """Exact lcm of the periods (rationalized to avoid float drift)."""
    if not periods or any(p <= 0 for p in periods):
        raise TasksetError(f"periods must be positive, got {periods}")
    fracs = [Fraction(p).limit_denominator(10 ** 9) for p in periods]
    den = math.lcm(*(f.denominator for f in fracs))
    nums = [f.numerator * (den // f.denominator) for f in fracs]
    return float(Fraction(math.lcm(*nums), den))


def _prefix_subtask(st: Subtask, prefix: str) -> Subtask:
    """Network-namespaced schedule template entry (built ONCE per network).

    Tensor names are prefixed per network, so the template is shared by every
    job instance of that network inside the hyperperiod."""
    loads = [dataclasses.replace(t, tensor=prefix + t.tensor)
             for t in st.loads]
    store = (dataclasses.replace(st.store, tensor=prefix + st.store.tensor)
             if st.store is not None else None)
    return Subtask(
        sid=st.sid, op_name=prefix + st.op_name, kind=st.kind,
        flops=st.flops, int8=st.int8, loads=loads, store=store,
        sp_resident=st.sp_resident, deps=list(st.deps), tile=st.tile)


def _instantiate_job(st: Subtask, offset: int) -> Subtask:
    """Job instance of a prefixed template subtask: only sids shift; the
    loads/store/tile structures are shared with the template (they are
    read-only to the scheduler), so instantiating a job is O(deps) instead
    of re-deriving every transfer per release."""
    return Subtask(
        sid=offset + st.sid, op_name=st.op_name, kind=st.kind,
        flops=st.flops, int8=st.int8, loads=st.loads, store=st.store,
        sp_resident=st.sp_resident, deps=[offset + d for d in st.deps],
        tile=st.tile)


def compile_taskset(specs: list[NetworkSpec], hw: HardwareModel,
                    num_cores: int | None = None) -> CompiledTaskset:
    """Partition + map each network, then merge all job releases in the
    hyperperiod into one subtask set with release times.

    Global sids are assigned in (release, network) order, so each core's
    queue (sorted by sid) interleaves jobs by release while keeping every
    job's internal topological order intact.
    """
    if len({s.name for s in specs}) != len(specs):
        raise TasksetError("network names must be unique")
    n_cores = num_cores or hw.num_workers

    templates: list[tuple[NetworkSpec, list[Subtask], Mapping]] = []
    for spec in specs:
        part = Partitioner(hw)
        subtasks = part.partition(spec.graph)
        mapping = map_reverse_affinity(subtasks, hw, n_cores)
        # the per-network template is prefixed ONCE; each job release below
        # reuses it instead of re-deriving every transfer
        prefixed = [_prefix_subtask(st, f"{spec.name}::") for st in subtasks]
        templates.append((spec, prefixed, mapping))

    H = hyperperiod([s.period_s for s in specs])
    releases: list[tuple[float, int, int]] = []   # (release, net_idx, job_idx)
    for i, spec in enumerate(specs):
        n_jobs = round(H / spec.period_s)
        releases.extend((k * spec.period_s, i, k) for k in range(n_jobs))
    releases.sort()

    merged: list[Subtask] = []
    jobs: list[Job] = []
    release_of: dict[int, float] = {}
    core_of: dict[int, int] = {}
    core_flops = [0.0] * n_cores
    affinity_saved = 0.0
    offset = 0
    for rel_t, i, k in releases:
        spec, prefixed, mapping = templates[i]
        sids = []
        for st in prefixed:
            clone = _instantiate_job(st, offset)
            merged.append(clone)
            sids.append(clone.sid)
            release_of[clone.sid] = rel_t
            core_of[clone.sid] = mapping.core_of[st.sid]
            core_flops[core_of[clone.sid]] += st.flops
        affinity_saved += mapping.affinity_bytes_saved
        jobs.append(Job(network=spec.name, net_idx=i, job_idx=k,
                        release=rel_t, abs_deadline=rel_t + spec.deadline,
                        sids=sids))
        offset += len(prefixed)

    merged_mapping = Mapping(n_cores, core_of, core_flops, affinity_saved)
    return CompiledTaskset(specs=list(specs), hyperperiod_s=H, jobs=jobs,
                           subtasks=merged, mapping=merged_mapping,
                           release=release_of,
                           templates={spec.name: (prefixed, mapping)
                                      for spec, prefixed, mapping
                                      in templates})


def _job_finishes(sched: StaticSchedule, jobs: list[Job]) -> None:
    """Fill Job.finish: a job is done when its last compute AND its last
    output store have drained (results must reach shared memory to count)."""
    end: dict[int, float] = {}
    for s in sched.compute:
        end[s.sid] = max(end.get(s.sid, 0.0), s.end)
    for s in sched.dma:
        if s.kind == "out":
            end[s.sid] = max(end.get(s.sid, 0.0), s.end)
    for job in jobs:
        job.finish = max(end[sid] for sid in job.sids)


def schedule_taskset(compiled: CompiledTaskset, hw: HardwareModel, *,
                     wcet: bool = True, time_scale: float = 1.0,
                     arbitration: str = "static") -> StaticSchedule:
    """Run the hyperperiod through the event-driven list scheduler and
    annotate per-job finish times. wcet=False replays at actual (peak)
    rates — used to check the response bounds compose.

    Job.finish/.response reflect the MOST RECENT call on this compiled
    taskset; capture the WCET bounds (or use TasksetReport) before
    replaying with wcet=False.
    """
    sched = compute_schedule(compiled.subtasks, compiled.mapping, hw,
                             wcet=wcet, arbitration=arbitration,
                             time_scale=time_scale, release=compiled.release)
    compiled.schedule = sched
    _job_finishes(sched, compiled.jobs)
    return sched
