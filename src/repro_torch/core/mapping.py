"""Subtask -> core mapping (paper §III.B step 3).

The paper: "the network is traversed in reverse, from the result layer to the
input layer, in order to determine dependencies between the subtasks. In a
second pass, interdependent calculations are then mapped to the same core to
keep as much data as possible in the local memory. Dependencies on subtasks
with large amounts of data are prioritized."

Implementation: greedy reverse-topological placement. A subtask scores each
core by the DMA bytes it would *avoid* being placed there:

  * consumer affinity — its output stays scratchpad-resident for consumers
    already placed on that core (weighted by the store bytes, i.e. "large
    amounts of data are prioritized");
  * weight affinity — a weight tile some subtask on that core already loads
    is fetched once and reused;

minus a load-balance penalty expressed in byte-equivalents (seconds of
compute imbalance x DMA bandwidth), so saved transfers and added imbalance
are in the same unit.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from .partition import Subtask
from ..hw import HardwareModel


@dataclasses.dataclass
class Mapping:
    num_cores: int
    core_of: dict[int, int]                      # sid -> core
    core_flops: list[float]
    affinity_bytes_saved: float                  # estimate from the greedy

    def subtasks_on(self, core: int) -> list[int]:
        return sorted(s for s, c in self.core_of.items() if c == core)


def map_reverse_affinity(subtasks: list[Subtask], hw: HardwareModel,
                         num_cores: int | None = None,
                         balance_weight: float = 1.0) -> Mapping:
    """The paper's mapping pass."""
    n_cores = num_cores or hw.num_workers
    by_id = {st.sid: st for st in subtasks}

    # pass 1 (reverse traversal): consumer lists, weighted by shared bytes
    consumers: dict[int, list[tuple[int, float]]] = defaultdict(list)
    for st in subtasks:
        for d in st.deps:
            dep = by_id[d]
            w = float(dep.store.nbytes if dep.store else 0)
            consumers[d].append((st.sid, w))

    core_of: dict[int, int] = {}
    core_flops = [0.0] * n_cores
    core_time = [0.0] * n_cores
    # (core, weight-tile key) -> True once any subtask on the core loads it
    weight_resident: set[tuple[int, tuple]] = set()
    saved = 0.0

    # pass 2: place in reverse model order; consumers are placed before
    # their producers, so affinity pulls producers onto consumer cores.
    for st in sorted(subtasks, key=lambda s: -s.sid):
        score = [0.0] * n_cores
        for cons_sid, w in consumers.get(st.sid, ()):  # consumer affinity
            c = core_of.get(cons_sid)
            if c is not None:
                score[c] += w
        for ld in st.loads:                            # weight reuse affinity
            if ld.kind != "weight":
                continue
            for c in range(n_cores):
                if (c, ld.key()) in weight_resident:
                    score[c] += float(ld.nbytes)
        t = hw.wcet_compute_s(st.flops, st.int8)
        min_t = min(core_time)
        best, best_val = 0, -float("inf")
        for c in range(n_cores):
            penalty = (core_time[c] + t - min_t) * hw.dram_bw
            val = score[c] - balance_weight * penalty
            if val > best_val:
                best, best_val = c, val
        core_of[st.sid] = best
        core_flops[best] += st.flops
        core_time[best] += t
        saved += score[best]
        for ld in st.loads:
            if ld.kind == "weight":
                weight_resident.add((best, ld.key()))

    return Mapping(n_cores, core_of, core_flops, saved)


def map_round_robin(subtasks: list[Subtask], hw: HardwareModel,
                    num_cores: int | None = None) -> Mapping:
    """Naive baseline: ignore data reuse entirely."""
    n_cores = num_cores or hw.num_workers
    core_of = {st.sid: st.sid % n_cores for st in subtasks}
    core_flops = [0.0] * n_cores
    for st in subtasks:
        core_flops[core_of[st.sid]] += st.flops
    return Mapping(n_cores, core_of, core_flops, 0.0)
