"""Static memory-access scheduling (paper §III.B steps 6-7).

Event-driven list scheduler producing the management-core program: a fixed
timeline of DMA transactions and per-core compute slots.

Paper semantics implemented here:
  * the model's (topological) subtask order is preserved per core;
  * memory transactions are scheduled **as early as possible** such that
    **only one transaction takes place at a time** (single DMA channel with
    exclusive access to DRAM and the interconnect -> freedom from
    interference by design);
  * ties between cores are broken **round-robin**;
  * dual-ported scratchpads allow the next subtask's transfers to overlap
    the current subtask's compute (depth-1 prefetch / double buffering);
  * data produced and consumed on the same core stays scratchpad-resident
    (the mapping pass maximizes exactly this); weight tiles remain resident
    per-core under an LRU capacity model;
  * the schedule is computed from **WCET estimates** of subtasks and
    transfers; replaying it with actual (faster) times never violates it,
    which is what makes the total WCET compositional.

Also implements the TDMA-arbitration baseline the paper argues against
(fixed per-core bus slots -> predictable but wastes bandwidth).
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
from collections import OrderedDict

from .partition import Subtask
from .mapping import Mapping
from ..hw import HardwareModel

_EPS = 1e-12


@dataclasses.dataclass
class DMASlot:
    start: float
    end: float
    core: int
    sid: int
    tensor: str
    kind: str                 # "act" | "weight" | "out"
    nbytes: int


@dataclasses.dataclass
class ComputeSlot:
    start: float
    end: float
    core: int
    sid: int


@dataclasses.dataclass(eq=False)          # identity-hashable: schedules are
class StaticSchedule:                     # cache keys for compiled replayers
    makespan: float
    dma: list[DMASlot]
    compute: list[ComputeSlot]
    arbitration: str          # "static" | "tdma"
    wcet_mode: bool
    num_cores: int
    bytes_moved: int
    bytes_saved_reuse: int

    def dma_busy(self) -> float:
        return sum(s.end - s.start for s in self.dma)

    def dma_utilization(self) -> float:
        return self.dma_busy() / self.makespan if self.makespan else 0.0

    def core_busy(self) -> list[float]:
        busy = [0.0] * self.num_cores
        for s in self.compute:
            busy[s.core] += s.end - s.start
        return busy

    def compute_utilization(self) -> float:
        return (sum(self.core_busy())
                / (self.num_cores * self.makespan) if self.makespan else 0.0)


class ScheduleError(RuntimeError):
    pass


class _LRU:
    """Per-core resident-weight model with byte capacity."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.entries: OrderedDict[tuple, int] = OrderedDict()
        self.used = 0

    def hit(self, key: tuple) -> bool:
        if key in self.entries:
            self.entries.move_to_end(key)
            return True
        return False

    def insert(self, key: tuple, nbytes: int):
        if key in self.entries:
            self.entries.move_to_end(key)
            return
        while self.used + nbytes > self.capacity and self.entries:
            _, evicted = self.entries.popitem(last=False)
            self.used -= evicted
        if self.used + nbytes <= self.capacity:
            self.entries[key] = nbytes
            self.used += nbytes


def _tdma_finish(eligible: float, core: int, dur: float,
                 quantum: float, n_cores: int) -> tuple[float, float]:
    """Earliest (start, end) for a transfer restricted to `core`'s TDMA slots.

    Closed form: advance to the core's next slot, consume the slot remainder,
    then whole further slots (one per TDMA cycle) until `dur` is used up.
    """
    cycle = quantum * n_cores
    s0 = core * quantum
    t = eligible
    pos = t % cycle
    if pos < s0:
        t += s0 - pos
        off = 0.0
    elif pos >= s0 + quantum:
        t += cycle - pos + s0
        off = 0.0
    else:
        off = pos - s0
    started = t
    first = quantum - off
    if dur <= first + _EPS:
        return started, t + dur
    left = dur - first
    full_slots = int(left // quantum)
    rem = left - full_slots * quantum
    end = t + first + full_slots * cycle
    if rem > _EPS:
        end += (cycle - quantum) + rem
    return started, end


def compute_schedule(subtasks: list[Subtask], mapping: Mapping,
                     hw: HardwareModel, *, wcet: bool = True,
                     arbitration: str = "static",
                     tdma_quantum: float | None = None,
                     weight_cache_bytes: int | None = None,
                     time_scale: float = 1.0,
                     release: dict[int, float] | None = None,
                     engine: str = "auto") -> StaticSchedule:
    """Build the static schedule.

    wcet=True uses WCET-margined times (this is the schedule that ships);
    wcet=False uses peak-rate times (an "actual execution" replay used by
    tests/benchmarks to show the bound holds).
    time_scale multiplies compute times only (models real cores running
    somewhere between peak and WCET).
    release maps sid -> earliest time any of its transfers or compute may
    start (job release in a multi-network taskset; see repro_torch.core.taskset).
    engine selects the construction algorithm — the *output* is identical
    (slot-for-slot, property-tested):
      * "rescan"  — the original O(transactions x cores) candidate rescan;
        kept as the reference oracle and for TDMA arbitration;
      * "eventq"  — heap-based event queue: candidate eligibilities are
        computed once when they become known and selection is O(log n);
        static arbitration only;
      * "auto"    — "eventq" when it applies, else "rescan".
    """
    if engine == "auto":
        engine = "eventq" if arbitration == "static" else "rescan"
    if engine == "eventq":
        if arbitration != "static":
            raise ValueError("eventq engine supports static arbitration only")
        return _schedule_eventq(subtasks, mapping, hw, wcet=wcet,
                                weight_cache_bytes=weight_cache_bytes,
                                time_scale=time_scale, release=release)
    if engine != "rescan":
        raise ValueError(f"unknown schedule engine {engine}")
    return _schedule_rescan(subtasks, mapping, hw, wcet=wcet,
                            arbitration=arbitration,
                            tdma_quantum=tdma_quantum,
                            weight_cache_bytes=weight_cache_bytes,
                            time_scale=time_scale, release=release)


def _schedule_rescan(subtasks: list[Subtask], mapping: Mapping,
                     hw: HardwareModel, *, wcet: bool = True,
                     arbitration: str = "static",
                     tdma_quantum: float | None = None,
                     weight_cache_bytes: int | None = None,
                     time_scale: float = 1.0,
                     release: dict[int, float] | None = None) -> StaticSchedule:
    """Reference list scheduler (the seed implementation, kept verbatim)."""
    n = mapping.num_cores
    by_id = {st.sid: st for st in subtasks}
    q: list[list[int]] = [mapping.subtasks_on(c) for c in range(n)]
    rel = release or {}

    def dma_t(nbytes: float) -> float:
        return hw.wcet_dma_s(nbytes) if wcet else hw.dma_time_s(nbytes)

    def comp_t(st: Subtask) -> float:
        base = (hw.wcet_compute_s(st.flops, st.int8) if wcet
                else hw.compute_time_s(st.flops, st.int8))
        return max(base, 1e-12) * time_scale

    quantum = tdma_quantum or (64 * 1024 / hw.dram_bw)  # 64 KiB default slot
    cache_cap = weight_cache_bytes or int(hw.scratchpad_bytes * 0.25)
    weight_cache = [_LRU(cache_cap) for _ in range(n)]

    # --- per-subtask derived info -------------------------------------------
    core_of = mapping.core_of
    compute_start: dict[int, float] = {}
    compute_end: dict[int, float] = {}
    store_end: dict[int, float] = {}

    # effective loads after residency analysis; computed lazily per subtask
    def effective_loads(st: Subtask):
        """Loads that actually hit the DMA channel, with dep sids per load."""
        eff = []
        c = core_of[st.sid]
        for ld in st.loads:
            if ld.kind == "weight":
                if weight_cache[c].hit(ld.key()):
                    continue
                weight_cache[c].insert(ld.key(), ld.sp_bytes)
                eff.append((ld, []))
                continue
            prods = [d for d in st.deps
                     if by_id[d].store and by_id[d].store.tensor == ld.tensor]
            overlapping = [d for d in prods if _overlaps(by_id[d].store.region,
                                                         ld.region)]
            if overlapping and all(core_of[d] == c for d in overlapping):
                continue                       # fully resident on this core
            eff.append((ld, overlapping))
        return eff

    # --- event loop ----------------------------------------------------------
    dma_free = 0.0
    core_dma_free = [0.0] * n                  # TDMA: per-core serialization
    dma_slots: list[DMASlot] = []
    comp_slots: list[ComputeSlot] = []
    ptr = [0] * n                              # next queue index per core
    # state machine per core: loads of q[c][ptr] being issued
    pend_loads: list[list | None] = [None] * n
    loads_done_at: list[float] = [0.0] * n
    pend_stores: list[list[tuple[float, Subtask]]] = [[] for _ in range(n)]
    rr = 0
    bytes_moved = 0
    bytes_total = 0
    n_done = 0
    total = len(subtasks)
    guard = 0

    def prefetch_gate(c: int, idx: int) -> float:
        """Earliest time loads for queue item idx may start on core c."""
        released = rel.get(q[c][idx], 0.0)
        if idx == 0:
            return released
        prev = q[c][idx - 1]
        if hw.dual_ported:
            gate = compute_start.get(prev, float("inf"))
        else:
            gate = compute_end.get(prev, float("inf"))
        return max(gate, released)

    for st in subtasks:
        bytes_total += st.load_bytes() + (st.store.nbytes if st.store else 0)

    while n_done < total:
        guard += 1
        if guard > 50 * total + 10_000:
            raise ScheduleError("scheduler failed to make progress")

        # 1. try to issue computes whose loads are all done
        progressed = False
        for c in range(n):
            if ptr[c] >= len(q[c]):
                continue
            sid = q[c][ptr[c]]
            st = by_id[sid]
            if pend_loads[c] is None:
                pend_loads[c] = effective_loads(st)
                loads_done_at[c] = 0.0
            if pend_loads[c]:
                continue
            # all loads issued & done -> schedule compute
            gate = prefetch_gate(c, ptr[c])
            if gate == float("inf"):
                continue
            prev_end = (compute_end[q[c][ptr[c] - 1]] if ptr[c] > 0 else 0.0)
            same_core_dep_end = max(
                [compute_end.get(d, 0.0) for d in st.deps
                 if core_of[d] == c] + [0.0])
            start = max(loads_done_at[c], prev_end, same_core_dep_end,
                        rel.get(sid, 0.0))
            end = start + comp_t(st)
            compute_start[sid], compute_end[sid] = start, end
            comp_slots.append(ComputeSlot(start, end, c, sid))
            if st.store is not None:
                pend_stores[c].append((end, st))
            else:
                store_end[sid] = end
            ptr[c] += 1
            pend_loads[c] = None
            n_done += 1
            progressed = True
        if progressed:
            continue

        # 2. pick the next DMA transaction (paper: ASAP, one at a time,
        #    round-robin tie-break across cores)
        candidates = []  # (eligible, order, core, kind, payload)
        for off in range(n):
            c = (rr + off) % n
            # stores first within a core (frees the buffer earliest)
            if pend_stores[c]:
                ready, st = pend_stores[c][0]
                candidates.append((ready, off, c, "store", st))
            if ptr[c] < len(q[c]) and pend_loads[c]:
                gate = prefetch_gate(c, ptr[c])
                if gate != float("inf"):
                    ld, deps = pend_loads[c][0]
                    dep_t = 0.0
                    ok = True
                    for d in deps:
                        if core_of[d] == c:
                            dep_t = max(dep_t, compute_end.get(d, 0.0))
                        elif d in store_end:
                            dep_t = max(dep_t, store_end[d])
                        else:
                            ok = False        # producer store not yet known
                            break
                    if ok:
                        candidates.append((max(gate, dep_t), off, c,
                                           "load", ld))
        if not candidates:
            raise ScheduleError("deadlock: no schedulable transaction")

        if arbitration == "static":
            # earliest actual start on the shared channel wins
            candidates.sort(key=lambda x: (max(x[0], dma_free), x[1]))
            eligible, _, c, kind, payload = candidates[0]
            start = max(eligible, dma_free)
            if kind == "store":
                st = payload
                dur = dma_t(st.store.nbytes)
                end = start + dur
                dma_slots.append(DMASlot(start, end, c, st.sid,
                                         st.store.tensor, "out",
                                         st.store.nbytes))
                bytes_moved += st.store.nbytes
                store_end[st.sid] = end
                pend_stores[c].pop(0)
            else:
                ld = payload
                dur = dma_t(ld.nbytes)
                end = start + dur
                sid = q[c][ptr[c]]
                dma_slots.append(DMASlot(start, end, c, sid, ld.tensor,
                                         ld.kind, ld.nbytes))
                bytes_moved += ld.nbytes
                pend_loads[c].pop(0)
                loads_done_at[c] = max(loads_done_at[c], end)
            dma_free = end
            rr = (c + 1) % n
        elif arbitration == "tdma":
            # each core owns fixed slots; transfers serialize per core only
            candidates.sort(key=lambda x: (max(x[0], core_dma_free[x[2]]),
                                           x[1]))
            eligible, _, c, kind, payload = candidates[0]
            e = max(eligible, core_dma_free[c])
            if kind == "store":
                st = payload
                s, t_end = _tdma_finish(e, c, dma_t(st.store.nbytes),
                                        quantum, n)
                dma_slots.append(DMASlot(s, t_end, c, st.sid,
                                         st.store.tensor, "out",
                                         st.store.nbytes))
                bytes_moved += st.store.nbytes
                store_end[st.sid] = t_end
                pend_stores[c].pop(0)
            else:
                ld = payload
                s, t_end = _tdma_finish(e, c, dma_t(ld.nbytes), quantum, n)
                sid = q[c][ptr[c]]
                dma_slots.append(DMASlot(s, t_end, c, sid, ld.tensor,
                                         ld.kind, ld.nbytes))
                bytes_moved += ld.nbytes
                pend_loads[c].pop(0)
                loads_done_at[c] = max(loads_done_at[c], t_end)
            core_dma_free[c] = t_end
        else:
            raise ValueError(f"unknown arbitration {arbitration}")

    # flush remaining stores
    for c in range(n):
        for ready, st in pend_stores[c]:
            if arbitration == "static":
                start = max(ready, dma_free)
                end = start + dma_t(st.store.nbytes)
                dma_free = end
            else:
                start, end = _tdma_finish(max(ready, core_dma_free[c]), c,
                                          dma_t(st.store.nbytes), quantum, n)
                core_dma_free[c] = end
            dma_slots.append(DMASlot(start, end, c, st.sid, st.store.tensor,
                                     "out", st.store.nbytes))
            bytes_moved += st.store.nbytes
            store_end[st.sid] = end

    makespan = max([s.end for s in dma_slots] +
                   [s.end for s in comp_slots] + [0.0])
    return StaticSchedule(
        makespan=makespan, dma=sorted(dma_slots, key=lambda s: s.start),
        compute=sorted(comp_slots, key=lambda s: s.start),
        arbitration=arbitration, wcet_mode=wcet, num_cores=n,
        bytes_moved=bytes_moved,
        bytes_saved_reuse=max(0, bytes_total - bytes_moved))


def _schedule_eventq(subtasks: list[Subtask], mapping: Mapping,
                     hw: HardwareModel, *, wcet: bool = True,
                     weight_cache_bytes: int | None = None,
                     time_scale: float = 1.0,
                     release: dict[int, float] | None = None) -> StaticSchedule:
    """Event-queue list scheduler (static arbitration).

    Produces slot-for-slot identical schedules to ``_schedule_rescan``: the
    same ASAP / exclusive-channel / round-robin policy, but instead of
    rebuilding every core's DMA candidate each iteration, a candidate's
    eligibility is computed exactly once — when its inputs (prefetch gate,
    producer store completion) become known — and kept in

      * a min-heap keyed by eligibility for candidates not yet ready at the
        channel-free time (O(log n) push/pop), and
      * a sorted core list for "tied" candidates (eligible <= channel free
        time, where the round-robin tie-break decides): the winner is the
        cyclic successor of the round-robin pointer (O(log n) bisect).

    Correctness of the split relies on two monotonicity facts: the channel
    free time never decreases, and an eligibility never changes once the
    candidate exists — so candidates migrate heap -> tied set at most once.
    """
    n = mapping.num_cores
    by_id = {st.sid: st for st in subtasks}
    q: list[list[int]] = [mapping.subtasks_on(c) for c in range(n)]
    rel = release or {}

    def dma_t(nbytes: float) -> float:
        return hw.wcet_dma_s(nbytes) if wcet else hw.dma_time_s(nbytes)

    def comp_t(st: Subtask) -> float:
        base = (hw.wcet_compute_s(st.flops, st.int8) if wcet
                else hw.compute_time_s(st.flops, st.int8))
        return max(base, 1e-12) * time_scale

    cache_cap = weight_cache_bytes or int(hw.scratchpad_bytes * 0.25)
    weight_cache = [_LRU(cache_cap) for _ in range(n)]

    core_of = mapping.core_of
    compute_start: dict[int, float] = {}
    compute_end: dict[int, float] = {}
    store_end: dict[int, float] = {}

    def effective_loads(st: Subtask):
        eff = []
        c = core_of[st.sid]
        for ld in st.loads:
            if ld.kind == "weight":
                if weight_cache[c].hit(ld.key()):
                    continue
                weight_cache[c].insert(ld.key(), ld.sp_bytes)
                eff.append((ld, []))
                continue
            prods = [d for d in st.deps
                     if by_id[d].store and by_id[d].store.tensor == ld.tensor]
            overlapping = [d for d in prods if _overlaps(by_id[d].store.region,
                                                         ld.region)]
            if overlapping and all(core_of[d] == c for d in overlapping):
                continue
            eff.append((ld, overlapping))
        return eff

    def prefetch_gate(c: int, idx: int) -> float:
        released = rel.get(q[c][idx], 0.0)
        if idx == 0:
            return released
        prev = q[c][idx - 1]
        if hw.dual_ported:
            gate = compute_start.get(prev, float("inf"))
        else:
            gate = compute_end.get(prev, float("inf"))
        return max(gate, released)

    dma_free = 0.0
    dma_slots: list[DMASlot] = []
    comp_slots: list[ComputeSlot] = []
    ptr = [0] * n
    pend_loads: list[list | None] = [None] * n
    loads_done_at: list[float] = [0.0] * n
    pend_stores: list[list[tuple[float, Subtask]]] = [[] for _ in range(n)]
    rr = 0
    bytes_moved = 0
    bytes_total = 0
    n_done = 0
    total = len(subtasks)
    for st in subtasks:
        bytes_total += st.load_bytes() + (st.store.nbytes if st.store else 0)

    # -- candidate bookkeeping (pref: 0 = store, 1 = load, the stable order
    #    the rescan engine's per-core append implies) ------------------------
    _ST, _LD = 0, 1
    live: dict[tuple[int, int], float] = {}     # (core, pref) -> eligibility
    ver: dict[tuple[int, int], int] = {}        # invalidates stale heap rows
    heap: list[tuple[float, int, int, int]] = []  # (elig, ver, core, pref)
    tied: list[list[bool]] = [[False, False] for _ in range(n)]
    tied_cores: list[int] = []                  # sorted; any tied candidate
    load_waiters: dict[int, list[int]] = {}     # producer sid -> waiting cores

    def _tied_add(c: int):
        i = bisect.bisect_left(tied_cores, c)
        if i == len(tied_cores) or tied_cores[i] != c:
            tied_cores.insert(i, c)

    def _tied_discard(c: int):
        if not tied[c][_ST] and not tied[c][_LD]:
            i = bisect.bisect_left(tied_cores, c)
            if i < len(tied_cores) and tied_cores[i] == c:
                tied_cores.pop(i)

    def _register(c: int, pref: int, elig: float):
        key = (c, pref)
        ver[key] = ver.get(key, 0) + 1
        live[key] = elig
        if elig <= dma_free:
            tied[c][pref] = True
            _tied_add(c)
        else:
            heapq.heappush(heap, (elig, ver[key], c, pref))

    def _remove(c: int, pref: int):
        live.pop((c, pref), None)
        if tied[c][pref]:
            tied[c][pref] = False
            _tied_discard(c)

    def _valid(row: tuple[float, int, int, int]) -> bool:
        elig, v, c, pref = row
        return ver.get((c, pref)) == v and live.get((c, pref)) == elig

    def _drain():
        # migrate heap candidates whose eligibility the channel has caught up
        # with into the round-robin tied set
        while heap and heap[0][0] <= dma_free:
            row = heapq.heappop(heap)
            if _valid(row):
                _, _, c, pref = row
                tied[c][pref] = True
                _tied_add(c)

    def _try_register_load(c: int):
        """Create the load candidate for core c's head load once every
        producer completion it depends on is known; else park on a waiter."""
        if ptr[c] >= len(q[c]) or not pend_loads[c] or (c, _LD) in live:
            return
        ld, deps = pend_loads[c][0]
        gate = prefetch_gate(c, ptr[c])
        if gate == float("inf"):
            return
        dep_t = 0.0
        for d in deps:
            if core_of[d] == c:
                dep_t = max(dep_t, compute_end.get(d, 0.0))
            elif d in store_end:
                dep_t = max(dep_t, store_end[d])
            else:
                load_waiters.setdefault(d, []).append(c)
                return
        _register(c, _LD, max(gate, dep_t))

    def _set_store_end(sid: int, t: float):
        store_end[sid] = t
        for c in load_waiters.pop(sid, ()):
            _try_register_load(c)

    def _try_issue(c: int) -> bool:
        """Issue core c's next compute if its loads are all done. Mirrors
        rescan step 1 exactly (the head's effective loads are evaluated the
        moment the queue pointer reaches it)."""
        nonlocal n_done
        if ptr[c] >= len(q[c]):
            return False
        sid = q[c][ptr[c]]
        st = by_id[sid]
        if pend_loads[c] is None:
            pend_loads[c] = effective_loads(st)
            loads_done_at[c] = 0.0
            if pend_loads[c]:
                _try_register_load(c)
        if pend_loads[c]:
            return False
        prev_end = (compute_end[q[c][ptr[c] - 1]] if ptr[c] > 0 else 0.0)
        same_core_dep_end = max(
            [compute_end.get(d, 0.0) for d in st.deps
             if core_of[d] == c] + [0.0])
        start = max(loads_done_at[c], prev_end, same_core_dep_end,
                    rel.get(sid, 0.0))
        end = start + comp_t(st)
        compute_start[sid], compute_end[sid] = start, end
        comp_slots.append(ComputeSlot(start, end, c, sid))
        if st.store is not None:
            pend_stores[c].append((end, st))
            if len(pend_stores[c]) == 1:
                _register(c, _ST, end)
        else:
            _set_store_end(sid, end)
        ptr[c] += 1
        pend_loads[c] = None
        n_done += 1
        if ptr[c] < len(q[c]):
            pend_loads[c] = effective_loads(by_id[q[c][ptr[c]]])
            loads_done_at[c] = 0.0
            if pend_loads[c]:
                _try_register_load(c)
        return True

    def _cascade(cores):
        # round-robin passes in ascending core order == the rescan engine's
        # scan-all-cores-until-no-progress, restricted to cores that can
        # actually have changed state
        active = sorted(set(cores))
        while active:
            active = [c for c in active if _try_issue(c)]

    _cascade(range(n))
    guard = 0
    while n_done < total:
        guard += 1
        if guard > 50 * total + 10_000:
            raise ScheduleError("scheduler failed to make progress")
        _drain()
        if tied_cores:
            i = bisect.bisect_left(tied_cores, rr)
            c = tied_cores[i] if i < len(tied_cores) else tied_cores[0]
            pref = _ST if tied[c][_ST] else _LD
            eligible = live[(c, pref)]
        else:
            while heap and not _valid(heap[0]):
                heapq.heappop(heap)
            if not heap:
                raise ScheduleError("deadlock: no schedulable transaction")
            e0 = heap[0][0]
            group: list[tuple[float, int, int, int]] = []
            while heap and heap[0][0] == e0:
                row = heapq.heappop(heap)
                if _valid(row):
                    group.append(row)
            best = min(group, key=lambda r: ((r[2] - rr) % n, r[3]))
            for row in group:
                if row is not best:
                    heapq.heappush(heap, row)
            eligible, _, c, pref = best
        _remove(c, pref)

        start = max(eligible, dma_free)
        if pref == _ST:
            _, st = pend_stores[c][0]
            dur = dma_t(st.store.nbytes)
            end = start + dur
            dma_slots.append(DMASlot(start, end, c, st.sid,
                                     st.store.tensor, "out",
                                     st.store.nbytes))
            bytes_moved += st.store.nbytes
            pend_stores[c].pop(0)
            dma_free = end
            rr = (c + 1) % n
            _set_store_end(st.sid, end)
            if pend_stores[c]:
                _register(c, _ST, pend_stores[c][0][0])
        else:
            ld, _ = pend_loads[c][0]
            dur = dma_t(ld.nbytes)
            end = start + dur
            sid = q[c][ptr[c]]
            dma_slots.append(DMASlot(start, end, c, sid, ld.tensor,
                                     ld.kind, ld.nbytes))
            bytes_moved += ld.nbytes
            pend_loads[c].pop(0)
            loads_done_at[c] = max(loads_done_at[c], end)
            dma_free = end
            rr = (c + 1) % n
            if pend_loads[c]:
                _try_register_load(c)
            else:
                _cascade([c])

    # flush remaining stores (same core order as the rescan engine)
    for c in range(n):
        for ready, st in pend_stores[c]:
            start = max(ready, dma_free)
            end = start + dma_t(st.store.nbytes)
            dma_free = end
            dma_slots.append(DMASlot(start, end, c, st.sid, st.store.tensor,
                                     "out", st.store.nbytes))
            bytes_moved += st.store.nbytes
            store_end[st.sid] = end

    makespan = max([s.end for s in dma_slots] +
                   [s.end for s in comp_slots] + [0.0])
    return StaticSchedule(
        makespan=makespan, dma=sorted(dma_slots, key=lambda s: s.start),
        compute=sorted(comp_slots, key=lambda s: s.start),
        arbitration="static", wcet_mode=wcet, num_cores=n,
        bytes_moved=bytes_moved,
        bytes_saved_reuse=max(0, bytes_total - bytes_moved))


def validate_schedule(sched: StaticSchedule, subtasks: list[Subtask],
                      mapping: Mapping,
                      release: dict[int, float] | None = None) -> None:
    """Structural invariants (property-tested): raise on any violation.

    Thin wrapper over the static analyzer: the invariants this function
    historically checked inline — exclusive DMA channel, per-core order,
    subtask coverage, dataflow/load ordering, release gating — now live
    in `repro_torch.analysis.schedule_rules` as rules RACE001/RACE002,
    SCHED001-003 (plus hardware-aware rules this wrapper does not run).
    Any error-severity diagnostic raises `ScheduleError` carrying the
    first few rule messages.
    """
    from ..analysis.schedule_rules import analyze_schedule
    diags = [d for d in analyze_schedule(sched, subtasks, mapping,
                                         release=release)
             if d.severity == "error"]
    if diags:
        head = "; ".join(f"{d.rule}: {d.message}" for d in diags[:3])
        more = f" (+{len(diags) - 3} more)" if len(diags) > 3 else ""
        raise ScheduleError(head + more)


def _overlaps(a: tuple, b: tuple) -> bool:
    from .partition import _regions_overlap
    return _regions_overlap(a, b)
