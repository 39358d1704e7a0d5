"""Schedule-structure and race/interference rules (SCHED*, RACE*, SPM004,
WCET002).

These rules walk a `StaticSchedule` plus the subtask/mapping artifacts it
was built from and prove the paper's interference-freedom claims: the
shared DMA channel is exclusively owned at every instant (RACE001), no
core consumes a buffer before the producing transfer has completed
(RACE002), TDMA transfers start and finish inside their core's granted
slot (RACE003), prefetches respect the double-buffer phase of the
previous queue item (SPM004), and — in WCET mode — every slot is at
least as long as the hardware model's worst-case estimate (WCET002).

Unlike the historical ``validate_schedule`` (now a thin wrapper over
this module), the rules never raise: they return every violation as a
`Diagnostic` so one corrupted artifact yields a full report.
"""

from __future__ import annotations

from ..core.mapping import Mapping
from ..core.partition import Subtask, _regions_overlap
from ..core.schedule import ComputeSlot, DMASlot, StaticSchedule
from ..hw import HardwareModel
from .diagnostics import Diagnostic

_EPS = 1e-9


def analyze_schedule(
    sched: StaticSchedule,
    subtasks: list[Subtask],
    mapping: Mapping,
    *,
    release: dict[int, float] | None = None,
    hw: HardwareModel | None = None,
    tdma_quantum: float | None = None,
    network: str | None = None,
) -> list[Diagnostic]:
    """Run every schedule-level rule; hardware-dependent rules (RACE003,
    SPM004, WCET002) only run when ``hw`` is given."""
    by_id = {st.sid: st for st in subtasks}
    core_of = dict(mapping.core_of)

    compute_by_sid: dict[int, ComputeSlot] = {}
    duplicated: set[int] = set()
    for cs in sched.compute:
        if cs.sid in compute_by_sid:
            duplicated.add(cs.sid)
        else:
            compute_by_sid[cs.sid] = cs

    diags = _coverage(sched, by_id, compute_by_sid, duplicated, network)
    diags += _core_order(sched, core_of, network)
    if sched.arbitration == "static":
        diags += dma_exclusivity(sched, network=network)
    elif hw is not None:
        diags += _tdma_grants(sched, hw, tdma_quantum, network)
    diags += _dataflow(sched, subtasks, core_of, compute_by_sid, network)
    if release:
        diags += _release_gating(sched, release, by_id, network)
    if hw is not None:
        diags += _prefetch_phase(sched, mapping, hw, compute_by_sid, by_id, network)
        if sched.wcet_mode:
            diags += _wcet_slots(sched, by_id, hw, network)
    return diags


def dma_exclusivity(
    sched: StaticSchedule, *, network: str | None = None
) -> list[Diagnostic]:
    """RACE001: under static arbitration the shared DMA channel is a
    single resource — no two windows may overlap, regardless of core."""
    diags: list[Diagnostic] = []
    if sched.arbitration != "static":
        return diags
    prev: DMASlot | None = None
    for s in sorted(sched.dma, key=lambda s: (s.start, s.end)):
        if prev is not None and s.start < prev.end - _EPS:
            diags.append(
                Diagnostic(
                    "RACE001",
                    f"DMA windows overlap on the shared channel: core "
                    f"{prev.core} {prev.kind} {prev.tensor!r} "
                    f"[{prev.start:.9f}, {prev.end:.9f}) vs core {s.core} "
                    f"{s.kind} {s.tensor!r} [{s.start:.9f}, {s.end:.9f})",
                    core=s.core,
                    sid=s.sid,
                    network=network,
                )
            )
        if prev is None or s.end > prev.end:
            prev = s
    return diags


def _coverage(
    sched: StaticSchedule,
    by_id: dict[int, Subtask],
    compute_by_sid: dict[int, ComputeSlot],
    duplicated: set[int],
    network: str | None,
) -> list[Diagnostic]:
    """SCHED003: every subtask computed exactly once, no phantom slots."""
    diags: list[Diagnostic] = []
    for sid in sorted(duplicated):
        st = by_id.get(sid)
        diags.append(
            Diagnostic(
                "SCHED003",
                f"subtask {sid} is computed more than once",
                sid=sid,
                op=st.op_name if st is not None else None,
                network=network,
            )
        )
    for sid in sorted(set(by_id) - set(compute_by_sid)):
        diags.append(
            Diagnostic(
                "SCHED003",
                f"subtask {sid} is never computed",
                sid=sid,
                op=by_id[sid].op_name,
                network=network,
            )
        )
    for sid in sorted(set(compute_by_sid) - set(by_id)):
        diags.append(
            Diagnostic(
                "SCHED003",
                f"compute slot references unknown subtask {sid}",
                sid=sid,
                network=network,
            )
        )
    for sid in sorted({s.sid for s in sched.dma} - set(by_id)):
        diags.append(
            Diagnostic(
                "SCHED003",
                f"DMA slot references unknown subtask {sid}",
                sid=sid,
                network=network,
            )
        )
    return diags


def _core_order(
    sched: StaticSchedule, core_of: dict[int, int], network: str | None
) -> list[Diagnostic]:
    """SCHED002: per-core compute slots are disjoint, in model (sid)
    order, and placed on the core the mapping assigned."""
    diags: list[Diagnostic] = []
    per_core: dict[int, list[ComputeSlot]] = {}
    for s in sched.compute:
        per_core.setdefault(s.core, []).append(s)
        mapped = core_of.get(s.sid)
        if mapped is not None and mapped != s.core:
            diags.append(
                Diagnostic(
                    "SCHED002",
                    f"subtask {s.sid} computes on core {s.core} but the "
                    f"mapping places it on core {mapped}",
                    core=s.core,
                    sid=s.sid,
                    network=network,
                )
            )
    for c, slots in sorted(per_core.items()):
        slots.sort(key=lambda s: s.start)
        for a, b in zip(slots, slots[1:]):
            if b.start < a.end - _EPS:
                diags.append(
                    Diagnostic(
                        "SCHED002",
                        f"compute slots overlap on core {c}: subtask {a.sid} "
                        f"[{a.start:.9f}, {a.end:.9f}) vs subtask {b.sid} "
                        f"[{b.start:.9f}, {b.end:.9f})",
                        core=c,
                        sid=b.sid,
                        network=network,
                    )
                )
            if b.sid < a.sid:
                diags.append(
                    Diagnostic(
                        "SCHED002",
                        f"model order violated on core {c}: subtask {b.sid} "
                        f"runs after subtask {a.sid}",
                        core=c,
                        sid=b.sid,
                        network=network,
                    )
                )
    return diags


def _tdma_grants(
    sched: StaticSchedule,
    hw: HardwareModel,
    quantum: float | None,
    network: str | None,
) -> list[Diagnostic]:
    """RACE003: under TDMA every transfer must start and finish inside
    its owning core's statically granted slot (interior cycles are owned
    by construction of the closed-form `_tdma_finish`)."""
    diags: list[Diagnostic] = []
    q = quantum if quantum is not None else 64 * 1024 / hw.dram_bw
    cycle = q * sched.num_cores
    for s in sched.dma:
        s0 = s.core * q
        for label, t in (("starts", s.start), ("ends", s.end)):
            pos = t % cycle
            # `_tdma_finish` builds times by float additions, so a point
            # that is mathematically on a cycle boundary can sit a few
            # ulps below it and the modulo wraps it to ~`cycle`; fold the
            # congruent position back toward the window before testing.
            if pos - cycle >= s0 - _EPS:
                pos -= cycle
            elif pos < s0 - _EPS:
                pos += cycle
            if pos > s0 + q + _EPS:
                diags.append(
                    Diagnostic(
                        "RACE003",
                        f"{s.kind} transfer for subtask {s.sid} {label} at "
                        f"{t:.9f}, outside core {s.core}'s granted TDMA "
                        f"window (quantum {q:.3e} s)",
                        core=s.core,
                        sid=s.sid,
                        network=network,
                    )
                )
                break
    return diags


def _dataflow(
    sched: StaticSchedule,
    subtasks: list[Subtask],
    core_of: dict[int, int],
    compute_by_sid: dict[int, ComputeSlot],
    network: str | None,
) -> list[Diagnostic]:
    """RACE002: no read before the producing work completes — compute
    after every dependency, compute after the subtask's own loads, and
    cross-core activation transfers only after the producer's store-back
    to shared memory has finished."""
    diags: list[Diagnostic] = []
    by_id = {st.sid: st for st in subtasks}
    start_of = {sid: s.start for sid, s in compute_by_sid.items()}
    end_of = {sid: s.end for sid, s in compute_by_sid.items()}

    for st in subtasks:
        t0 = start_of.get(st.sid)
        if t0 is None:
            continue
        for d in st.deps:
            te = end_of.get(d)
            if te is not None and t0 < te - _EPS:
                diags.append(
                    Diagnostic(
                        "RACE002",
                        f"subtask {st.sid} computes at {t0:.9f} before its "
                        f"dependency {d} completes at {te:.9f}",
                        core=core_of.get(st.sid),
                        sid=st.sid,
                        op=st.op_name,
                        network=network,
                    )
                )

    load_end: dict[int, float] = {}
    load_slots: dict[tuple[int, str], list[DMASlot]] = {}
    out_end: dict[tuple[int, str], float] = {}
    for s in sched.dma:
        if s.kind == "out":
            key = (s.sid, s.tensor)
            out_end[key] = max(out_end.get(key, 0.0), s.end)
            continue
        load_end[s.sid] = max(load_end.get(s.sid, 0.0), s.end)
        if s.kind == "act":
            load_slots.setdefault((s.sid, s.tensor), []).append(s)

    for sid, le in sorted(load_end.items()):
        t0 = start_of.get(sid)
        if t0 is not None and t0 < le - _EPS:
            st = by_id.get(sid)
            diags.append(
                Diagnostic(
                    "RACE002",
                    f"subtask {sid} computes at {t0:.9f} before its loads "
                    f"drain at {le:.9f}",
                    core=core_of.get(sid),
                    sid=sid,
                    op=st.op_name if st is not None else None,
                    network=network,
                )
            )

    for st in subtasks:
        c = core_of.get(st.sid)
        seen: set[str] = set()
        for ld in st.loads:
            if ld.kind != "act" or ld.tensor in seen:
                continue
            seen.add(ld.tensor)
            cross: list[int] = []
            for d in st.deps:
                prod = by_id.get(d)
                if prod is None or prod.store is None:
                    continue
                if prod.store.tensor != ld.tensor:
                    continue
                if not _regions_overlap(prod.store.region, ld.region):
                    continue
                if core_of.get(d) != c:
                    cross.append(d)
            if not cross:
                continue
            slots = load_slots.get((st.sid, ld.tensor))
            if not slots:
                diags.append(
                    Diagnostic(
                        "RACE002",
                        f"subtask {st.sid} consumes {ld.tensor!r} produced "
                        f"on another core, but the schedule records no "
                        f"transfer for it",
                        core=c,
                        sid=st.sid,
                        op=st.op_name,
                        network=network,
                    )
                )
                continue
            first = min(s.start for s in slots)
            for d in cross:
                pe = out_end.get((d, ld.tensor))
                if pe is None:
                    diags.append(
                        Diagnostic(
                            "RACE002",
                            f"producer {d} never stores {ld.tensor!r} back "
                            f"to shared memory for consumer {st.sid}",
                            core=c,
                            sid=st.sid,
                            op=st.op_name,
                            network=network,
                        )
                    )
                elif first < pe - _EPS:
                    diags.append(
                        Diagnostic(
                            "RACE002",
                            f"transfer of {ld.tensor!r} for subtask {st.sid} "
                            f"starts at {first:.9f} before producer {d} "
                            f"finishes storing it at {pe:.9f}",
                            core=c,
                            sid=st.sid,
                            op=st.op_name,
                            network=network,
                        )
                    )
    return diags


def _release_gating(
    sched: StaticSchedule,
    release: dict[int, float],
    by_id: dict[int, Subtask],
    network: str | None,
) -> list[Diagnostic]:
    """SCHED001: nothing for a job happens before the job's release."""
    diags: list[Diagnostic] = []
    for s in sched.dma:
        r = release.get(s.sid, 0.0)
        if s.start < r - _EPS:
            diags.append(
                Diagnostic(
                    "SCHED001",
                    f"{s.kind} DMA for subtask {s.sid} starts at "
                    f"{s.start:.9f} before its job release at {r:.9f}",
                    core=s.core,
                    sid=s.sid,
                    network=network,
                )
            )
    for cs in sched.compute:
        r = release.get(cs.sid, 0.0)
        if cs.start < r - _EPS:
            st = by_id.get(cs.sid)
            diags.append(
                Diagnostic(
                    "SCHED001",
                    f"subtask {cs.sid} computes at {cs.start:.9f} before "
                    f"its job release at {r:.9f}",
                    core=cs.core,
                    sid=cs.sid,
                    op=st.op_name if st is not None else None,
                    network=network,
                )
            )
    return diags


def _prefetch_phase(
    sched: StaticSchedule,
    mapping: Mapping,
    hw: HardwareModel,
    compute_by_sid: dict[int, ComputeSlot],
    by_id: dict[int, Subtask],
    network: str | None,
) -> list[Diagnostic]:
    """SPM004: double-buffer phase discipline — a queue item's loads may
    only start once the previous item's scratchpad phase has retired
    (its compute has *started* on dual-ported scratchpads, *ended* on
    single-ported ones)."""
    diags: list[Diagnostic] = []
    dma_by_sid: dict[int, list[DMASlot]] = {}
    for s in sched.dma:
        if s.kind != "out":
            dma_by_sid.setdefault(s.sid, []).append(s)
    for c in range(mapping.num_cores):
        queue = mapping.subtasks_on(c)
        for idx in range(1, len(queue)):
            sid = queue[idx]
            slots = dma_by_sid.get(sid)
            if not slots:
                continue
            prev = compute_by_sid.get(queue[idx - 1])
            if prev is None:
                continue
            gate = prev.start if hw.dual_ported else prev.end
            for s in slots:
                if s.start < gate - _EPS:
                    st = by_id.get(sid)
                    diags.append(
                        Diagnostic(
                            "SPM004",
                            f"prefetch of {s.tensor!r} for subtask {sid} "
                            f"starts at {s.start:.9f} while the previous "
                            f"queue item {queue[idx - 1]} still owns the "
                            f"scratchpad half (phase gate {gate:.9f})",
                            core=c,
                            sid=sid,
                            op=st.op_name if st is not None else None,
                            network=network,
                        )
                    )
    return diags


def _wcet_slots(
    sched: StaticSchedule,
    by_id: dict[int, Subtask],
    hw: HardwareModel,
    network: str | None,
) -> list[Diagnostic]:
    """WCET002: in WCET mode every slot must be at least as long as the
    hardware model's worst-case estimate for the work it performs."""
    diags: list[Diagnostic] = []
    for cs in sched.compute:
        st = by_id.get(cs.sid)
        if st is None:
            continue
        bound = max(hw.wcet_compute_s(st.flops, st.int8), 1e-12)
        dur = cs.end - cs.start
        if dur < bound - (1e-9 * bound + 1e-14 * abs(cs.end)):
            diags.append(
                Diagnostic(
                    "WCET002",
                    f"compute slot for subtask {cs.sid} lasts {dur:.3e} s, "
                    f"below its WCET estimate {bound:.3e} s",
                    core=cs.core,
                    sid=cs.sid,
                    op=st.op_name,
                    network=network,
                )
            )
    for s in sched.dma:
        bound = hw.wcet_dma_s(s.nbytes)
        dur = s.end - s.start
        if dur < bound - (1e-9 * bound + 1e-14 * abs(s.end)):
            diags.append(
                Diagnostic(
                    "WCET002",
                    f"{s.kind} DMA slot for subtask {s.sid} "
                    f"({s.tensor!r}, {s.nbytes} B) lasts {dur:.3e} s, "
                    f"below its WCET estimate {bound:.3e} s",
                    core=s.core,
                    sid=s.sid,
                    network=network,
                )
            )
    return diags
