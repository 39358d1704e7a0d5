"""WCET-soundness rules (WCET001, WCET003; WCET002 lives with the
schedule walk in `schedule_rules`).

WCET001 proves the analytical bound actually covers what the static
schedule implies: a single-network report's total WCET must be at least
the WCET-mode makespan, and every job's worst-case response derived from
the hyperperiod schedule must sit under its network's published response
bound (response-bound monotonicity across the hyperperiod). WCET003
flags admission-report inconsistencies — counts, hyperperiod, makespan,
or bounds that disagree with the artifacts they were derived from. Job
finishes are *recomputed* from the WCET schedule rather than read from
``Job.finish`` (replays overwrite that field in place)."""

from __future__ import annotations

from ..core.partition import Subtask
from ..core.schedule import StaticSchedule, compute_schedule
from ..core.taskset import CompiledTaskset
from ..core.wcet import TasksetReport, WCETReport
from ..hw import HardwareModel
from .diagnostics import Diagnostic

_EPS = 1e-9


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= _EPS * max(abs(a), abs(b), _EPS)


def analyze_wcet(
    report: WCETReport | None,
    sched: StaticSchedule | None,
    *,
    subtasks: list[Subtask] | None = None,
    network: str | None = None,
) -> list[Diagnostic]:
    """Single-network WCET report vs its schedule (WCET001/WCET003)."""
    diags: list[Diagnostic] = []
    if report is None or sched is None or not sched.wcet_mode:
        return diags
    if report.wcet_total_s < sched.makespan * (1 - _EPS):
        diags.append(
            Diagnostic(
                "WCET001",
                f"reported WCET bound {report.wcet_total_s:.9f} s is below "
                f"the schedule makespan {sched.makespan:.9f} s — the bound "
                f"is unsound",
                network=network,
            )
        )
    elif not _close(report.wcet_total_s, sched.makespan):
        diags.append(
            Diagnostic(
                "WCET003",
                f"reported WCET bound {report.wcet_total_s:.9f} s does not "
                f"match the schedule makespan {sched.makespan:.9f} s",
                network=network,
            )
        )
    if report.num_cores != sched.num_cores:
        diags.append(
            Diagnostic(
                "WCET003",
                f"report claims {report.num_cores} cores but the schedule "
                f"targets {sched.num_cores}",
                network=network,
            )
        )
    if report.bytes_moved != sched.bytes_moved:
        diags.append(
            Diagnostic(
                "WCET003",
                f"report claims {report.bytes_moved} bytes moved but the "
                f"schedule moves {sched.bytes_moved}",
                network=network,
            )
        )
    if subtasks is not None and report.num_subtasks != len(subtasks):
        diags.append(
            Diagnostic(
                "WCET003",
                f"report claims {report.num_subtasks} subtasks but the "
                f"partition holds {len(subtasks)}",
                network=network,
            )
        )
    return diags


def _recomputed_finishes(sched: StaticSchedule) -> dict[int, float]:
    """Per-sid retirement time (last compute AND last output store),
    mirroring `taskset._job_finishes` but never trusting `Job.finish`."""
    end: dict[int, float] = {}
    for cs in sched.compute:
        end[cs.sid] = max(end.get(cs.sid, 0.0), cs.end)
    for s in sched.dma:
        if s.kind == "out":
            end[s.sid] = max(end.get(s.sid, 0.0), s.end)
    return end


def analyze_taskset_report(
    report: TasksetReport | None,
    compiled: CompiledTaskset,
    hw: HardwareModel | None = None,
    *,
    schedule: StaticSchedule | None = None,
) -> list[Diagnostic]:
    """Hyperperiod admission report vs the compiled taskset.

    ``schedule`` overrides the taskset's recorded schedule; when the
    recorded one is an actual-rate replay (``wcet_mode=False``) and a
    hardware model is available, the WCET schedule is re-derived
    deterministically before checking."""
    diags: list[Diagnostic] = []
    if report is None:
        return diags
    sched = schedule if schedule is not None else compiled.schedule
    if sched is not None and not sched.wcet_mode:
        if hw is None:
            return [
                Diagnostic(
                    "ANL001",
                    "taskset carries an actual-rate replay schedule and no "
                    "hardware model; WCET soundness not checkable",
                )
            ]
        sched = compute_schedule(
            compiled.subtasks,
            compiled.mapping,
            hw,
            wcet=True,
            arbitration=sched.arbitration,
            release=compiled.release,
        )
    if sched is None:
        if hw is None:
            return [
                Diagnostic(
                    "ANL001",
                    "taskset carries no schedule and no hardware model; "
                    "WCET soundness not checkable",
                )
            ]
        sched = compute_schedule(
            compiled.subtasks,
            compiled.mapping,
            hw,
            wcet=True,
            release=compiled.release,
        )

    if not _close(report.hyperperiod_s, compiled.hyperperiod_s):
        diags.append(
            Diagnostic(
                "WCET003",
                f"report hyperperiod {report.hyperperiod_s:.9f} s does not "
                f"match the compiled hyperperiod "
                f"{compiled.hyperperiod_s:.9f} s",
            )
        )
    if report.total_jobs != len(compiled.jobs):
        diags.append(
            Diagnostic(
                "WCET003",
                f"report claims {report.total_jobs} jobs but the "
                f"hyperperiod instantiates {len(compiled.jobs)}",
            )
        )
    if report.total_subtasks != len(compiled.subtasks):
        diags.append(
            Diagnostic(
                "WCET003",
                f"report claims {report.total_subtasks} subtasks but the "
                f"taskset holds {len(compiled.subtasks)}",
            )
        )
    if report.makespan_s < sched.makespan * (1 - _EPS):
        diags.append(
            Diagnostic(
                "WCET001",
                f"report makespan {report.makespan_s:.9f} s is below the "
                f"WCET schedule makespan {sched.makespan:.9f} s — the "
                f"hyperperiod bound is unsound",
            )
        )
    elif not _close(report.makespan_s, sched.makespan):
        diags.append(
            Diagnostic(
                "WCET003",
                f"report makespan {report.makespan_s:.9f} s does not match "
                f"the WCET schedule makespan {sched.makespan:.9f} s",
            )
        )

    end = _recomputed_finishes(sched)
    known = {spec.name for spec in compiled.specs}
    for v in report.networks:
        if v.name not in known:
            diags.append(
                Diagnostic(
                    "WCET003",
                    f"report carries a verdict for unknown network "
                    f"{v.name!r}",
                    network=v.name,
                )
            )
    for spec in compiled.specs:
        try:
            verdict = report.verdict_of(spec.name)
        except KeyError:
            diags.append(
                Diagnostic(
                    "WCET003",
                    f"report carries no verdict for network {spec.name!r}",
                    network=spec.name,
                )
            )
            continue
        jobs = compiled.jobs_of(spec.name)
        if verdict.n_jobs != len(jobs):
            diags.append(
                Diagnostic(
                    "WCET003",
                    f"verdict for {spec.name!r} claims {verdict.n_jobs} "
                    f"jobs but the hyperperiod releases {len(jobs)}",
                    network=spec.name,
                )
            )
        if not _close(verdict.period_s, spec.period_s) or not _close(
            verdict.deadline_s, spec.deadline
        ):
            diags.append(
                Diagnostic(
                    "WCET003",
                    f"verdict for {spec.name!r} records period "
                    f"{verdict.period_s:.9f} s / deadline "
                    f"{verdict.deadline_s:.9f} s but the spec declares "
                    f"{spec.period_s:.9f} s / {spec.deadline:.9f} s",
                    network=spec.name,
                )
            )
        worst = 0.0
        for job in jobs:
            finishes = [end[sid] for sid in job.sids if sid in end]
            if not finishes:
                continue
            worst = max(worst, max(finishes) - job.release)
        if verdict.response_bound_s < worst - _EPS * max(worst, _EPS):
            diags.append(
                Diagnostic(
                    "WCET001",
                    f"response bound {verdict.response_bound_s:.9f} s for "
                    f"{spec.name!r} is below the schedule's worst job "
                    f"response {worst:.9f} s — a job can miss inside its "
                    f"certified budget",
                    network=spec.name,
                )
            )
        elif not _close(verdict.response_bound_s, worst):
            diags.append(
                Diagnostic(
                    "WCET003",
                    f"response bound {verdict.response_bound_s:.9f} s for "
                    f"{spec.name!r} does not match the schedule's worst "
                    f"job response {worst:.9f} s",
                    network=spec.name,
                )
            )
    return diags
