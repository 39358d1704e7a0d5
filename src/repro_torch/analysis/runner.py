"""Entry points binding the rule families to compiled artifacts.

`analyze_deployment` / `analyze_taskset_deployment` walk the in-memory
deployment objects `repro_torch.compile` returns; `analyze_artifact` /
`analyze_bundle` lint what is on disk (loading with verification off, so
a corrupt artifact can still be linted instead of refusing to open).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

from ..core.schedule import compute_schedule
from .diagnostics import AnalysisReport, Diagnostic, parse_suppressions
from .lifetime import analyze_program, analyze_subtasks
from .schedule_rules import analyze_schedule, dma_exclusivity
from .wcet_rules import analyze_taskset_report, analyze_wcet

def deployment_diagnostics(dep: Any) -> list[Diagnostic]:
    """Every rule family over one single-network deployment."""
    diags: list[Diagnostic] = []
    artifacts = getattr(dep, "artifacts", None) or {}
    subtasks = artifacts.get("partition")
    mapping = artifacts.get("map")
    hw = dep.machine
    if dep.schedule is not None:
        if subtasks is not None and mapping is not None:
            diags += analyze_schedule(dep.schedule, subtasks, mapping, hw=hw)
        else:
            # artifact predates the staged pipeline: the schedule is
            # still checkable for bus exclusivity, the rest is not
            diags.append(
                Diagnostic(
                    "ANL001",
                    "artifact carries no partition/mapping stage outputs; "
                    "only bus-exclusivity and WCET-report rules ran",
                )
            )
            diags += dma_exclusivity(dep.schedule)
    if subtasks is not None and hw is not None:
        diags += analyze_subtasks(subtasks, hw)
    if dep.program is not None:
        diags += analyze_program(
            dep.program, hw, options=getattr(dep, "options", None)
        )
    diags += analyze_wcet(dep.report, dep.schedule, subtasks=subtasks)
    return diags


def analyze_deployment(
    dep: Any, *, suppress: tuple = (), subject: str | None = None
) -> AnalysisReport:
    """Full analysis of one `Deployment`, honoring both the directives
    persisted on the artifact and any extra ``suppress`` entries."""
    t0 = time.perf_counter()
    diags = deployment_diagnostics(dep)
    carried = tuple(getattr(dep, "suppressions", ()) or ())
    report = AnalysisReport(
        subject=subject or f"{dep.graph.name}@{dep.machine.name}",
        diagnostics=diags,
        suppressions=parse_suppressions(carried + tuple(suppress)),
    )
    report.duration_s = time.perf_counter() - t0
    return report


def taskset_diagnostics(tdep: Any) -> list[Diagnostic]:
    """Every rule family over a compiled taskset (hyperperiod level plus
    each member network's executable deployment)."""
    diags: list[Diagnostic] = []
    compiled = tdep.taskset
    hw = tdep.machine
    sched = compiled.schedule
    if sched is not None and not sched.wcet_mode and hw is not None:
        # replays overwrite the recorded schedule in place; re-derive the
        # WCET-mode one deterministically before checking invariants
        sched = compute_schedule(
            compiled.subtasks,
            compiled.mapping,
            hw,
            wcet=True,
            arbitration=sched.arbitration,
            release=compiled.release,
        )
    if sched is not None:
        diags += analyze_schedule(
            sched,
            compiled.subtasks,
            compiled.mapping,
            release=compiled.release,
            hw=hw,
        )
    if hw is not None:
        diags += analyze_subtasks(compiled.subtasks, hw)
    diags += analyze_taskset_report(tdep.report, compiled, hw, schedule=sched)
    for name, dep in sorted(getattr(tdep, "deployments", {}).items()):
        diags += [
            d if d.network is not None else _with_network(d, name)
            for d in deployment_diagnostics(dep)
        ]
    return diags


def _with_network(diag: Diagnostic, network: str) -> Diagnostic:
    return dataclasses.replace(diag, network=network)


def analyze_taskset_deployment(
    tdep: Any, *, suppress: tuple = (), subject: str | None = None
) -> AnalysisReport:
    t0 = time.perf_counter()
    diags = taskset_diagnostics(tdep)
    carried = tuple(getattr(tdep, "suppressions", ()) or ())
    report = AnalysisReport(
        subject=subject or f"taskset@{tdep.machine.name}",
        diagnostics=diags,
        suppressions=parse_suppressions(carried + tuple(suppress)),
    )
    report.duration_s = time.perf_counter() - t0
    return report


def analyze_artifact(path: str, *, suppress: tuple = ()) -> AnalysisReport:
    """Lint one saved ``.rtdep`` artifact (verification off on load, so a
    bad artifact is reported instead of refused). The rules read the
    schedule and program only and run nothing, so the artifact is loaded
    for the host (``device="cpu"``): linting needs no GPU."""
    from ..compiler.deployment import Deployment

    dep = Deployment.load(path, verify=False, device="cpu")
    return analyze_deployment(dep, suppress=suppress, subject=path)


def analyze_bundle(
    dirpath: str, *, suppress: tuple = ()
) -> list[AnalysisReport]:
    """Lint every member of a bundle directory (loaded for the host, as
    `analyze_artifact` loads)."""
    from ..compiler.deployment import load_bundle

    deployments, _extra, _objects = load_bundle(dirpath, verify=False,
                                                device="cpu")
    return [
        analyze_deployment(
            dep, suppress=suppress, subject=f"{dirpath}::{name}"
        )
        for name, dep in sorted(deployments.items())
    ]


def is_cluster_artifact(dirpath: str) -> bool:
    """True when `dirpath` is a `ClusterServer.save` layout (a cluster
    manifest next to a replica bundle)."""
    from ..cluster.fleet import CLUSTER_MANIFEST

    return os.path.isfile(os.path.join(dirpath, CLUSTER_MANIFEST))


def analyze_cluster(
    dirpath: str, *, suppress: tuple = ()
) -> list[AnalysisReport]:
    """Lint a cluster artifact: every member of the (shared) replica
    bundle, one subject per member.

    Replicas are identical by construction (`ClusterServer.save` persists
    one bundle plus a manifest), so linting the bundle once covers the
    whole fleet; the manifest itself is validated for shape here so a
    corrupt cluster directory fails with exit 2 like any unreadable
    artifact."""
    import json

    from ..cluster.fleet import CLUSTER_MANIFEST, REPLICA_BUNDLE

    manifest_path = os.path.join(dirpath, CLUSTER_MANIFEST)
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest.get("kind") != "cluster":
        raise ValueError(
            f"{manifest_path}: manifest kind "
            f"{manifest.get('kind')!r} != 'cluster'"
        )
    replicas = int(manifest.get("replicas", 0))
    if replicas < 1:
        raise ValueError(
            f"{manifest_path}: replica count {replicas} < 1"
        )
    bundle = os.path.join(dirpath, REPLICA_BUNDLE)
    if not os.path.isdir(bundle):
        raise ValueError(
            f"{dirpath}: cluster manifest present but replica bundle "
            f"{REPLICA_BUNDLE!r} is missing"
        )
    return analyze_bundle(bundle, suppress=suppress)
