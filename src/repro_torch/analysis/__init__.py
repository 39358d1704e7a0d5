"""repro_torch.analysis — the schedule sanitizer.

Rule-based static analysis over compiled deployments: shared-memory
race/interference detection (RACE*), scratchpad lifetime checking
(SPM*), WCET-soundness verification (WCET*), and schedule-structure
invariants (SCHED*). See docs/analysis.md for the rule catalog,
suppression syntax, and CLI usage (``python -m repro_torch.analysis``).
"""

from .diagnostics import (
    ERROR,
    RULES,
    WARNING,
    AnalysisReport,
    Diagnostic,
    Rule,
    Suppression,
    parse_suppressions,
)
from .lifetime import analyze_program, analyze_subtasks
from .runner import (
    analyze_artifact,
    analyze_bundle,
    analyze_deployment,
    analyze_taskset_deployment,
    deployment_diagnostics,
    taskset_diagnostics,
)
from .schedule_rules import analyze_schedule, dma_exclusivity
from .wcet_rules import analyze_taskset_report, analyze_wcet

__all__ = [
    "ERROR",
    "RULES",
    "WARNING",
    "AnalysisReport",
    "Diagnostic",
    "Rule",
    "Suppression",
    "analyze_artifact",
    "analyze_bundle",
    "analyze_deployment",
    "analyze_program",
    "analyze_schedule",
    "analyze_subtasks",
    "analyze_taskset_deployment",
    "analyze_taskset_report",
    "analyze_wcet",
    "deployment_diagnostics",
    "dma_exclusivity",
    "parse_suppressions",
    "taskset_diagnostics",
]
