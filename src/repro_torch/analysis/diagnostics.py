"""Structured diagnostics for the schedule sanitizer (``repro_torch.analysis``).

Every rule family (races, scratchpad lifetime, WCET soundness, schedule
structure) reports findings as `Diagnostic` values: a stable rule ID from
the catalog below, a human-readable message, and provenance into the
artifact (core / subtask / op / megakernel segment / network). A
`Suppression` (``RULE`` or ``RULE@scope``) waives a finding; an
`AnalysisReport` bundles the findings for one artifact with the active
suppression set and is what the compiler pipeline, the artifact store,
and the CLI all gate on.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One catalog entry: stable ID, default severity, what it proves."""

    rule_id: str
    severity: str
    family: str
    title: str


_CATALOG = (
    Rule("SCHED001", ERROR, "schedule", "job-release gating"),
    Rule("SCHED002", ERROR, "schedule", "per-core program order"),
    Rule("SCHED003", ERROR, "schedule", "subtask coverage"),
    Rule("RACE001", ERROR, "race", "exclusive DMA channel"),
    Rule("RACE002", ERROR, "race", "read before producer completes"),
    Rule("RACE003", ERROR, "race", "access outside granted TDMA slot"),
    Rule("SPM001", ERROR, "scratchpad", "subtask working set over capacity"),
    Rule("SPM002", ERROR, "scratchpad", "megakernel segment over capacity"),
    Rule("SPM003", ERROR, "scratchpad", "use of non-resident buffer"),
    Rule("SPM004", ERROR, "scratchpad", "double-buffer phase violation"),
    Rule("WCET001", ERROR, "wcet", "bound below schedule makespan"),
    Rule("WCET002", ERROR, "wcet", "slot shorter than its WCET estimate"),
    Rule("WCET003", ERROR, "wcet", "admission report inconsistent"),
    Rule("ANL001", WARNING, "analysis", "artifact not fully analyzable"),
)

RULES: dict[str, Rule] = {r.rule_id: r for r in _CATALOG}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable rule ID plus provenance into the artifact."""

    rule: str
    message: str
    severity: str = ""
    core: int | None = None
    sid: int | None = None
    op: str | None = None
    step: int | None = None
    network: str | None = None

    def __post_init__(self) -> None:
        if not self.severity:
            rule = RULES.get(self.rule)
            severity = rule.severity if rule is not None else ERROR
            object.__setattr__(self, "severity", severity)

    @property
    def where(self) -> str:
        parts: list[str] = []
        if self.network is not None:
            parts.append(f"net={self.network}")
        if self.core is not None:
            parts.append(f"core={self.core}")
        if self.sid is not None:
            parts.append(f"sid={self.sid}")
        if self.op is not None:
            parts.append(f"op={self.op}")
        if self.step is not None:
            parts.append(f"seg={self.step}")
        return ",".join(parts)

    def row(self) -> str:
        where = self.where
        loc = f" [{where}]" if where else ""
        return f"{self.rule} {self.severity}{loc}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    """A waiver directive: ``RULE`` or ``RULE@scope``.

    The scope narrows the waiver to one site: an op name, ``s<sid>``,
    ``core<n>``, or a network name. A bare rule waives every instance.
    """

    rule: str
    scope: str | None = None

    @classmethod
    def parse(cls, text: str) -> "Suppression":
        rule, sep, scope = text.partition("@")
        rule = rule.strip().upper()
        if not rule:
            raise ValueError(f"empty rule in suppression {text!r}")
        if not sep:
            return cls(rule, None)
        return cls(rule, scope.strip() or None)

    def matches(self, diag: Diagnostic) -> bool:
        if self.rule != diag.rule:
            return False
        if self.scope is None:
            return True
        sites: list[str] = []
        if diag.op is not None:
            sites.append(diag.op)
        if diag.sid is not None:
            sites.append(f"s{diag.sid}")
        if diag.core is not None:
            sites.append(f"core{diag.core}")
        if diag.network is not None:
            sites.append(diag.network)
        return self.scope in sites

    def spelled(self) -> str:
        return self.rule if self.scope is None else f"{self.rule}@{self.scope}"


def parse_suppressions(
    items: Iterable[str | Suppression] | None,
) -> tuple[Suppression, ...]:
    """Normalize a mixed list of directives / parsed suppressions."""
    out: list[Suppression] = []
    for item in items or ():
        if isinstance(item, Suppression):
            out.append(item)
        else:
            out.append(Suppression.parse(item))
    return tuple(out)


@dataclasses.dataclass
class AnalysisReport:
    """All diagnostics for one analyzed subject plus the suppression set."""

    subject: str
    diagnostics: list[Diagnostic]
    suppressions: tuple[Suppression, ...] = ()
    duration_s: float = 0.0

    def suppressed(self, diag: Diagnostic) -> bool:
        return any(s.matches(diag) for s in self.suppressions)

    def unsuppressed(self, severity: str | None = None) -> list[Diagnostic]:
        out: list[Diagnostic] = []
        for d in self.diagnostics:
            if self.suppressed(d):
                continue
            if severity is not None and d.severity != severity:
                continue
            out.append(d)
        return out

    @property
    def errors(self) -> list[Diagnostic]:
        return self.unsuppressed(ERROR)

    @property
    def ok(self) -> bool:
        """True iff no unsuppressed error-severity diagnostic remains."""
        return not self.errors

    @property
    def clean(self) -> bool:
        """True iff the analysis produced no diagnostics at all."""
        return not self.diagnostics

    def summary(self) -> str:
        shown = self.unsuppressed()
        n_sup = len(self.diagnostics) - len(shown)
        head = (
            f"analysis[{self.subject}]: {len(shown)} diagnostics "
            f"({len(self.errors)} errors, {n_sup} suppressed) "
            f"in {self.duration_s * 1e3:.2f} ms"
        )
        return "\n".join([head] + ["  " + d.row() for d in shown])
