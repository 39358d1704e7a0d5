"""Staged pass pipeline: the paper's compile flow as inspectable stages.

The paper's compiler (§III.B steps 1-7) is one fixed sequence — import,
quantize, split into subtasks, map, schedule the DMA channel, bound the
WCET, emit per-core programs. `repro_torch.core` implements every step, but as
loose functions each caller re-chains by hand. This module makes the
sequence a first-class object:

    PassManager([QuantizePass(), PartitionPass(), MapPass(),
                 SchedulePass(), WCETPass(), LowerPass()]).run(ctx)

Every `Pass` reads and writes one shared `PassContext`; the manager records
per-stage wall time and a one-line artifact summary (`StageRecord`), and
each stage's artifact lands in `ctx.artifacts` so callers can inspect the
subtask set, the mapping, or the raw schedule of a finished compile —
`repro_torch.compile()` forwards all of it on the returned `Deployment`.

Custom pipelines are supported (drop the lowering stage for analysis-only
flows, insert a rewrite pass before partitioning); `default_passes()`
returns the paper-faithful sequence.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Protocol, runtime_checkable

import numpy as np

from ..analysis import (AnalysisReport, analyze_program, analyze_schedule,
                        analyze_subtasks, analyze_wcet, parse_suppressions)
from ..core.compiled import lower_program, supports_graph, SUPPORTED_KINDS
from ..core.executor import init_params
from ..core.graph import Graph
from ..core.mapping import map_reverse_affinity
from ..core.partition import Partitioner
from ..core.schedule import compute_schedule, validate_schedule
from ..core.wcet import report_from_schedule
from ..hw import HardwareModel


class PipelineError(ValueError):
    """A pass could not produce its artifact from the current context."""


class DeadlineError(PipelineError):
    """The compiled WCET bound exceeds the requested deadline."""


class VerificationError(PipelineError):
    """The schedule sanitizer found a blocking diagnostic (see
    `repro_torch.analysis` and docs/analysis.md; waive specific findings with
    `repro_torch.compile(..., suppress=("RULE@scope", ...))`)."""


def check_deadline(report, deadline: float | None, graph_name: str,
                   hw_name: str) -> None:
    """Raise `DeadlineError` iff `report`'s bound exceeds `deadline`.

    The single deadline comparison (tolerance and message) shared by the
    wcet pass and the deployment-cache hit path in `repro_torch.compile`."""
    if deadline is not None and report.wcet_total_s > deadline * (1 + 1e-9):
        raise DeadlineError(
            f"{graph_name}: WCET bound "
            f"{report.wcet_total_s * 1e3:.3f} ms exceeds deadline "
            f"{deadline * 1e3:.3f} ms on {hw_name}")


@dataclasses.dataclass(frozen=True)
class StageRecord:
    """Per-stage compile telemetry: what ran, how long, what it produced."""

    name: str
    duration_s: float
    summary: str

    def row(self) -> str:
        return f"{self.name:<10}{self.duration_s * 1e3:>9.2f} ms  {self.summary}"


@dataclasses.dataclass
class PassContext:
    """Mutable compile state threaded through the pass pipeline.

    Inputs (set by the caller): graph, hw, params, num_cores, arbitration,
    deadline, validate. Artifacts (set by passes): subtasks, mapping,
    schedule, report, program — each also mirrored into `artifacts` under
    the producing pass's name.
    """

    graph: Graph
    hw: HardwareModel
    params: dict
    num_cores: int | None = None
    arbitration: str = "static"
    deadline: float | None = None
    validate: bool = True
    strict: bool = False                 # verify: fail on warnings too
    suppress: tuple = ()                 # "RULE" / "RULE@scope" waivers
    backend_options: object = None       # BackendOptions, for the verifier
    # -- produced by passes --
    subtasks: list | None = None
    mapping: object = None
    schedule: object = None
    report: object = None
    program: object = None
    analysis: object = None              # AnalysisReport from VerifyPass
    artifacts: dict = dataclasses.field(default_factory=dict)
    stages: list[StageRecord] = dataclasses.field(default_factory=list)


@runtime_checkable
class Pass(Protocol):
    """One pipeline stage. `run` mutates the context and returns a one-line
    artifact summary for the stage record."""

    name: str

    def run(self, ctx: PassContext) -> str: ...


class PassManager:
    """Runs passes in order, timing each and recording its artifact."""

    def __init__(self, passes: list[Pass]):
        self.passes = list(passes)

    def run(self, ctx: PassContext) -> PassContext:
        for p in self.passes:
            t0 = time.perf_counter()
            summary = p.run(ctx)
            ctx.stages.append(StageRecord(
                name=p.name, duration_s=time.perf_counter() - t0,
                summary=summary or ""))
        return ctx

    @staticmethod
    def timing_table(ctx: PassContext) -> str:
        total = sum(s.duration_s for s in ctx.stages)
        rows = [s.row() for s in ctx.stages]
        rows.append(f"{'total':<10}{total * 1e3:>9.2f} ms")
        return "\n".join(rows)


# -- concrete passes ----------------------------------------------------------

class QuantizePass:
    """Validate the int8 graph contract and complete the parameter set.

    Graphs here are already int8-quantized IR (the paper quantizes before
    import; `repro_torch.core.quantize` produces the weights/multipliers). This
    pass enforces that contract — static shapes, topological order, known
    dtypes — and fills any missing weight / requant-multiplier entry from
    `init_params` defaults WITHOUT mutating the caller's dict, so a partial
    params dict compiles while a complete one is baked verbatim.
    """

    name = "quantize"

    def run(self, ctx: PassContext) -> str:
        ctx.graph.validate()
        required = [w for op in ctx.graph.ops for w in op.weights]
        required += [f"{op.name}.mult" for op in ctx.graph.ops
                     if op.kind == "requant"]
        missing = [k for k in required if k not in ctx.params]
        if missing:
            defaults = init_params(ctx.graph)
            ctx.params = {**{k: defaults[k] for k in missing}, **ctx.params}
        n_int8 = sum(1 for t in ctx.graph.tensors.values()
                     if t.dtype in ("int8", "uint8"))
        ctx.artifacts[self.name] = {
            "params": ctx.params, "missing_filled": list(missing),
            "int8_tensors": n_int8}
        return (f"{len(ctx.graph.ops)} ops, {n_int8} int8 tensors"
                + (f", {len(missing)} params synthesized" if missing else ""))


class PartitionPass:
    """Split operators into scratchpad-sized subtasks (paper step 2)."""

    name = "partition"

    def run(self, ctx: PassContext) -> str:
        ctx.subtasks = Partitioner(ctx.hw).partition(ctx.graph)
        ctx.artifacts[self.name] = ctx.subtasks
        return f"{len(ctx.subtasks)} subtasks"


class MapPass:
    """Reverse-traversal reuse-affinity core mapping (paper step 3)."""

    name = "map"

    def run(self, ctx: PassContext) -> str:
        if ctx.subtasks is None:
            raise PipelineError("map pass needs the partition artifact")
        ctx.mapping = map_reverse_affinity(ctx.subtasks, ctx.hw,
                                           ctx.num_cores)
        ctx.artifacts[self.name] = ctx.mapping
        return (f"{ctx.mapping.num_cores} cores, affinity saved "
                f"{ctx.mapping.affinity_bytes_saved / 1e6:.2f} MB")


class SchedulePass:
    """Static DMA + compute schedule with WCET times (paper steps 6-7)."""

    name = "schedule"

    def run(self, ctx: PassContext) -> str:
        if ctx.subtasks is None or ctx.mapping is None:
            raise PipelineError("schedule pass needs partition + map")
        ctx.schedule = compute_schedule(ctx.subtasks, ctx.mapping, ctx.hw,
                                        wcet=True,
                                        arbitration=ctx.arbitration)
        if ctx.validate:
            validate_schedule(ctx.schedule, ctx.subtasks, ctx.mapping)
        ctx.artifacts[self.name] = ctx.schedule
        return (f"{len(ctx.schedule.dma)} DMA + "
                f"{len(ctx.schedule.compute)} compute slots, "
                f"makespan {ctx.schedule.makespan * 1e3:.3f} ms")


class WCETPass:
    """Compositional WCET bound; enforces the requested deadline."""

    name = "wcet"

    def run(self, ctx: PassContext) -> str:
        if ctx.schedule is None:
            raise PipelineError("wcet pass needs the schedule artifact")
        ctx.report = report_from_schedule(ctx.graph, ctx.hw, ctx.subtasks,
                                          ctx.mapping, ctx.schedule)
        ctx.artifacts[self.name] = ctx.report
        check_deadline(ctx.report, ctx.deadline, ctx.graph.name,
                       ctx.hw.name)
        return (f"bound {ctx.report.wcet_total_s * 1e3:.3f} ms, "
                f"dominant: {ctx.report.dominant_term()}")


class LowerPass:
    """Lower the scheduled network to a replayable CompiledProgram."""

    name = "lower"

    def run(self, ctx: PassContext) -> str:
        if ctx.schedule is None:
            raise PipelineError("lower pass needs the schedule artifact")
        if not supports_graph(ctx.graph):
            bad = sorted({op.kind for op in ctx.graph.ops
                          if op.kind not in SUPPORTED_KINDS})
            raise PipelineError(
                f"{ctx.graph.name}: op kinds {bad} have no executable "
                "lowering (analysis-only graph); use repro_torch.core.analyze "
                "for WCET-only flows")
        params = {k: np.asarray(v) if not isinstance(v, np.ndarray) else v
                  for k, v in ctx.params.items()}
        ctx.program = lower_program(ctx.graph, params, ctx.subtasks,
                                    ctx.mapping, ctx.schedule, hw=ctx.hw)
        ctx.artifacts[self.name] = ctx.program
        return (f"{ctx.program.num_instructions} instructions, "
                f"{len(ctx.program.batches)} fused op batches")


class VerifyPass:
    """Static schedule sanitizer (`repro_torch.analysis`) as a pipeline stage.

    Re-checks what the earlier passes produced instead of trusting them:
    race/interference freedom over the static schedule, scratchpad
    lifetime over the lowered program's megakernel plan, and WCET
    soundness of the report. The full `AnalysisReport` lands in
    `ctx.analysis` / `ctx.artifacts["verify"]`; any unsuppressed
    error-severity diagnostic (with `ctx.strict`: any unsuppressed
    diagnostic at all) raises `VerificationError`.
    """

    name = "verify"

    def run(self, ctx: PassContext) -> str:
        diags = []
        if (ctx.schedule is not None and ctx.subtasks is not None
                and ctx.mapping is not None):
            diags += analyze_schedule(ctx.schedule, ctx.subtasks,
                                      ctx.mapping, hw=ctx.hw)
        if ctx.subtasks is not None:
            diags += analyze_subtasks(ctx.subtasks, ctx.hw)
        if ctx.program is not None:
            diags += analyze_program(ctx.program, ctx.hw,
                                     options=ctx.backend_options)
        if ctx.report is not None:
            diags += analyze_wcet(ctx.report, ctx.schedule,
                                  subtasks=ctx.subtasks)
        report = AnalysisReport(subject=ctx.graph.name, diagnostics=diags,
                                suppressions=parse_suppressions(ctx.suppress))
        ctx.analysis = report
        ctx.artifacts[self.name] = report
        blocking = report.unsuppressed() if ctx.strict else report.errors
        if blocking:
            shown = "\n".join("  " + d.row() for d in blocking[:10])
            raise VerificationError(
                f"{ctx.graph.name}: schedule sanitizer found "
                f"{len(blocking)} blocking diagnostic(s):\n{shown}")
        n_sup = len(diags) - len(report.unsuppressed())
        return (f"{len(diags)} diagnostics, "
                f"{len(report.errors)} errors"
                + (f", {n_sup} suppressed" if n_sup else ""))


def default_passes() -> list[Pass]:
    """The paper-faithful stage sequence behind `repro_torch.compile`, plus the
    schedule sanitizer as the final gate."""
    return [QuantizePass(), PartitionPass(), MapPass(), SchedulePass(),
            WCETPass(), LowerPass(), VerifyPass()]
