"""Scratchpad lifetime rules (SPM001-SPM003).

SPM001 checks every subtask's peak scratchpad residency against the
physical capacity. SPM002/SPM003 re-derive the megakernel's segment
packing (``core/megakernel.py::_pack``) and check it instead of trusting
it: SPM002 proves each fused segment's footprint fits the scratchpad,
and SPM003 replays each fused kernel's residency step by step, flagging
any read of a buffer that is neither streamed in nor produced earlier in
the segment (use-after-evict / use-before-def inside the kernel).
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence
from typing import Any

from ..core import megakernel as mk
from ..core.compiled import CompiledProgram
from ..core.partition import Subtask
from ..hw import HardwareModel
from .diagnostics import Diagnostic


def analyze_subtasks(
    subtasks: Iterable[Subtask],
    hw: HardwareModel,
    *,
    network: str | None = None,
) -> list[Diagnostic]:
    """SPM001: no subtask's working set may exceed the physical
    scratchpad (the partitioner budgets a *fraction* of it; the analyzer
    checks the hard capacity so custom data fractions stay sound)."""
    diags: list[Diagnostic] = []
    cap = hw.scratchpad_bytes
    for st in subtasks:
        if st.sp_resident > cap:
            diags.append(
                Diagnostic(
                    "SPM001",
                    f"subtask {st.sid} keeps {st.sp_resident} bytes "
                    f"resident, over the {cap}-byte scratchpad",
                    sid=st.sid,
                    op=st.op_name,
                    network=network,
                )
            )
    return diags


def analyze_program(
    prog: CompiledProgram,
    hw: HardwareModel | None = None,
    *,
    options: Any = None,
    segments: Sequence[mk.Segment] | None = None,
    network: str | None = None,
) -> list[Diagnostic]:
    """SPM002 + SPM003 over a lowered program's megakernel plan.

    ``segments`` injects a precomputed (possibly corrupted) plan for
    testing; by default the plan is re-derived with the same backend
    options the deployment carries, while the *capacity* checked against
    is always the analyzed machine's physical ``scratchpad_bytes``.
    """
    if hw is None:
        hw = prog.hw
    if segments is None:
        budget = getattr(options, "scratchpad_budget", None)
        max_kernels = getattr(options, "max_kernels", None)
        segments = mk.plan_segments(prog, budget=budget, max_kernels=max_kernels)
    diags: list[Diagnostic] = []
    capacity = hw.scratchpad_bytes if hw is not None else None
    dual = hw.dual_ported if hw is not None else True
    for si, seg in enumerate(segments):
        if seg.kind != "fused":
            # tiled segments grid-stream through the double-buffered
            # tiled kernel and "outside" steps run at the XLA level —
            # neither holds a whole-segment footprint in scratchpad
            continue
        if capacity is not None:
            foot = mk.segment_footprint(prog, seg, dual)
            if foot > capacity:
                names = ", ".join(s.batch.name for s in seg.steps)
                diags.append(
                    Diagnostic(
                        "SPM002",
                        f"fused segment {si} needs {foot} scratchpad bytes "
                        f"({len(seg.steps)} steps: {names}), over the "
                        f"{capacity}-byte capacity",
                        core=seg.core,
                        step=si,
                        network=network,
                    )
                )
        diags += _residency(prog, seg, si, network)
    return diags


def _residency(
    prog: CompiledProgram,
    seg: mk.Segment,
    si: int,
    network: str | None,
) -> list[Diagnostic]:
    """SPM003: replay the fused kernel's residency set in step order."""
    ins, wids, _outs = mk.segment_io(prog, seg)
    local = set(ins)
    wset = set(wids)
    diags: list[Diagnostic] = []
    for step in seg.steps:
        b = step.batch
        for i in b.in_idx:
            if i not in local:
                diags.append(
                    Diagnostic(
                        "SPM003",
                        f"step {b.name!r} in fused segment {si} reads "
                        f"buffer {prog.buffers[i][0]!r}, which is neither "
                        f"streamed in nor produced earlier in the segment "
                        f"(use after evict)",
                        core=seg.core,
                        op=b.name,
                        step=si,
                        network=network,
                    )
                )
        if b.w_idx is not None and b.w_idx not in wset:
            diags.append(
                Diagnostic(
                    "SPM003",
                    f"step {b.name!r} in fused segment {si} reads weight "
                    f"buffer {prog.buffers[b.w_idx][0]!r} that is not "
                    f"streamed into the kernel",
                    core=seg.core,
                    op=b.name,
                    step=si,
                    network=network,
                )
            )
        local.add(step.out_idx)
        if step.mode == "torch":
            local.add(b.out_idx)
    return diags
