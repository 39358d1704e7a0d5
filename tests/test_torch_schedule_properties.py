"""Property twins (hypothesis) of `tests/test_schedule_properties.py`: the
port's partitioner, mappers and schedulers against the JAX package's on
random graphs and machines.

Each example is drawn once as a recipe and built in both packages. The
subtasks, mappings and schedules (slot for slot) must be identical, and
the port's keep the paper's guarantees P1-P7 that the reference modules
check. `max_examples` stays modest: every example runs twice.
"""

from __future__ import annotations

import types

import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")

import hypothesis.strategies as st          # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402

import repro.core.cnn as rcnn               # noqa: E402
import repro.core.graph as rgraph           # noqa: E402
import repro.core.mapping as rmapping       # noqa: E402
import repro.core.partition as rpartition   # noqa: E402
import repro.core.schedule as rschedule     # noqa: E402
import repro.core.wcet as rwcet             # noqa: E402
import repro.hw as rhw                      # noqa: E402
import repro_torch.core.cnn as tcnn         # noqa: E402
import repro_torch.core.graph as tgraph     # noqa: E402
import repro_torch.core.mapping as tmapping  # noqa: E402
import repro_torch.core.partition as tpartition  # noqa: E402
import repro_torch.core.schedule as tschedule  # noqa: E402
import repro_torch.core.wcet as twcet       # noqa: E402
import repro_torch.hw as thw                # noqa: E402

PKGS = (types.SimpleNamespace(cnn=rcnn, graph=rgraph, mapping=rmapping,
                              part=rpartition, sched=rschedule, wcet=rwcet,
                              hw=rhw),
        types.SimpleNamespace(cnn=tcnn, graph=tgraph, mapping=tmapping,
                              part=tpartition, sched=tschedule, wcet=twcet,
                              hw=thw))
QUICK = dict(deadline=None, suppress_health_check=[HealthCheck.too_slow])


@st.composite
def graph_recipe(draw):
    """Random small MLP-ish graphs (linear chains + skip adds), as a
    recipe: (rows, width, [(kind, n_out)])."""
    rows = draw(st.sampled_from([1, 4, 16]))
    width = draw(st.sampled_from([32, 64, 128]))
    steps = [(draw(st.sampled_from(["linear", "relu", "add"])),
              draw(st.sampled_from([32, 64, 128])))
             for _ in range(draw(st.integers(2, 6)))]
    return rows, width, steps


def build(P, recipe):
    rows, width, steps = recipe
    g = P.graph.Graph("rand")
    g.add_tensor("input", (rows, width), "int8", is_input=True)
    x, skip = "input", None
    for i, (kind, n_out) in enumerate(steps):
        if kind == "linear":
            x = P.graph.linear(g, f"fc{i}", x, n_out)
            x = P.graph.requant(g, f"rq{i}", x)
        elif kind == "relu":
            x = P.graph.eltwise(g, f"relu{i}", "relu", [x])
        elif skip is not None and g.tensors[skip].shape == \
                g.tensors[x].shape:
            x = P.graph.eltwise(g, f"add{i}", "add", [x, skip])
        skip = x
    g.mark_output(x)
    g.validate()
    return g


machine = st.tuples(st.sampled_from([1, 2, 4, 8]),
                    st.sampled_from([64 * 1024, 256 * 1024, 1024 * 1024]))


def _sched(s):
    """A schedule as plain data (the packages' slot classes differ)."""
    return (s.makespan, [repr(x) for x in s.dma],
            [repr(x) for x in s.compute], s.bytes_moved,
            s.bytes_saved_reuse)


def _plan(P, recipe, hw_spec, mapper="affinity"):
    cores, sp = hw_spec
    hw = P.hw.scaled_paper_machine(cores, scratchpad_bytes=sp)
    part = P.part.Partitioner(hw)
    subtasks = part.partition(build(P, recipe))
    mfun = (P.mapping.map_reverse_affinity if mapper == "affinity"
            else P.mapping.map_round_robin)
    return hw, part, subtasks, mfun(subtasks, hw)


@settings(max_examples=12, **QUICK)
@given(recipe=graph_recipe(), hw_spec=machine,
       mapper=st.sampled_from(["affinity", "rr"]))
def test_schedule_invariants(recipe, hw_spec, mapper):
    out = []
    for P in PKGS:
        hw, part, subtasks, mapping = _plan(P, recipe, hw_spec, mapper)
        for stk in subtasks:                             # P5
            assert stk.working_set <= part.budget
        wcet_sched = P.sched.compute_schedule(subtasks, mapping, hw,
                                              wcet=True)
        P.sched.validate_schedule(wcet_sched, subtasks, mapping)  # P1-P3
        runs = [_sched(wcet_sched)]
        for scale in (1.0, 0.71, 0.33):                  # P4
            actual = P.sched.compute_schedule(subtasks, mapping, hw,
                                              wcet=False, time_scale=scale)
            P.sched.validate_schedule(actual, subtasks, mapping)
            assert actual.makespan <= wcet_sched.makespan * (1 + 1e-9)
            runs.append(_sched(actual))
        cp = P.wcet.critical_path(subtasks, hw)
        assert cp <= wcet_sched.makespan * (1 + 1e-9)
        out.append(([repr(s) for s in subtasks], dict(mapping.core_of),
                    runs, cp))
    assert out[0] == out[1]


@settings(max_examples=6, **QUICK)
@given(recipe=graph_recipe(), hw_spec=machine)
def test_static_beats_tdma(recipe, hw_spec):
    out = []
    for P in PKGS:
        hw, _, subtasks, mapping = _plan(P, recipe, hw_spec)
        static = P.sched.compute_schedule(subtasks, mapping, hw, wcet=True)
        tdma = P.sched.compute_schedule(subtasks, mapping, hw, wcet=True,
                                        arbitration="tdma")
        assert static.makespan <= tdma.makespan * 1.05   # P6
        out.append((_sched(static), _sched(tdma)))
    assert out[0] == out[1]


@settings(max_examples=12, **QUICK)
@given(recipe=graph_recipe(), hw_spec=machine,
       mapper=st.sampled_from(["affinity", "rr"]), wcet=st.booleans())
def test_eventq_engine_identical_to_rescan(recipe, hw_spec, mapper, wcet):
    out = []
    for P in PKGS:
        hw, _, subtasks, mapping = _plan(P, recipe, hw_spec, mapper)
        a = P.sched.compute_schedule(subtasks, mapping, hw, wcet=wcet,
                                     engine="rescan")
        b = P.sched.compute_schedule(subtasks, mapping, hw, wcet=wcet,
                                     engine="eventq")
        assert _sched(a) == _sched(b)                    # P7
        out.append(_sched(b))
    assert out[0] == out[1]


def test_small_cnn_schedule():
    out = []
    for P in PKGS:
        hw = P.hw.scaled_paper_machine(4)
        subtasks = P.part.Partitioner(hw).partition(P.cnn.small_cnn())
        mapping = P.mapping.map_reverse_affinity(subtasks, hw)
        sched = P.sched.compute_schedule(subtasks, mapping, hw)
        P.sched.validate_schedule(sched, subtasks, mapping)
        assert sched.makespan > 0
        assert sched.bytes_saved_reuse >= 0
        out.append(_sched(sched))
    assert out[0] == out[1]
