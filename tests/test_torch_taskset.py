"""The port's multi-network hyperperiod scheduler against the JAX
package's: a twin of each test of `tests/test_taskset.py`.

Both packages build the same tasksets (`small_cnn` and MLPs at fixed
shapes) and analyze them on the same machines; the reports, hyperperiod
programs, job tables and verdicts must be identical (the scheduler is
plain Python in both), and the port's schedule keeps the taskset
properties T1-T6 the reference tests check.
"""

from __future__ import annotations

import types

import pytest

import repro.core.cnn as rcnn
import repro.core.graph as rgraph
import repro.core.schedule as rschedule
import repro.core.taskset as rtaskset
import repro.core.wcet as rwcet
import repro.hw as rhw
import repro_torch.core.cnn as tcnn
import repro_torch.core.graph as tgraph
import repro_torch.core.schedule as tschedule
import repro_torch.core.taskset as ttaskset
import repro_torch.core.wcet as twcet
import repro_torch.hw as thw

PKGS = {
    "jax": types.SimpleNamespace(cnn=rcnn, graph=rgraph, sched=rschedule,
                                 ts=rtaskset, wcet=rwcet, hw=rhw),
    "torch": types.SimpleNamespace(cnn=tcnn, graph=tgraph, sched=tschedule,
                                   ts=ttaskset, wcet=twcet, hw=thw),
}


def _both(fn):
    """fn(package namespace) for the JAX package, then the port."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


def mlp(P, name: str, rows: int = 4, width: int = 128, depth: int = 3):
    g = P.graph.Graph(name)
    g.add_tensor("input", (rows, width), "int8", is_input=True)
    x = "input"
    for i in range(depth):
        x = P.graph.linear(g, f"fc{i}", x, width)
        x = P.graph.requant(g, f"rq{i}", x)
    g.mark_output(x)
    g.validate()
    return g


def three_network_specs(P):
    return [
        P.ts.NetworkSpec("detector", P.cnn.small_cnn(32, 32), 1 / 30),
        P.ts.NetworkSpec("lane", mlp(P, "lane"), 1 / 100),
        P.ts.NetworkSpec("speech", mlp(P, "speech", rows=8, width=256,
                                       depth=4), 1 / 10),
    ]


def _program(compiled):
    """A taskset program as comparable plain data."""
    s = compiled.schedule
    return (s.makespan, [repr(x) for x in s.dma],
            [repr(x) for x in s.compute], dict(compiled.release),
            [(j.network, j.job_idx, j.release, j.abs_deadline, j.sids,
              j.finish) for j in compiled.jobs])


# -- T1: hyperperiod ---------------------------------------------------------

def test_hyperperiod_exact_lcm():
    for periods, want in (([1 / 30, 1 / 100, 1 / 10], 0.1),
                          ([0.02, 0.05], 0.1), ([0.25], 0.25),
                          ([1 / 3, 1 / 7], 1.0)):
        r, t = _both(lambda P: P.ts.hyperperiod(periods))
        assert r == t == pytest.approx(want)


def test_hyperperiod_rejects_nonpositive():
    msgs = []
    for P in PKGS.values():
        with pytest.raises(P.ts.TasksetError) as ei:
            P.ts.hyperperiod([0.1, 0.0])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_duplicate_names_rejected():
    msgs = []
    for P in PKGS.values():
        g = mlp(P, "a")
        with pytest.raises(P.ts.TasksetError) as ei:
            P.ts.compile_taskset([P.ts.NetworkSpec("x", g, 0.1),
                                  P.ts.NetworkSpec("x", g, 0.2)],
                                 P.hw.scaled_paper_machine(2))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# -- T2-T4 + verdict on a 3-network taskset ----------------------------------

def test_analyze_taskset_three_networks():
    def run(P):
        return P.wcet.analyze_taskset(three_network_specs(P),
                                      P.hw.scaled_paper_machine(8),
                                      num_cores=8)
    (rrep, rcomp), (report, compiled) = _both(run)
    assert repr(rrep) == repr(report)
    assert _program(rcomp) == _program(compiled)

    assert report.hyperperiod_s == pytest.approx(0.1)
    assert [n.n_jobs for n in report.networks] == [3, 10, 1]
    assert report.total_jobs == 14
    assert all(n.response_bound_s > 0 for n in report.networks)
    assert report.schedulable
    sched = compiled.schedule
    slots = sorted(sched.dma, key=lambda s: (s.start, s.end))
    for a, b in zip(slots, slots[1:]):
        assert b.start >= a.end - 1e-9, f"DMA overlap: {a} / {b}"
    end = {s.sid: s.end for s in sched.compute}
    start = {s.sid: s.start for s in sched.compute}
    for st in compiled.subtasks:
        for d in st.deps:
            assert start[st.sid] >= end[d] - 1e-9
    for s in list(sched.dma) + list(sched.compute):
        assert s.start >= compiled.release[s.sid] - 1e-9
    for job in compiled.jobs:
        assert job.finish > job.release
        assert job.response == pytest.approx(job.finish - job.release)


# -- T5: taskset compositionality --------------------------------------------

def test_replay_never_exceeds_response_bounds():
    def run(P):
        hw = P.hw.scaled_paper_machine(4)
        specs = three_network_specs(P)
        report, compiled = P.wcet.analyze_taskset(specs, hw, num_cores=4)
        bounds = {n.name: n.response_bound_s for n in report.networks}
        replays = []
        for scale in (1.0, 0.71, 0.33):
            sched = P.ts.schedule_taskset(compiled, hw, wcet=False,
                                          time_scale=scale)
            P.sched.validate_schedule(sched, compiled.subtasks,
                                      compiled.mapping,
                                      release=compiled.release)
            got = {s.name: compiled.response_bound(s.name) for s in specs}
            for name, v in got.items():
                assert v <= bounds[name] * (1 + 1e-9)
            replays.append((sched.makespan, got))
        return bounds, replays
    r, t = _both(run)
    assert r == t


# -- T6: schedulability verdicts ---------------------------------------------

def test_impossible_deadline_not_schedulable():
    def run(P):
        specs = [P.ts.NetworkSpec("det", P.cnn.small_cnn(32, 32), 1 / 30,
                                  deadline_s=1e-9)]
        report, _ = P.wcet.analyze_taskset(
            specs, P.hw.scaled_paper_machine(2), num_cores=2)
        assert not report.networks[0].schedulable
        assert not report.schedulable
        return repr(report)
    r, t = _both(run)
    assert r == t


def test_hyperperiod_overrun_not_schedulable():
    def run(P):
        report, _ = P.wcet.analyze_taskset(
            [P.ts.NetworkSpec("det", P.cnn.small_cnn(64, 64), 1e-4)],
            P.hw.scaled_paper_machine(2), num_cores=2)
        assert not report.fits_hyperperiod
        assert not report.schedulable
        return repr(report)
    r, t = _both(run)
    assert r == t


def test_single_network_taskset_matches_single_analysis():
    def run(P):
        hw = P.hw.scaled_paper_machine(4)
        g = P.cnn.small_cnn(32, 32)
        rep_single, *_ = P.wcet.analyze(g, hw, num_cores=4)
        report, _ = P.wcet.analyze_taskset([P.ts.NetworkSpec("net", g, 1.0)],
                                           hw, num_cores=4)
        assert (report.networks[0].response_bound_s
                == pytest.approx(rep_single.wcet_total_s, rel=1e-9))
        return rep_single.wcet_total_s, report.networks[0].response_bound_s
    r, t = _both(run)
    assert r == t


# -- the property test (hypothesis) ------------------------------------------

# (the deterministic twins above keep running without hypothesis, as the
# reference module's do)
try:
    import hypothesis
    import hypothesis.strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    PERIODS = [1 / 100, 1 / 50, 1 / 30, 1 / 10]

    @st.composite
    def random_taskset(draw):
        """A taskset recipe: (name, rows, width, depth, period) each."""
        return [(f"net{i}", draw(st.sampled_from([1, 4, 8])),
                 draw(st.sampled_from([32, 64, 128])),
                 draw(st.integers(1, 3)), draw(st.sampled_from(PERIODS)))
                for i in range(draw(st.integers(1, 3)))]

    @hypothesis.settings(
        max_examples=10, deadline=None,
        suppress_health_check=[hypothesis.HealthCheck.too_slow])
    @hypothesis.given(recipe=random_taskset(),
                      cores=st.sampled_from([1, 2, 4]))
    def test_taskset_invariants_random(recipe, cores):
        def run(P):
            hw = P.hw.scaled_paper_machine(cores)
            specs = [P.ts.NetworkSpec(n, mlp(P, n, r, w, d), p)
                     for n, r, w, d, p in recipe]
            report, compiled = P.wcet.analyze_taskset(specs, hw,
                                                      num_cores=cores)
            sched = compiled.schedule
            slots = sorted(sched.dma, key=lambda s: (s.start, s.end))
            for a, b in zip(slots, slots[1:]):
                assert b.start >= a.end - 1e-9
            P.sched.validate_schedule(sched, compiled.subtasks,
                                      compiled.mapping,
                                      release=compiled.release)
            bounds = {n.name: n.response_bound_s for n in report.networks}
            for scale in (1.0, 0.5):
                P.ts.schedule_taskset(compiled, hw, wcet=False,
                                      time_scale=scale)
                for spec in specs:
                    assert (compiled.response_bound(spec.name)
                            <= bounds[spec.name] * (1 + 1e-9))
            return repr(report), _program(compiled)
        r, t = _both(run)
        assert r == t
