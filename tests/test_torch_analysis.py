"""The port's schedule sanitizer against the JAX package's: the twins of
`tests/test_analysis.py` that `tests/test_torch_compiler_api.py` (RACE001,
SPM002/003) and `tests/test_torch_analysis_cli.py` (the CLI) do not hold.

Both packages compile `small_cnn` on `PAPER_RISCV` (the port on the CPU),
then each twin applies the same mutation to both artifacts — slots,
subtasks, reports — and requires the same diagnostics (rule, message,
scope, compared as rows), the same verdicts, and the same refusals.
"""

import dataclasses
import os
import re
import types

import pytest

import repro
import repro.analysis as RA
import repro.analysis.diagnostics as RD
import repro.compiler as RC
import repro.core.cnn as rcnn
import repro.core.schedule as RS
import repro.hw as RH
import repro_torch
import repro_torch.analysis as TA
import repro_torch.analysis.diagnostics as TD
import repro_torch.compiler as TC
import repro_torch.core.cnn as tcnn
import repro_torch.core.schedule as TS
import repro_torch.hw as TH

PKGS = (
    types.SimpleNamespace(name="jax", pkg=repro, A=RA, D=RD, C=RC,
                          cnn=rcnn, S=RS, HW=RH.PAPER_RISCV, kw={},
                          load_kw={}),
    types.SimpleNamespace(name="torch", pkg=repro_torch, A=TA, D=TD, C=TC,
                          cnn=tcnn, S=TS, HW=TH.PAPER_RISCV,
                          kw={"device": "cpu"}, load_kw={"device": "cpu"}),
)


def _compile(P, **kw):
    return P.pkg.compile(P.cnn.small_cnn(), P.HW, backend="numpy",
                         num_cores=4, use_cache=False, **P.kw, **kw)


@pytest.fixture(scope="module")
def deps():
    return [_compile(P) for P in PKGS]


def _rows(diags):
    return sorted(d.row() for d in diags)


def _rules(diags):
    return {d.rule for d in diags}


def _mutated_schedule(dep, *, dma=None, compute=None):
    sched = dep.schedule
    return dataclasses.replace(
        sched, dma=list(sched.dma) if dma is None else dma,
        compute=list(sched.compute) if compute is None else compute)


def _reanalyze(P, dep, sched):
    return P.A.analyze_schedule(sched, dep.artifacts["partition"],
                                dep.artifacts["map"], hw=dep.machine)


def _same(fn, deps=None):
    """fn(P[, dep]) in both packages: equal results, returned."""
    if deps is None:
        out = [fn(P) for P in PKGS]
    else:
        out = [fn(P, d) for P, d in zip(PKGS, deps)]
    assert out[0] == out[1]
    return out[1]


def _dropped_compute(dep):
    return dataclasses.replace(dep, schedule=_mutated_schedule(
        dep, compute=list(dep.schedule.compute)[:-1]))


# -- honest artifacts ----------------------------------------------------------

def test_clean_under_tdma():
    def run(P):
        dep = _compile(P, arbitration="tdma")
        assert P.A.analyze_deployment(dep).clean
        return repr(dep.report)
    _same(run)


def test_verify_false_skips_the_pass():
    def run(P):
        dep = _compile(P, verify=False)
        names = [s.name for s in dep.stages]
        assert "verify" not in names and "verify" not in dep.artifacts
        return names
    _same(run)


# -- race rules ----------------------------------------------------------------

def test_race002_compute_before_dependency(deps):
    def run(P, dep):
        victim = next(st for st in dep.artifacts["partition"] if st.deps)
        compute = list(dep.schedule.compute)
        for i, cs in enumerate(compute):
            if cs.sid == victim.sid:
                compute[i] = dataclasses.replace(cs, start=0.0,
                                                 end=cs.end - cs.start)
                break
        return _rows(_reanalyze(P, dep, _mutated_schedule(
            dep, compute=compute)))
    assert any("RACE002" in r for r in _same(run, deps))


def test_race003_transfer_outside_tdma_grant():
    def run(P):
        dep = _compile(P, arbitration="tdma")
        dma = list(dep.schedule.dma)
        dma[0] = dataclasses.replace(dma[0], core=(dma[0].core + 1) % 4)
        return _rows(_reanalyze(P, dep, _mutated_schedule(dep, dma=dma)))
    assert any("RACE003" in r for r in _same(run))


# -- schedule-structure rules ------------------------------------------------

def test_sched001_release_violation(deps):
    def run(P, dep):
        sid = dep.schedule.compute[0].sid
        return _rows(P.A.analyze_schedule(
            dep.schedule, dep.artifacts["partition"], dep.artifacts["map"],
            hw=dep.machine, release={sid: dep.schedule.makespan * 2}))
    assert any("SCHED001" in r for r in _same(run, deps))


def test_sched003_dropped_and_duplicated_compute(deps):
    def run(P, dep):
        compute = list(dep.schedule.compute)
        dropped = compute.pop()
        a = _rows(_reanalyze(P, dep, _mutated_schedule(dep,
                                                       compute=compute)))
        b = _rows(_reanalyze(P, dep, _mutated_schedule(
            dep, compute=list(dep.schedule.compute) + [dropped])))
        return a, b
    a, b = _same(run, deps)
    assert any("SCHED003" in r for r in a)
    assert any("SCHED003" in r for r in b)


def test_validate_schedule_wrapper_still_raises(deps):
    def run(P, dep):
        with pytest.raises(P.S.ScheduleError, match="SCHED003") as ei:
            P.S.validate_schedule(
                _mutated_schedule(dep,
                                  compute=list(dep.schedule.compute)[:-1]),
                dep.artifacts["partition"], dep.artifacts["map"])
        P.S.validate_schedule(dep.schedule, dep.artifacts["partition"],
                              dep.artifacts["map"])
        return str(ei.value)
    _same(run, deps)


# -- scratchpad-lifetime rules -----------------------------------------------

def test_spm001_subtask_working_set_over_capacity(deps):
    def run(P, dep):
        tiny = dataclasses.replace(P.HW, scratchpad_bytes=64)
        diags = P.A.analyze_subtasks(dep.artifacts["partition"], tiny)
        assert _rules(diags) == {"SPM001"}
        return _rows(diags)
    _same(run, deps)


# -- WCET-soundness rules ----------------------------------------------------

def test_wcet001_bound_below_makespan(deps):
    def run(P, dep):
        bad = dataclasses.replace(dep.report,
                                  wcet_total_s=dep.schedule.makespan / 2)
        return _rows(P.A.analyze_wcet(bad, dep.schedule))
    assert any("WCET001" in r for r in _same(run, deps))


def test_wcet002_slot_below_estimate(deps):
    def run(P, dep):
        subtasks = [dataclasses.replace(st, flops=st.flops * 1000)
                    if i == 0 else st
                    for i, st in enumerate(dep.artifacts["partition"])]
        return _rows(P.A.analyze_schedule(dep.schedule, subtasks,
                                          dep.artifacts["map"],
                                          hw=dep.machine))
    assert any("WCET002" in r for r in _same(run, deps))


def test_wcet003_report_inconsistency(deps):
    def run(P, dep):
        bad = dataclasses.replace(dep.report,
                                  bytes_moved=dep.report.bytes_moved + 1)
        return _rows(P.A.analyze_wcet(bad, dep.schedule,
                                      subtasks=dep.artifacts["partition"]))
    assert any("WCET003" in r for r in _same(run, deps))


# -- suppression -------------------------------------------------------------

def test_suppression_parsing_and_scopes():
    def run(P):
        s = P.D.Suppression.parse("race001@core2")
        hit = P.D.Diagnostic("RACE001", "synthetic", core=2)
        miss = P.D.Diagnostic("RACE001", "synthetic", core=3)
        assert s.matches(hit) and not s.matches(miss)
        assert P.D.parse_suppressions(["WCET001"])[0].scope is None
        with pytest.raises(ValueError) as ei:
            P.D.Suppression.parse("@scope-without-rule")
        return s.rule, s.scope, str(ei.value)
    assert _same(run)[:2] == ("RACE001", "core2")


def test_suppressed_errors_unblock_compile_and_save(deps):
    def run(P, dep):
        bad = _dropped_compute(dep)
        rep = P.A.analyze_deployment(bad)
        assert not rep.ok and "SCHED003" in _rules(rep.unsuppressed())
        waived = P.A.analyze_deployment(bad, suppress=("SCHED003",))
        waived_rows = [d for d in waived.diagnostics if waived.suppressed(d)]
        assert waived.ok and waived_rows
        assert not P.A.analyze_deployment(bad, suppress=("RACE001",)).ok
        return _rows(rep.unsuppressed()), _rows(waived_rows)
    _same(run, deps)


# -- artifact gating ---------------------------------------------------------

def test_save_refuses_bad_artifact_and_force_overrides(deps, tmp_path):
    def run(P, dep):
        bad = _dropped_compute(dep)
        path = str(tmp_path / f"{P.name}-bad.rtdep")
        with pytest.raises(P.C.ArtifactError,
                           match="refusing to persist") as e1:
            bad.save(path)
        assert not os.path.exists(path)
        bad.save(path, force=True)
        with pytest.raises(P.C.ArtifactError,
                           match="schedule sanitizer") as e2:
            P.pkg.Deployment.load(path, machine=P.HW, **P.load_kw)
        loaded = P.pkg.Deployment.load(path, machine=P.HW, verify=False,
                                       **P.load_kw)
        assert len(loaded.schedule.compute) == len(bad.schedule.compute)
        return tuple(re.sub(r" in [0-9.]+ ms", "",
                            str(e.value).replace(path, "X"))
                     for e in (e1, e2))
    _same(run, deps)


def test_save_honors_persisted_suppressions(deps, tmp_path):
    def run(P, dep):
        bad = dataclasses.replace(_dropped_compute(dep),
                                  suppressions=("SCHED003",))
        path = str(tmp_path / f"{P.name}-waived.rtdep")
        bad.save(path)
        loaded = P.pkg.Deployment.load(path, machine=P.HW, **P.load_kw)
        return loaded.suppressions
    assert _same(run, deps) == ("SCHED003",)


def test_compile_strict_and_suppress_knobs():
    def run(P):
        dep = _compile(P, strict=True, suppress=("RACE001@core0",))
        assert dep.artifacts["verify"].ok
        assert isinstance(P.C.VerificationError("x"), P.C.PipelineError)
        return dep.suppressions, repr(dep.report)
    assert _same(run)[0] == ("RACE001@core0",)
