"""The port's pure-Python compiler stack against the JAX package's.

Partitioning, mapping, scheduling (both engines), the taskset analysis and
the WCET bounds are copies of the reference, so everything must be
IDENTICAL: the comparison is exact, on `repr` of the dataclasses (which
prints every field, floats to the last bit) and with `np.array_equal` for
arrays. The same goes for the machine models and `init_params`; and
`params_from_reference` must refuse a parameter dict that does not fit the
graph.
"""

import numpy as np
import pytest

import repro.core as R
import repro.hw as RH
import repro_torch.core as T
import repro_torch.hw as TH

PRESETS = {
    "small_cnn": lambda m: m.cnn.small_cnn(),
    "resnet50": lambda m: m.cnn.resnet50(h=32, w=32, width=0.25,
                                         blocks=(1, 1, 1, 1), num_classes=16),
    "yolov5s": lambda m: m.cnn.yolov5s_backbone(h=64, w=64, width=0.25),
}


@pytest.mark.parametrize("cores", [4, 16])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_analysis_identical(preset, cores):
    out = []
    for core, hw in ((R, RH), (T, TH)):
        g = PRESETS[preset](core)
        rep, sched, subtasks, mapping = core.analyze(
            g, hw.scaled_paper_machine(cores), num_cores=cores)
        out.append((g, rep, sched, subtasks, mapping))
    (rg, rr, rs, rsub, rmap), (tg, tr, ts, tsub, tmap) = out
    assert R.graph_signature(rg) == T.graph_signature(tg)
    assert repr(rsub) == repr(tsub)
    assert repr(rmap) == repr(tmap)
    assert rs.makespan == ts.makespan
    assert repr(rs.dma) == repr(ts.dma)
    assert repr(rs.compute) == repr(ts.compute)
    assert repr(rr) == repr(tr)


def test_schedule_engines_identical():
    for core, hw in ((R, RH), (T, TH)):
        g = core.cnn.small_cnn()
        m = hw.scaled_paper_machine(4)
        subtasks = core.Partitioner(m).partition(g)
        mapping = core.map_reverse_affinity(subtasks, m)
        a = core.compute_schedule(subtasks, mapping, m, engine="rescan")
        b = core.compute_schedule(subtasks, mapping, m, engine="eventq")
        assert a.dma == b.dma and a.compute == b.compute
    ref = R.compute_schedule(*_sub_map(R, RH), RH.scaled_paper_machine(4),
                             engine="eventq")
    port = T.compute_schedule(*_sub_map(T, TH), TH.scaled_paper_machine(4),
                              engine="eventq")
    assert repr(ref) == repr(port)


def _sub_map(core, hw):
    m = hw.scaled_paper_machine(4)
    subtasks = core.Partitioner(m).partition(core.cnn.small_cnn())
    return subtasks, core.map_reverse_affinity(subtasks, m)


def test_adas_taskset_identical():
    """The two CNN networks of examples/adas_taskset.py (its LM member
    waits for the port's LM slice)."""
    out = []
    for core, hw in ((R, RH), (T, TH)):
        specs = [core.NetworkSpec("detector", core.cnn.yolov5s_backbone(
                     h=64, w=64, width=0.25), period_s=1 / 30),
                 core.NetworkSpec("lane_keeper", core.cnn.small_cnn(48, 48),
                                  period_s=1 / 100)]
        report, compiled = core.analyze_taskset(
            specs, hw.scaled_paper_machine(16), 16)
        out.append((report, compiled))
    (rr, rc), (tr, tc) = out
    assert repr(rr) == repr(tr)
    assert rr.schedulable == tr.schedulable
    assert rc.hyperperiod_s == tc.hyperperiod_s
    assert repr(rc.jobs) == repr(tc.jobs)
    assert repr(rc.schedule.dma) == repr(tc.schedule.dma)
    assert repr(rc.schedule.compute) == repr(tc.schedule.compute)
    assert rc.schedule.makespan == tc.schedule.makespan


@pytest.mark.parametrize("machine", ["PAPER_RISCV", "TPU_V5E", 1, 4, 16, 64])
def test_machines_and_blocks_identical(machine):
    if isinstance(machine, str):
        rm, tm = getattr(RH, machine), getattr(TH, machine)
    else:
        rm = RH.scaled_paper_machine(machine)
        tm = TH.scaled_paper_machine(machine)
    assert rm.fingerprint() == tm.fingerprint()
    assert rm.with_mesh(2, 2).fingerprint() == tm.with_mesh(2, 2).fingerprint()
    for M, K, N in ((1, 2048, 1000), (3136, 576, 64), (64, 64, 64)):
        for ob in (1, 4):
            assert (RH.derive_gemm_blocks(rm, M, K, N, ob)
                    == TH.derive_gemm_blocks(tm, M, K, N, ob))
    for op in R.cnn.resnet50().ops:
        if op.kind == "conv2d":
            for ob in (1, 4):
                assert (RH.derive_conv_blocks(rm, op.attrs, ob)
                        == TH.derive_conv_blocks(tm, op.attrs, ob))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_init_params_identical(preset):
    rp = R.init_params(PRESETS[preset](R), seed=5)
    tp = T.init_params(PRESETS[preset](T), seed=5)
    assert sorted(rp) == sorted(tp)
    for k in rp:
        assert np.asarray(rp[k]).dtype == np.asarray(tp[k]).dtype
        assert np.array_equal(rp[k], tp[k])


def test_params_from_reference_checks_the_graph():
    g = T.cnn.small_cnn()
    ref = R.init_params(R.cnn.small_cnn(), seed=3)
    got = T.params_from_reference(g, ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.array_equal(got[k], ref[k])
        assert got[k] is not ref[k]              # a copy, not an alias
    per_channel = dict(ref)
    per_channel["conv1.rq.mult"] = np.full(16, 0.01, np.float32)
    T.params_from_reference(g, per_channel)
    for bad, match in [
            ({**ref, "conv1.w": ref["conv1.w"][:-1]}, "expected int8"),
            ({**ref, "conv1.w": ref["conv1.w"].astype(np.int16)},
             "expected int8"),
            ({**ref, "fc.rq.mult": np.float32(1)}, "unexpected"),
            ({k: v for k, v in ref.items() if k != "fc.w"}, "missing"),
            ({**ref, "conv1.rq.mult": np.float64(0.01)}, "float32"),
            ({**ref, "conv1.rq.mult": np.ones(3, np.float32)}, "float32")]:
        with pytest.raises(ValueError, match=match):
            T.params_from_reference(g, bad)
