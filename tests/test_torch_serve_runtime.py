"""The slice as a whole: the port's `Server` against the JAX package's.

ResNet50 at test size and `small_cnn` are registered on both servers (the
reference on its "jax" backend, the port on "torch" and "cuda" — on the
CPU, the kernels' plain versions) with the speed ratio pinned. The same
requests must give equal outputs (`np.array_equal`: integer arithmetic
throughout), equal ticket states, deadline verdicts and telemetry counts
(host latencies themselves differ, so the ratio is pinned far from any
latency: every verdict is decided by the pinned budget, not by timing).
Admission rejection is atomic, and a saved server reloads and serves the
same results.
"""

from unittest import mock

import numpy as np
import pytest

import repro.core as R
import repro.hw as RH
import repro.serve as RS
import repro_torch.core as T
import repro_torch.hw as TH
import repro_torch.serve as TS
from repro_torch.core import megakernel as TMK
from repro_torch.kernels import launch_counts, reset_launch_counts


def _resnet(m):
    return m.cnn.resnet50(h=32, w=32, width=0.25, blocks=(1, 1, 1, 1),
                          num_classes=16)


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(
        -64, 64, (n, 32, 32, 3)).astype(np.int8)


def _serve(server_cls, core, hw, backend, speed_ratio, **kw):
    srv = server_cls(hw.scaled_paper_machine(4), backend=backend,
                     num_cores=4, speed_ratio=speed_ratio, **kw)
    vr = srv.register("resnet", _resnet(core), period_s=1 / 20, slots=2,
                      params=core.init_params(_resnet(core), seed=1))
    vc = srv.register("cnn", core.cnn.small_cnn(), period_s=1 / 40, slots=3,
                      params=core.init_params(core.cnn.small_cnn(), seed=2))
    xs = _frames(7)
    tickets = [srv.submit("resnet", xs[i]) for i in range(5)]  # 1 waits
    tickets += [srv.submit("cnn", xs[i], deadline_s=1e-12 if i == 1
                           else None) for i in range(4)]
    tele = srv.run(hyperperiods=2)
    return srv, (vr, vc), tickets, tele


def _summary(tele):
    return {"metrics": tele["metrics"], "queue_depths": tele["queue_depths"],
            "dropped": tele["dropped"], "shed": tele["shed"],
            "hyperperiods": tele["hyperperiods_completed"],
            "speed_ratio": tele["speed_ratio"],
            "counts": {n: (v["checks"], v["misses"])
                       for n, v in tele["networks"].items()}}


@pytest.mark.parametrize("speed_ratio", [1e6, 1e-9],
                         ids=["ample-budget", "no-budget"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_server_matches_jax_server(backend, speed_ratio, monkeypatch):
    rsrv, rv, rtickets, rtele = _serve(RS.Server, R, RH, "jax", speed_ratio)
    fused = mock.Mock(wraps=TMK.run_fused)
    monkeypatch.setattr(TMK, "run_fused", fused)
    reset_launch_counts()
    tsrv, tv, ttickets, ttele = _serve(TS.Server, T, TH, backend,
                                       speed_ratio, device="cpu")
    assert [repr(v) for v in rv] == [repr(v) for v in tv]
    assert repr(rsrv.report) == repr(tsrv.report)
    assert _summary(rtele) == _summary(ttele)
    for rt, tt in zip(rtickets, ttickets):
        assert (rt.tid, rt.network, rt.status) == (tt.tid, tt.network,
                                                   tt.status)
        if rt.status == "queued":
            continue
        rr, tr = rt.result(), tt.result()
        assert rr.response_bound_s == tr.response_bound_s
        assert rr.release_s == tr.release_s
        assert rr.verdict.met == tr.verdict.met
        assert rr.verdict.deadline_s == tr.verdict.deadline_s
        assert rr.verdict.outcome == tr.verdict.outcome
        assert sorted(rr.output) == sorted(tr.output)
        for k in rr.output:
            assert np.array_equal(np.asarray(rr.output[k]), tr.output[k])
    # on the CPU the wrappers take their plain versions: no kernel launch
    assert sum(launch_counts().values()) == 0
    if backend == "cuda":
        # every served job ran its program through the K3 wrapper
        jobs = {n: v[0] for n, v in _summary(ttele)["counts"].items()}
        assert fused.call_count >= sum(jobs.values())


def test_outputs_match_reference_forward():
    srv, _, tickets, _ = _serve(TS.Server, T, TH, "cuda", 1e6, device="cpu")
    xs = _frames(7)
    params = {"resnet": T.init_params(_resnet(T), seed=1),
              "cnn": T.init_params(T.cnn.small_cnn(), seed=2)}
    graphs = {"resnet": _resnet(T), "cnn": T.cnn.small_cnn()}
    i_of = {"resnet": 0, "cnn": 0}
    assert [t.status for t in tickets] == ["done"] * 4 + ["queued"] + [
        "done"] * 4
    for t in tickets:
        i = i_of[t.network]
        i_of[t.network] += 1
        if not t.done:
            continue
        ref = T.reference_forward(graphs[t.network], params[t.network],
                                  {"input": xs[i]})
        for k, v in t.result().output.items():
            assert np.array_equal(ref[k], v)


def test_admission_reject_is_atomic():
    srv = TS.Server(TH.scaled_paper_machine(4), backend="cuda", num_cores=4,
                    device="cpu")
    srv.register("cnn", T.cnn.small_cnn(), period_s=1 / 50, slots=2)
    report_before, nets_before = srv.report, list(srv.networks)
    with pytest.raises(TS.AdmissionError) as ei:
        srv.register("greedy", T.cnn.small_cnn(), period_s=1 / 50,
                     deadline_s=1e-9)
    assert ei.value.report is not None and not ei.value.report.schedulable
    assert srv.networks == nets_before and srv.report is report_before
    with pytest.raises(TS.ServeError):
        srv.register("cnn", T.cnn.small_cnn(), period_s=1 / 10)
    with pytest.raises(TypeError):
        srv.register("junk", object(), period_s=1 / 10)
    assert srv.networks == nets_before
    t = srv.submit("cnn", _frames(1)[0])
    srv.run(hyperperiods=1)
    assert t.done


def test_waiting_paths_raise_not_implemented(tmp_path):
    """What still waits for its port raises, naming its ROADMAP item:
    cluster artifacts (item 13) and training recovery (item 15). A
    non-config network is a TypeError. (Resilience and mode changes are
    ported: tests/test_torch_resilience.py; LM networks and
    `register_decode`: tests/test_torch_continuous.py.)"""
    from repro_torch.analysis.runner import analyze_cluster
    from repro_torch.train import fault
    srv = TS.Server(TH.scaled_paper_machine(4), backend="torch",
                    device="cpu")

    class Cfg:
        num_layers = 2

    with pytest.raises(TypeError, match="ModelConfig"):
        srv.register("lm", Cfg(), period_s=0.1)
    assert srv.networks == []
    with pytest.raises(NotImplementedError, match="item 13"):
        analyze_cluster(str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 15"):
        fault.run_with_recovery(lambda s, i: s, None, 1, None)
    with pytest.raises(NotImplementedError, match="item 15"):
        fault.elastic_remesh(None, None, None)


def test_save_load_serves_bit_exact(tmp_path):
    srv, _, tickets, _ = _serve(TS.Server, T, TH, "cuda", 1e6, device="cpu")
    assert srv.verify().ok
    srv.save(str(tmp_path))
    srv2 = TS.Server.load(str(tmp_path), device="cpu")
    assert srv2.backend == "cuda" and srv2.networks == ["resnet", "cnn"]
    assert repr(srv2.report) == repr(srv.report)
    xs = _frames(7)
    t = srv2.submit("resnet", xs[0])
    srv2.run(hyperperiods=1)
    for k, v in t.result().output.items():
        assert np.array_equal(v, tickets[0].result().output[k])


def test_attach_executors_free_runs_compiled_deployments():
    srv = TS.Server(TH.scaled_paper_machine(4), backend="cuda", num_cores=4,
                    device="cpu")
    srv.add("cnn", T.cnn.small_cnn(), period_s=1 / 50)
    engines = srv.attach_executors()
    assert set(engines) == {"cnn"}
    tele = srv.run(hyperperiods=2)
    assert tele["metrics"]["jobs"] == 2 and tele["metrics"]["idle_jobs"] == 0
    assert engines["cnn"].metrics == {"batches": 2, "samples": 2}
    assert "device=cpu" in srv.summary()
