"""The port's serving runtime against the JAX package's: the twins of
`tests/test_serve_runtime.py` that `tests/test_torch_serve_runtime.py`
does not hold — admission verdicts and rollback, both queue policies,
`RequestQueue` validation, unknown and unserveable submissions, pinned
deadline verdicts, per-request deadlines, failed jobs, free-running
networks, pending tickets, release order and release times across
hyperperiods, static batch slots, save/load, bundle corruption, the
monitor's accounting and the thin engine wrappers.

Every scenario runs on both packages' `Server` (the port's on the CPU,
its "numpy" backend beside the JAX package's, or "torch" beside "jax")
with the speed ratio pinned wherever a verdict is read; statuses,
outputs, verdicts, telemetry counts and error messages must be equal.
"""

import json
import re
import types

import numpy as np
import pytest

import repro.compiler as RC
import repro.core.cnn as rcnn
import repro.hw as RH
import repro.models.config as RMC
import repro.serve as RS
import repro_torch.compiler as TC
import repro_torch.core.cnn as tcnn
import repro_torch.hw as TH
import repro_torch.models.config as TMC
import repro_torch.serve as TS

PKGS = (
    types.SimpleNamespace(name="jax", S=RS, C=RC, cnn=rcnn, hw=RH, MC=RMC,
                          kw={}, backends={"numpy": "numpy",
                                           "compiled": "jax"}),
    types.SimpleNamespace(name="torch", S=TS, C=TC, cnn=tcnn, hw=TH,
                          MC=TMC, kw={"device": "cpu"},
                          backends={"numpy": "numpy", "compiled": "torch"}),
)


def _frame(seed=0, h=32, w=32):
    return np.random.default_rng(seed).integers(
        -64, 64, (h, w, 3)).astype(np.int8)


def _lm_cfg(P, layers=2):
    # swiglu gates emit "mul" ops, which have no compiled lowering: the
    # decode graph is analysis-only (schedulable, not executable)
    return P.MC.ModelConfig(name="tiny_lm", family="dense",
                            num_layers=layers, d_model=128, num_heads=4,
                            num_kv_heads=4, d_ff=256, vocab_size=512,
                            act="swiglu")


def _server(P, backend="numpy", **kw):
    return P.S.Server(P.hw.scaled_paper_machine(4),
                      backend=P.backends[backend], num_cores=4, **P.kw, **kw)


def _mixed_server(P, backend="numpy", **kw):
    """1 CNN graph + 1 LM decode network (analysis-only, step_fn-served)."""
    srv = _server(P, backend, **kw)
    srv.register("cnn", P.cnn.small_cnn(), period_s=1 / 50, slots=2)
    srv.register("lm", _lm_cfg(P), period_s=1 / 25, cache_len=64,
                 step_fn=lambda tok: np.int64(tok) * 3 + 1)
    return srv


def _both(fn):
    out = [fn(P) for P in PKGS]
    assert out[0] == out[1]
    return out[1]


def _raises(fn, exc, **kw):
    with pytest.raises(exc, **kw) as ei:
        fn()
    return str(ei.value)


def _outputs(t):
    return {k: np.asarray(v).tolist() for k, v in t.result().output.items()}


def _counts(tele):
    return {"metrics": tele["metrics"], "dropped": tele["dropped"],
            "queue_depths": tele["queue_depths"],
            "hyperperiods": tele["hyperperiods_completed"],
            "networks": {n: (v["checks"], v["misses"])
                         for n, v in tele["networks"].items()}}


# -- admission ---------------------------------------------------------------

def test_register_returns_verdict_and_is_schedulable():
    def run(P):
        srv = _mixed_server(P)
        assert srv.report is not None and srv.report.schedulable
        v = srv.report.verdict_of("cnn")
        assert v.schedulable and v.response_bound_s > 0
        assert srv.report.bound("cnn") == v.response_bound_s
        assert set(srv.report.response_bounds) == {"cnn", "lm"}
        with pytest.raises(KeyError, match="nope"):
            srv.report.bound("nope")
        return repr(srv.report), dict(srv.report.response_bounds)
    _both(run)


def test_admission_error_rollback():
    def run(P):
        srv = _mixed_server(P)
        nets_before = list(srv.networks)
        dup = _raises(lambda: srv.register("cnn", P.cnn.small_cnn(),
                                           period_s=1 / 10), P.S.ServeError)
        junk = _raises(lambda: srv.register("junk", object(),
                                            period_s=1 / 10), TypeError)
        assert srv.networks == nets_before and srv.report.schedulable
        return dup, junk.replace("repro_torch", "repro")
    _both(run)


# -- queues ------------------------------------------------------------------

def test_queue_reject_policy_backpressure():
    def run(P):
        srv = _mixed_server(P, queue_capacity=2, queue_policy="reject")
        x = _frame()
        srv.submit("cnn", x)
        srv.submit("cnn", x)
        msg = _raises(lambda: srv.submit("cnn", x), P.S.BackpressureError)
        assert srv.queue_depths()["cnn"] == 2
        return msg, srv.queue_depths()
    _both(run)


def test_queue_drop_oldest_policy():
    def run(P):
        srv = _mixed_server(P, queue_capacity=2, queue_policy="drop-oldest",
                            speed_ratio=1e12)
        t1, t2, t3 = (srv.submit("cnn", _frame(i)) for i in (1, 2, 3))
        assert t1.status == "dropped" and t1.terminal
        r1 = t1.result()
        assert r1.output is None
        assert r1.verdict.outcome == "dropped" and not r1.verdict.met
        srv.run(hyperperiods=1)
        assert t2.done and t3.done
        tele = srv.telemetry()
        assert tele["dropped"]["cnn"] == 1
        assert tele["metrics"]["dropped"] == 1
        assert tele["events"]["cnn"]["dropped"] == 1
        return _counts(tele), _outputs(t2), _outputs(t3)
    _both(run)


def test_request_queue_validation():
    def run(P):
        msgs = [_raises(lambda: P.S.RequestQueue("x", capacity=0),
                        ValueError),
                _raises(lambda: P.S.RequestQueue("x", policy="fifo?"),
                        ValueError)]
        q = P.S.RequestQueue("x", capacity=1, policy="drop-oldest")
        q.push(P.S.Ticket(0, "x", None))
        evicted = q.push(P.S.Ticket(1, "x", None))
        assert evicted is not None and evicted.status == "dropped"
        return msgs, evicted.tid
    _both(run)


def test_submit_unknown_or_unserveable_network():
    def run(P):
        srv = _mixed_server(P)
        a = _raises(lambda: srv.submit("ghost", _frame()), P.S.ServeError,
                    match="unknown network")
        srv2 = _server(P)
        srv2.register("lm_only", _lm_cfg(P), period_s=1 / 25, cache_len=64)
        b = _raises(lambda: srv2.submit("lm_only", 3), P.S.ServeError,
                    match="no executor")
        srv2.attach("lm_only", lambda tok: tok + 1)
        t = srv2.submit("lm_only", 3)
        srv2.run(hyperperiods=1)
        assert t.result().output == 4
        return a, b
    _both(run)


# -- tickets + deadline verdicts ---------------------------------------------

def test_ticket_verdicts_pinned_generous_ratio():
    def run(P):
        srv = _mixed_server(P, speed_ratio=1e12)
        t1 = srv.submit("cnn", _frame(5))
        t2 = srv.submit("lm", 7)
        srv.run(hyperperiods=1)
        for t in (t1, t2):
            r = t.result()
            assert r.deadline_met and r.verdict.met
            assert r.latency_s > 0 and r.response_bound_s > 0
            assert r.verdict.budget_s > r.latency_s
        assert t2.result().output == 22
        assert srv.monitor.misses == {}
        return (_outputs(t1), [t.result().response_bound_s
                               for t in (t1, t2)],
                [t.result().verdict.deadline_s for t in (t1, t2)])
    _both(run)


def test_ticket_verdicts_pinned_tiny_ratio_miss():
    def run(P):
        srv = _mixed_server(P, speed_ratio=1e-12)
        t = srv.submit("cnn", _frame(5))
        srv.run(hyperperiods=1)
        assert not t.result().deadline_met
        assert srv.monitor.misses["cnn"] == 1
        assert srv.monitor.miss_rate("cnn") == 1.0
        snap = srv.monitor.snapshot()
        assert snap["networks"]["cnn"]["miss_rate"] == 1.0
        assert sum(snap["networks"]["cnn"]["histogram"].values()) == 1
        return t.result().verdict.outcome, _outputs(t)
    _both(run)


def test_per_request_deadline_overrides_network_deadline():
    def run(P):
        srv = _mixed_server(P, speed_ratio=1.0)
        tight = srv.submit("cnn", _frame(1), deadline_s=1e-12)
        loose = srv.submit("cnn", _frame(2), deadline_s=1e6)
        srv.run(hyperperiods=1)
        assert tight.result().latency_s == loose.result().latency_s
        assert not tight.result().deadline_met
        assert loose.result().deadline_met
        return [(t.result().verdict.deadline_s, t.result().deadline_met)
                for t in (tight, loose)]
    _both(run)


def test_failed_job_marks_popped_tickets_failed():
    def run(P):
        srv = _server(P)
        srv.register("cnn", P.cnn.small_cnn(), period_s=1 / 50, slots=2)
        good = srv.submit("cnn", _frame())
        bad = srv.submit("cnn", {"wrong_key": _frame()})
        a = _raises(lambda: srv.run(hyperperiods=1), P.S.ServeError,
                    match="missing input")
        assert good.status == "failed" and bad.status == "failed"
        b = _raises(good.result, P.S.ServeError, match="failed.*missing input")
        t = srv.submit("cnn", _frame())
        srv.run(hyperperiods=1)
        assert t.done
        return a, b, _outputs(t)
    _both(run)


def test_autorun_network_refuses_submissions():
    def run(P):
        eng = P.S.MultiModelEngine(hw=P.hw.scaled_paper_machine(4),
                                   num_cores=4, **P.kw)
        eng.add_graph("a", P.cnn.small_cnn(), period_s=1 / 50,
                      step_fn=lambda: 1)
        return _raises(lambda: eng.server.submit("a", _frame()),
                       P.S.ServeError, match="free-runs")
    _both(run)


def test_pending_ticket_has_no_result():
    def run(P):
        t = _mixed_server(P).submit("cnn", _frame())
        return _raises(t.result, P.S.ServeError, match="queued")
    _both(run)


# -- release-order execution ---------------------------------------------------

def test_release_order_across_hyperperiods():
    def run(P):
        srv = _server(P)
        seen = []
        srv.register("fast", P.cnn.small_cnn(), period_s=1 / 100,
                     step_fn=lambda p: seen.append(("fast", p)) or p)
        srv.register("slow", P.cnn.small_cnn(h=24, w=24), period_s=1 / 50,
                     step_fn=lambda p: seen.append(("slow", p)) or p)
        assert srv.compiled.hyperperiod_s == pytest.approx(1 / 50)
        for hp in range(3):
            for k in range(2):
                srv.submit("fast", (hp, k))
            srv.submit("slow", (hp, 0))
        tel = srv.run(hyperperiods=3)
        assert [k for k, _ in seen] == ["fast", "slow", "fast"] * 3
        assert [p for k, p in seen if k == "fast"] == \
            [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]
        assert tel["hyperperiods_completed"] == 3
        assert tel["metrics"]["tickets"] == 9
        assert srv.monitor.checks == {"fast": 6, "slow": 3}
        return seen, _counts(tel)["metrics"]
    _both(run)


def test_ticket_release_times_accumulate():
    def run(P):
        srv = _mixed_server(P)
        releases = []
        for hp in range(3):
            t = srv.submit("lm", hp)
            srv.run(hyperperiods=1)
            releases.append(t.result().release_s)
        H = srv.compiled.hyperperiod_s
        assert releases == pytest.approx([0.0, H, 2 * H])
        return releases
    _both(run)


def test_step_serves_in_static_batch_slots():
    def run(P):
        srv = _server(P)
        srv.register("cnn", P.cnn.small_cnn(), period_s=1 / 50, slots=2)
        tickets = [srv.submit("cnn", _frame(i)) for i in (1, 2, 3)]
        srv.run(hyperperiods=1)
        assert [t.done for t in tickets] == [True, True, False]
        srv.run(hyperperiods=1)
        assert tickets[2].done
        solo = _server(P)
        solo.register("cnn", P.cnn.small_cnn(), period_s=1 / 50, slots=2)
        ts = solo.submit("cnn", _frame(3))
        solo.run(hyperperiods=1)
        assert _outputs(tickets[2]) == _outputs(ts)
        return [_outputs(t) for t in tickets]
    _both(run)


# -- save / load ----------------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "compiled"])
def test_server_save_load_roundtrip_bit_exact(tmp_path, backend):
    def run(P):
        srv = _mixed_server(P, backend=backend)
        path = str(tmp_path / f"{P.name}-fleet")
        srv.save(path)
        srv2 = P.S.Server.load(
            path, step_fns={"lm": lambda tok: np.int64(tok) * 3 + 1},
            **P.kw)
        assert srv2.backend == P.backends[backend]
        assert srv2.report.schedulable
        assert srv2.report.response_bounds == srv.report.response_bounds
        outs = []
        for s in (srv, srv2):
            ts = [s.submit("cnn", _frame(i)) for i in (11, 12)]
            tl = s.submit("lm", 5)
            s.run(hyperperiods=3)
            assert all(t.done for t in ts) and tl.result().output == 16
            outs.append([_outputs(t) for t in ts])
        assert outs[0] == outs[1]
        return outs[1]
    _both(run)


def test_server_load_refuses_wrong_machine(tmp_path):
    def run(P):
        path = str(tmp_path / f"{P.name}-fleet")
        _mixed_server(P).save(path)
        return _raises(lambda: P.S.Server.load(
            path, machine=P.hw.scaled_paper_machine(8), **P.kw),
            P.C.ArtifactError).replace(path, "X")
    _both(run)


def test_save_bundle_detects_corruption(tmp_path):
    def run(P):
        path = str(tmp_path / f"{P.name}-fleet")
        _mixed_server(P).save(path)
        kw = P.kw
        with open(path + "/objects.pkl", "ab") as f:
            f.write(b"tamper")
        a = _raises(lambda: P.C.load_bundle(path, **kw), P.C.ArtifactError,
                    match="hash mismatch")
        with open(path + "/bundle.json") as f:
            manifest = json.load(f)
        manifest["format"] = 99
        with open(path + "/bundle.json", "w") as f:
            json.dump(manifest, f)
        b = _raises(lambda: P.C.load_bundle(path, **kw), P.C.ArtifactError,
                    match="unsupported bundle format")
        # the pickled payloads differ between the packages (their module
        # names), so their hashes do; the messages agree up to the hashes
        return (re.sub(r"[0-9a-f]{64}", "H", a.replace(path, "X")),
                b.replace(path, "X"))
    _both(run)


# -- monitor ----------------------------------------------------------------

def test_monitor_per_step_accounting():
    def run(P):
        mon = P.S.DeadlineMonitor(speed_ratio=1.0, slack_factor=1.0)
        for lat in (0.5, 2.0, 3.0):
            mon.check("n", lat, 1.0)
        assert mon.checks["n"] == 3 and mon.misses["n"] == 2
        assert mon.miss_rate("n") == pytest.approx(2 / 3)
        snap = mon.snapshot()
        assert snap["networks"]["n"]["p50_s"] == 2.0
        assert snap["networks"]["n"]["max_s"] == 3.0
        mon.reset()
        assert mon.checks == {} and mon.speed_ratio == 1.0
        return snap
    _both(run)


def test_monitor_calibrates_once():
    def run(P):
        mon = P.S.DeadlineMonitor()
        v = mon.check("n", 0.02, 0.01)
        assert v.met and mon.speed_ratio == pytest.approx(2.0)
        v2 = mon.check("n", 0.05, 0.01)
        assert not v2.met
        ratio = mon.speed_ratio
        mon.reset(recalibrate=True)
        assert mon.speed_ratio is None
        return ratio, (v.met, v.budget_s), (v2.met, v2.budget_s)
    _both(run)


# -- wrappers ------------------------------------------------------------------

def test_predictable_engine_counts_misses_per_step():
    import jax

    import repro.configs as JCF
    import repro.models as JM
    import repro_torch.configs as TCF
    import repro_torch.models as TM
    jcfg = JCF.get_config("smollm-135m", reduced=True)
    tcfg = TCF.get_config("smollm-135m", reduced=True)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    out = []
    for P, cfg, params in ((PKGS[0], jcfg, jp), (PKGS[1], tcfg, tp)):
        eng = P.S.PredictableEngine(cfg, params, batch_size=2, max_len=64,
                                    hw=P.hw.scaled_paper_machine(4),
                                    speed_ratio=1e-12)
        done = eng.generate([P.S.Request(rid=0, prompt=[1, 2],
                                         max_new_tokens=6)])
        assert done[0].out
        assert eng.deadline_checks == 5
        assert eng.deadline_misses == eng.deadline_checks
        out.append((done[0].out, eng.deadline_checks, eng.deadline_misses))
    assert out[0] == out[1]


def test_multi_model_engine_admit_model():
    def run(P):
        eng = P.S.MultiModelEngine(hw=P.hw.scaled_paper_machine(4),
                                   num_cores=4, **P.kw)
        assert eng.admit_graph("det", P.cnn.small_cnn(), period_s=1 / 50)
        assert eng.admit_model("lm", _lm_cfg(P), period_s=1 / 25,
                               cache_len=64)
        return sorted(s.name for s in eng.specs)
    assert _both(run) == ["det", "lm"]
