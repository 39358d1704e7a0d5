"""The port's resilience layer against the JAX package's: mirrors of the 21
tests of tests/test_resilience.py (mixed-criticality shedding, atomic
hyperperiod-boundary mode changes, fault injection + recovery), plus a
draw-for-draw check of the seeded fault injector.

Each Server scenario runs once through the JAX package's `Server` on its
"numpy" backend (as its own tests run it) and once through the port's on
the CPU (`device="cpu"`), parametrised over the port backends "torch" and
"cuda" (on the CPU, the CUDA kernels' plain versions). The two runs must
agree exactly — this path is integer arithmetic and host logic: ticket
statuses and errors in submission order, verdict outcomes, outputs
(`np.array_equal`), `metrics`, `monitor.events`, the breaker states after
every step, `injector.injected`, `network_status`, `mode_name` and
`clock_base_s`. The speed ratio is pinned far from any host latency, so
no verdict depends on timing. The reference tests' own assertions are
then held on the port's run.
"""

import types

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro.core.cnn as jcnn
import repro.hw as JH
import repro.models as JM
import repro.models.config as JMC
import repro.serve as JS
import repro.serve.continuous as JCont
import repro.serve.faults as JF
import repro_torch.configs as TC
import repro_torch.core.cnn as tcnn
import repro_torch.hw as TH
import repro_torch.models as TM
import repro_torch.models.config as TMC
import repro_torch.serve as TS
import repro_torch.serve.continuous as TCont
import repro_torch.serve.faults as TF

BACKENDS = ["torch", "cuda"]


def _pkg(serve, faults, cont, cnn, hw, mcfg, server_kw):
    return types.SimpleNamespace(
        S=serve, F=faults, cont=cont, cnn=cnn, HW=hw.scaled_paper_machine(4),
        ModelConfig=mcfg.ModelConfig, server_kw=server_kw)


def _ref():
    return _pkg(JS, JF, JCont, jcnn, JH, JMC, {"backend": "numpy"})


def _port(backend):
    return _pkg(TS, TF, TCont, tcnn, TH, TMC,
                {"backend": backend, "device": "cpu"})


def _frame(seed=0, h=32, w=32):
    return np.random.default_rng(seed).integers(
        -64, 64, (h, w, 3)).astype(np.int8)


def _lm_cfg(P, layers=2):
    # swiglu gates emit "mul" ops (no compiled lowering) -> analysis-only
    return P.ModelConfig(name="tiny_lm", family="dense", num_layers=layers,
                         d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
                         vocab_size=512, act="swiglu")


class _Flaky:
    """step_fn that fails its first `fails` calls, then heals."""

    def __init__(self, fails):
        self.calls = 0
        self.fails = fails

    def __call__(self, tok):
        self.calls += 1
        if self.calls <= self.fails:
            raise RuntimeError("transient executor fault")
        return np.int64(tok) + 1


def _server(P, **kw):
    srv = P.S.Server(P.HW, num_cores=4, speed_ratio=1e9,
                     **P.server_kw, **kw)
    # the breaker states after every step (Server.run steps through step)
    srv.breaker_log = []
    step = srv.step

    def logged_step():
        job = step()
        srv.breaker_log.append(dict(srv.telemetry()["breakers"]))
        return job

    srv.step = logged_step
    return srv


def _single_lm(P, step_fn, **kw):
    srv = _server(P, **kw)
    srv.register("lm", _lm_cfg(P), period_s=1 / 10, cache_len=64,
                 step_fn=step_fn)
    return srv


def _two_tier(P, queue_capacity=4, **kw):
    """High-criticality executable CNN + low-criticality step_fn LM."""
    srv = _server(P, queue_capacity=queue_capacity, **kw)
    srv.register("hi", P.cnn.small_cnn(), period_s=1 / 50, slots=2,
                 criticality=2)
    srv.register("lo", _lm_cfg(P), period_s=1 / 25, cache_len=64,
                 criticality=0, step_fn=lambda tok: np.int64(tok) * 2)
    return srv


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic)):
        return (str(np.asarray(x).dtype), np.asarray(x).tolist())
    return x


def _ticket(t):
    row = {"tid": t.tid, "network": t.network, "status": t.status,
           "error": t.error}
    if t.status in ("done", "degraded", "dropped"):
        r = t.result()
        v = r.verdict
        row.update(output=_plain(r.output), outcome=v.outcome, met=v.met,
                   deadline_s=v.deadline_s, bound_s=r.response_bound_s,
                   release_s=r.release_s)
    return row


def _state(srv, tickets=()):
    res = srv.resilience
    return {
        "tickets": [_ticket(t) for t in tickets],
        "metrics": dict(srv.metrics),
        "events": {n: dict(e) for n, e in srv.monitor.events.items()},
        "checks": dict(srv.monitor.checks),
        "misses": dict(srv.monitor.misses),
        "networks": list(srv.networks),
        "shed": list(srv.shed_networks),
        "status": {n: srv.network_status(n) for n in srv.networks},
        "mode": srv.mode_name,
        "clock_base_s": srv.clock_base_s,
        "hyperperiods": srv.hyperperiods_completed,
        "breakers": srv.breaker_log,
        "injected": (dict(res.injector.injected)
                     if res is not None and res.injector is not None
                     else None),
    }


def _twin(scenario, backend):
    """Run `scenario(P)` through both packages; their states must be equal.
    Returns the port's (srv, tickets, extra)."""
    rs, rt, rx = scenario(_ref())
    ts, tt, tx = scenario(_port(backend))
    assert _state(ts, tt) == _state(rs, rt)
    assert _plain(tx) == _plain(rx)
    return ts, tt, tx


# -- fault plan / injector ----------------------------------------------------

@pytest.mark.parametrize("F", [JF, TF], ids=["jax", "port"])
def test_fault_plan_validation(F):
    with pytest.raises(ValueError, match="sum"):
        F.FaultPlan(fail_rate=0.6, timeout_rate=0.5)
    with pytest.raises(ValueError, match="fail_rate"):
        F.FaultPlan(fail_rate=-0.1)
    with pytest.raises(ValueError, match="spike_factor"):
        F.FaultPlan(spike_rate=0.1, spike_factor=0.5)
    with pytest.raises(ValueError, match="max_retries"):
        F.RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="threshold"):
        F.BreakerPolicy(threshold=0)
    assert F.RetryPolicy(backoff_s=0.1, backoff_factor=2.0).backoff(3) == \
        pytest.approx(0.4)


@pytest.mark.chaos
def test_fault_injection_is_seeded_and_exclusion_free():
    def run(F):
        plan = F.FaultPlan(seed=3, fail_rate=0.4, timeout_rate=0.2,
                           spike_rate=0.2, networks=("a",))
        i1, i2 = plan.injector(), plan.injector()
        seq1 = []
        for _ in range(40):
            assert i1.draw("b") is None     # excluded: never faults...
            seq1.append(i1.draw("a"))
        seq2 = [i2.draw("a") for _ in range(40)]
        assert seq1 == seq2                 # ...and consumes NO draw
        assert set(seq1) > {None}           # the plan actually fires
        assert i1.injected["fail"] == sum(s == "fail" for s in seq1)
        assert i1.injected["timeout"] == sum(s == "timeout" for s in seq1)
        return seq1, i1.injected
    assert run(TF) == run(JF)


@pytest.mark.chaos
def test_injector_draws_equal_the_jax_package_draw_for_draw():
    """1,000 draws over a mixed `networks` filter: the same faults in the
    same order, the same excluded calls, the same counts."""
    nets = ("det", "lane", "park", "lane", "aux", "park", "lane")

    def draws(F):
        inj = F.FaultPlan(seed=2024, fail_rate=0.2, timeout_rate=0.1,
                          spike_rate=0.15,
                          networks=("lane", "park")).injector()
        seq = [inj.draw(nets[i % len(nets)]) for i in range(1000)]
        return seq, dict(inj.injected)

    tseq, tinj = draws(TF)
    jseq, jinj = draws(JF)
    assert tseq == jseq and tinj == jinj
    assert {"fail", "timeout", "spike", None} == set(tseq)

    def raised(F):
        """Raising draws raise the same exception types at a call site."""
        inj = F.FaultPlan(seed=1, fail_rate=0.5, timeout_rate=0.5).injector()
        kinds = []
        for _ in range(20):
            try:
                inj.before_call("n")
            except F.InjectedTimeout as e:
                kinds.append(("timeout", str(e)))
            except F.InjectedFailure as e:
                kinds.append(("fail", str(e)))
        return kinds

    assert raised(TF) == raised(JF)
    assert {k for k, _ in raised(TF)} == {"fail", "timeout"}


def test_circuit_breaker_state_machine():
    def run(S):
        m = S.DeadlineMonitor()
        b = S.CircuitBreaker("n", S.BreakerPolicy(threshold=2,
                                                  cooldown_jobs=2),
                             monitor=m)
        assert b.on_release() == "run" and not b.degraded
        b.record_failure()
        assert b.state == "closed"          # one failure is not a trip
        b.record_failure()
        assert b.state == "open" and b.degraded
        assert b.on_release() == "skip"     # cooldown release 1
        assert b.on_release() == "probe"    # cooldown release 2 -> half-open
        b.record_failure()                  # failed probe: back to open
        assert b.state == "open"
        assert b.on_release() == "skip"
        assert b.on_release() == "probe"
        b.record_success()                  # successful probe closes
        assert b.state == "closed" and not b.degraded
        assert m.event_count("breaker_open", "n") == 2
        assert m.event_count("breaker_half_open", "n") == 2
        assert m.event_count("breaker_close", "n") == 1
        b.record_failure()
        b.record_success()
        b.record_failure()
        assert b.state == "closed"          # success resets the streak
        return b.transitions, m.events, b.summary()
    assert run(TS) == run(JS)


# -- retry + breaker on the server -------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_bounded_retry_recovers_transient_fault(backend):
    def scenario(P):
        flaky = _Flaky(1)
        srv = _single_lm(P, flaky)
        srv.enable_resilience(retry=P.F.RetryPolicy(max_retries=2))
        t = srv.submit("lm", 4)
        srv.run(hyperperiods=1)
        return srv, [t], flaky.calls

    srv, (t,), calls = _twin(scenario, backend)
    assert t.done and t.result().output == 5
    assert calls == 2
    assert srv.metrics["retries"] == 1
    assert srv.telemetry()["events"]["lm"]["retry"] == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_exhausted_retries_degrade_instead_of_crashing(backend):
    def scenario(P):
        flaky = _Flaky(10 ** 6)
        srv = _single_lm(P, flaky)
        srv.enable_resilience(retry=P.F.RetryPolicy(max_retries=1))
        t = srv.submit("lm", 4)
        srv.run(hyperperiods=1)             # must NOT raise
        return srv, [t], flaky.calls

    srv, (t,), calls = _twin(scenario, backend)
    assert t.status == "degraded" and t.terminal
    assert "transient executor fault" in t.error
    r = t.result()                      # terminal: result() answers
    assert r.output is None and r.verdict.outcome == "degraded"
    assert calls == 2                   # 1 + max_retries attempts
    assert srv.telemetry()["events"]["lm"]["job_failed"] == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_without_resilience_failures_still_propagate(backend):
    def scenario(P):
        srv = _single_lm(P, _Flaky(10 ** 6))
        t = srv.submit("lm", 4)
        with pytest.raises(RuntimeError, match="transient"):
            srv.run(hyperperiods=1)
        return srv, [t], None

    srv, (t,), _ = _twin(scenario, backend)
    assert t.status == "failed"         # the legacy contract is untouched
    with pytest.raises(TS.ServeError, match="failed"):
        t.result()


@pytest.mark.parametrize("backend", BACKENDS)
def test_breaker_trips_degrades_and_recovers_via_probe(backend):
    def scenario(P):
        flaky = _Flaky(10 ** 6)
        srv = _single_lm(P, flaky)
        srv.enable_resilience(retry=P.F.RetryPolicy(max_retries=0),
                              breaker=P.F.BreakerPolicy(threshold=2,
                                                        cooldown_jobs=2))
        seen = []
        t1 = srv.submit("lm", 1)
        srv.step()
        t2 = srv.submit("lm", 2)
        srv.step()                      # 2 consecutive failed jobs: trip
        seen.append((t1.status, t2.status, srv.network_status("lm")))
        t3 = srv.submit("lm", 3)        # open: degrade at submit, no queue
        srv.step()                      # cooldown release 1 (skip)
        flaky.fails = 0                 # executor heals
        srv.step()                      # cooldown release 2 -> half-open
        t4 = srv.submit("lm", 4)        # half-open still queues (probe food)
        seen.append(t4.status)
        srv.step()                      # probe succeeds -> closed
        return srv, [t1, t2, t3, t4], seen

    srv, (t1, t2, t3, t4), seen = _twin(scenario, backend)
    (s1, s2, status), s4 = seen
    assert s1 == s2 == "degraded"
    assert status["breaker_open"]
    assert srv.breaker_log[1]["lm"] == "open"
    assert t3.status == "degraded" and t3.result().verdict.outcome == \
        "degraded"
    assert srv.breaker_log[3]["lm"] == "half_open"
    assert s4 == "queued"
    assert t4.done and t4.result().output == 5
    assert srv.telemetry()["breakers"]["lm"] == "closed"
    ev = srv.telemetry()["events"]["lm"]
    assert ev["breaker_open"] == 1 and ev["breaker_close"] == 1
    assert srv.metrics["degraded"] == 3


# -- mixed-criticality overload shedding --------------------------------------

def test_overload_policy_validation():
    for S in (TS, JS):
        with pytest.raises(ValueError, match="hysteresis|flapping"):
            S.OverloadPolicy(shed_queue_frac=0.5, restore_queue_frac=0.5)
        with pytest.raises(ValueError, match="restore_hyperperiods"):
            S.OverloadPolicy(restore_hyperperiods=0)
    assert TS.OverloadPolicy() == TS.OverloadPolicy(**vars(JS.OverloadPolicy()))


@pytest.mark.parametrize("backend", BACKENDS)
def test_overload_sheds_lowest_criticality_then_restores(backend):
    def scenario(P):
        srv = _two_tier(P, overload=P.S.OverloadPolicy(
            shed_queue_frac=0.5, restore_queue_frac=0.25,
            restore_hyperperiods=2))
        lo = [srv.submit("lo", i) for i in range(3)]   # 3 >= 0.5 * 4
        srv.step()                      # boundary: shed before executing
        seen = [list(srv.shed_networks), sorted(srv.report.response_bounds),
                [t.status for t in lo]]
        late = srv.submit("lo", 9)      # shed queue is paused
        seen.append(srv.telemetry()["shed"])
        srv.run(hyperperiods=2)         # two calm boundaries -> restore
        seen.append(sorted(srv.report.response_bounds))
        t = srv.submit("lo", 4)
        srv.run(hyperperiods=1)
        return srv, lo + [late, t], seen

    srv, tickets, seen = _twin(scenario, backend)
    shed, bounds, statuses, tele_shed, bounds_after = seen
    assert shed == ["lo"] and tele_shed == ["lo"]
    assert bounds == ["hi"]             # WCET re-ran on the survivors only
    assert statuses == ["degraded"] * 3
    for t in tickets[:3]:
        assert t.terminal and t.result().verdict.outcome == "degraded"
        assert not t.result().verdict.met
    assert tickets[3].status == "degraded"
    assert srv.metrics["sheds"] == 1
    assert srv.shed_networks == []
    assert srv.metrics["restores"] == 1
    assert bounds_after == ["hi", "lo"]
    ev = srv.telemetry()["events"]["lo"]
    assert ev["shed"] == 1 and ev["restore"] == 1
    assert tickets[4].done and tickets[4].result().output == 8


@pytest.mark.parametrize("backend", BACKENDS)
def test_shed_refuses_last_active_network_and_manual_api(backend):
    def scenario(P):
        srv = _two_tier(P)
        srv.shed("lo")                  # manual shed works without a policy
        seen = [list(srv.shed_networks)]
        with pytest.raises(P.S.ServeError, match="only"):
            srv.shed("hi")
        with pytest.raises(P.S.ServeError, match="not shed"):
            srv.restore("hi")
        seen.append(srv.restore())
        return srv, [], seen

    srv, _, seen = _twin(scenario, backend)
    assert seen == [["lo"], "lo"]
    assert srv.shed_networks == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_clock_stays_monotonic_across_shed_and_restore(backend):
    def scenario(P):
        srv = _two_tier(P, overload=P.S.OverloadPolicy(
            shed_queue_frac=0.5, restore_queue_frac=0.25,
            restore_hyperperiods=1))
        t0 = srv.submit("hi", _frame(0))
        srv.run(hyperperiods=1)
        lo = [srv.submit("lo", i) for i in range(3)]   # shed at the boundary
        srv.run(hyperperiods=2)         # shed, then calm restore
        t1 = srv.submit("hi", _frame(1))
        srv.run(hyperperiods=1)
        return srv, [t0, *lo, t1], None

    srv, tickets, _ = _twin(scenario, backend)
    t0, t1 = tickets[0], tickets[-1]
    assert srv.metrics["sheds"] == 1 and srv.metrics["restores"] == 1
    # absolute release timestamps never run backwards across the two
    # schedule changes (clock_base_s carries the completed hyperperiods)
    assert t1.result().release_s >= t0.result().release_s
    assert srv.clock_base_s > 0


# -- atomic mode changes ------------------------------------------------------

def test_mode_validation():
    def run(S, cnn):
        with pytest.raises(S.ModeChangeError, match="no networks"):
            S.Mode("empty", ())
        with pytest.raises(S.ModeChangeError, match="duplicate"):
            S.Mode("dup", (S.ModeNetwork("a", cnn.small_cnn(), 0.1),
                           S.ModeNetwork("a", cnn.small_cnn(), 0.1)))
        m = S.Mode("ok", (S.ModeNetwork("a", cnn.small_cnn(), 0.1),))
        return m.network_names()
    assert run(TS, tcnn) == run(JS, jcnn) == ["a"]


def _parking_mode(P):
    return P.S.Mode("parking", (
        P.S.ModeNetwork("hi", P.cnn.small_cnn(), period_s=1 / 25, slots=2,
                        criticality=2),
        P.S.ModeNetwork("park", P.cnn.small_cnn(), period_s=1 / 25, slots=2,
                        criticality=1),
    ))


@pytest.mark.parametrize("backend", BACKENDS)
def test_mode_switch_applies_only_at_hyperperiod_boundary(backend):
    def scenario(P):
        srv = _two_tier(P)
        seen = {"njobs": len(srv.compiled.jobs)}
        t_lo = srv.submit("lo", 21)
        srv.step()                      # now mid-hyperperiod
        seen["cursor"] = srv._cursor
        report = srv.switch_mode(_parking_mode(P))
        # staged but NOT applied: the old taskset keeps serving
        seen["staged"] = (report.schedulable, list(srv.networks),
                          srv.mode_name, srv.network_status("lo"),
                          srv.network_status("hi"))
        while srv._cursor != 0:         # drain the current hyperperiod
            srv.step()
        seen["at_boundary"] = (list(srv.networks), t_lo.status)
        t_lo2 = srv.submit("lo", 22)    # will not see another lo job
        t_hi = srv.submit("hi", _frame(3))  # persists into the new mode
        srv.step()                      # first step past the boundary: swap
        seen["swapped"] = (srv.mode_name, sorted(srv.networks),
                           srv.metrics["mode_switches"], t_lo2.status)
        srv.run(hyperperiods=1)
        return srv, [t_lo, t_lo2, t_hi], seen

    srv, (t_lo, t_lo2, t_hi), seen = _twin(scenario, backend)
    assert seen["njobs"] >= 2           # the boundary test needs a mid-point
    assert seen["cursor"] != 0
    ok, nets, mode, lo_status, hi_status = seen["staged"]
    assert ok and set(nets) == {"hi", "lo"} and mode is None
    assert lo_status["departing"] and not hi_status["departing"]
    # the boundary itself has not been crossed by a step yet; lo drained
    # under the OLD schedule
    assert set(seen["at_boundary"][0]) == {"hi", "lo"}
    assert seen["at_boundary"][1] == "done" and t_lo.done
    # departing network's ticket resolved terminally, not hung
    assert seen["swapped"] == ("parking", ["hi", "park"], 1, "dropped")
    assert t_lo2.result().verdict.outcome == "dropped"
    # the persisting network's queue carried over and serves under the
    # NEW schedule, with the absolute clock carried forward
    assert t_hi.done
    assert t_hi.result().release_s >= srv.clock_base_s > 0
    assert srv.telemetry()["mode"] == "parking"


@pytest.mark.parametrize("backend", BACKENDS)
def test_mode_switch_rejection_is_atomic(backend):
    def scenario(P):
        srv = _two_tier(P)
        bad = P.S.Mode("impossible", (
            P.S.ModeNetwork("hi", P.cnn.small_cnn(), period_s=1 / 50,
                            deadline_s=1e-9),))
        with pytest.raises(P.S.AdmissionError):
            srv.switch_mode(bad)
        seen = [srv._staged_mode is None, list(srv.networks), srv.mode_name]
        t = srv.submit("hi", _frame())  # current mode still serves
        srv.run(hyperperiods=1)
        return srv, [t], seen

    srv, (t,), seen = _twin(scenario, backend)
    assert seen[0]                      # nothing staged
    assert set(seen[1]) == {"hi", "lo"} and seen[2] is None
    assert t.done


@pytest.mark.parametrize("backend", BACKENDS)
def test_mode_switch_on_idle_server_applies_immediately(backend):
    def scenario(P):
        srv = _server(P)
        srv.register("hi", P.cnn.small_cnn(), period_s=1 / 50, slots=2)
        srv.switch_mode(_parking_mode(P))   # cursor 0: no wait needed
        seen = [srv.mode_name, sorted(srv.networks)]
        t = srv.submit("park", _frame(1))
        srv.run(hyperperiods=1)
        return srv, [t], seen

    srv, (t,), seen = _twin(scenario, backend)
    assert seen == ["parking", ["hi", "park"]]
    assert t.done
    # the staged deployment was compiled for the server's own device
    assert srv._nets["park"].deployment.device == "cpu"


# -- chaos: end-to-end fault injection ---------------------------------------

@pytest.mark.chaos
@pytest.mark.parametrize("backend", BACKENDS)
def test_chaos_every_ticket_terminal_high_criticality_clean(backend):
    """The acceptance bar: under a seeded fault burst on the low-crit
    network, every ticket terminates and the high-criticality network
    shows ZERO deadline misses — with the JAX package's exact trace."""
    def scenario(P):
        srv = _two_tier(P, queue_capacity=4, queue_policy="drop-oldest")
        plan = P.F.FaultPlan(seed=7, fail_rate=0.35, timeout_rate=0.15,
                             spike_rate=0.1, networks=("lo",))
        srv.enable_resilience(faults=plan,
                              retry=P.F.RetryPolicy(max_retries=1),
                              breaker=P.F.BreakerPolicy(threshold=2,
                                                        cooldown_jobs=2))
        tickets = []
        for k in range(12):
            tickets += [srv.submit("hi", _frame(2 * k + i))
                        for i in range(2)]
            tickets += [srv.submit("lo", int(k)) for _ in range(2)]
            srv.run(hyperperiods=1)
        while any(srv.queue_depths().values()):
            srv.run(hyperperiods=1)     # drain the low-crit backlog
        return srv, tickets, None

    srv, tickets, _ = _twin(scenario, backend)
    assert all(t.terminal for t in tickets), \
        sorted({t.status for t in tickets if not t.terminal})
    hi = [t for t in tickets if t.network == "hi"]
    assert all(t.done and t.result().verdict.met for t in hi)
    tele = srv.telemetry()
    assert tele["networks"]["hi"]["misses"] == 0
    assert srv.resilience.injector.injected["fail"] > 0
    assert srv.metrics["retries"] > 0
    assert srv.metrics["dropped"] > 0
    # every recorded error is an injected fault, never a swallowed one
    assert all(t.error.startswith(("InjectedFailure", "InjectedTimeout"))
               for t in tickets if t.error is not None)


@pytest.mark.chaos
@pytest.mark.parametrize("backend", BACKENDS)
def test_chaos_run_is_reproducible_from_its_seed(backend):
    def run_once(P):
        srv = _two_tier(P, queue_capacity=4, queue_policy="drop-oldest")
        plan = P.F.FaultPlan(seed=11, fail_rate=0.4, networks=("lo",))
        srv.enable_resilience(faults=plan,
                              retry=P.F.RetryPolicy(max_retries=1),
                              breaker=P.F.BreakerPolicy(threshold=2,
                                                        cooldown_jobs=2))
        tickets = []
        for k in range(10):
            tickets.append(srv.submit("lo", int(k)))
            srv.run(hyperperiods=1)
        return srv, tickets, None

    srv, tickets, _ = _twin(run_once, backend)
    again, again_tickets, _ = run_once(_port(backend))
    assert _state(again, again_tickets) == _state(srv, tickets)
    statuses = [t.status for t in tickets]
    assert "degraded" in statuses and "done" in statuses


# -- continuous engine fault hook --------------------------------------------

@pytest.mark.parametrize("xp", ["numpy", "torch"])
def test_continuous_fault_hook_is_resumable_and_spikes(xp):
    def run(S, cont, backend):
        calls = {"n": 0}

        def hook():
            calls["n"] += 1
            if calls["n"] == 2:
                raise S.InjectedFailure("injected decode fault")
            return "spike" if calls["n"] == 3 else None

        mon = S.DeadlineMonitor(speed_ratio=1.0, slack_factor=1.0)
        eng = cont.ContinuousEngine(backend, max_tokens=8, monitor=mon,
                                    step_bound_s=1e-12, network="toy",
                                    fault_hook=hook, spike_factor=1e6)
        eng.enqueue([1, 2], 5)
        eng.step()
        with pytest.raises(S.InjectedFailure):
            eng.step()                  # raised BEFORE any state mutation
        done = eng.drain()              # a clean retry resumes the stream
        assert [r.out for r in done] == cont.toy_reference([[1, 2]], [5])
        assert mon.misses.get("toy", 0) >= 1   # the spiked step blew it
        return [r.out for r in done], eng.metrics, calls["n"]

    port = run(TS, TCont, TCont.ToyBackend(slots=2, xp=xp))
    assert port == run(JS, JCont, JCont.ToyBackend(slots=2))


# -- DeadlineMonitor reset ----------------------------------------------------

def test_monitor_reset_clears_occupancy_events_and_windows():
    def run(S):
        m = S.DeadlineMonitor(speed_ratio=1.0, slack_factor=1.0)
        m.record_occupancy("n", 3, 4)
        m.check("n", 10.0, 1.0)         # a miss
        m.record_event("n", "shed")
        before = (m.mean_occupancy("n"), m.recent_miss_rate("n"))
        assert before == (pytest.approx(0.75), 1.0)
        m.reset(recalibrate=True)
        # EVERY accumulator is back to zero
        assert m._occ == {} and m.events == {}
        assert m.mean_occupancy("n") == 0.0
        assert m.recent_miss_rate("n") == 0.0
        assert m.snapshot()["networks"] == {} and \
            m.snapshot()["events"] == {}
        assert m.speed_ratio == 1.0     # pinned ratio survives recalibrate
        m2 = S.DeadlineMonitor()
        m2.check("x", 0.5, 0.1)
        assert m2.speed_ratio is not None
        m2.reset(recalibrate=True)      # measured ratio is forgotten
        assert m2.speed_ratio is None
        return before, m.snapshot()
    assert run(TS) == run(JS)


def test_recent_miss_rate_recovers_where_cumulative_is_sticky():
    def run(S):
        m = S.DeadlineMonitor(speed_ratio=1.0, slack_factor=1.0)
        for _ in range(10):
            m.check("n", 10.0, 1.0)     # a bad burst
        for _ in range(32):
            m.check("n", 0.1, 1.0)      # long recovery
        assert m.miss_rate("n") > 0.2   # cumulative stays polluted
        assert m.recent_miss_rate("n", window=32) == 0.0
        return m.miss_rate("n"), m.recent_miss_rate("n")
    assert run(TS) == run(JS)


# -- save/load round trip with a decode network -------------------------------

@pytest.fixture(scope="module")
def lm():
    jcfg = JC.get_config("smollm-135m", reduced=True)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = TC.get_config("smollm-135m", reduced=True)
    return {"jax": (jcfg, jp), "port": (cfg, TM.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), "cpu"))}


@pytest.mark.parametrize("backend", BACKENDS)
def test_save_load_round_trip_with_decode_network(lm, tmp_path, backend):
    def scenario(P):
        side = "jax" if P.S is JS else "port"
        cfg, params = lm[side]
        srv = _server(P)
        srv.register("cnn", P.cnn.small_cnn(), period_s=1 / 50, slots=2,
                     criticality=1)
        srv.register_decode("lm", cfg, period_s=0.05, params=params,
                            slots=2, criticality=2, prompt_len=6,
                            max_new_tokens=4, max_len=64)
        t = srv.submit("lm", [1, 2, 3])     # the engine is live pre-save
        for _ in range(64):
            srv.step()
            if t.done:
                break
        load_kw = {} if side == "jax" else {"device": "cpu"}
        srv2 = P.S.Server.load(srv.save(str(tmp_path / side)), **load_kw)
        seen = {"schedulable": srv2.report.schedulable,
                "networks": sorted(srv2.networks),
                "crit": {s.name: s.criticality for s in srv2.specs},
                "bounds": srv2.report.response_bounds,
                "shed_order": srv2.report.shed_order()}
        with pytest.raises(P.S.ServeError, match="no executor"):
            srv2.submit("lm", [1, 2, 3])
        x = _frame(5)
        ta, tb = srv.submit("cnn", x), srv2.submit("cnn", x)
        srv.run(hyperperiods=1)
        srv2.run(hyperperiods=1)
        seen["reloaded"] = _ticket(tb)
        seen["bounds_before"] = srv.report.response_bounds
        return srv, [t, ta], seen

    srv, (t, ta), seen = _twin(scenario, backend)
    assert t.done
    assert seen["schedulable"] and seen["networks"] == ["cnn", "lm"]
    assert seen["crit"] == {"cnn": 1, "lm": 2}
    assert seen["bounds"] == seen["bounds_before"]
    assert seen["shed_order"] == srv.report.shed_order()
    # the executable network serves bit-exact after the round trip
    assert seen["reloaded"]["output"] == _plain(ta.result().output)


@pytest.mark.parametrize("backend", BACKENDS)
def test_shed_resolves_in_flight_decode_tickets(lm, backend):
    """Shedding a decode network resolves its in-flight streams degraded,
    as the JAX package does: they would otherwise never be stepped again
    and never reach a terminal state."""
    def scenario(P):
        side = "jax" if P.S is JS else "port"
        cfg, params = lm[side]
        srv = _server(P)
        srv.register("cnn", P.cnn.small_cnn(), period_s=1 / 50, slots=2,
                     criticality=2)
        srv.register_decode("lm", cfg, period_s=0.05, params=params,
                            slots=2, criticality=0, prompt_len=6,
                            max_new_tokens=8, max_len=64)
        t = srv.submit("lm", [1, 2, 3])
        while not srv._nets["lm"].inflight:
            srv.step()
        srv.shed("lm")
        return srv, [t], None

    srv, (t,), _ = _twin(scenario, backend)
    assert t.status == "degraded" and t.terminal
    assert srv._nets["lm"].inflight == {}
