"""Continuous batching in the port: mirrors of tests/test_continuous.py.

DecodeState/ResultTokens invariants; the differential suite (the
continuous loop token-for-token against the batch-to-completion oracle,
on the toy backend over numpy and torch and on the LM backends of
smollm-135m and zamba2-1.2b REDUCED); deadline accounting under
continuous load; and `Server.register_decode`. Two cross-package checks:
the port's ToyBackend gives the JAX package's streams, and the port's
greedy LM token streams equal the JAX package's for the same params
(carried across with `params_from_numpy`) and prompts. Everything runs on
the CPU (`device="cpu"`), where the kernel wrappers take their plain
versions.
"""

import random
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.serve.continuous import ContinuousEngine as JContinuousEngine
from repro.serve.continuous import LMBackend as JLMBackend
from repro.serve.continuous import ToyBackend as JToyBackend
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.core.wcet import sustained_occupancy
from repro_torch.hw import scaled_paper_machine
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.models import params_from_numpy
from repro_torch.serve import AdmissionError, DeadlineMonitor, Server
from repro_torch.serve.continuous import (ContinuousEngine, DecodeState,
                                          LMBackend, ResultTokens, SlotError,
                                          ToyBackend, result_from_packed,
                                          toy_reference)
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ["smollm-135m", "zamba2-1.2b"]


# -- DecodeState invariants -----------------------------------------------------

def _packed(tokens, valid, lengths):
    return result_from_packed(np.stack(
        [np.asarray(tokens), np.asarray(valid), np.asarray(lengths)], axis=1))


def test_insert_occupied_slot_rejected():
    st = DecodeState(2, 4)
    st.insert(0, 10, first_token=5)
    with pytest.raises(SlotError, match="occupied"):
        st.insert(0, 11)
    with pytest.raises(SlotError, match="out of range"):
        st.insert(2, 12)


def test_evicted_slot_immediately_reusable():
    st = DecodeState(1, 4)
    st.insert(0, 1, first_token=7)
    assert list(st.evict(0)) == [7]
    with pytest.raises(SlotError, match="already free"):
        st.evict(0)
    st.insert(0, 2, first_token=9)
    assert list(st.tokens[0, :1]) == [9] and st.lengths[0] == 1


def test_append_no_cross_slot_contamination():
    st = DecodeState(3, 8)
    st.insert(0, 100, first_token=1)
    st.insert(2, 200, first_token=2)
    st.append(_packed([11, 99, 22], [1, 1, 1], [2, 1, 2]))  # slot1 invalid
    assert list(st.tokens[0, :2]) == [1, 11]
    assert list(st.tokens[2, :2]) == [2, 22]
    assert not st.valid[1] and st.lengths[1] == 0
    assert np.all(st.tokens[1] == 0)


def test_lengths_monotone_and_overflow_guarded():
    st = DecodeState(1, 3)
    st.insert(0, 1, first_token=4)
    seen = [int(st.lengths[0])]
    for t in (5, 6):
        st.append(_packed([t], [1], [seen[-1] + 1]))
        seen.append(int(st.lengths[0]))
    assert seen == [1, 2, 3]
    with pytest.raises(SlotError, match="overflow"):
        st.append(_packed([7], [1], [4]))


def test_result_tokens_partition_enforced():
    data = np.zeros((2, 3), np.int32)
    ResultTokens(data, (0, 1), (1, 2), (2, 3)).check_partition()
    bad = [((0, 1), (1, 2), (1, 3)),
           ((0, 1), (2, 3), (2, 3)),
           ((0, 1), (1, 2), (2, 2))]
    for t_idx, v_idx, l_idx in bad:
        with pytest.raises(SlotError, match="partition|cover"):
            ResultTokens(data, t_idx, v_idx, l_idx).check_partition()
    with pytest.raises(SlotError, match="cover"):
        ResultTokens(np.zeros((2, 4), np.int32),
                     (0, 1), (1, 2), (2, 3)).check_partition()


def test_append_rejects_wrong_slot_count():
    st = DecodeState(3, 4)
    with pytest.raises(SlotError, match="slots"):
        st.append(_packed([1, 2], [1, 1], [1, 1]))


def test_packed_result_from_a_torch_tensor():
    packed = torch.tensor([[3, 1, 2], [0, 0, 0]], dtype=torch.int32)
    r = result_from_packed(packed)
    assert isinstance(r.data, np.ndarray) and r.data.dtype == np.int32
    assert r.tokens()[:, 0].tolist() == [3, 0]


# -- differential: toy backend (numpy AND torch) --------------------------------

@pytest.mark.parametrize("xp", ["numpy", "torch"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_toy_continuous_matches_reference(xp, seed):
    rng = random.Random(seed)
    slots = rng.choice([1, 2, 3, 5])
    n = rng.randint(4, 12)
    prompts = [[rng.randint(1, 200) for _ in range(rng.randint(1, 6))]
               for _ in range(n)]
    max_new = [rng.randint(1, 10) for _ in range(n)]
    expect = toy_reference(prompts, max_new)
    eng = ContinuousEngine(ToyBackend(slots=slots, xp=xp), max_tokens=12,
                           prefill_per_step=rng.choice([1, 2]))
    order = list(range(n))
    rng.shuffle(order)
    reqs = {}
    for i in order:
        reqs[i] = eng.enqueue(prompts[i], max_new[i], rid=i)
        if rng.random() < 0.7:
            eng.step()
    eng.drain()
    for i in range(n):
        assert reqs[i].out == expect[i], f"request {i} diverged"


def test_toy_numpy_torch_and_jax_backends_bit_identical():
    prompts = [[3, 1, 4], [1, 5], [9]]
    max_new = [6, 4, 8]
    outs = {}
    for xp in ("numpy", "torch"):
        eng = ContinuousEngine(ToyBackend(slots=2, xp=xp), max_tokens=8)
        reqs = [eng.enqueue(p, m) for p, m in zip(prompts, max_new)]
        eng.drain()
        outs[xp] = [r.out for r in reqs]
    jeng = JContinuousEngine(JToyBackend(slots=2, xp="jax"), max_tokens=8)
    jreqs = [jeng.enqueue(p, m) for p, m in zip(prompts, max_new)]
    jeng.drain()
    assert outs["numpy"] == outs["torch"] == [r.out for r in jreqs]
    with pytest.raises(ValueError, match="array module"):
        ToyBackend(slots=1, xp="jax")


# -- differential: real LM vs ServeEngine.serve oracle --------------------------

PROMPT_LEN, MAX_LEN = 6, 64


@pytest.fixture(scope="module")
def lms():
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch, reduced=True)
        jp = jinit_params(jcfg, jax.random.PRNGKey(0))
        cfg = get_config(arch, reduced=True)
        out[arch] = (cfg, params_from_numpy(
            cfg, jax.tree.map(np.asarray, jp), "cpu"), jcfg, jp)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_oracle_grouping_independent(lms, arch):
    cfg, params, _, _ = lms[arch]
    mk = lambda: [Request(rid=i, prompt=[7 + 3 * i, 2], max_new_tokens=5)
                  for i in range(5)]
    outs = {}
    for bs in (2, 4):
        done = ServeEngine(cfg, params, batch_size=bs, max_len=MAX_LEN
                           ).serve(mk(), prompt_len=PROMPT_LEN)
        outs[bs] = {r.rid: r.out for r in done}
    assert outs[2] == outs[4]


def test_serve_oracle_rejects_overlong_prompt(lms):
    cfg, params, _, _ = lms["smollm-135m"]
    eng = ServeEngine(cfg, params, batch_size=2, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="exceeds prompt_len"):
        eng.serve([Request(rid=0, prompt=[1] * 4, max_new_tokens=2)],
                  prompt_len=3)
    with pytest.raises(ValueError, match="batch"):
        eng.generate([Request(rid=i, prompt=[1]) for i in range(3)])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,slots", [(0, 2), (1, 3)])
def test_lm_continuous_matches_oracle(lms, arch, seed, slots):
    """Continuous batching over the port's LM step functions is
    token-for-token the batch-to-completion oracle under randomized
    arrival order."""
    cfg, params, _, _ = lms[arch]
    rng = random.Random(seed)
    n = 6
    prompts = [[rng.randint(1, 500) for _ in range(rng.randint(1, PROMPT_LEN))]
               for _ in range(n)]
    max_new = [rng.randint(1, 8) for _ in range(n)]
    oracle = [Request(rid=i, prompt=list(p), max_new_tokens=m)
              for i, (p, m) in enumerate(zip(prompts, max_new))]
    ServeEngine(cfg, params, batch_size=4, max_len=MAX_LEN
                ).serve(oracle, prompt_len=PROMPT_LEN)
    expect = {r.rid: r.out for r in oracle}
    backend = LMBackend(cfg, params, slots=slots, prompt_len=PROMPT_LEN,
                        max_len=MAX_LEN)
    eng = ContinuousEngine(backend, max_tokens=8, prefill_per_step=2)
    order = list(range(n))
    rng.shuffle(order)
    reqs = {}
    for i in order:
        reqs[i] = eng.enqueue(prompts[i], max_new[i], rid=i)
        eng.step()
    eng.drain()
    for i in range(n):
        assert reqs[i].out == expect[i], f"request {i} diverged"


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_token_streams_equal_the_jax_package(lms, arch):
    """Same params, same prompts: the port's oracle and continuous loop
    give the JAX package's greedy streams (and its continuous loop's)."""
    cfg, params, jcfg, jp = lms[arch]
    rng = random.Random(5)
    prompts = [[rng.randint(1, 500) for _ in range(rng.randint(1, PROMPT_LEN))]
               for _ in range(5)]
    max_new = [rng.randint(2, 7) for _ in range(5)]
    jreqs = [JRequest(rid=i, prompt=list(p), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    JServeEngine(jcfg, jp, batch_size=4, max_len=MAX_LEN
                 ).serve(jreqs, prompt_len=PROMPT_LEN)
    treqs = [Request(rid=i, prompt=list(p), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    ServeEngine(cfg, params, batch_size=4, max_len=MAX_LEN
                ).serve(treqs, prompt_len=PROMPT_LEN)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    jeng = JContinuousEngine(JLMBackend(jcfg, jp, slots=2,
                                        prompt_len=PROMPT_LEN,
                                        max_len=MAX_LEN), max_tokens=8)
    teng = ContinuousEngine(LMBackend(cfg, params, slots=2,
                                      prompt_len=PROMPT_LEN,
                                      max_len=MAX_LEN), max_tokens=8)
    jout = [jeng.enqueue(p, m) for p, m in zip(prompts, max_new)]
    tout = [teng.enqueue(p, m) for p, m in zip(prompts, max_new)]
    jeng.drain()
    teng.drain()
    assert [r.out for r in tout] == [r.out for r in jout] \
        == [r.out for r in jreqs]


def test_lm_backend_rejects_encdec_and_bad_shapes(lms):
    cfg, params, _, _ = lms["smollm-135m"]
    encdec = get_config("seamless-m4t-medium", reduced=True)
    with pytest.raises(NotImplementedError, match="encdec"):
        LMBackend(encdec, params, slots=2, prompt_len=4, max_len=32)
    with pytest.raises(ValueError, match="decode room"):
        LMBackend(cfg, params, slots=2, prompt_len=8, max_len=8)
    be = LMBackend(cfg, params, slots=2, prompt_len=4, max_len=32)
    with pytest.raises(ValueError, match="prompt length"):
        be.prefill([1] * 5)


def test_lm_backend_decodes_through_the_scan_wrapper(lms, monkeypatch):
    """The hybrid backend's decode step goes through the K5 wrapper once
    per Mamba2 layer (its plain version on the CPU: no kernel launch)."""
    cfg, params, _, _ = lms["zamba2-1.2b"]
    be = LMBackend(cfg, params, slots=2, prompt_len=4, max_len=32)
    cache = be.insert(be.prefill([1, 2])[1], be.init_cache(), 0)
    k5 = mock.Mock(wraps=ops.ssm_scan)
    monkeypatch.setattr(ops, "ssm_scan", k5)
    reset_launch_counts()
    cache, res = be.generate(cache, np.array([3, 0], np.int32),
                             np.array([True, False]),
                             np.array([1, 0], np.int32))
    assert k5.call_count == cfg.num_layers
    assert launch_counts()["ssm_scan"] == 0
    assert res.valid()[:, 0].tolist() == [1, 0]
    assert cache["pos"].tolist() == [4, 1]


# -- deadline accounting under continuous load ----------------------------------

def _toy_engine(monitor, *, slots=2, step_bound=1.0, default_deadline=None):
    return ContinuousEngine(ToyBackend(slots=slots), max_tokens=8,
                            prefill_per_step=slots, monitor=monitor,
                            step_bound_s=step_bound,
                            default_deadline_s=default_deadline,
                            network="toy")


def test_miss_counts_match_hand_computed_trace():
    mon = DeadlineMonitor(speed_ratio=1e-12)
    eng = _toy_engine(mon, default_deadline=1.0)
    r1 = eng.enqueue([5, 6], 3)
    r2 = eng.enqueue([7], 3)
    eng.drain()
    assert r1.done and r2.done
    assert eng.metrics["decode_steps"] == 2
    assert mon.checks["toy"] == 2
    assert mon.misses["toy"] == 2
    assert r1.verdict.missed and r2.verdict.missed


def test_zero_misses_under_generous_ratio():
    mon = DeadlineMonitor(speed_ratio=1e9)
    eng = _toy_engine(mon, default_deadline=1.0)
    for i in range(5):
        eng.enqueue([i + 1], 4)
    eng.drain()
    assert mon.checks["toy"] == eng.metrics["decode_steps"] > 0
    assert mon.misses.get("toy", 0) == 0
    assert all(r.verdict.met for r in eng.completed)


def test_mid_stream_request_judged_against_own_deadline():
    mon = DeadlineMonitor(speed_ratio=1.0)
    eng = _toy_engine(mon, slots=2, default_deadline=1e6)
    eng.enqueue([1, 2], 6)
    eng.step()
    late = eng.enqueue([3], 3, deadline_s=1e-9)
    eng.drain()
    checks, misses = mon.checks["toy"], mon.misses.get("toy", 0)
    assert late.verdict.missed and late.verdict.deadline_s == 1e-9
    first = eng.completed[-1] if eng.completed[-1] is not late \
        else eng.completed[0]
    assert first.verdict.met and first.verdict.deadline_s == 1e6
    assert checks == eng.metrics["decode_steps"]
    assert misses == 0


def test_occupancy_recorded_per_decode_step():
    mon = DeadlineMonitor(speed_ratio=1e9)
    eng = _toy_engine(mon, slots=4)
    eng.enqueue([1], 3)
    eng.enqueue([2], 3)
    eng.drain()
    assert mon.mean_occupancy("toy") == pytest.approx(0.5)
    snap = mon.snapshot()["networks"]["toy"]
    assert snap["mean_occupancy"] == pytest.approx(0.5)
    assert snap["slot_capacity"] == 4
    with pytest.raises(ValueError, match="not in"):
        mon.record_occupancy("toy", 5, 4)


def test_sustained_occupancy_math():
    v = sustained_occupancy("lm", slots=8, period_s=0.05, step_bound_s=0.01,
                            arrival_rps=4.0, tokens_per_request=20.0)
    assert v.token_capacity_tps == pytest.approx(160.0)
    assert v.offered_load_tps == pytest.approx(80.0)
    assert v.occupancy == pytest.approx(0.5)
    assert v.step_fits and v.schedulable
    over = sustained_occupancy("lm", slots=8, period_s=0.05,
                               step_bound_s=0.01, arrival_rps=10.0,
                               tokens_per_request=20.0)
    assert over.occupancy > 1.0 and not over.schedulable


# -- Server integration -----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_server_register_decode_serves_continuously(lms, arch):
    cfg, params, _, _ = lms[arch]
    srv = Server(scaled_paper_machine(4), speed_ratio=1e9, device="cpu")
    verdict = srv.register_decode(
        "lm", cfg, period_s=0.05, params=params, slots=3,
        prompt_len=PROMPT_LEN, max_new_tokens=8, max_len=MAX_LEN,
        prefill_per_step=2, arrival_rps=10.0, tokens_per_request=5.0)
    assert verdict.schedulable
    expect_reqs = [Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=5)
                   for i in range(4)]
    ServeEngine(cfg, params, batch_size=4, max_len=MAX_LEN
                ).serve(expect_reqs, prompt_len=PROMPT_LEN)
    expect = {r.rid: r.out for r in expect_reqs}
    tickets = {i: srv.submit("lm", [1 + i, 2, 3]) for i in range(2)}
    mid = None
    for _ in range(40):
        srv.step()
        if mid is None:                 # arrive mid-stream
            mid = {i: srv.submit(
                "lm", {"prompt": [1 + i, 2, 3], "max_new_tokens": 5},
                deadline_s=123.0) for i in (2, 3)}
        if all(t.done for t in tickets.values()) and \
                all(t.done for t in mid.values()):
            break
    for i, t in {**tickets, **mid}.items():
        r = t.result()
        assert r.output[:5] == expect[i][:5]
        assert r.verdict.met
    assert mid[2].result().verdict.deadline_s == 123.0
    tel = srv.telemetry()
    assert tel["continuous"]["lm"]["evictions"] == 4
    assert tel["sustained"]["lm"]["schedulable"]
    assert 0 < tel["networks"]["lm"]["mean_occupancy"] <= 1
    assert "occ=" in srv.summary()


@pytest.mark.parametrize("arch", ARCHS)
def test_server_rejects_oversubscribed_decode_net(lms, arch):
    cfg, params, _, _ = lms[arch]
    srv = Server(scaled_paper_machine(4), speed_ratio=1e9, device="cpu")
    with pytest.raises(AdmissionError, match="oversubscribes"):
        srv.register_decode("lm", cfg, period_s=0.05, params=params,
                            slots=1, prompt_len=4, max_new_tokens=8,
                            max_len=MAX_LEN, arrival_rps=100.0)
    assert srv.networks == []           # atomic rollback


@pytest.mark.parametrize("arch", ARCHS)
def test_server_decode_ticket_failure_is_contained(lms, arch):
    cfg, params, _, _ = lms[arch]
    srv = Server(scaled_paper_machine(4), speed_ratio=1e9, device="cpu")
    srv.register_decode("lm", cfg, period_s=0.05, params=params, slots=2,
                        prompt_len=4, max_new_tokens=4, max_len=MAX_LEN)
    bad = srv.submit("lm", [1] * 9)     # longer than prompt_len
    with pytest.raises(ValueError, match="prompt length"):
        srv.step()
    assert bad.status == "failed" and "prompt length" in bad.error
    good = srv.submit("lm", [1, 2])
    for _ in range(10):
        srv.step()
        if good.done:
            break
    assert len(good.result().output) == 4


def test_server_admits_a_model_config_like_the_jax_server():
    """`register` lowers a ModelConfig to one decode-step graph
    (`core.lmgraph`), analysis-only and served through step_fn, with the
    JAX package's bound; a decode network is saved as analysis-only."""
    import repro.hw as RH
    import repro.serve as RS
    jcfg = jget_config("zamba2-1.2b")
    cfg = get_config("zamba2-1.2b")
    kw = dict(period_s=0.05, slots=4, batch=4, cache_len=256, max_layers=4)
    rsrv = RS.Server(RH.scaled_paper_machine(64))
    tsrv = Server(scaled_paper_machine(64), device="cpu")
    rv = rsrv.register("z", jcfg, step_fn=lambda p: p, **kw)
    tv = tsrv.register("z", cfg, step_fn=lambda p: p, **kw)
    assert repr(rv) == repr(tv) and tv.schedulable
    t = tsrv.submit("z", 7)
    tsrv.run(hyperperiods=1)
    assert t.result().output == 7
