"""The port's LM serving engines and decode-graph WCET against the JAX
package's: a twin of each test of `tests/test_serve.py`.

smollm-135m (REDUCED) generates through both packages' `ServeEngine` and
`PredictableEngine` with the JAX package's params carried across
(`params_from_numpy`, on the CPU): the tokens, step counts and deadline
checks must be equal. The decode-graph WCET of four configs, the
per-token analysis and the core-count scaling are plain Python in both
packages and must be identical.
"""

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro.core.lmgraph as JG
import repro.core.wcet as JW
import repro.hw as JH
import repro.models as JM
import repro.serve.engine as JE
import repro.serve.predictable as JP
import repro_torch.configs as TC
import repro_torch.core.lmgraph as TG
import repro_torch.core.wcet as TW
import repro_torch.hw as TH
import repro_torch.models as TM
import repro_torch.serve.engine as TE
import repro_torch.serve.predictable as TP


@pytest.fixture(scope="module")
def smollm():
    """smollm-135m REDUCED: (jax cfg, jax params, port cfg, port params)."""
    jcfg = JC.get_config("smollm-135m", reduced=True)
    tcfg = TC.get_config("smollm-135m", reduced=True)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, TM.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), "cpu")


def _sides(smollm):
    jcfg, jp, tcfg, tp = smollm
    return (("jax", JE, jcfg, jp), ("port", TE, tcfg, tp))


def test_engine_generates(smollm):
    outs = {}
    for side, E, cfg, params in _sides(smollm):
        eng = E.ServeEngine(cfg, params, batch_size=4, max_len=64)
        done = eng.generate([E.Request(rid=i, prompt=[1 + i, 2, 3],
                                       max_new_tokens=6) for i in range(3)])
        assert len(done) == 3
        for r in done:
            assert len(r.out) == 6
            assert all(0 <= t < cfg.vocab_size for t in r.out)
        assert eng.metrics["decode_steps"] == 5
        outs[side] = ([(r.rid, r.out) for r in done], dict(eng.metrics))
    assert outs["port"] == outs["jax"]


def test_engine_greedy_deterministic(smollm):
    outs = {}
    for side, E, cfg, params in _sides(smollm):
        eng = E.ServeEngine(cfg, params, batch_size=2, max_len=64)
        runs = [eng.generate([E.Request(rid=0, prompt=[5, 6, 7],
                                        max_new_tokens=8)])[0].out
                for _ in range(2)]
        assert runs[0] == runs[1]
        outs[side] = runs[0]
    assert outs["port"] == outs["jax"]


def _decode_wcet(C, G, W, H, arch, cores=8, hw="TPU_V5E"):
    cfg = C.get_config(arch)
    g = G.lm_decode_graph(cfg, batch=8, cache_len=2048, layers=2)
    report, sched, subtasks, mapping = W.analyze(g, getattr(H, hw),
                                                 num_cores=cores)
    return report, subtasks


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-1.6b",
                                  "zamba2-1.2b", "mixtral-8x22b"])
def test_lm_decode_graph_wcet(arch):
    jrep, _ = _decode_wcet(JC, JG, JW, JH, arch)
    report, subtasks = _decode_wcet(TC, TG, TW, TH, arch)
    assert repr(report) == repr(jrep)
    assert report.wcet_total_s > 0
    assert report.num_subtasks == len(subtasks)
    assert report.dma_utilization <= 1.0 + 1e-9
    assert report.compute_utilization <= 1.0 + 1e-9


def test_analyze_decode_scales_layers():
    reps = [P.analyze_decode(C.get_config("smollm-135m"), batch=8,
                             cache_len=1024, hw=H.TPU_V5E, max_layers=2)
            for P, C, H in ((JP, JC, JH), (TP, TC, TH))]
    rep = reps[1]
    assert rep.summary() == reps[0].summary()
    assert rep.per_token_wcet_s == reps[0].per_token_wcet_s
    assert rep.layers_modeled == 2
    assert rep.scaled_to_layers == 30
    assert rep.per_token_wcet_s > rep.wcet.wcet_total_s


def test_predictable_engine_runs_with_deadlines(smollm):
    outs = {}
    for (side, E, cfg, params), (P, H) in zip(_sides(smollm),
                                              ((JP, JH), (TP, TH))):
        # the speed ratio pinned, so host timing decides no verdict
        eng = P.PredictableEngine(cfg, params, batch_size=2, max_len=64,
                                  hw=H.scaled_paper_machine(4),
                                  speed_ratio=1e9)
        done = eng.generate([E.Request(rid=0, prompt=[1, 2],
                                       max_new_tokens=4)])
        assert done[0].out and eng.deadline_checks > 0
        outs[side] = (done[0].out, eng.deadline_checks, eng.deadline_misses)
    assert outs["port"] == outs["jax"]


def test_wcet_scales_down_with_cores():
    w = {}
    for side, C, G, W, H in (("jax", JC, JG, JW, JH),
                             ("port", TC, TG, TW, TH)):
        g = G.lm_decode_graph(C.get_config("smollm-135m"), batch=8,
                              cache_len=1024, layers=2)
        w[side] = {cores: W.analyze(g, H.PAPER_RISCV,
                                    num_cores=cores)[0].wcet_total_s
                   for cores in (1, 4, 16)}
    assert w["port"] == w["jax"]
    assert w["port"][4] < w["port"][1] * 0.7
    assert w["port"][16] <= w["port"][4] * 1.02
