"""`repro_torch.serve.predictable` and `repro_torch.launch.serve` against the
JAX package: the per-token WCET analysis of every LM config the decode
graph takes, on three machines; `PredictableEngine`'s greedy tokens and
per-step deadline checks on a 2-layer dense config (the JAX package's
params carried across with `params_from_numpy`); `MultiModelEngine`'s
admission and rejection; and the launcher's `--analyze-only` summary.
Everything runs on the CPU (`device="cpu"`)."""

import dataclasses

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro.core.cnn as jcnn
import repro.hw as JH
import repro.launch.serve as JL
import repro.models as JM
import repro.serve.engine as JE
import repro.serve.predictable as JP
import repro_torch.configs as TC
import repro_torch.core.cnn as tcnn
import repro_torch.hw as TH
import repro_torch.launch.serve as TL
import repro_torch.models as TM
import repro_torch.serve.engine as TE
import repro_torch.serve.predictable as TP


def _machines(hw):
    return [hw.PAPER_RISCV, hw.TPU_V5E, hw.scaled_paper_machine(4)]


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_analyze_decode_matches_jax(arch):
    """Equal per-token WCET for every config `lm_decode_graph` takes; a
    config it refuses is refused by both packages alike."""
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for jhw, thw in zip(_machines(JH), _machines(TH)):
        try:
            jrep = JP.analyze_decode(jcfg, 4, 128, jhw, max_layers=2)
        except Exception as e:
            with pytest.raises(type(e)):
                TP.analyze_decode(tcfg, 4, 128, thw, max_layers=2)
            continue
        trep = TP.analyze_decode(tcfg, 4, 128, thw, max_layers=2)
        assert trep.per_token_wcet_s == jrep.per_token_wcet_s
        assert (trep.layers_modeled, trep.scaled_to_layers) == \
            (jrep.layers_modeled, jrep.scaled_to_layers)
        assert trep.summary() == jrep.summary()


@pytest.fixture(scope="module")
def dense2():
    """smollm-135m REDUCED cut to 2 layers, params from the JAX package."""
    jcfg = dataclasses.replace(JC.get_config("smollm-135m", reduced=True),
                               num_layers=2)
    tcfg = dataclasses.replace(TC.get_config("smollm-135m", reduced=True),
                               num_layers=2)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, TM.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), "cpu")


def test_predictable_engine_tokens_and_checks_match_jax(dense2):
    jcfg, jp, tcfg, tp = dense2
    hw = (JH.scaled_paper_machine(4), TH.scaled_paper_machine(4))
    prompts = [[1, 2], [5, 6, 7], [9]]
    outs = {}
    for side, P, E, cfg, params, m in (("jax", JP, JE, jcfg, jp, hw[0]),
                                       ("port", TP, TE, tcfg, tp, hw[1])):
        eng = P.PredictableEngine(cfg, params, batch_size=4, max_len=64,
                                  hw=m, speed_ratio=1e9)
        done = eng.generate([E.Request(rid=i, prompt=p, max_new_tokens=5)
                             for i, p in enumerate(prompts)])
        outs[side] = ([r.out for r in done], eng.report.per_token_wcet_s,
                      eng.deadline_checks, eng.deadline_misses,
                      dict(eng.metrics))
    assert outs["port"] == outs["jax"]
    tokens, _, checks, misses, metrics = outs["port"]
    assert all(len(t) == 5 for t in tokens)
    # every decode step is checked, one check per step
    assert checks == metrics["decode_steps"] == 4 and misses == 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_multimodel_engine_admits_and_rejects_like_jax(backend):
    def run(P, cnn, hw, **kw):
        eng = P.MultiModelEngine(hw.scaled_paper_machine(4), num_cores=4,
                                 **kw)
        got = [eng.admit_graph("cam", cnn.small_cnn(), period_s=1 / 50),
               eng.admit_graph("greedy", cnn.small_cnn(), period_s=1 / 50,
                               deadline_s=1e-9)]
        names = [s.name for s in eng.specs]
        lm = (JC if P is JP else TC).get_config("smollm-135m", reduced=True)
        got.append(eng.admit_model("lm", lm, period_s=1 / 10, cache_len=64,
                                   step_fn=lambda: None))
        got.append(eng.admit_model("lm_late", lm, period_s=1 / 10,
                                   deadline_s=1e-9, cache_len=64,
                                   step_fn=lambda: None))
        engines = eng.attach_compiled_executors()
        res = eng.run_hyperperiod(speed_ratio=1e9)
        return (got, names, [s.name for s in eng.specs], sorted(engines),
                repr(eng.report), res["checks"], res["misses"],
                sorted(eng.step_fns))

    port = run(TP, tcnn, TH, backend=backend, device="cpu")
    assert port == run(JP, jcnn, JH)
    got, names_after_reject = port[0], port[1]
    assert got == [True, False, True, False]
    assert names_after_reject == ["cam"]     # the rejection rolled back


@pytest.mark.parametrize("argv", [
    ["--arch", "zamba2-1.2b", "--analyze-only"],
    ["--arch", "smollm-135m", "--analyze-only", "--hw", "paper",
     "--batch", "2", "--max-len", "64"],
])
def test_launch_serve_analyze_only_prints_the_reference_summary(argv,
                                                                capsys):
    JL.main(argv)
    want = capsys.readouterr().out
    TL.main(argv)
    assert capsys.readouterr().out == want
    assert "per-token WCET" in want


def test_launch_serve_runs_the_predictable_engine(capsys):
    TL.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
             "--requests", "3", "--batch", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("tokens ->") == 3
    # 2 batches x 2 decode steps, each checked once
    assert "deadline misses" in out and out.rstrip().endswith("/4")
