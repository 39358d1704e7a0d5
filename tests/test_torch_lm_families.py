"""Serving the moe, RWKV (`ssm`) and encdec families on the CPU, through
the port's entry points, against the JAX package's.

Reduced configs in float32 with the JAX package's params carried across:
`ServeEngine.serve` gives the JAX package's greedy streams for each family
(seamless-m4t-medium's encoder reading the prompt as `src_tokens`); the
continuous loop and `Server.register_decode` give `ServeEngine.serve`'s
streams token for token for the moe and RWKV families; continuous batching
and `PredictableEngine` refuse encdec in both packages. Attention takes the
oracle on the CPU: no K4 wrapper call, no launch.
"""

import random
from unittest import mock

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.serve.continuous import LMBackend as JLMBackend
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.predictable import PredictableEngine as JPredictableEngine
import repro.hw as JH
from repro_torch.configs import get_config
from repro_torch.hw import scaled_paper_machine
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.models import params_from_numpy
from repro_torch.serve import PredictableEngine, Server
from repro_torch.serve.continuous import ContinuousEngine, LMBackend
from repro_torch.serve.engine import Request, ServeEngine

PROMPT_LEN, MAX_LEN = 6, 64
ARCHS = ["mixtral-8x22b", "arctic-480b", "rwkv6-1.6b", "seamless-m4t-medium"]
DECODER_ONLY = ARCHS[:3]


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


def _prompts(seed, n):
    rng = random.Random(seed)
    prompts = [[rng.randint(1, 500) for _ in range(rng.randint(1, PROMPT_LEN))]
               for _ in range(n)]
    return prompts, [rng.randint(2, 7) for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_streams_equal_the_jax_package(lms, arch, monkeypatch):
    cfg, params, jcfg, jp = lms[arch]
    prompts, max_new = _prompts(5, 5)
    jreqs = [JRequest(rid=i, prompt=list(p), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    JServeEngine(jcfg, jp, batch_size=4, max_len=MAX_LEN
                 ).serve(jreqs, prompt_len=PROMPT_LEN)
    k4 = mock.Mock(wraps=ops.flash_attention)
    monkeypatch.setattr(ops, "flash_attention", k4)
    reset_launch_counts()
    treqs = [Request(rid=i, prompt=list(p), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    eng = ServeEngine(cfg, params, batch_size=4, max_len=MAX_LEN)
    eng.serve(treqs, prompt_len=PROMPT_LEN)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(len(r.out) == m for r, m in zip(treqs, max_new))
    assert eng.metrics["prefills"] == 2
    assert k4.call_count == 0 and sum(launch_counts().values()) == 0


@pytest.mark.parametrize("arch", DECODER_ONLY)
@pytest.mark.parametrize("seed,slots", [(0, 2), (1, 3)])
def test_continuous_matches_oracle(lms, arch, seed, slots):
    """Requests entering and leaving the slots in a random order give
    `ServeEngine.serve`'s streams: moe capacity and the RWKV state are per
    row, so slots never couple."""
    cfg, params, _, _ = lms[arch]
    prompts, max_new = _prompts(seed, 6)
    oracle = [Request(rid=i, prompt=list(p), max_new_tokens=m)
              for i, (p, m) in enumerate(zip(prompts, max_new))]
    ServeEngine(cfg, params, batch_size=4, max_len=MAX_LEN
                ).serve(oracle, prompt_len=PROMPT_LEN)
    eng = ContinuousEngine(LMBackend(cfg, params, slots=slots,
                                     prompt_len=PROMPT_LEN, max_len=MAX_LEN),
                           max_tokens=8, prefill_per_step=2)
    order = list(range(6))
    random.Random(seed).shuffle(order)
    reqs = {}
    for i in order:
        reqs[i] = eng.enqueue(prompts[i], max_new[i], rid=i)
        eng.step()
    eng.drain()
    assert [reqs[i].out for i in range(6)] == [r.out for r in oracle]


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_server_register_decode_equals_serve(lms, arch):
    """`Server.register_decode` admits the config (its decode-step graph
    from `core.lmgraph`) and serves 4 tickets, 2 of them mid-stream, each
    equal to `ServeEngine.serve` token for token."""
    cfg, params, _, _ = lms[arch]
    srv = Server(scaled_paper_machine(4), speed_ratio=1e9, device="cpu")
    verdict = srv.register_decode(
        "lm", cfg, period_s=0.05, params=params, slots=2,
        prompt_len=PROMPT_LEN, max_new_tokens=6, max_len=MAX_LEN)
    assert verdict.schedulable
    prompts = [[1 + i, 2, 3 + 5 * i][: 1 + i % 3] for i in range(4)]
    oracle = [Request(rid=i, prompt=p, max_new_tokens=6)
              for i, p in enumerate(prompts)]
    ServeEngine(cfg, params, batch_size=4, max_len=MAX_LEN
                ).serve(oracle, prompt_len=PROMPT_LEN)
    tickets = [srv.submit("lm", p) for p in prompts[:2]]
    for step in range(60):
        srv.step()
        if step == 1:
            tickets += [srv.submit("lm", p) for p in prompts[2:]]
        if len(tickets) == 4 and all(t.done for t in tickets):
            break
    assert [t.result().output for t in tickets] == [r.out for r in oracle]
    assert srv.telemetry()["continuous"]["lm"]["evictions"] == 4


def test_continuous_batching_refuses_encdec_in_both_packages(lms):
    cfg, params, jcfg, jp = lms["seamless-m4t-medium"]
    with pytest.raises(NotImplementedError, match="encdec"):
        JLMBackend(jcfg, jp, slots=2, prompt_len=4, max_len=32)
    with pytest.raises(NotImplementedError, match="encdec"):
        LMBackend(cfg, params, slots=2, prompt_len=4, max_len=32)
    srv = Server(scaled_paper_machine(4), speed_ratio=1e9, device="cpu")
    with pytest.raises(NotImplementedError, match="encdec"):
        srv.register_decode("lm", cfg, period_s=0.05, params=params,
                            slots=2, prompt_len=4, max_len=32)
    assert srv.networks == []           # atomic rollback


def test_predictable_engine_refuses_encdec_like_jax(lms):
    """seamless-m4t-medium has `num_layers` 0 (its layers are `enc_layers`
    and `dec_layers`), and the JAX package's `analyze_decode` divides by it:
    `PredictableEngine` cannot be built for encdec there, and the port
    keeps that refusal (ROADMAP.md, queue 3). `ServeEngine` serves it."""
    cfg, params, jcfg, jp = lms["seamless-m4t-medium"]
    assert cfg.num_layers == 0
    with pytest.raises(ZeroDivisionError):
        JPredictableEngine(jcfg, jp, batch_size=4, max_len=MAX_LEN,
                           hw=JH.scaled_paper_machine(4), speed_ratio=1e9)
    with pytest.raises(ZeroDivisionError):
        PredictableEngine(cfg, params, batch_size=4, max_len=MAX_LEN,
                          hw=scaled_paper_machine(4), speed_ratio=1e9)
