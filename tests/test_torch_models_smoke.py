"""Twins of tests/test_models_smoke.py's serving and config checks, and of
tests/test_perf_features.py's SSD check, for the port.

Every assigned architecture serves at REDUCED scale on the CPU (prefill +
one decode step, the JAX package's params carried across): the logits have
the JAX package's shape, are finite and agree with the JAX package's
within atol/rtol 1e-4 in float32. The analytic parameter counts equal the
JAX package's and land near the published sizes; moe active counts match.
The Mamba2 chunked SSD form equals the token-by-token recurrence.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import prefill_step as jprefill_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import (ModelConfig, decode_step, init_cache,
                                params_from_numpy, prefill_step)
from repro_torch.models.ssm import ssm_apply, ssm_init

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_serve(arch):
    cfg = get_config(arch, reduced=True)
    jcfg = jget_config(arch, reduced=True)
    rng = np.random.default_rng(8)
    B, S = 2, 12
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    jbatch = {"tokens": jnp.asarray(toks)}
    batch = {"tokens": torch.as_tensor(toks)}
    if cfg.family == "encdec":
        src = rng.integers(0, cfg.vocab_size, (B, S))
        jbatch["src_tokens"] = jnp.asarray(src)
        batch["src_tokens"] = torch.as_tensor(src)
    jl, jc = jax.jit(jprefill_step(jcfg))(
        jp, jbatch, jinit_cache(jcfg, B, S + 2, enc_len=S))
    logits, cache = prefill_step(cfg)(
        params, batch, init_cache(cfg, B, S + 2, enc_len=S, device="cpu"))
    assert tuple(logits.shape) == jl.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    jl2, jc = jax.jit(jdecode_step(jcfg))(
        jp, jc, jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None])
    logits2, cache = decode_step(cfg)(params, cache, tok)
    assert tuple(logits2.shape) == jl2.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(logits2).all()
    np.testing.assert_allclose(logits2.numpy(), np.asarray(jl2), **TOL)
    assert int(cache["pos"]) == int(jc["pos"]) == S


def test_param_counts_match_published():
    """Config sanity: the port's analytic counts are the JAX package's, and
    land near the published sizes."""
    expect = {
        "pixtral-12b": 12.2e9, "internlm2-20b": 19.9e9,
        "smollm-135m": 135e6, "minicpm-2b": 2.7e9,
        "qwen1.5-110b": 111e9, "zamba2-1.2b": 1.2e9,
        "rwkv6-1.6b": 1.5e9, "arctic-480b": 480e9,
        "mixtral-8x22b": 141e9, "seamless-m4t-medium": 0.8e9,
    }
    assert sorted(expect) == sorted(ARCH_IDS)
    for arch, n in expect.items():
        cfg = get_config(arch)
        got = cfg.param_count()
        assert got == jget_config(arch).param_count(), arch
        assert cfg.active_param_count() == \
            jget_config(arch).active_param_count(), arch
        assert abs(got - n) / n < 0.12, f"{arch}: {got:.3e} vs {n:.3e}"


def test_moe_active_params():
    arctic = get_config("arctic-480b")
    assert arctic.active_param_count() < 0.05 * arctic.param_count()
    mixtral = get_config("mixtral-8x22b")
    ratio = mixtral.active_param_count() / mixtral.param_count()
    assert 0.2 < ratio < 0.35          # 39B / 141B


def test_ssd_chunked_matches_sequential():
    """Mamba2 SSD chunked form == token-by-token recurrence (50 tokens:
    the chunked branch; one token at a time: the K5 wrapper's plain
    version)."""
    cfg = ModelConfig(name="s", family="hybrid", num_layers=1, d_model=32,
                      num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                      ssm_state=8, attn_every=2, dtype="float32")
    p = ssm_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                 device="cpu")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 50, 32)).astype(np.float32) * 0.5)
    y_chunk, (st_chunk, _) = ssm_apply(p, x, cfg)
    st = torch.zeros((2, 64, 8))
    conv = torch.zeros((2, cfg.ssm_conv - 1, 64))
    ys = []
    for t in range(50):
        yt, (st, conv) = ssm_apply(p, x[:, t:t + 1], cfg, state=st,
                                   conv_cache=conv)
        ys.append(yt)
    y_seq = torch.cat(ys, dim=1)
    assert float((y_chunk - y_seq).abs().max()) < 1e-4
    assert float((st_chunk - st).abs().max()) < 1e-4
