"""The port's LM models (`repro_torch.models`) against the JAX package's.

Each config runs at its REDUCED size in float32 with the JAX package's own
`init_params(PRNGKey(0))` carried across (`params_from_numpy`). The same
prompts (numpy seeds) go through `prefill_step` and four `decode_step`s in
both packages; the last-token logits and every cache leaf must agree to
atol 1e-4 / rtol 1e-4 (float32 sums in another order). Prompts of 6
tokens take the Mamba2 block's K5 branch (S <= 8), 16 tokens its chunked
SSD branch. A per-row `pos` vector with one row past the cache end is held
against the JAX package's vmapped per-row decode (the continuous-batching
path), whose `dynamic_update_slice` clamps the write.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import cache_spec as jcache_spec
from repro.models import decode_step as jdecode_step
from repro.models import forward_hidden as jforward_hidden
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import prefill_step as jprefill_step
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.models import (ModelConfig, cache_spec, decode_step,
                                forward_hidden, init_cache, init_params,
                                params_from_numpy, prefill_step)

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 32


def _configs(arch, **changes):
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **changes)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, cfg


def _params(jcfg, cfg):
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")


def _close(got: dict, want: dict, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], np.asarray(want[k])
        assert tuple(g.shape) == w.shape, k
        if g.dtype == torch.int8:
            # int8 caches quantize the same floats: equal but for values
            # whose scaled float lands within rounding of a .5
            assert np.abs(g.numpy().astype(np.int32) - w.astype(np.int32)
                          ).max() <= 1, k
        else:
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32), err_msg=k,
                                       **tol)


def _run_both(jcfg, cfg, S, B=2, steps=4, seed=0, tol=TOL):
    jp, tp = _params(jcfg, cfg)
    toks = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jax.jit(jprefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks)}, jinit_cache(jcfg, B, MAX_LEN))
    tl, tc = prefill_step(cfg)(tp, {"tokens": torch.as_tensor(toks).long()},
                               init_cache(cfg, B, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    _close(tc, jc, tol)
    jdec, tdec = jax.jit(jdecode_step(jcfg)), decode_step(cfg)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        jl, jc = jdec(jp, jc, jnp.asarray(tok[:, None]))
        tl, tc = tdec(tp, tc, torch.as_tensor(tok[:, None]).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        _close(tc, jc, tol)
    return tp


@pytest.mark.parametrize("S", [6, 16])
@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b"])
def test_prefill_and_decode_match_jax(arch, S, monkeypatch):
    jcfg, cfg = _configs(arch)
    spies = {k: mock.Mock(wraps=getattr(ops, k))
             for k in ("ssm_scan", "flash_attention")}
    for k, spy in spies.items():
        monkeypatch.setattr(ops, k, spy)
    reset_launch_counts()
    _run_both(jcfg, cfg, S)
    # the Mamba2 blocks call the K5 wrapper once per layer per decode step,
    # and per layer in a short prefill; on the CPU it runs its plain
    # version, which is no kernel launch (attention takes the oracle here)
    n_ssm = cfg.num_layers * (4 + (S <= 8)) if cfg.family == "hybrid" else 0
    assert spies["ssm_scan"].call_count == n_ssm
    assert spies["flash_attention"].call_count == 0
    assert sum(launch_counts().values()) == 0


@pytest.mark.parametrize("S", [6, 16])
def test_hybrid_with_a_tail_matches_jax(S):
    """num_layers % attn_every != 0: the tail of Mamba2 layers after the
    last shared-attention group (5 layers, period 2: a tail of 1)."""
    jcfg, cfg = _configs("zamba2-1.2b", num_layers=5, attn_every=2)
    assert cfg.num_layers % cfg.attn_every == 1
    _run_both(jcfg, cfg, S)


def test_dense_int8_kv_cache_matches_jax():
    """The int8 cache's decode rounds q and the probabilities to bf16 (8
    mantissa bits) in both packages, so a last-bit float32 difference
    upstream can move one bf16 rounding: held to 4e-3 (about one bf16 ulp
    at the logits' magnitude, |x| < 1) instead of float32's 1e-4."""
    jcfg, cfg = _configs("smollm-135m", kv_cache_dtype="int8")
    _run_both(jcfg, cfg, 6, tol=dict(atol=4e-3, rtol=1e-2))


def _jax_rows(jcfg, jp, jc, toks, pos):
    """The JAX package's continuous-batching decode: its batch-1 step
    vmapped over the slot axis with a per-slot pos (serve/continuous.py)."""
    step = jdecode_step(jcfg)

    def row_fn(params, cache_row, tok):
        cache1 = {k: (v if k == "pos" else v[:, None])
                  for k, v in cache_row.items()}
        logits, new = step(params, cache1, tok[None])
        return logits[0], {k: (v if k == "pos" else v[:, 0])
                           for k, v in new.items()}

    axes = {k: (0 if k == "pos" else 1) for k in jc}
    vrow = jax.vmap(row_fn, in_axes=(None, axes, 0), out_axes=(0, axes))
    return jax.jit(vrow)(jp, {**jc, "pos": jnp.asarray(pos, jnp.int32)},
                         jnp.asarray(toks))


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b"])
def test_per_row_pos_with_overrun_matches_vmapped_rows(arch):
    """Rows at different positions, one of them past max_len - 1 (an idle
    slot keeps advancing): the write lands at max_len - 1 and the mask
    covers the whole cache, as in the JAX package."""
    jcfg, cfg = _configs(arch)
    jp, tp = _params(jcfg, cfg)
    B = 3
    toks = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (B, 6)).astype(np.int32)
    _, jc = jax.jit(jprefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks)}, jinit_cache(jcfg, B, MAX_LEN))
    _, tc = prefill_step(cfg)(tp, {"tokens": torch.as_tensor(toks).long()},
                              init_cache(cfg, B, MAX_LEN, device="cpu"))
    pos = np.array([5, 11, MAX_LEN + 3], np.int32)
    nxt = np.array([[7], [8], [9]], np.int32)
    for _ in range(2):
        jl, jc = _jax_rows(jcfg, jp, jc, nxt, pos)
        tl, tc = decode_step(cfg)(tp, {**tc, "pos": torch.as_tensor(pos)},
                                  torch.as_tensor(nxt).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _close(tc, jc)
        assert tc["pos"].tolist() == (pos + 1).tolist()
        pos = pos + 1
    # the overrun row wrote its last two tokens at max_len - 1
    assert not torch.equal(tc["k"][:, 2, :, MAX_LEN - 1],
                            torch.zeros_like(tc["k"][:, 2, :, 0]))


def test_forward_hidden_matches_jax():
    for arch in ("smollm-135m", "zamba2-1.2b"):
        jcfg, cfg = _configs(arch)
        jp, tp = _params(jcfg, cfg)
        x = np.random.default_rng(2).standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
        jh, _ = jforward_hidden(jcfg, jp, jnp.asarray(x), jnp.arange(12))
        th, aux = forward_hidden(cfg, tp, torch.as_tensor(x),
                                 torch.arange(12))
        assert aux == 0.0
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b"])
def test_init_params_and_cache_have_the_jax_layout(arch):
    """The port's own `init_params` builds the JAX package's tree (same
    keys, shapes, dtypes), and `cache_spec` its cache layout, so params
    and caches carry across as tree maps."""
    jcfg = jget_config(arch)                 # full width, bf16
    cfg = get_config(arch)
    small = dataclasses.replace(cfg, num_layers=2, vocab_size=64)
    jsmall = dataclasses.replace(jcfg, num_layers=2, vocab_size=64)
    shapes = jax.eval_shape(lambda: jinit_params(jsmall,
                                                 jax.random.PRNGKey(0)))
    tp = init_params(small, torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(tp))
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    jspec = jcache_spec(jcfg, 4, 64)
    for k, (shape, dt) in cache_spec(cfg, 4, 64).items():
        assert shape == jspec[k].shape, k
        assert str(dt).split(".")[-1] == str(jspec[k].dtype), k


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_params_from_numpy_keeps_bfloat16_bits():
    jcfg = dataclasses.replace(jget_config("zamba2-1.2b", reduced=True),
                               dtype="bfloat16")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    w_j = np.asarray(jp["layers"]["ssm"]["in_proj"])
    w_t = tp["layers"]["ssm"]["in_proj"]
    assert w_t.dtype == torch.bfloat16
    assert np.array_equal(w_t.view(torch.int16).numpy(),
                          w_j.view(np.int16))
    assert tp["layers"]["ssm"]["a_log"].dtype == torch.float32


def test_waiting_families_raise_not_implemented():
    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        if cfg.family in ("dense", "hybrid"):
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            prefill_step(cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_params(cfg, device="cpu")
    assert JConfig.__dataclass_fields__.keys() == \
        ModelConfig.__dataclass_fields__.keys()
