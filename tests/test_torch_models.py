"""The port's LM models (`repro_torch.models`) against the JAX package's.

Each config runs at its REDUCED size in float32 with the JAX package's own
`init_params(PRNGKey(0))` carried across (`params_from_numpy`). The same
prompts (numpy seeds) go through `prefill_step` and four `decode_step`s in
both packages; the last-token logits and every cache leaf must agree to
atol 1e-4 / rtol 1e-4 (float32 sums in another order). Prompts of 6
tokens take the Mamba2 block's K5 branch (S <= 8), 16 tokens its chunked
SSD branch. A per-row `pos` vector with one row past the cache end is held
against the JAX package's vmapped per-row decode (the continuous-batching
path), whose `dynamic_update_slice` clamps the write. The encdec family's
encoder reads the prompt as `src_tokens` (the audio frontend is a stub).
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
from repro.models.transformer import decode_trunk as jdecode_trunk
from repro.models.transformer import encode as jencode
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.models import (ModelConfig, cache_spec, chunked_xent,
                                decode_step, decode_trunk, encode,
                                forward_hidden, init_cache, init_params,
                                params_from_numpy, prefill_step, train_loss)

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


def _batches(cfg, toks):
    """The same prompts as a JAX and a port batch; the encdec encoder
    reads them as its source tokens."""
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.as_tensor(toks).long()}
    if cfg.family == "encdec":
        jb["src_tokens"], tb["src_tokens"] = jb["tokens"], tb["tokens"]
    return jb, tb


def _run_both(jcfg, cfg, S, B=2, steps=4, seed=0, tol=TOL):
    jp, tp = _params(jcfg, cfg)
    toks = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = _batches(cfg, toks)
    jl, jc = jax.jit(jprefill_step(jcfg))(
        jp, jb, jinit_cache(jcfg, B, MAX_LEN, enc_len=S))
    tl, tc = prefill_step(cfg)(tp, tb, init_cache(cfg, B, MAX_LEN, enc_len=S,
                                                  device="cpu"))
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
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_jax(arch, S, monkeypatch):
    jcfg, cfg = _configs(arch)
    spies = {k: mock.Mock(wraps=getattr(ops, k))
             for k in ("ssm_scan", "flash_attention")}
    for k, spy in spies.items():
        monkeypatch.setattr(ops, k, spy)
    reset_launch_counts()
    tp = _run_both(jcfg, cfg, S)
    if cfg.family == "encdec":
        # the cross-attention cache holds the encoder's S positions
        assert tuple(init_cache(cfg, 2, MAX_LEN, enc_len=S, device="cpu")
                     ["xk"].shape) == (cfg.dec_layers, 2, cfg.num_kv_heads,
                                       S, cfg.hd)
    assert sum(t.numel() for t in _leaves(tp)) == sum(
        np.prod(x.shape) for x in jax.tree.leaves(
            jax.eval_shape(lambda: jinit_params(jcfg,
                                                jax.random.PRNGKey(0)))))
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


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b",
                                  "mixtral-8x22b", "arctic-480b",
                                  "rwkv6-1.6b"])
def test_per_row_pos_with_overrun_matches_vmapped_rows(arch):
    """Rows at different positions, one of them past max_len - 1 (an idle
    slot keeps advancing): the write lands at max_len - 1 and the mask
    covers the whole cache, as in the JAX package. The moe rows route
    their tokens alone (capacity per row) as the vmapped batch-1 steps do;
    the RWKV state has no positions, only `pos` advances per row."""
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
    if "k" in tc:
        # the overrun row wrote its last two tokens at max_len - 1
        assert not torch.equal(tc["k"][:, 2, :, MAX_LEN - 1],
                                torch.zeros_like(tc["k"][:, 2, :, 0]))


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b",
                                  "mixtral-8x22b", "arctic-480b",
                                  "rwkv6-1.6b"])
def test_forward_hidden_matches_jax(arch):
    """The decoder-only trunk, and the routers' summed aux loss for moe."""
    jcfg, cfg = _configs(arch)
    jp, tp = _params(jcfg, cfg)
    x = np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jh, jaux = jforward_hidden(jcfg, jp, jnp.asarray(x), jnp.arange(12))
    th, aux = forward_hidden(cfg, tp, torch.as_tensor(x), torch.arange(12))
    if cfg.family == "moe":
        np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    else:
        assert aux == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_encode_and_decode_trunk_match_jax():
    """The encdec trunk over whole sequences: the encoder on 10 source
    positions, the decoder on 7 target positions cross-attending to it."""
    jcfg, cfg = _configs("seamless-m4t-medium")
    jp, tp = _params(jcfg, cfg)
    rng = np.random.default_rng(3)
    xe = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    je = jencode(jcfg, jp, jnp.asarray(xe), jnp.arange(10))
    te = encode(cfg, tp, torch.as_tensor(xe), torch.arange(10))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    jd = jdecode_trunk(jcfg, jp, jnp.asarray(xd), je, jnp.arange(7),
                       jnp.arange(10))
    td = decode_trunk(cfg, tp, torch.as_tensor(xd), te, torch.arange(7),
                      torch.arange(10))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


def _layers_cut(cfg, n):
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, enc_layers=n, dec_layers=n,
                                   vocab_size=64)
    return dataclasses.replace(cfg, num_layers=n, vocab_size=64)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_and_cache_have_the_jax_layout(arch):
    """The port's own `init_params` builds the JAX package's tree (same
    keys, shapes, dtypes), and `cache_spec` its cache layout, so params
    and caches carry across as tree maps. Full width (bf16) at 2 layers,
    except where two layers' MLPs or experts would take GBs
    (qwen1.5-110b, internlm2-20b, pixtral-12b, the moe configs): there
    d_ff and the expert count are cut, which changes no leaf's name or
    dtype."""
    jcfg = jget_config(arch)                 # full width, bf16
    cfg = get_config(arch)
    cut = {}
    if cfg.family == "moe" or 6 * cfg.d_model * cfg.d_ff > 2e8:
        cut = dict(d_ff=256)
    if cfg.family == "moe":
        cut.update(num_experts=2, dense_residual_ff=min(
            cfg.dense_residual_ff, 64))
    small = _layers_cut(dataclasses.replace(cfg, **cut), 2)
    jsmall = _layers_cut(dataclasses.replace(jcfg, **cut), 2)
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
    jspec = jcache_spec(jcfg, 4, 64, enc_len=24)
    spec = cache_spec(cfg, 4, 64, enc_len=24)
    assert sorted(spec) == sorted(jspec)
    for k, (shape, dt) in spec.items():
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


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_training_surface_raises_naming_item_15(arch):
    """Every family serves and has the training surface: `train_loss`
    builds a loss function, and `chunked_xent` (here over chunks of 5
    positions, the last one padded) equals the JAX package's within rtol
    1e-6 on the same float32 inputs. (Before the training port both
    raised NotImplementedError naming ROADMAP item 15.)"""
    from repro.models.transformer import chunked_xent as jchunked_xent
    cfg = get_config(arch, reduced=True)
    assert callable(train_loss(cfg))
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, cfg.vocab_size, (2, 12))
    w = (rng.standard_normal((cfg.d_model, cfg.vocab_size)) * 0.05
         ).astype(np.float32)
    params = ({"embed": {"table": w.T.copy()}} if cfg.tie_embeddings
              else {"lm_head": {"w": w}})
    got = chunked_xent(cfg, jax.tree.map(torch.as_tensor, params),
                       torch.as_tensor(h), torch.as_tensor(labels), chunk=5)
    want = jchunked_xent(cfg, jax.tree.map(jnp.asarray, params),
                         jnp.asarray(h), jnp.asarray(labels), chunk=5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert JConfig.__dataclass_fields__.keys() == \
        ModelConfig.__dataclass_fields__.keys()
