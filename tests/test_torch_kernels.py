"""The port's kernel layer against the JAX package's Pallas kernels.

On the CPU every kernel wrapper takes its plain torch version; those are
held bit-exactly (`np.array_equal`: everything here is integer, and the
requant is the same float32 multiply and round-half-even) against
`gemm_int8_pallas` / `conv2d_int8_pallas` in Pallas interpret mode and
against `repro.kernels.ref`. The `cuda`-marked test holds the CUDA kernels
against the plain versions on a GPU and skips without one.
"""

import importlib
import math
from unittest import mock

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.conv2d_im2col import (conv2d_int8_pallas,
                                         im2col_patches as j_im2col)
from repro.kernels.gemm_int8 import gemm_int8_pallas
from repro_torch.core import quantize as tq
from repro_torch.kernels import (conv2d_int8, conv2d_int8_plain, gemm_int8,
                                 gemm_int8_plain, launch_counts, ref,
                                 reset_launch_counts)
from repro_torch.kernels.conv2d_im2col import (CHUNK_K, TILE_M, TILE_N,
                                               conv_splits, split_workspace)
from repro_torch.kernels.gemm_int8 import (SKINNY_CHUNK, SKINNY_M, SKINNY_N,
                                           gemm_splits)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _mult(rng, kind, n):
    if kind is None:
        return None
    if kind == "scalar":
        return np.float32(0.003)
    return (rng.random(n) * 0.002 + 1e-5).astype(np.float32)


# -- K1: int8 GEMM ------------------------------------------------------------

@pytest.mark.parametrize("mult", [None, "scalar", "channel"])
@pytest.mark.parametrize("M,K,N", [(8, 16, 8), (1, 512, 64), (257, 129, 65),
                                   (3, 1030, 5), (37, 131, 77)])
def test_gemm_plain_matches_pallas(rng, M, K, N, mult):
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    m = _mult(rng, mult, N)
    want = np.asarray(gemm_int8_pallas(x, w, m, bm=32, bn=32, bk=32,
                                       interpret=True))
    got = gemm_int8(_t(x), _t(w), None if m is None else _t(m)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(ref.gemm_int8(_t(x), _t(w), m).numpy(),
                          np.asarray(jref.gemm_int8(x, w, m)))


@pytest.mark.parametrize("mult", [None, "channel"])
@pytest.mark.parametrize("M", [1, 8, 256])
def test_gemm_plain_matches_pallas_at_classifier_shapes(rng, M, mult):
    """The classifier's product (K 2048, N 1000) at batch 1 and 8 (K1's
    skinny route on the card) and at M 256 (its tensor-core route)."""
    K, N = 2048, 1000
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    m = _mult(rng, mult, N)
    want = np.asarray(gemm_int8_pallas(x, w, m, bm=min(M, 128), bn=256,
                                       bk=1024, interpret=True))
    got = gemm_int8(_t(x), _t(w), None if m is None else _t(m)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("M", [1, 2, 8, 16])
def test_gemm_splits_skinny_route_fills_the_card(M):
    """M <= 16 takes the skinny route; at the classifier's (K 2048, N
    1000) its 64-column tiles x splits reach 132 blocks with the least
    split, at most one per 128-row K chunk, and the kernel's balanced
    ranges give every split at least one chunk; one SM-set of 8 gives 1."""
    K, N = 2048, 1000
    route, S = gemm_splits(M, N, K)
    tiles = math.ceil(N / SKINNY_N)
    chunks = math.ceil(K / SKINNY_CHUNK)
    assert route == "skinny" and M <= SKINNY_M
    assert (tiles, S) == (16, 9)
    assert tiles * S >= 132 and tiles * (S - 1) < 132 and S <= chunks
    bounds = [s * chunks // S for s in range(S + 1)]
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    assert gemm_splits(M, N, K, sms=8) == ("skinny", 1)
    assert gemm_splits(M, N, 100) == ("skinny", 1)     # one K chunk
    assert gemm_splits(M, 8, 4096) == ("skinny", 32)   # one tile, 32 chunks


@pytest.mark.parametrize("M", [17, 37, 256, 4096])
def test_gemm_splits_tensor_core_route(M):
    """M > 16 takes the int8 tensor-core tile, split as K2 splits a conv
    of the same (M, K, N)."""
    for K, N in ((2048, 1000), (131, 77), (64, 200)):
        route, S = gemm_splits(M, N, K)
        assert route == "mma" and S == conv_splits(M, N, K)
        tiles = math.ceil(M / TILE_M) * math.ceil(N / TILE_N)
        assert S <= max(1, math.ceil(K / CHUNK_K))
        assert tiles * S >= 132 or S == max(1, math.ceil(K / CHUNK_K))
    assert gemm_splits(256, 1000, 2048) == ("mma", 3)   # 64 tiles x 3


def test_gemm_batched_folds_into_m(rng):
    x = rng.integers(-128, 128, (4, 3, 40)).astype(np.int8)
    w = rng.integers(-128, 128, (40, 9)).astype(np.int8)
    got = gemm_int8(_t(x), _t(w), _t(np.float32(0.01))).numpy()
    for b in range(4):
        assert np.array_equal(got[b], np.asarray(
            jref.gemm_int8(x[b], w, np.float32(0.01))))


def test_requant_rounds_half_to_even():
    """acc * 0.5 lands exactly on .5 for odd accumulators: 0.5 -> 0,
    1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -1.5 -> -2 (never floor(x + 0.5))."""
    x = np.ones((1, 1), np.int8)
    w = np.array([[1, 3, 5, -1, -3, 7, 2]], np.int8)
    expect = np.array([[0, 2, 2, 0, -2, 4, 1]], np.int8)
    got = gemm_int8(_t(x), _t(w), _t(np.float32(0.5))).numpy()
    assert np.array_equal(got, expect)
    assert np.array_equal(np.asarray(gemm_int8_pallas(
        x, w, np.float32(0.5), bm=8, bn=8, bk=8, interpret=True)), expect)
    acc = torch.tensor([[1, 3, 5, -1, -3, 7, 2]], dtype=torch.int32)
    assert np.array_equal(tq.requantize(acc, np.float32(0.5)).numpy(),
                          expect)


def test_requant_saturates_and_matches_jax(rng):
    """Full-range int32 accumulators (float32 conversion rounds above
    2^24) requantize identically to the JAX package's `requantize`."""
    import jax.numpy as jnp
    from repro.core.quantize import requantize as j_requantize
    acc = rng.integers(-2**31, 2**31 - 1, (64, 33), dtype=np.int64).astype(
        np.int32)
    for m in (np.float32(1e-7), np.float32(0.37),
              (rng.random(33) * 1e-6).astype(np.float32)):
        got = ref.requant(_t(acc), _t(m)).numpy()
        want = np.asarray(j_requantize(jnp.asarray(acc), jnp.asarray(m)))
        assert np.array_equal(got, want)
        assert np.array_equal(tq.requantize(_t(acc), m).numpy(), want)


# -- K2: implicit-im2col conv --------------------------------------------------

@pytest.mark.parametrize("mult", [None, "scalar", "channel"])
@pytest.mark.parametrize("H,W,C,N,k,stride,pad", [
    (16, 16, 3, 8, 3, 1, 1),
    (17, 19, 6, 24, 3, 2, 1),
    (14, 14, 8, 16, 1, 1, 0),
    (15, 15, 16, 20, 1, 2, 0),
    (20, 18, 3, 8, 7, 2, 3),          # the ResNet stem at a small size
])
def test_conv_plain_matches_pallas(rng, H, W, C, N, k, stride, pad, mult):
    x = rng.integers(-128, 128, (H, W, C)).astype(np.int8)
    w = rng.integers(-128, 128, (k * k * C, N)).astype(np.int8)
    m = _mult(rng, mult, N)
    want = np.asarray(conv2d_int8_pallas(
        x, w, m, kh=k, kw=k, stride=stride, padding=pad, rows_t=4, bn=8,
        interpret=True))
    got = conv2d_int8(_t(x), _t(w), None if m is None else _t(m), kh=k,
                      kw=k, stride=stride, padding=pad).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(
        ref.conv2d_int8(_t(x), _t(w), stride, pad, m).numpy(),
        np.asarray(jref.conv2d_int8(x, w, stride, pad, m)))


def test_conv_batched_and_im2col(rng):
    x = rng.integers(-128, 128, (3, 11, 9, 5)).astype(np.int8)
    w = rng.integers(-128, 128, (3 * 3 * 5, 7)).astype(np.int8)
    got = conv2d_int8(_t(x), _t(w), kh=3, kw=3, stride=2, padding=1).numpy()
    for b in range(3):
        assert np.array_equal(got[b], np.asarray(jref.conv2d_int8_general(
            x[b], w, 3, 3, 2, 1)))
        assert np.array_equal(
            ref.im2col_patches(_t(x[b]), 3, 2, 2, 1).numpy(),
            np.asarray(j_im2col(x[b], 3, 2, 2, 1)))


@pytest.fixture(scope="module")
def path_convs():
    """(M at batch 1, K, N) of every conv that ResNet50-224 on
    scaled_paper_machine(64) runs as its own K2 launch, from the port's
    planner (the shapes chip_smoke.py times on the card)."""
    import repro_torch
    from repro_torch.core import cnn, init_params
    from repro_torch.core import compiled as C
    from repro_torch.core import megakernel as MK
    from repro_torch.hw import scaled_paper_machine
    g = cnn.resnet50()
    dep = repro_torch.compile(g, scaled_paper_machine(64), backend="cuda",
                              params=init_params(g, seed=0), device="cpu")
    shapes = []
    for seg in MK.plan_segments(dep.program):
        st = seg.steps[0]
        if seg.kind == "tiled" and st.mode != "gemm":
            a = st.batch.attrs
            oh, ow = C.conv_out_hw(a)
            shapes.append((oh * ow, a["kh"] * a["kw"] * a["C_in"],
                           a["C_out"]))
    return shapes


@pytest.mark.parametrize("batch", [1, 8])
def test_conv_splits_fill_the_card_on_the_path(path_convs, batch):
    """Every path conv gets tiles x splits >= 132 blocks, or one split per
    K chunk; the split is the least that does, and the kernel's balanced
    ranges [s*c//S, (s+1)*c//S) give every split at least one chunk."""
    assert len(path_convs) == 50
    for M1, K, N in path_convs:
        M = batch * M1
        S = conv_splits(M, N, K)
        tiles = math.ceil(M / TILE_M) * math.ceil(N / TILE_N)
        chunks = math.ceil(K / CHUNK_K)
        assert 1 <= S <= chunks
        assert tiles * S >= 132 or S == chunks, (M, K, N, S)
        assert S == 1 or tiles * (S - 1) < 132, (M, K, N, S)
        bounds = [s * chunks // S for s in range(S + 1)]
        assert bounds[0] == 0 and bounds[-1] == chunks
        assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    # the deepest 3x3 conv: 8 tiles split 17 ways (72 chunks, 4-5 each)
    assert conv_splits(49, 512, 4608) == 17
    assert conv_splits(12544, 64, 147) == 1      # the stem fills the card
    assert conv_splits(49, 512, 4608, sms=8) == 1


def test_split_workspace_one_buffer_per_device_and_size():
    """The split-K workspace and counters are allocated once per (device,
    kind, size rounded up to a power of two) and then reused: a fresh
    allocation per call would add a memset launch per conv."""
    cpu = torch.device("cpu")
    a = split_workspace(cpu, "partials", 1000)
    assert a.dtype == torch.int32 and a.numel() == 1024
    assert torch.count_nonzero(a) == 0
    assert split_workspace(cpu, "partials", 1024) is a
    assert split_workspace(cpu, "partials", 600) is a
    b = split_workspace(cpu, "partials", 1025)
    assert b is not a and b.numel() == 2048
    c = split_workspace(cpu, "counters", 1000)
    assert c is not a and c.numel() == 1024
    assert torch.count_nonzero(c) == 0
    assert split_workspace(cpu, "counters", 1000) is c


def test_round_half_even_div_negative_sums():
    """Floor division semantics: the remainder is brought into [0, n) so
    negative exact halves round to even too (-5/2 -> -2, -7/2 -> -4)."""
    s = np.arange(-4000, 4000, 7, dtype=np.int32)
    s = np.concatenate([s, np.array([-5, -7, -9, -1, -3, 5, 7, 9], np.int32)])
    for n in (1, 2, 4, 9, 49, 196):
        got = ref.round_half_even_div(_t(s), n).numpy()
        assert np.array_equal(got, np.asarray(jref.round_half_even_div(s, n)))
        assert np.array_equal(got, np.round(s / n).astype(np.int32))


def test_wrappers_count_calls_and_refuse_bad_operands(rng, monkeypatch):
    """On CPU tensors each call takes the plain version, and the launch
    counters, which count kernel launches only, stay at 0."""
    x = _t(rng.integers(-128, 128, (4, 8)).astype(np.int8))
    w = _t(rng.integers(-128, 128, (8, 3)).astype(np.int8))
    plain = {}
    for mod, name in (("gemm_int8", "gemm_int8_plain"),
                      ("conv2d_im2col", "conv2d_int8_plain")):
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        plain[name] = mock.Mock(wraps=getattr(m, name))
        monkeypatch.setattr(m, name, plain[name])
    reset_launch_counts()
    gemm_int8(x, w)
    gemm_int8(x, w)
    conv2d_int8(x.reshape(2, 2, 8), w.repeat(9, 1)[:72], kh=3, kw=3,
                padding=1)
    assert plain["gemm_int8_plain"].call_count == 2
    assert plain["conv2d_int8_plain"].call_count == 1
    assert launch_counts() == {"gemm_int8": 0, "conv2d_int8": 0,
                               "megakernel": 0, "flash_attention": 0,
                               "ssm_scan": 0, "tiled_int8": 0,
                               "lut_int8": 0}
    with pytest.raises(TypeError):
        gemm_int8(x.to(torch.int32), w)
    with pytest.raises(ValueError):
        gemm_int8(x, w[:5])
    with pytest.raises(ValueError):
        conv2d_int8(x.reshape(2, 2, 8), w, kh=3, kw=3)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On a GPU: K1, K2 and K3 launch and agree with their plain versions
    bit for bit: K1 on both routes (the classifier at M 1 and 8, skinny and
    split 9 ways; M 256 on the tensor cores), K2 also split over K (17
    ways, and with C % 16 != 0), K3 on a segment shaped as the path's
    (one 3x3 conv 28x28x128 -> 128, split 6 ways at batch 1);
    chip_smoke.py covers the full-size path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def i8(*shape):
        return torch.as_tensor(rng.integers(-128, 128, shape).astype(
            np.int8)).to(dev)

    for M, K, N in ((1, 2048, 1000), (8, 2048, 1000), (256, 2048, 1000),
                    (5, 131, 77), (16, 300, 1000), (37, 131, 77),
                    (130, 64, 200)):
        x, w = i8(M, K), i8(K, N)
        m = torch.as_tensor((rng.random(N) * 0.002).astype(np.float32),
                            device=dev)
        for mm in (None, m, m[:1]):
            assert torch.equal(gemm_int8(x, w, mm), gemm_int8_plain(x, w, mm))
    for B, H, W, C, N, k, s, p in ((1, 32, 32, 3, 64, 7, 2, 3),
                                   (2, 14, 14, 64, 64, 3, 1, 1),
                                   (3, 9, 17, 12, 33, 5, 1, 2),
                                   (1, 8, 8, 128, 512, 3, 1, 1),
                                   (1, 9, 9, 24, 72, 3, 1, 1)):
        x, w = i8(B, H, W, C), i8(k * k * C, N)
        kw = dict(kh=k, kw=k, stride=s, padding=p)
        assert torch.equal(conv2d_int8(x, w, **kw),
                           conv2d_int8_plain(x, w, **kw))
    import repro_torch
    from repro_torch.core import compiled as C
    from repro_torch.core import init_params
    from repro_torch.core import megakernel as MK
    from repro_torch.core.graph import Graph, conv2d, requant
    from repro_torch.hw import scaled_paper_machine
    g = Graph("path_segment")
    g.add_tensor("input", (28, 28, 128), "int8", is_input=True)
    g.mark_output(requant(g, "c.rq", conv2d(g, "c", "input", 128, 3)))
    g.validate()
    dep = repro_torch.compile(g, scaled_paper_machine(64), backend="cuda",
                              params=init_params(g, seed=0), device="cuda")
    prog = dep.program
    consts = C.device_consts(prog, dev)
    seg, = (s_ for s_ in MK.plan_segments(prog) if s_.kind == "fused")
    tab = MK.build_segment_table(prog, seg, consts, dev)
    for B in (1, 8):
        vals = [None] * len(prog.buffers)
        vals[prog.input_idx["input"]] = i8(B, 28, 28, 128)
        kv = list(vals)
        reset_launch_counts()
        MK.run_fused(prog, seg, kv, consts, tab)
        assert launch_counts()["megakernel"] == 1
        MK.run_fused_plain(prog, seg, vals, consts)
        for i in tab.outs:
            assert torch.equal(kv[i], vals[i])
