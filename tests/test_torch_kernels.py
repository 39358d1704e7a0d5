"""The port's kernel layer against the JAX package's Pallas kernels.

On the CPU every kernel wrapper takes its plain torch version; those are
held bit-exactly (`np.array_equal`: everything here is integer, and the
requant is the same float32 multiply and round-half-even) against
`gemm_int8_pallas` / `conv2d_int8_pallas` in Pallas interpret mode and
against `repro.kernels.ref`. The `cuda`-marked test holds the CUDA kernels
against the plain versions on a GPU and skips without one.
"""

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


def test_round_half_even_div_negative_sums():
    """Floor division semantics: the remainder is brought into [0, n) so
    negative exact halves round to even too (-5/2 -> -2, -7/2 -> -4)."""
    s = np.arange(-4000, 4000, 7, dtype=np.int32)
    s = np.concatenate([s, np.array([-5, -7, -9, -1, -3, 5, 7, 9], np.int32)])
    for n in (1, 2, 4, 9, 49, 196):
        got = ref.round_half_even_div(_t(s), n).numpy()
        assert np.array_equal(got, np.asarray(jref.round_half_even_div(s, n)))
        assert np.array_equal(got, np.round(s / n).astype(np.int32))


def test_wrappers_count_calls_and_refuse_bad_operands(rng):
    x = _t(rng.integers(-128, 128, (4, 8)).astype(np.int8))
    w = _t(rng.integers(-128, 128, (8, 3)).astype(np.int8))
    reset_launch_counts()
    gemm_int8(x, w)
    gemm_int8(x, w)
    conv2d_int8(x.reshape(2, 2, 8), w.repeat(9, 1)[:72], kh=3, kw=3,
                padding=1)
    assert launch_counts() == {"gemm_int8": 2, "conv2d_int8": 1,
                               "megakernel": 0}
    with pytest.raises(TypeError):
        gemm_int8(x.to(torch.int32), w)
    with pytest.raises(ValueError):
        gemm_int8(x, w[:5])
    with pytest.raises(ValueError):
        conv2d_int8(x.reshape(2, 2, 8), w, kh=3, kw=3)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On a GPU: K1 and K2 launch and agree with their plain versions bit
    for bit (chip_smoke.py covers K3 and the full-size shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def i8(*shape):
        return torch.as_tensor(rng.integers(-128, 128, shape).astype(
            np.int8)).to(dev)

    for M, K, N in ((1, 2048, 1000), (37, 131, 77), (130, 64, 200)):
        x, w = i8(M, K), i8(K, N)
        m = torch.as_tensor((rng.random(N) * 0.002).astype(np.float32),
                            device=dev)
        for mm in (None, m, m[:1]):
            assert torch.equal(gemm_int8(x, w, mm), gemm_int8_plain(x, w, mm))
    for B, H, W, C, N, k, s, p in ((1, 32, 32, 3, 64, 7, 2, 3),
                                   (2, 14, 14, 64, 64, 3, 1, 1),
                                   (3, 9, 17, 12, 33, 5, 1, 2)):
        x, w = i8(B, H, W, C), i8(k * k * C, N)
        kw = dict(kh=k, kw=k, stride=s, padding=p)
        assert torch.equal(conv2d_int8(x, w, **kw),
                           conv2d_int8_plain(x, w, **kw))
