"""The kernel wrappers under autograd and on several cards.

  * K4 under autograd (`FlashAttentionFn`) on CPU tensors: the forward
    goes through the kernel's forward once per call (spied with
    `unittest.mock.Mock(wraps=...)`) and gives the plain version's value;
    the gradients equal, exactly, autograd of the plain attention that the
    backward recomputes (`attention_reference`), for every input that
    requires grad and for GQA, windowed and long (blockwise) inputs.
  * K5 under autograd (`SsmScanFn`), likewise: the kernel's forward once
    per call, the gradients of a, x and h0 equal autograd of
    `ssm_scan_plain`; the model's short-prefill path trains through it.
  * The wrappers whose kernels have no backward (K1, K2, K3) raise
    `RuntimeError` when called in grad mode with an input that requires
    grad, on every device; under `no_grad` they run. K6 takes only int8
    tensors, which cannot require grad.
  * On two or more GPUs (`cuda` marker; skipped here): K1-K5 launch on
    their tensors' card with another card current, equal to their plain
    versions, and leave the current card as it was.
"""

import importlib
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_im2col import conv2d_int8, conv2d_int8_plain
from repro_torch.kernels.gemm_int8 import gemm_int8, gemm_int8_plain
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
from repro_torch.models.attention import attend

# the modules (the package exports their wrappers under the same names)
K4 = importlib.import_module("repro_torch.kernels.flash_attention")
K5 = importlib.import_module("repro_torch.kernels.ssm_scan")


def _qkv(B, Hq, Hkv, Sq, Skv, D, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*s):
        return torch.as_tensor(rng.standard_normal(s).astype(np.float32)
                               ).to(dtype)
    return t(B, Hq, Sq, D), t(B, Hkv, Skv, D), t(B, Hkv, Skv, D)


CASES = [((2, 6, 2, 16, 16, 8), True, None, 4096),
         ((1, 4, 4, 12, 12, 16), False, None, 4096),
         ((2, 4, 1, 10, 10, 8), True, 3, 4096),
         ((1, 2, 2, 5, 9, 8), True, None, 4096),
         ((1, 4, 2, 40, 40, 8), True, None, 16)]       # blockwise backward


@pytest.mark.parametrize("shape,causal,window,thr", CASES)
def test_k4_autograd_function_on_cpu(shape, causal, window, thr):
    q, k, v = _qkv(*shape)
    dout = _qkv(*shape, seed=1)[0]
    spy = mock.Mock(wraps=K4._kernel_forward)
    with mock.patch.object(K4, "_kernel_forward", spy), \
            mock.patch.object(K4, "BLOCKWISE_THRESHOLD", thr):
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = K4.FlashAttentionFn.apply(qs, ks, vs, causal, window, None)
        assert spy.call_count == 1
        out.backward(dout)
    assert torch.equal(out.detach(),
                       K4.flash_attention_plain(q, k, v, causal, window))
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    K4.attention_reference(qr, kr, vr, causal=causal, window=window,
                           blockwise_threshold=thr).backward(dout)
    for got, want in ((qs, qr), (ks, kr), (vs, vr)):
        assert torch.equal(got.grad, want.grad)


def test_k4_wrapper_routes_grad_through_the_function():
    """The wrapper takes the Function only when an input requires grad in
    grad mode; only k requiring grad gives only k a gradient."""
    q, k, v = _qkv(1, 2, 1, 6, 6, 8)
    with mock.patch.object(K4.FlashAttentionFn, "apply",
                           wraps=K4.FlashAttentionFn.apply) as fn:
        K4.flash_attention(q, k, v)
        with torch.no_grad():
            K4.flash_attention(q, k.requires_grad_(True), v)
        assert fn.call_count == 0
        out = K4.flash_attention(q, k, v)
        assert fn.call_count == 1
    (g,) = torch.autograd.grad(out.sum(), k)
    kr = k.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(ref.flash_attention(q, kr, v).sum(), kr)
    assert torch.equal(g, want)


def test_attend_trains_through_the_reference_on_cpu():
    """`attend` on CPU tensors under autograd is the plain reference, as
    in the JAX package's ref backend: no kernel forward runs."""
    q, k, v = (t.requires_grad_(True) for t in _qkv(1, 4, 2, 8, 8, 8))
    with mock.patch.object(K4, "_kernel_forward",
                           wraps=K4._kernel_forward) as spy:
        attend(q, k, v).sum().backward()
        assert spy.call_count == 0
    assert q.grad is not None and k.grad is not None


K5_CASES = [((2, 5, 3), False, (True, True, False)),
            ((1, 9, 4), True, (True, True, True)),
            ((2, 7, 6), True, (False, True, False)),
            ((3, 4, 2), True, (False, False, True))]


def _ax(shape, h0, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, shape).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    h = (torch.as_tensor(rng.standard_normal((shape[0], shape[2])).astype(
        np.float32)) if h0 else None)
    return a, x, h


@pytest.mark.parametrize("shape,h0,need", K5_CASES)
def test_k5_autograd_function_on_cpu(shape, h0, need):
    """`ssm_scan` under autograd goes through `SsmScanFn`: the kernel's
    forward once, its value the plain version's, and the gradients of
    every input that requires grad equal autograd of `ssm_scan_plain`
    exactly (no gradient for the others)."""
    ins = _ax(shape, h0)
    dy = _ax(shape, False, seed=1)[1]
    spy = mock.Mock(wraps=K5._kernel_forward)
    with mock.patch.object(K5, "_kernel_forward", spy):
        got = [None if t is None else t.clone().requires_grad_(n)
               for t, n in zip(ins, need)]
        y = ssm_scan(*got)
        assert spy.call_count == 1
        y.backward(dy)
    assert torch.equal(y.detach(), ssm_scan_plain(*ins))
    want = [None if t is None else t.clone().requires_grad_(n)
            for t, n in zip(ins, need)]
    ssm_scan_plain(*want).backward(dy)
    for g, w, n in zip(got, want, need):
        if g is None:
            continue
        if n:
            assert torch.equal(g.grad, w.grad)
        else:
            assert g.grad is None


def test_ssm_short_prefill_trains_through_k5():
    """The SSM block's short-prefill path (S <= 8) under autograd calls
    the K5 wrapper, once per block, and its gradients equal those of the
    same block with the scan replaced by `ssm_scan_plain`."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="t", family="hybrid", num_layers=1, d_model=32,
                      num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
                      ssm_state=4)
    p = SSM.ssm_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 6, 32, generator=torch.Generator().manual_seed(1))

    def grads(scan):
        ps = {k: t.clone().requires_grad_(True) for k, t in p.items()}
        xs = x.clone().requires_grad_(True)
        with mock.patch.object(SSM.kops, "ssm_scan", scan):
            y, _ = SSM.ssm_apply(ps, xs, cfg)
        y.square().sum().backward()
        return [xs.grad] + [ps[k].grad for k in sorted(ps)]

    spy = mock.Mock(wraps=ssm_scan)
    got = grads(spy)
    assert spy.call_count == 1
    want = grads(ssm_scan_plain)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrappers_without_backward_refuse_grad():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(-128, 128, (4, 16)).astype(np.int8))
    w = torch.as_tensor(rng.integers(-128, 128, (16, 8)).astype(np.int8))
    mult = torch.full((8,), 0.01, requires_grad=True)
    with pytest.raises(RuntimeError, match="gemm_int8: the kernel has no"):
        gemm_int8(x, w, mult)
    xc = torch.as_tensor(rng.integers(-128, 128, (6, 6, 4)).astype(np.int8))
    wc = torch.as_tensor(rng.integers(-128, 128, (36, 8)).astype(np.int8))
    with pytest.raises(RuntimeError, match="conv2d_int8: the kernel has no"):
        conv2d_int8(xc, wc, mult, kh=3, kw=3)
    from types import SimpleNamespace

    from repro_torch.core import megakernel as MK
    with pytest.raises(RuntimeError, match="megakernel: the kernel has no"):
        MK.run_fused(None, None, [torch.zeros(2, requires_grad=True)], None,
                     SimpleNamespace(ins=[0]))
    # under no_grad, or with nothing requiring grad, they run
    with torch.no_grad():
        assert torch.equal(gemm_int8(x, w, mult),
                           gemm_int8_plain(x, w, mult.detach()))
        assert torch.equal(conv2d_int8(xc, wc, mult, kh=3, kw=3),
                           conv2d_int8_plain(xc, wc, mult.detach(), kh=3,
                                             kw=3))


@pytest.mark.cuda
def test_k4_autograd_function_on_the_card():
    """On a GPU: under autograd K4 launches once per forward, its output is
    the no-grad launch's bit for bit, and the gradients are the plain
    attention's autograd on the card (f32: within rtol 1e-4, atol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    for shape, causal, window, thr in CASES + [((2, 9, 3, 128, 128, 64),
                                                True, None, 4096)]:
        q, k, v = (t.cuda() for t in _qkv(*shape))
        dout = _qkv(*shape, seed=1)[0].cuda()
        nograd = K4.flash_attention(q, k, v, causal=causal, window=window)
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        _lib.reset_launch_counts()
        with mock.patch.object(K4, "BLOCKWISE_THRESHOLD", thr):
            out = K4.flash_attention(qs, ks, vs, causal=causal,
                                     window=window)
            out.backward(dout)
        torch.cuda.synchronize()
        assert _lib.launch_counts()["flash_attention"] == 1
        assert torch.equal(out.detach(), nograd)
        qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
        K4.attention_reference(qr, kr, vr, causal=causal, window=window,
                               blockwise_threshold=thr).backward(dout)
        for got, want in ((qs, qr), (ks, kr), (vs, vr)):
            torch.testing.assert_close(got.grad, want.grad, rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.cuda
def test_k5_autograd_function_on_the_card():
    """On a GPU: under autograd K5 launches once per forward, its output is
    the no-grad launch's bit for bit, and the gradients are the plain
    scan's autograd on the card (within rtol 1e-5, atol 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    for shape, h0, need in K5_CASES + [((2, 8, 4096), True,
                                        (True, True, True))]:
        ins = [None if t is None else t.cuda() for t in _ax(shape, h0)]
        dy = _ax(shape, False, seed=1)[1].cuda()
        nograd = ssm_scan(*ins)
        got = [None if t is None else t.clone().requires_grad_(n)
               for t, n in zip(ins, need)]
        _lib.reset_launch_counts()
        y = ssm_scan(*got)
        y.backward(dy)
        torch.cuda.synchronize()
        assert _lib.launch_counts()["ssm_scan"] == 1
        assert torch.equal(y.detach(), nograd)
        want = [None if t is None else t.clone().requires_grad_(n)
                for t, n in zip(ins, need)]
        ssm_scan_plain(*want).backward(dy)
        for g, w, n in zip(got, want, need):
            if g is not None and n:
                torch.testing.assert_close(g.grad, w.grad, rtol=1e-5,
                                           atol=1e-6)


@pytest.mark.cuda
def test_k1_to_k5_launch_on_each_card_after_another():
    """On two or more GPUs: each of K1-K5 runs on card 0, then on every
    other card with card 0 current and with that card current, equal to
    its plain version on the CPU (K4 within 1e-5 in f32), the result on
    the input's card and the current card unchanged."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs (the kernels have no interpret "
                    "mode)")
    import repro_torch
    from repro_torch.core import compiled as C
    from repro_torch.core import init_params
    from repro_torch.core import megakernel as MK
    from repro_torch.core.graph import Graph, conv2d, requant
    from repro_torch.hw import scaled_paper_machine
    rng = np.random.default_rng(0)

    def i8(*shape):
        return torch.as_tensor(rng.integers(-128, 128, shape).astype(
            np.int8))

    x, w = i8(37, 300), i8(300, 77)
    xc, wc = i8(2, 14, 14, 64), i8(9 * 64, 64)
    q, k, v = _qkv(2, 8, 2, 100, 100, 64)
    a, xs = torch.rand(2, 9, 33), torch.rand(2, 9, 33)
    g = Graph("segment")
    g.add_tensor("input", (28, 28, 128), "int8", is_input=True)
    g.mark_output(requant(g, "c.rq", conv2d(g, "c", "input", 128, 3)))
    g.validate()
    prog = repro_torch.compile(g, scaled_paper_machine(64), backend="torch",
                               params=init_params(g, seed=0),
                               device="cpu").program
    seg, = (s_ for s_ in MK.plan_segments(prog) if s_.kind == "fused")
    frame = i8(1, 28, 28, 128)
    vals = [None] * len(prog.buffers)
    vals[prog.input_idx["input"]] = frame
    MK.run_fused_plain(prog, seg, vals, C.device_consts(prog,
                                                        torch.device("cpu")))
    want = {"gemm_int8": gemm_int8_plain(x, w),
            "conv2d_int8": conv2d_int8_plain(xc, wc, kh=3, kw=3, padding=1),
            "flash_attention": K4.flash_attention_plain(q, k, v),
            "ssm_scan": ssm_scan_plain(a, xs)}

    def run_all(dev):
        dev = torch.device(dev)
        got = {"gemm_int8": gemm_int8(x.to(dev), w.to(dev)),
               "conv2d_int8": conv2d_int8(xc.to(dev), wc.to(dev), kh=3,
                                          kw=3, padding=1),
               "flash_attention": K4.flash_attention(q.to(dev), k.to(dev),
                                                     v.to(dev)),
               "ssm_scan": ssm_scan(a.to(dev), xs.to(dev))}
        consts = C.device_consts(prog, dev)
        tab = MK.build_segment_table(prog, seg, consts, dev)
        kv = [None] * len(prog.buffers)
        kv[prog.input_idx["input"]] = frame.to(dev)
        MK.run_fused(prog, seg, kv, consts, tab)
        got["megakernel"] = [kv[i] for i in tab.outs]
        torch.cuda.synchronize(dev)
        return got, tab

    torch.cuda.set_device(0)
    runs = [(0, 0)] + [(d, c) for d in range(1, torch.cuda.device_count())
                       for c in (0, d)]
    for dev, current in runs:
        torch.cuda.set_device(current)
        _lib.reset_launch_counts()
        got, tab = run_all(f"cuda:{dev}")
        assert torch.cuda.current_device() == current
        assert all(n == 1 for name, n in _lib.launch_counts().items()
                   if name != "tiled_int8"), _lib.launch_counts()
        for name in ("gemm_int8", "conv2d_int8", "ssm_scan"):
            assert got[name].device.index == dev
            assert torch.equal(got[name].cpu(), want[name]), (name, dev)
        torch.testing.assert_close(got["flash_attention"].cpu(),
                                   want["flash_attention"], rtol=1e-5,
                                   atol=1e-5)
        for i, o in zip(tab.outs, got["megakernel"]):
            assert o.device.index == dev
            assert torch.equal(o.cpu(), vals[i]), ("megakernel", dev)
    torch.cuda.set_device(0)
