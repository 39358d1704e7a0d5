#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printing its own lines; any failure exits non-zero:

  1. environment: torch/CUDA versions, nvcc, the card's name and power limit;
  2. build: the CUDA kernels from src/repro_torch/csrc (one nvcc each, in
     parallel, for sm_90a);
  3. kernels: K1 (int8 GEMM), K2 (implicit-im2col int8 conv) and K3 (the
     fused-segment megakernel) against their plain torch versions on the
     card, bit for bit (torch.equal), with times (median of 20 runs after
     warm-up, CUDA events) beside the plain version's and, where one
     PyTorch call computes the same function, that call's;
  4. main path: int8 ResNet50-224 compiled for scaled_paper_machine(64) and
     run through `Deployment.run` on the megakernel path, the per-op kernel
     path and the plain "torch" backend at batch 1 and 8, each output bit
     for bit against the numpy `reference_forward`, with latency and
     launches per program (wrapper counters, confirmed by torch.profiler);
  5. serving: a `Server` on the "cuda" backend answers 8 requests.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Weights and inputs are random, from seeds.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published dense peaks (NVIDIA data sheet): int8 tensor cores and
# HBM3 bandwidth. The bound of a kernel is the larger of its bytes over the
# memory rate and its int8 MACs (2 ops each) over the int8 rate.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

RUNS, WARM = 20, 3
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


class Bound:
    """Sums of the two halves of the bound over a kernel's shapes."""

    def __init__(self):
        self.bytes_ms = self.ops_ms = self.ms = 0.0

    def add(self, nbytes: float, ops: float) -> float:
        b, o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8_OPS * 1e3
        self.bytes_ms += b
        self.ops_ms += o
        self.ms += max(b, o)
        return max(b, o)

    @property
    def by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


def time_ms(torch, fn) -> float:
    """Median device time of `fn` over RUNS launches after WARM warm-ups."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(torch, fn) -> float:
    """Median host wall time of `fn` + synchronize over RUNS runs."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def expect_equal(torch, name: str, got, want) -> int:
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: kernel gave {got.dtype} {tuple(got.shape)}, plain "
             f"{want.dtype} {tuple(want.shape)}")
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item() \
        if got.numel() else 0
    if not torch.equal(got, want):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err})")
    return int(err)


def mixed_graph():
    """A small graph whose one fused segment holds every K3 step kind:
    gemm, conv, standalone requant (the accumulators are also outputs),
    relu, int8 and int32 add, max and avg pool, gap and concat."""
    from repro_torch.core.cnn import concat
    from repro_torch.core.graph import (Graph, conv2d, eltwise,
                                        global_avg_pool, linear, pool2d,
                                        requant)
    g = Graph("mixed")
    g.add_tensor("input", (20, 20, 8), "int8", is_input=True)
    y = conv2d(g, "c1", "input", 16, 3)
    g.mark_output(y)
    yq = requant(g, "c1.rq", y)
    p = pool2d(g, "ap", "avgpool", yq, 3, 1, padding=1)
    z = conv2d(g, "c2", p, 16, 3, stride=2)
    zq = requant(g, "c2.rq", z)
    a = pool2d(g, "mp", "maxpool", yq, 2, 2)
    s = eltwise(g, "add", "add", [zq, a])
    g.mark_output(eltwise(g, "add32", "add", [z, z]))
    r = eltwise(g, "relu", "relu", [s])
    c = concat(g, "cat", [r, a])
    g.mark_output(linear(g, "fc", global_avg_pool(g, "gap", c), 10))
    g.validate()
    return g


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the repository")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")

    from repro_torch.compiler import BackendOptions
    from repro_torch.core import cnn, init_params, reference_forward
    from repro_torch.core import compiled as C
    from repro_torch.core import megakernel as MK
    from repro_torch.hw import scaled_paper_machine
    from repro_torch.kernels import _lib
    from repro_torch.kernels.conv2d_im2col import (conv2d_int8,
                                                   conv2d_int8_plain)
    from repro_torch.kernels.gemm_int8 import gemm_int8, gemm_int8_plain
    import repro_torch

    dev = torch.device("cuda")
    report: dict = {"checks": [], "paths": [], "serve": []}

    # -- 1. environment ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_lib._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {nvcc.splitlines()[-1]}")
    say(f"[env] {smi}; {torch.cuda.device_count()} device(s)")
    report["card"] = smi

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    out_dir = _lib.build_all(verbose=True)
    say(f"[build] {', '.join(_lib.SOURCES)} -> {out_dir.relative_to(ROOT)} "
        f"in {time.perf_counter() - t0:.1f} s")
    for src in _lib.SOURCES:
        _lib.load(src)

    rng = np.random.default_rng(SEED)

    def i8(*shape):
        return torch.as_tensor(rng.integers(-128, 128, size=shape)
                               .astype(np.int8)).to(dev)

    def mults(n):
        return torch.as_tensor((0.002 + 0.001 * rng.random(n))
                               .astype(np.float32)).to(dev)

    kernels = {k: {"max_abs_err": 0} for k in _lib.KERNELS}

    # -- 3a. K1 --------------------------------------------------------------
    for (M, K, N, mode) in [(1, 2048, 1000, "int32"), (1, 2048, 1000, "rq"),
                            (8, 2048, 1000, "int32"), (8, 2048, 1000, "rq"),
                            (37, 131, 77, "int32"), (37, 131, 77, "rq1"),
                            (1, 3, 5, "rq"), (130, 64, 200, "rq")]:
        x, w = i8(M, K), i8(K, N)
        m = (None if mode == "int32" else
             mults(1) if mode == "rq1" else mults(N))
        err = expect_equal(torch, f"K1 {M}x{K}x{N} {mode}",
                           gemm_int8(x, w, m), gemm_int8_plain(x, w, m))
        kernels["gemm_int8"]["max_abs_err"] = max(
            kernels["gemm_int8"]["max_abs_err"], err)
        ms = time_ms(torch, lambda: gemm_int8(x, w, m))
        pms = time_ms(torch, lambda: gemm_int8_plain(x, w, m))
        lib_ms = None
        if mode == "int32":
            # torch._int_mm wants M > 16 and K, N multiples of 8: pad M
            Mp, Kp, Np = max(32, -(-M // 8) * 8), -(-K // 8) * 8, -(-N // 8) * 8
            xp = torch.zeros(Mp, Kp, dtype=torch.int8, device=dev)
            wp = torch.zeros(Kp, Np, dtype=torch.int8, device=dev)
            xp[:M, :K], wp[:K, :N] = x, w
            if not torch.equal(torch._int_mm(xp, wp)[:M, :N],
                               gemm_int8_plain(x, w)):
                fail("torch._int_mm disagrees with the plain GEMM")
            lib_ms = time_ms(torch, lambda: torch._int_mm(xp, wp))
        b = Bound().add(M * K + K * N
                        + M * N * (4 if mode == "int32" else 1),
                        2 * M * N * K)
        say(f"[K1] {M}x{K}x{N} {mode}: equal; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, library {lib_ms} ms, bound {b:.5f} ms")
        report["checks"].append({"kernel": "gemm_int8", "shape": [M, K, N],
                                 "mode": mode, "ms": ms, "plain_ms": pms,
                                 "library_ms": lib_ms, "bound_ms": b})

    # -- 3b. K2 --------------------------------------------------------------
    torch.backends.cudnn.allow_tf32 = False

    def conv_case(tag, B, H, W, Cin, N, k, s, p, rq=True, timed=True):
        x, w = i8(B, H, W, Cin), i8(k * k * Cin, N)
        m = mults(N) if rq else None
        kw = dict(kh=k, kw=k, stride=s, padding=p)
        err = expect_equal(torch, f"K2 {tag}", conv2d_int8(x, w, m, **kw),
                           conv2d_int8_plain(x, w, m, **kw))
        kernels["conv2d_int8"]["max_abs_err"] = max(
            kernels["conv2d_int8"]["max_abs_err"], err)
        if not timed:
            return None
        ms = time_ms(torch, lambda: conv2d_int8(x, w, m, **kw))
        pms = time_ms(torch, lambda: conv2d_int8_plain(x, w, m, **kw))
        # the library yardstick: cuDNN's float32 convolution (TF32 off) on
        # float copies of the same inputs, NCHW in channels-last memory
        xf = x.permute(0, 3, 1, 2).float().contiguous(
            memory_format=torch.channels_last)
        wf = w.reshape(k, k, Cin, N).permute(3, 2, 0, 1).float().contiguous(
            memory_format=torch.channels_last)
        lib_ms = time_ms(torch, lambda: torch.nn.functional.conv2d(
            xf, wf, stride=s, padding=p))
        oh = (H + 2 * p - k) // s + 1
        ow = (W + 2 * p - k) // s + 1
        macs = B * oh * ow * N * k * k * Cin
        b = Bound().add(x.numel() + w.numel() + B * oh * ow * N
                        * (1 if rq else 4), 2 * macs)
        say(f"[K2] {tag} B={B} {H}x{W}x{Cin}->{N} k{k} s{s} p{p}: equal; "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, cuDNN f32 "
            f"{lib_ms:.4f} ms, bound {b:.5f} ms")
        report["checks"].append({"kernel": "conv2d_int8", "tag": tag,
                                 "shape": [B, H, W, Cin, N, k, s, p],
                                 "ms": ms, "plain_ms": pms,
                                 "library_ms": lib_ms, "bound_ms": b})
        return ms

    for B in (1, 8):
        conv_case("stem", B, 224, 224, 3, 64, 7, 2, 3)
        conv_case("3x3", B, 56, 56, 64, 64, 3, 1, 1)
        conv_case("1x1s2", B, 56, 56, 256, 512, 1, 2, 0)
    conv_case("ragged", 2, 13, 11, 5, 70, 3, 2, 1, rq=False, timed=False)
    conv_case("ragged-rq", 3, 9, 17, 12, 33, 5, 1, 2, timed=False)

    # -- 3c. K3 on every fused segment ---------------------------------------
    def fused_checks(tag, g, hw, B):
        """K3 on every fused segment of `g`'s plan, each against its plain
        version on the same inputs, timed; returns the per-program sums."""
        params = init_params(g, seed=SEED)
        dep = repro_torch.compile(g, hw, backend="cuda", params=params,
                                  device="cuda")
        prog = dep.program
        consts = C.device_consts(prog, dev)
        segments = MK.plan_segments(prog)
        shape = g.tensors[g.inputs[0]].shape
        x = torch.as_tensor(rng.integers(-64, 64, size=(B,) + shape)
                            .astype(np.int8)).to(dev)
        vals: list = [None] * len(prog.buffers)
        vals[prog.input_idx[g.inputs[0]]] = x
        total = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound(), "n": 0}
        for si, seg in enumerate(segments):
            if seg.kind == "fused":
                tab = MK.build_segment_table(prog, seg, consts, dev)
                kv = list(vals)
                MK.run_fused(prog, seg, kv, consts, tab)
                MK.run_fused_plain(prog, seg, vals, consts)
                for i in tab.outs:
                    err = expect_equal(
                        torch, f"K3 {tag} segment {si} "
                        f"{prog.buffers[i][0]}", kv[i], vals[i])
                    kernels["megakernel"]["max_abs_err"] = max(
                        kernels["megakernel"]["max_abs_err"], err)
                sv = list(vals)
                ms = time_ms(torch, lambda: MK.run_fused(
                    prog, seg, list(sv), consts, tab))
                pms = time_ms(torch, lambda: MK.run_fused_plain(
                    prog, seg, list(sv), consts))
                ins, wids, outs = MK.segment_io(prog, seg)
                nbytes = B * sum(MK._buffer_bytes(prog, i)
                                 for i in ins + outs) + sum(
                    MK._buffer_bytes(prog, i) for i in wids)
                macs = 0
                for st in seg.steps:
                    a = st.batch.attrs
                    if st.mode == "gemm":
                        macs += B * a["M"] * a["K"] * a["N"]
                    elif st.mode == "conv2d":
                        oh, ow = C.conv_out_hw(a)
                        macs += (B * oh * ow * a["C_out"] * a["kh"]
                                 * a["kw"] * a["C_in"])
                b = total["bound"].add(nbytes, 2 * macs)
                names = [s.batch.name for s in seg.steps]
                shown = ", ".join(names[:4]) + (", ..." if len(names) > 4
                                                else "")
                say(f"[K3] {tag} segment {si} ({len(names)} steps: "
                    f"{shown}): "
                    f"equal; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                    f"bound {b:.5f} ms")
                report["checks"].append({
                    "kernel": "megakernel", "tag": f"{tag}/{si}",
                    "steps": names,
                    "ms": ms, "plain_ms": pms, "library_ms": None,
                    "bound_ms": b})
                total["ms"] += ms
                total["plain_ms"] += pms
                total["n"] += 1
            elif seg.kind == "tiled":
                C.run_kernel_step(prog, seg.steps[0], vals, consts)
            else:
                b_ = seg.steps[0].batch
                vals[b_.out_idx] = C._torch_op(b_, vals, prog, consts)
        n_steps = sum(len(s.steps) for s in segments if s.kind == "fused")
        say(f"[K3] {tag}: {total['n']} fused segments ({n_steps} steps) "
            f"bit-exact at batch {B}")
        return total

    hw4 = scaled_paper_machine(4)
    for tag, g in [("mixed", mixed_graph()),
                   ("small_cnn", cnn.small_cnn()),
                   ("resnet50-test", cnn.resnet50(
                       h=32, w=32, width=0.25, blocks=(1, 1, 1, 1),
                       num_classes=16)),
                   ("yolov5s-test", cnn.yolov5s_backbone(h=64, w=64,
                                                         width=0.25))]:
        fused_checks(tag, g, hw4, 4)

    # -- 4. main path: ResNet50-224 on scaled_paper_machine(64) --------------
    hw = scaled_paper_machine(64)
    g = cnn.resnet50()
    params = init_params(g, seed=SEED)
    t0 = time.perf_counter()
    dep = repro_torch.compile(g, hw, backend="cuda", params=params,
                              device="cuda")
    say(f"[path] compiled {g.name} for {hw.name} in "
        f"{time.perf_counter() - t0:.2f} s: "
        f"{dep.program.num_instructions} instructions, WCET bound "
        f"{dep.wcet_bound_s * 1e3:.3f} ms, "
        f"{len(dep.artifacts['verify'].errors)} sanitizer errors")
    segments = MK.plan_segments(dep.program)
    kinds = {k: sum(s.kind == k for s in segments)
             for k in ("tiled", "fused", "outside")}
    n_launch_plan = kinds["tiled"] + kinds["fused"]
    say(f"[path] megakernel plan: {kinds}, {n_launch_plan} launches "
        f"(cap {dep.program.num_cores})")

    # the three full-width fused segments, against their plain versions
    k3 = fused_checks("resnet50-224", g, hw, 1)
    kernels["megakernel"].update(ms=k3["ms"], plain_ms=k3["plain_ms"],
                                 bound_ms=k3["bound"].ms,
                                 bound_by=k3["bound"].by, library_ms=None)

    # K1/K2 at every tiled shape of the path (batch 1): per-program sums
    prog = dep.program
    consts = C.device_consts(prog, dev)
    sums = {"gemm_int8": [0.0, 0.0, 0.0], "conv2d_int8": [0.0, 0.0, 0.0]}
    bounds = {"gemm_int8": Bound(), "conv2d_int8": Bound()}
    for seg in segments:
        if seg.kind != "tiled":
            continue
        st = seg.steps[0]
        a = st.batch.attrs
        w = consts.weights[st.batch.w_idx]
        m = None if st.mult is None else consts.mults[st.out_idx]
        if st.mode == "gemm":
            x = i8(1, a["M"], a["K"])
            ms = time_ms(torch, lambda: gemm_int8(x, w, m))
            pms = time_ms(torch, lambda: gemm_int8_plain(x, w, m))
            xp = torch.zeros(32, a["K"], dtype=torch.int8, device=dev)
            Np = -(-a["N"] // 8) * 8
            wp = torch.zeros(a["K"], Np, dtype=torch.int8, device=dev)
            xp[:a["M"]], wp[:, :a["N"]] = x[0], w
            lib = time_ms(torch, lambda: torch._int_mm(xp, wp))
            key = "gemm_int8"
            b = bounds[key].add(x.numel() + w.numel() + a["M"] * a["N"]
                                * (1 if m is not None else 4),
                                2 * a["M"] * a["K"] * a["N"])
        else:
            oh, ow = C.conv_out_hw(a)
            x = i8(1, a["H"], a["W"], a["C_in"])
            kw = dict(kh=a["kh"], kw=a["kw"], stride=a["stride"],
                      padding=a["padding"])
            ms = time_ms(torch, lambda: conv2d_int8(x, w, m, **kw))
            pms = time_ms(torch, lambda: conv2d_int8_plain(x, w, m, **kw))
            xf = x.permute(0, 3, 1, 2).float().contiguous(
                memory_format=torch.channels_last)
            wf = w.reshape(a["kh"], a["kw"], a["C_in"], a["C_out"]).permute(
                3, 2, 0, 1).float().contiguous(
                memory_format=torch.channels_last)
            lib = time_ms(torch, lambda: torch.nn.functional.conv2d(
                xf, wf, stride=a["stride"], padding=a["padding"]))
            key = "conv2d_int8"
            b = bounds[key].add(x.numel() + w.numel() + oh * ow * a["C_out"]
                                * (1 if m is not None else 4),
                                2 * oh * ow * a["C_out"] * a["kh"] * a["kw"]
                                * a["C_in"])
        for j, v in enumerate((ms, pms, lib)):
            sums[key][j] += v
        report["checks"].append({"kernel": key, "tag": st.batch.name,
                                 "ms": ms, "plain_ms": pms,
                                 "library_ms": lib, "bound_ms": b})
    for key, (ms, pms, lib) in sums.items():
        bd = bounds[key]
        kernels[key].update(ms=ms, plain_ms=pms, library_ms=lib,
                            bound_ms=bd.ms, bound_by=bd.by)
        say(f"[path] {key} over the path's tiled shapes (batch 1, summed): "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, library {lib:.4f} ms, "
            f"bound {bd.ms:.5f} ms ({bd.by})")

    inputs = {B: rng.integers(-64, 64, size=(B, 224, 224, 3)).astype(np.int8)
              for B in (1, 8)}
    refs = {B: [reference_forward(g, params, {"input": inputs[B][b]})
                for b in range(B)] for B in (1, 8)}
    out_name = g.outputs[0]
    paths = {"megakernel": ("cuda", BackendOptions(),
                            lambda: MK.megakernel_batched(prog, dev)),
             "per-op": ("cuda", BackendOptions(megakernel=False),
                        lambda: C.kernel_batched(prog, dev)),
             "torch": ("torch", BackendOptions(),
                       lambda: C.torch_batched(prog, dev))}
    path_counts = None
    cells = []
    for label, (backend, opts, make) in paths.items():
        d = dep.with_backend(backend, options=opts)
        for B in (1, 8):
            out = d.run({"input": inputs[B]}, batched=True)
            for b in range(B):
                if not np.array_equal(out[out_name][b],
                                      refs[B][b][out_name]):
                    fail(f"{label} batch {B}: sample {b} differs from "
                         "reference_forward")
            fn = make()
            xin = C.to_device(prog, {"input": inputs[B]}, dev)
            _lib.reset_launch_counts()
            fn(xin)
            torch.cuda.synchronize()
            counts = _lib.launch_counts()
            n = sum(counts.values())
            say(f"[path] {label} batch {B}: bit-exact vs reference_forward; "
                f"{n} launches per program {counts}")
            if label == "megakernel":
                if n != n_launch_plan or n > prog.num_cores:
                    fail(f"megakernel path launched {n} kernels, plan "
                         f"says {n_launch_plan}, cap {prog.num_cores}")
                if B == 1:
                    path_counts = counts
            cells.append((label, B, fn, xin, d.runner(batched=True),
                          counts))

    # latency: the cells in turns, five rounds, so clock and neighbour
    # drift lands on every cell alike; each round is a median of RUNS
    rounds = {(c[0], c[1]): ([], []) for c in cells}
    for _ in range(5):
        for label, B, fn, xin, run, _c in cells:
            dev_ms, io_ms = rounds[(label, B)]
            dev_ms.append(host_ms(torch, lambda: fn(xin)))
            io_ms.append(host_ms(torch, lambda: run({"input": inputs[B]})))
    for label, B, fn, xin, run, counts in cells:
        dev_ms, io_ms = rounds[(label, B)]
        say(f"[path] {label} batch {B}: device-resident "
            f"{statistics.median(dev_ms):.3f} ms (rounds "
            f"{', '.join(f'{v:.3f}' for v in dev_ms)}), numpy in/out "
            f"{statistics.median(io_ms):.3f} ms")
        report["paths"].append({"path": label, "batch": B,
                                "ms": statistics.median(dev_ms),
                                "rounds_ms": dev_ms,
                                "numpy_io_ms": statistics.median(io_ms),
                                "launches": counts})

    # the profiler sees the same launches as the counters, and says where
    # the device time of one batch-1 megakernel program goes (a first
    # profiled run absorbs the profiler's start-up and is discarded)
    from torch.profiler import ProfilerActivity, profile
    fn = MK.megakernel_batched(prog, dev)
    xin = C.to_device(prog, {"input": inputs[1]}, dev)
    for _ in range(2):
        fn(xin)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(xin)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    seen = {k: 0 for k in _lib.KERNELS}
    device_events = 0
    busy_us = 0.0
    by_name: dict = {}
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            device_events += 1
            us = ev.time_range.elapsed_us()
            busy_us += us
            short = ev.name.replace("(anonymous namespace)::", "")
            short = short.split("(")[0][-60:]
            by_name[short] = by_name.get(short, 0.0) + us
            for k in _lib.KERNELS:
                if f"{k}_kernel" in ev.name:
                    seen[k] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    lat_us = statistics.median(rounds[("megakernel", 1)][0]) * 1e3
    say(f"[path] profiled megakernel batch 1: {device_events} device "
        f"events, busy {busy_us:.0f} us; profiled wall {wall_us:.0f} us "
        f"(idle share {1 - busy_us / wall_us:.3f}), unprofiled median "
        f"{lat_us:.0f} us (idle share {1 - busy_us / lat_us:.3f}); top: "
        + "; ".join(f"{k} {v:.0f} us" for k, v in top))
    report["profile"] = {"device_events": device_events, "busy_us": busy_us,
                         "profiled_wall_us": wall_us,
                         "unprofiled_us": lat_us, "top_us": top}
    if device_events == 0:
        say("[path] profiler recorded no device events; launches rest on "
            "the wrapper counters")
    elif seen != path_counts:
        fail(f"profiler saw {seen} kernel launches, counters say "
             f"{path_counts}")
    else:
        say(f"[path] profiler confirms the launches: {seen}")

    # -- 5. serving -----------------------------------------------------------
    from repro_torch.serve import Server
    srv = Server(hw, backend="cuda", device="cuda")
    verdict = srv.register("resnet50", g, period_s=0.1, slots=4,
                           params=params)
    say(f"[serve] admitted resnet50: bound {verdict.response_bound_s * 1e3:.3f}"
        f" ms, deadline {verdict.deadline_s * 1e3:.1f} ms")
    xs = rng.integers(-64, 64, size=(8, 224, 224, 3)).astype(np.int8)
    tickets = [srv.submit("resnet50", xs[i]) for i in range(8)]
    _lib.reset_launch_counts()
    srv.run(hyperperiods=2)
    torch.cuda.synchronize()
    serve_counts = _lib.launch_counts()
    for i, t in enumerate(tickets):
        if t.status != "done":
            fail(f"ticket {t.tid} ended {t.status}: {t.error}")
        r = t.result()
        ref = reference_forward(g, params, {"input": xs[i]})[out_name]
        if not np.array_equal(r.output[out_name], ref):
            fail(f"ticket {t.tid}: output differs from reference_forward")
        say(f"[serve] ticket {t.tid}: done, bit-exact, latency "
            f"{r.latency_s * 1e3:.3f} ms, deadline "
            f"{'met' if r.deadline_met else 'MISSED'} "
            f"({r.verdict.outcome})")
        report["serve"].append({"tid": t.tid, "latency_ms":
                                r.latency_s * 1e3,
                                "met": r.deadline_met})
    tele = srv.telemetry()
    say(f"[serve] {tele['metrics']['tickets']} tickets, "
        f"{tele['metrics']['jobs']} jobs, launches {serve_counts}")
    for k in _lib.KERNELS:
        if serve_counts[k] == 0:
            fail(f"kernel {k} was not launched on the main path")

    # -- result lines ---------------------------------------------------------
    where = {
        "gemm_int8": ("src/repro_torch/csrc/gemm_int8.cu",
                      "src/repro/kernels/gemm_int8.py:120"),
        "conv2d_int8": ("src/repro_torch/csrc/conv2d_im2col.cu",
                        "src/repro/kernels/conv2d_im2col.py:82"),
        "megakernel": ("src/repro_torch/csrc/megakernel.cu",
                       "src/repro/core/megakernel.py:261"),
    }
    line = {"kernels": []}
    for k in _lib.KERNELS:
        kd = kernels[k]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": where[k][0],
            "replaces": where[k][1], "launches": serve_counts[k],
            "max_abs_err": kd["max_abs_err"], "ms": kd["ms"],
            "plain_ms": kd["plain_ms"], "bound_ms": kd["bound_ms"],
            "bound_by": kd["bound_by"],
            "library_ms": kd["library_ms"]})
    report["kernels"] = line["kernels"]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
