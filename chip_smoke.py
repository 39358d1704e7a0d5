#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printing its own lines; any failure exits non-zero:

  1. environment: torch/CUDA versions, nvcc, the card's name and power limit;
  2. build: the CUDA kernels from src/repro_torch/csrc (one nvcc each, in
     parallel, for sm_90a), and the tensor-core instructions in their SASS
     (cuobjdump: HMMA in K4's 16-bit kernels, IMMA in K1, K2 and K3, and
     no dp4a left in K3);
  3. kernels: K1 (int8 GEMM: split-K skinny route at M <= 16, the int8
     tensor-core tile above), K2 (implicit-im2col int8 conv on the int8
     tensor cores, split over K inside its launch) and K3 (the
     fused-segment megakernel, its conv and gemm steps on the same tile)
     against their plain torch versions on the card, bit for bit
     (torch.equal), with device times beside the plain version's and,
     where one PyTorch call computes the same function, that call's (every
     time of a kernel, plain version or library call is `graph_ms`: calls
     replayed from a CUDA graph); K2 also at every tiled conv of the main
     path, batch 1 and 8, with its grid (tiles x splits); K3 at the main
     path's three fused segments at batch 1 and 8, each beside K2 and
     cuDNN's float32 conv on the same conv;
  4. main path: int8 ResNet50-224 compiled for scaled_paper_machine(64) and
     run through `Deployment.run` on the megakernel path, the per-op kernel
     path and the plain "torch" backend at batch 1 and 8, each output bit
     for bit against the numpy `reference_forward`, with latency and
     launches per program (wrapper counters, confirmed by torch.profiler);
  5. serving: a `Server` on the "cuda" backend answers 8 requests;
  6. LM: K4 (flash attention) and K5 (the gated scan) against their plain
     torch versions on the card (K4 in f32, bf16 and f16 on the CPU tests'
     shapes, bf16 at the path's shapes), with times beside the plain
     version's, the
     library call's and the bound; zamba2-1.2B at full width as a float32
     copy: prefill of 32 tokens + 4 decode steps, card against CPU, then
     served through `Server.register_decode` (4 slots, 8 tickets, 4 of
     them arriving mid-stream), every stream equal token for token to the
     batch-to-completion oracle `ServeEngine.serve`; then the main path,
     zamba2-1.2B in bf16 through the same Server path, with prefill and
     decode-step times, launches per prefill (K4) and per decode step
     (K5), and the profiler's view of one decode step (its streams against
     the oracle are printed beside the bf16 noise, not held to it).

Then one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Weights and inputs are random, from seeds.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published dense peaks (NVIDIA data sheet): int8 and bf16 tensor
# cores, float32 outside the tensor cores, and HBM3 bandwidth. The bound of
# a kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate of their type.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the kernels each main path must launch (counts read around that path)
CNN_KERNELS = ("gemm_int8", "conv2d_int8", "megakernel")
LM_KERNELS = ("flash_attention", "ssm_scan")

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

    def add(self, nbytes: float, ops: float,
            peak_ops: float = PEAK_INT8_OPS) -> float:
        b, o = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
        self.bytes_ms += b
        self.ops_ms += o
        self.ms += max(b, o)
        return max(b, o)

    @property
    def by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


def events_ms(torch, fn, runs: int = RUNS) -> float:
    """Median time between CUDA events around `fn` over `runs` calls after
    WARM warm-ups."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(torch, fns) -> float:
    """Device time of one call, the one yardstick for every kernel, plain
    version and library call here: n calls captured in a CUDA graph
    (cycling over `fns`, one callable or a list of the same call on
    different inputs), the graph replayed (median of RUNS replays, CUDA
    events) and divided by n. n (1 to 20) is what fills about 1 ms, so
    the replay's own launch gap is spread thin. Replay leaves out the
    Python wrappers' host time, which exceeds a few-microsecond kernel's
    own."""
    fns = fns if isinstance(fns, list) else [fns]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:           # first calls (library loads, caches) eager
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    one = events_ms(torch, fns[0], runs=3)
    n = max(len(fns), min(20, math.ceil(1.0 / max(one, 1e-3))))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fns[i % len(fns)]()
    return events_ms(torch, g.replay) / n


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


def sass_counts(out_dir: Path) -> dict:
    """HMMA / IMMA / IDP (dp4a) instructions in the built K4, K2, K1 and K3
    libraries: their counts and the distinct forms (opcode with its
    modifiers)."""
    from repro_torch.kernels import _lib
    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    counts = {}
    for src in ("flash_attention", "conv2d_im2col", "gemm_int8",
                "megakernel"):
        text = subprocess.run([str(tool), "-sass",
                               str(out_dir / f"lib{src}.so")],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[src] = {}
        for op in ("HMMA", "IMMA", "IDP"):
            found = re.findall(rf"\s({op}(?:\.\w+)*)\s", text)
            counts[src][op] = len(found)
            counts[src][f"{op} forms"] = sorted(set(found))
    return counts


def _kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled kernel entry with its integer
    and type template arguments: `ns::k<4, true>` -> "k<4,1>"."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name, i = mangled, 0
    while i < len(s) and s[i].isdigit():
        m = re.match(r"\d+", s[i:])
        j = i + m.end()
        name, i = s[j:j + int(m.group())], j + int(m.group())
    if s[i:i + 1] == "I":
        i += 1
        args = []
        while i < len(s) and s[i] != "E":
            m = re.match(r"L[a-z]+(\d+)E|(\d+)", s[i:])
            if m is None:
                break
            if m.group(1) is not None:
                args.append(m.group(1))
                i += m.end()
            else:
                j = i + m.end()
                args.append(s[j:j + int(m.group(2))])
                i = j + int(m.group(2))
        name += "<" + ",".join(args) + ">"
    return name


def ptxas_summary(out_dir: Path) -> dict:
    """{library: {kernel: [registers, spill store bytes]}} from the ptxas
    reports that `_lib.build_all(verbose=True)` keeps beside each
    library."""
    out: dict = {}
    for f in sorted(out_dir.glob("lib*.ptxas.txt")):
        lib = out.setdefault(f.name[3:-len(".ptxas.txt")], {})
        cur = None
        for line in f.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = lib.setdefault(_kernel_name(m.group(1)), [0, 0])
            elif cur is not None:
                m = re.search(r"(\d+) bytes spill stores", line)
                if m:
                    cur[1] = int(m.group(1))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    cur[0] = int(m.group(1))
    return out


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

def profile_once(torch, fn):
    """Profile one call of `fn` after a warm-up (a first profiled call
    absorbs the profiler's start-up and is discarded). Returns (device
    events by kernel short name, busy us, profiled wall us, events)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, by_name, names = 0.0, {}, []
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            us = ev.time_range.elapsed_us()
            busy_us += us
            names.append(ev.name)
            short = ev.name.replace("(anonymous namespace)::", "")
            short = short.split("(")[0].split("<")[0][-60:]
            by_name[short] = by_name.get(short, 0.0) + us
    return by_name, busy_us, wall_us, names


# the K4 parameter sets of tests/test_torch_lm_kernels.py (B, Hq, Hkv, Sq,
# Skv, D), causal, window
K4_TEST_CASES = [((1, 4, 4, 64, 64, 32), True, None),
                 ((2, 8, 2, 100, 100, 64), True, None),
                 ((2, 8, 2, 100, 100, 64), True, 37),
                 ((1, 4, 1, 33, 77, 16), True, None),
                 ((2, 4, 4, 64, 64, 32), False, None),
                 ((2, 8, 2, 1, 100, 64), True, None)]


def lm_phase(torch, np, rng, kernels, report, smi) -> dict:
    """Phase 6. Returns the kernel launch counts of the LM serving run."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.hw import scaled_paper_machine
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    params_to, prefill_step)
    from repro_torch.serve import Server
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device("cuda")
    # float32 GEMMs in full float32, and bf16 GEMMs reduced in float32 (as
    # the TPU's MXU accumulates): cuBLAS may otherwise reduce split-K
    # partials in bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(dev).manual_seed(SEED)
    lm: dict = {"checks": []}
    report["lm"] = lm
    k4, k5 = kernels["flash_attention"], kernels["ssm_scan"]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def close(name, got, want, atol, rtol) -> float:
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"{name}: kernel gave {got.dtype} {tuple(got.shape)}, "
                 f"plain {want.dtype} {tuple(want.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), atol=atol,
                              rtol=rtol):
            fail(f"{name}: kernel disagrees with its plain version (max abs "
                 f"err {err}, atol {atol}, rtol {rtol})")
        return err

    # -- 6a. K4 against its plain version ------------------------------------
    n = 0
    for (B, Hq, Hkv, Sq, Skv, D), causal, window in K4_TEST_CASES:
        q, k, v = randn(B, Hq, Sq, D), randn(B, Hkv, Skv, D), \
            randn(B, Hkv, Skv, D)
        for scale in (None, 0.25):
            err = close(f"K4 f32 {(B, Hq, Hkv, Sq, Skv, D)} causal={causal} "
                        f"window={window} scale={scale}",
                        flash_attention(q, k, v, causal=causal,
                                        window=window, scale=scale),
                        flash_attention_plain(q, k, v, causal, window,
                                              scale), 3e-5, 1e-4)
            k4["max_abs_err"] = max(k4["max_abs_err"], err)
            n += 1
    say(f"[K4] f32: {n} checks on the CPU tests' shapes within atol 3e-5, "
        f"rtol 1e-4 (max abs err {k4['max_abs_err']:.3g})")
    # the 16-bit route (tensor cores) on the same cases. Tolerances: the
    # output is rounded to the type, and a kernel value a hair off the
    # plain version's can round one ulp apart (2^-6 bf16, 2^-9 f16 at
    # |out| < 4; rtol covers larger outputs); the kernel also rounds P to
    # the type before P V (relative 2^-9 bf16, 2^-12 f16), which the plain
    # version's float32 P V does not
    for dt, name, atol, rtol in ((torch.bfloat16, "bf16", 2e-2, 1e-2),
                                 (torch.float16, "f16", 4e-3, 2e-3)):
        n, worst = 0, 0.0
        for (B, Hq, Hkv, Sq, Skv, D), causal, window in K4_TEST_CASES:
            q = randn(B, Hq, Sq, D, dtype=dt)
            k, v = (randn(B, Hkv, Skv, D, dtype=dt) for _ in range(2))
            for scale in (None, 0.25):
                err = close(f"K4 {name} {(B, Hq, Hkv, Sq, Skv, D)} causal="
                            f"{causal} window={window} scale={scale}",
                            flash_attention(q, k, v, causal=causal,
                                            window=window, scale=scale),
                            flash_attention_plain(q, k, v, causal, window,
                                                  scale), atol, rtol)
                worst = max(worst, err)
                n += 1
        k4["max_abs_err"] = max(k4["max_abs_err"], worst)
        lm["checks"].append({"kernel": "flash_attention", "dtype": name,
                             "cases": n, "max_abs_err": worst,
                             "atol": atol, "rtol": rtol})
        say(f"[K4] {name} (tensor cores): {n} checks on the CPU tests' "
            f"shapes within atol {atol}, rtol {rtol} (max abs err "
            f"{worst:.3g})")
    for B in (1, 4):
        # the path's shape: zamba2's shared attention over a 128-token
        # prompt, at batch 1 (LMBackend prefill) and 4 (ServeEngine)
        Hq, S, D = 32, 128, 64
        q, k, v = (randn(B, Hq, S, D, dtype=torch.bfloat16)
                   for _ in range(3))
        err = close(f"K4 bf16 {(B, Hq, S, D)}",
                    flash_attention(q, k, v, causal=True),
                    flash_attention_plain(q, k, v, True), 2e-2, 0.0)
        k4["max_abs_err"] = max(k4["max_abs_err"], err)
        ms = graph_ms(torch, lambda: flash_attention(q, k, v, causal=True))
        pms = graph_ms(torch, lambda: flash_attention_plain(q, k, v, True))
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        bd = Bound()
        b = bd.add(4 * q.numel() * 2,
                   2 * 2 * B * Hq * D * (S * (S + 1) // 2), PEAK_BF16_FLOPS)
        say(f"[K4] bf16 {(B, Hq, S, D)} causal: max abs err {err:.3g} "
            f"(atol 2e-2); device time (CUDA graph) kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, library (scaled_dot_product_attention) "
            f"{lib_ms:.4f} ms, bound {b:.5f} ms ({bd.by})")
        lm["checks"].append({"kernel": "flash_attention",
                             "shape": [B, Hq, S, D], "dtype": "bf16",
                             "max_abs_err": err, "ms": ms, "plain_ms": pms,
                             "library_ms": lib_ms, "bound_ms": b})
        if B == 1:
            k4.update(ms=ms, plain_ms=pms, library_ms=lib_ms, bound_ms=b,
                      bound_by=bd.by)

    # -- 6b. K5 against its plain version ------------------------------------
    for B, T, with_h0 in ((4, 1, True), (1, 8, False)):
        D = 2 * 2048 * 64                  # zamba2's (channel, state) pairs
        # four input sets (67 MB at B = 4) cycled through the timed graph,
        # more than the 50 MB L2 holds: each launch reads from HBM as the
        # decode step's cached state does
        sets = []
        for _ in range(4):
            a = torch.rand((B, T, D), generator=gen, device=dev) * 0.9 + 0.05
            sets.append((a, randn(B, T, D),
                         randn(B, D) if with_h0 else None))
        a, x, h0 = sets[0]
        err = close(f"K5 {(B, T, D)} h0={with_h0}", ssm_scan(a, x, h0),
                    ssm_scan_plain(a, x, h0), 1e-6, 1e-5)
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        ms = graph_ms(torch, [lambda s_=s_: ssm_scan(*s_) for s_ in sets])
        pms = graph_ms(torch, [lambda s_=s_: ssm_scan_plain(*s_)
                               for s_ in sets])
        lib_ms = None
        if T == 1 and with_h0:
            close("torch.addcmul as K5 at T = 1",
                  torch.addcmul(x, a, h0[:, None]),
                  ssm_scan_plain(a, x, h0), 1e-6, 1e-5)
            lib_ms = graph_ms(torch, [
                lambda s_=s_: torch.addcmul(s_[1], s_[0], s_[2][:, None])
                for s_ in sets])
        bd = Bound()
        b = bd.add(3 * B * T * D * 4 + (B * D * 4 if with_h0 else 0),
                   2 * B * T * D, PEAK_F32_FLOPS)
        say(f"[K5] f32 {(B, T, D)} h0={with_h0}: max abs err {err:.3g} "
            f"(rtol 1e-5); device time (CUDA graph) kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, library (addcmul) "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
            f"{b:.5f} ms ({bd.by})")
        lm["checks"].append({"kernel": "ssm_scan", "shape": [B, T, D],
                             "h0": with_h0, "max_abs_err": err, "ms": ms,
                             "plain_ms": pms, "library_ms": lib_ms,
                             "bound_ms": b})
        if T == 1:
            k5.update(ms=ms, plain_ms=pms, library_ms=lib_ms, bound_ms=b,
                      bound_by=bd.by)

    # -- 6c. zamba2-1.2B at full width, float32 copy -------------------------
    cfg = get_config("zamba2-1.2b")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    # K4 once per shared-attention application (6), K5 once per Mamba2
    # layer in a decode step (38)
    n_k4, n_k5 = cfg.num_layers // cfg.attn_every, cfg.num_layers
    # the 8 prompts (16-128 tokens) that both Server runs below answer
    lens = rng.integers(16, 129, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]

    def serve_tickets(cfg_, params_, new_tokens):
        """`Server.register_decode` with 4 slots: 4 tickets before the
        first step and 4 mid-stream, each done with `new_tokens` tokens.
        The launch counts are read around the serving loop alone."""
        srv = Server(scaled_paper_machine(64), backend="cuda")
        t0 = time.perf_counter()
        verdict = srv.register_decode(
            "zamba2", cfg_, period_s=0.1, params=params_, slots=4,
            prompt_len=128, max_new_tokens=new_tokens, max_len=256)
        say(f"[lm] admitted zamba2-1.2b ({cfg_.dtype}) in "
            f"{time.perf_counter() - t0:.2f} s: modeled bound of one decode "
            f"step on the modeled RISC-V machine "
            f"{verdict.response_bound_s * 1e3:.3f} ms, period 100 ms")
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        tickets = [srv.submit("zamba2", prompts[i]) for i in range(4)]
        jobs = 0
        while not all(t.terminal for t in tickets) or len(tickets) < 8:
            srv.step()
            jobs += 1
            if jobs == 3:                        # 4 arrive mid-stream
                tickets += [srv.submit("zamba2", prompts[i])
                            for i in range(4, 8)]
            if jobs > 1000:
                fail("the LM server did not finish 8 tickets in 1000 jobs")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = _lib.launch_counts()
        tele = srv.telemetry()["continuous"]["zamba2"]
        for t in tickets:
            if t.status != "done":
                fail(f"LM ticket {t.tid} ended {t.status}: {t.error}")
            if len(t.result().output) != new_tokens:
                fail(f"LM ticket {t.tid}: {len(t.result().output)} tokens")
        if counts["flash_attention"] != n_k4 * tele["prefills"] or \
                counts["ssm_scan"] != n_k5 * tele["decode_steps"]:
            fail(f"LM serving launched {counts} for {tele['prefills']} "
                 f"prefills and {tele['decode_steps']} decode steps "
                 f"(expected {n_k4} K4 per prefill, {n_k5} K5 per decode "
                 f"step)")
        return srv, verdict, tickets, jobs, wall_s, counts, tele

    def oracle(cfg_, params_, new_tokens):
        """The streams of `ServeEngine.serve(batch_size=4)` on the card."""
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=new_tokens)
                for i, p in enumerate(prompts)]
        ServeEngine(cfg_, params_, batch_size=4, max_len=256).serve(
            reqs, prompt_len=128)
        return [r.out for r in reqs]

    t0 = time.perf_counter()
    p_dev = init_params(cfg32, torch.Generator(dev).manual_seed(SEED))
    p_cpu = params_to(p_dev, "cpu")
    n_params = sum(t.numel() for t in _leaves(p_dev))
    say(f"[lm] zamba2-1.2b float32 copy: {n_params / 1e9:.3f} B params on "
        f"the card and the CPU in {time.perf_counter() - t0:.1f} s")
    toks = rng.integers(1, cfg.vocab_size, (1, 32))
    sides = {}
    for side, p_, d_ in (("card", p_dev, dev), ("cpu", p_cpu, "cpu")):
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill_step(cfg32)(
            p_, {"tokens": torch.as_tensor(toks, device=d_)},
            init_cache(cfg32, 1, 64, device=d_))
        outs = [logits.cpu()]
        sides[side] = {"prefill_counts": _lib.launch_counts()}
        for _ in range(4):
            tok = torch.argmax(outs[-1][:, -1], dim=-1)[:, None]
            if side == "cpu":                   # teacher-forced by the card
                tok = torch.argmax(sides["card"]["logits"][len(outs) - 1]
                                   [:, -1], dim=-1)[:, None]
            logits, cache = decode_step(cfg32)(p_, cache, tok.to(d_))
            outs.append(logits.cpu())
        sides[side].update(logits=outs, s=time.perf_counter() - t0)
    for i, (ld, lc) in enumerate(zip(sides["card"]["logits"],
                                     sides["cpu"]["logits"])):
        atol = 1e-3 * lc.abs().max().item()
        err = (ld - lc).abs().max().item()
        what = "prefill" if i == 0 else f"decode step {i}"
        if not torch.allclose(ld, lc, rtol=1e-3, atol=atol):
            fail(f"zamba2 float32 {what}: card logits differ from the CPU's "
                 f"(max abs err {err}, atol {atol})")
        if not torch.equal(ld[:, -1].argmax(-1), lc[:, -1].argmax(-1)):
            fail(f"zamba2 float32 {what}: greedy tokens differ")
        lm["checks"].append({"model": "zamba2-1.2b f32", "step": what,
                             "max_abs_err": err, "atol": atol})
    pc = sides["card"]["prefill_counts"]
    if pc["flash_attention"] != n_k4:
        fail(f"zamba2 float32 prefill launched K4 {pc['flash_attention']} "
             f"times, expected {n_k4}")
    say(f"[lm] zamba2-1.2b float32: prefill (32 tokens) + 4 decode steps, "
        f"card logits within rtol 1e-3 / atol 1e-3 max|logits| of the CPU's "
        f"and greedy tokens equal (card {sides['card']['s']:.2f} s, CPU "
        f"{sides['cpu']['s']:.2f} s)")
    del p_cpu, sides

    # the continuous-batching path exactly: per-row pos, the clamped
    # per-row cache writes and K5 resuming each slot's state, on the
    # float32 copy, where only the float32 rounding of another GEMM shape
    # separates the two schedules
    _, _, tickets, _, wall_s, _, _ = serve_tickets(cfg32, p_dev, 8)
    want = oracle(cfg32, p_dev, 8)
    for t, w in zip(tickets, want):
        if t.result().output != w:
            fail(f"zamba2 float32 Server ticket {t.tid} gave "
                 f"{t.result().output}, ServeEngine.serve {w}")
    say(f"[lm] zamba2-1.2b float32 through Server.register_decode: 8 of 8 "
        f"streams (8 tokens each, 4 tickets mid-stream) equal "
        f"ServeEngine.serve(batch_size=4) token for token ({wall_s:.2f} s)")
    lm["f32_server"] = {"streams_equal_oracle": 8, "wall_s": wall_s}
    del p_dev
    torch.cuda.empty_cache()

    # -- 6d. the main path: zamba2-1.2B in bf16 through the Server -----------
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED))
    srv, verdict, tickets, jobs, wall_s, lm_counts, tele = serve_tickets(
        cfg, params, 32)
    for k in LM_KERNELS:
        if lm_counts[k] == 0:
            fail(f"kernel {k} was not launched on the LM serving path")
    n_tok = sum(len(t.result().output) for t in tickets)
    say(f"[lm] Server: 8 tickets done, 32 tokens each, in {jobs} jobs "
        f"({tele['prefills']} prefills, {tele['decode_steps']} decode "
        f"steps, {wall_s:.2f} s, {n_tok / wall_s:.1f} tokens/s end to end); "
        f"launches {lm_counts}")

    # A diagnostic, not a gate: how far bf16 rounding carries the streams
    # from the oracle's. LMBackend prefills each prompt alone (GEMMs with
    # M = 128), the oracle four at once (M = 512); with random weights the
    # 38 layers amplify bf16 rounding far beyond one ulp of the logits, so
    # greedy streams flip wherever the top-2 margin is inside this noise.
    diffs = []
    for g0 in (0, 4):
        padded = torch.tensor([[0] * (128 - len(p)) + p
                               for p in prompts[g0:g0 + 4]], device=dev)
        l4, _ = prefill_step(cfg)(params, {"tokens": padded},
                                  init_cache(cfg, 4, 256, device=dev))
        for i in range(4):
            l1, _ = prefill_step(cfg)(params, {"tokens": padded[i:i + 1]},
                                      init_cache(cfg, 1, 256, device=dev))
            diffs.append((l1[0, -1] - l4[i, -1]).abs())
    diffs = torch.cat(diffs).float()
    noise = {q_: torch.quantile(diffs, q_).item() for q_ in (0.5, 0.99)}
    noise["max"] = diffs.max().item()
    say(f"[lm] bf16 prefill logits, batch 1 vs batch 4 on the same 8 "
        f"prompts: |difference| median {noise[0.5]:.4g}, 99th percentile "
        f"{noise[0.99]:.4g}, max {noise['max']:.4g} (max |logit| "
        f"{l4.abs().max().item():.3g})")
    want = oracle(cfg, params, 32)
    same, margins = 0, []
    for t, p, w in zip(tickets, prompts, want):
        got = t.result().output
        if got == w:
            same += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, w)) if a != b)
        padded = [0] * (128 - len(p)) + p + w[:i]
        logits, _ = prefill_step(cfg)(
            params, {"tokens": torch.tensor([padded], device=dev)},
            init_cache(cfg, 1, 256, device=dev))
        top2 = torch.topk(logits[0, -1].float(), 2).values
        margins.append((top2[0] - top2[1]).item())
    inside = sum(m < noise[0.99] for m in margins)
    say(f"[lm] bf16: {same} of 8 streams equal ServeEngine.serve("
        f"batch_size=4) token for token; the rest first differ at top-2 "
        f"margins {[round(m_, 4) for m_ in margins]}, {inside} of them below "
        f"the 99th percentile of the noise (the float32 run holds this "
        f"path to the oracle exactly)")
    backend = srv._nets["zamba2"].cengine.backend

    # times and launches per prefill and per decode step
    def prefill_once():
        return backend.prefill(prompts[0])

    _lib.reset_launch_counts()
    prefill_once()
    per_prefill = _lib.launch_counts()
    cache = backend.init_cache()
    for slot in range(4):
        cache = backend.insert(backend.prefill(prompts[slot])[1], cache,
                               slot)
    prev = np.array([5, 6, 7, 8], np.int32)
    valid = np.ones(4, bool)
    lengths = np.ones(4, np.int32)

    def decode_once():
        return backend.generate(cache, prev, valid, lengths)

    _lib.reset_launch_counts()
    decode_once()
    per_step = _lib.launch_counts()
    if per_prefill["flash_attention"] != n_k4 or \
            per_step["ssm_scan"] != n_k5:
        fail(f"launches per prefill {per_prefill}, per decode step "
             f"{per_step}: expected {n_k4} K4 and {n_k5} K5")
    prefill_ms = host_ms(torch, prefill_once)
    step_ms = host_ms(torch, decode_once)
    say(f"[lm] bf16, batch-1 prefill of 128 tokens: {prefill_ms:.3f} ms "
        f"(K4 x{per_prefill['flash_attention']}); 4-slot decode step: "
        f"median {step_ms:.3f} ms (K5 x{per_step['ssm_scan']}), "
        f"{4e3 / step_ms:.1f} tokens/s")
    profiles = {}
    for what, fn, kern, want in (("decode step", decode_once, "ssm_scan",
                                  n_k5),
                                 ("prefill", prefill_once,
                                  "flash_attention", n_k4)):
        by_name, busy_us, wall_us, names = profile_once(torch, fn)
        seen = sum(f"{kern}_kernel" in nm for nm in names)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        unprof_us = (step_ms if what == "decode step" else prefill_ms) * 1e3
        say(f"[lm] profiled {what}: {len(names)} device events, busy "
            f"{busy_us:.0f} us; profiled wall {wall_us:.0f} us, unprofiled "
            f"median {unprof_us:.0f} us (idle share "
            f"{1 - busy_us / unprof_us:.3f}); {kern}_kernel x{seen}; top: "
            + "; ".join(f"{k} {v:.0f} us" for k, v in top))
        if names and seen != want:
            fail(f"profiler saw {kern}_kernel {seen} times in one {what}, "
                 f"expected {want}")
        if not names:
            say(f"[lm] profiler recorded no device events for the {what}; "
                "launches rest on the wrapper counters")
        else:
            say(f"[lm] profiler confirms {seen} {kern}_kernel launches per "
                f"{what}")
        profiles[what] = {"device_events": len(names), "busy_us": busy_us,
                          "profiled_wall_us": wall_us,
                          "unprofiled_us": unprof_us, "kernel_seen": seen,
                          "top_us": top}
    lm.update(serve={"jobs": jobs, "wall_s": wall_s, "tokens": n_tok,
                     "tokens_per_s": n_tok / wall_s, "launches": lm_counts,
                     "continuous": tele, "streams_equal_oracle": same,
                     "bound_ms": verdict.response_bound_s * 1e3},
              prefill_ms=prefill_ms, decode_step_ms=step_ms,
              decode_tokens_per_s=4e3 / step_ms, per_prefill=per_prefill,
              per_decode_step=per_step, profile=profiles, card=smi,
              prefill_noise={str(k_): v_ for k_, v_ in noise.items()},
              stream_margins=margins)
    return lm_counts


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


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
    from repro_torch.kernels import conv2d_im2col as K2
    from repro_torch.kernels.conv2d_im2col import (conv2d_int8,
                                                   conv2d_int8_plain)
    from repro_torch.kernels.gemm_int8 import (gemm_int8, gemm_int8_plain,
                                               gemm_splits)
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
    ptxas = ptxas_summary(out_dir)
    report["ptxas"] = ptxas
    for lib_, ks in ptxas.items():
        say(f"[build] ptxas lib{lib_}.so (registers, spill store bytes): "
            + ", ".join(f"{k} {r}/{sp}" for k, (r, sp) in ks.items()))
    sass = sass_counts(out_dir)
    report["sass"] = sass
    ops = ("HMMA", "IMMA", "IDP")
    say("[build] tensor-core and dp4a instructions in the SASS "
        "(cuobjdump -sass): " + "; ".join(
            f"lib{k}.so " + ", ".join(f"{op} x{v[op]}" for op in ops)
            + f" ({', '.join(f for op in ops for f in v[op + ' forms'])})"
            for k, v in sass.items()))
    if sass["flash_attention"]["HMMA"] == 0 or any(
            sass[k]["IMMA"] == 0 for k in ("conv2d_im2col", "gemm_int8",
                                           "megakernel")):
        fail("K4's 16-bit kernels, K2, K1 or K3 hold no tensor-core "
             "instruction")
    if sass["megakernel"]["IDP"]:
        fail("K3 still multiplies with dp4a")

    rng = np.random.default_rng(SEED)

    def i8(*shape):
        return torch.as_tensor(rng.integers(-128, 128, size=shape)
                               .astype(np.int8)).to(dev)

    def mults(n):
        return torch.as_tensor((0.002 + 0.001 * rng.random(n))
                               .astype(np.float32)).to(dev)

    kernels = {k: {"max_abs_err": 0} for k in _lib.KERNELS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # -- 3a. K1 --------------------------------------------------------------
    # the classifier at batch 1 and 8 (skinny route) and 256 (tensor cores)
    for (M, K, N, mode) in [(1, 2048, 1000, "int32"), (1, 2048, 1000, "rq"),
                            (8, 2048, 1000, "int32"), (8, 2048, 1000, "rq"),
                            (256, 2048, 1000, "int32"),
                            (256, 2048, 1000, "rq"),
                            (37, 131, 77, "int32"), (37, 131, 77, "rq1"),
                            (5, 131, 77, "rq1"), (16, 300, 1000, "int32"),
                            (1, 3, 5, "rq"), (130, 64, 200, "rq")]:
        x, w = i8(M, K), i8(K, N)
        m = (None if mode == "int32" else
             mults(1) if mode == "rq1" else mults(N))
        err = expect_equal(torch, f"K1 {M}x{K}x{N} {mode}",
                           gemm_int8(x, w, m), gemm_int8_plain(x, w, m))
        kernels["gemm_int8"]["max_abs_err"] = max(
            kernels["gemm_int8"]["max_abs_err"], err)
        ms = graph_ms(torch, lambda: gemm_int8(x, w, m))
        pms = graph_ms(torch, lambda: gemm_int8_plain(x, w, m))
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
            lib_ms = graph_ms(torch, lambda: torch._int_mm(xp, wp))
        b = Bound().add(M * K + K * N
                        + M * N * (4 if mode == "int32" else 1),
                        2 * M * N * K)
        route, splits = gemm_splits(M, N, K, sms)
        say(f"[K1] {M}x{K}x{N} {mode}: equal; {route} route, {splits} "
            f"splits; kernel {ms:.4f} ms, plain {pms:.4f} ms, library "
            f"{lib_ms} ms, bound {b:.5f} ms")
        report["checks"].append({"kernel": "gemm_int8", "shape": [M, K, N],
                                 "mode": mode, "route": route,
                                 "splits": splits, "ms": ms,
                                 "plain_ms": pms, "library_ms": lib_ms,
                                 "bound_ms": b})

    # -- 3b. K2 --------------------------------------------------------------
    torch.backends.cudnn.allow_tf32 = False

    def k2_grid(M, N, K):
        """K2's grid for an (M, K) x (K, N) conv: (tiles, splits)."""
        tiles = math.ceil(M / K2.TILE_M) * math.ceil(N / K2.TILE_N)
        return tiles, K2.conv_splits(M, N, K, sms)

    def conv_case(tag, B, H, W, Cin, N, k, s, p, rq="channel", timed=True):
        x, w = i8(B, H, W, Cin), i8(k * k * Cin, N)
        m = mults(N) if rq == "channel" else mults(1) if rq == "scalar" \
            else None
        kw = dict(kh=k, kw=k, stride=s, padding=p)
        err = expect_equal(torch, f"K2 {tag}", conv2d_int8(x, w, m, **kw),
                           conv2d_int8_plain(x, w, m, **kw))
        kernels["conv2d_int8"]["max_abs_err"] = max(
            kernels["conv2d_int8"]["max_abs_err"], err)
        oh = (H + 2 * p - k) // s + 1
        ow = (W + 2 * p - k) // s + 1
        tiles, splits = k2_grid(B * oh * ow, N, k * k * Cin)
        shape = f"{tag} B={B} {H}x{W}x{Cin}->{N} k{k} s{s} p{p} ({rq})"
        if not timed:
            say(f"[K2] {shape}: equal; grid {tiles} tiles x {splits} "
                f"splits (K = {k * k * Cin}, "
                f"{math.ceil(k * k * Cin / K2.CHUNK_K)} chunks)")
            return None
        ms = graph_ms(torch, lambda: conv2d_int8(x, w, m, **kw))
        pms = graph_ms(torch, lambda: conv2d_int8_plain(x, w, m, **kw))
        # the library yardstick: cuDNN's float32 convolution (TF32 off) on
        # float copies of the same inputs, NCHW in channels-last memory
        xf = x.permute(0, 3, 1, 2).float().contiguous(
            memory_format=torch.channels_last)
        wf = w.reshape(k, k, Cin, N).permute(3, 2, 0, 1).float().contiguous(
            memory_format=torch.channels_last)
        lib_ms = graph_ms(torch, lambda: torch.nn.functional.conv2d(
            xf, wf, stride=s, padding=p))
        macs = B * oh * ow * N * k * k * Cin
        b = Bound().add(x.numel() + w.numel() + B * oh * ow * N
                        * (1 if rq else 4), 2 * macs)
        say(f"[K2] {shape}: equal; grid {tiles}x{splits}; "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, cuDNN f32 "
            f"{lib_ms:.4f} ms, bound {b:.5f} ms")
        report["checks"].append({"kernel": "conv2d_int8", "tag": tag,
                                 "shape": [B, H, W, Cin, N, k, s, p],
                                 "grid": [tiles, splits],
                                 "ms": ms, "plain_ms": pms,
                                 "library_ms": lib_ms, "bound_ms": b})
        return ms

    for B in (1, 8):
        conv_case("stem", B, 224, 224, 3, 64, 7, 2, 3)
        conv_case("3x3", B, 56, 56, 64, 64, 3, 1, 1)
        conv_case("1x1s2", B, 56, 56, 256, 512, 1, 2, 0)
    conv_case("ragged", 2, 13, 11, 5, 70, 3, 2, 1, rq=None, timed=False)
    conv_case("ragged-rq", 3, 9, 17, 12, 33, 5, 1, 2, timed=False)
    # split-K edges: 18 K chunks over 17 splits (K = 1152 is no multiple
    # of the split), int32 and scalar-requant outputs, C % 16 != 0 (the
    # scalar patch loader) split 4 ways, and a batch that lowers the split
    conv_case("split-ragged", 1, 8, 8, 128, 512, 3, 1, 1, timed=False)
    conv_case("split-ragged-i32", 1, 8, 8, 128, 512, 3, 1, 1, rq=None,
              timed=False)
    conv_case("split-c24", 1, 9, 9, 24, 72, 3, 1, 1, rq="scalar",
              timed=False)
    conv_case("split-b3", 3, 7, 7, 512, 512, 3, 1, 1, timed=False)

    # -- 3c. K3 on every fused segment ---------------------------------------
    def fused_checks(tag, g, hw, B, against_k2=False):
        """K3 on every fused segment of `g`'s plan, each against its plain
        version on the same inputs, timed; returns the per-program sums.
        `against_k2`: a segment that is one conv is also run and timed on
        K2 (same bits) and cuDNN's float32 conv on the same inputs."""
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
        total = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound(), "n": 0,
                 "k2_ms": 0.0, "library_ms": 0.0}
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
                ms = graph_ms(torch, lambda: MK.run_fused(
                    prog, seg, list(sv), consts, tab))
                pms = graph_ms(torch, lambda: MK.run_fused_plain(
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
                splits = MK.split_plan(tab, B, sms)[0]
                k2 = lib = None
                extra = ""
                if against_k2 and [s.mode for s in seg.steps] == ["conv2d"]:
                    st = seg.steps[0]
                    a = st.batch.attrs
                    w = consts.weights[st.batch.w_idx]
                    m = None if st.mult is None else consts.mults[st.out_idx]
                    xk = sv[st.batch.in_idx[0]]
                    kw = dict(kh=a["kh"], kw=a["kw"], stride=a["stride"],
                              padding=a["padding"])
                    expect_equal(torch, f"K2 on K3's {tag} segment {si}",
                                 conv2d_int8(xk, w, m, **kw).reshape(
                                     vals[st.out_idx].shape),
                                 vals[st.out_idx])
                    k2 = graph_ms(torch, lambda: conv2d_int8(xk, w, m, **kw))
                    xf = xk.permute(0, 3, 1, 2).float().contiguous(
                        memory_format=torch.channels_last)
                    wf = w.reshape(a["kh"], a["kw"], a["C_in"],
                                   a["C_out"]).permute(3, 2, 0, 1).float() \
                        .contiguous(memory_format=torch.channels_last)
                    lib = graph_ms(torch, lambda: torch.nn.functional.conv2d(
                        xf, wf, stride=a["stride"], padding=a["padding"]))
                    total["k2_ms"] += k2
                    total["library_ms"] += lib
                    extra = (f", K2 on the same conv {k2:.4f} ms (K3/K2 "
                             f"{ms / k2:.2f}), cuDNN f32 {lib:.4f} ms")
                say(f"[K3] {tag} batch {B} segment {si} ({len(names)} "
                    f"steps: {shown}; splits {sorted(splits.values())}): "
                    f"equal; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                    f"bound {b:.5f} ms{extra}")
                report["checks"].append({
                    "kernel": "megakernel", "tag": f"{tag}/{si}",
                    "batch": B, "steps": names, "splits": splits,
                    "ms": ms, "plain_ms": pms, "library_ms": lib,
                    "k2_ms": k2, "bound_ms": b})
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

    # the three full-width fused segments, against their plain versions,
    # at batch 1 and 8, each beside K2 and cuDNN on the same conv
    k3 = fused_checks("resnet50-224", g, hw, 1, against_k2=True)
    k3_8 = fused_checks("resnet50-224", g, hw, 8, against_k2=True)
    for B_, t_ in ((1, k3), (8, k3_8)):
        say(f"[K3] resnet50-224 batch {B_}, {t_['n']} fused segments "
            f"summed: kernel {t_['ms']:.4f} ms, K2 on the same convs "
            f"{t_['k2_ms']:.4f} ms, cuDNN f32 {t_['library_ms']:.4f} ms, "
            f"plain {t_['plain_ms']:.4f} ms, bound {t_['bound'].ms:.5f} ms")
    kernels["megakernel"].update(ms=k3["ms"], plain_ms=k3["plain_ms"],
                                 bound_ms=k3["bound"].ms,
                                 bound_by=k3["bound"].by,
                                 library_ms=k3["library_ms"],
                                 batch8_ms=k3_8["ms"])

    # K1/K2 at every tiled shape of the path (batch 1): per-program sums
    prog = dep.program
    consts = C.device_consts(prog, dev)
    sums = {"gemm_int8": [0.0, 0.0, 0.0], "conv2d_int8": [0.0, 0.0, 0.0]}
    bounds = {"gemm_int8": Bound(), "conv2d_int8": Bound()}
    sum8 = 0.0          # K2 over the same shapes at batch 8
    for seg in segments:
        if seg.kind != "tiled":
            continue
        st = seg.steps[0]
        a = st.batch.attrs
        w = consts.weights[st.batch.w_idx]
        m = None if st.mult is None else consts.mults[st.out_idx]
        if st.mode == "gemm":
            x = i8(1, a["M"], a["K"])
            ms = graph_ms(torch, lambda: gemm_int8(x, w, m))
            pms = graph_ms(torch, lambda: gemm_int8_plain(x, w, m))
            xp = torch.zeros(32, a["K"], dtype=torch.int8, device=dev)
            Np = -(-a["N"] // 8) * 8
            wp = torch.zeros(a["K"], Np, dtype=torch.int8, device=dev)
            xp[:a["M"]], wp[:, :a["N"]] = x[0], w
            lib = graph_ms(torch, lambda: torch._int_mm(xp, wp))
            key = "gemm_int8"
            b = bounds[key].add(x.numel() + w.numel() + a["M"] * a["N"]
                                * (1 if m is not None else 4),
                                2 * a["M"] * a["K"] * a["N"])
        else:
            oh, ow = C.conv_out_hw(a)
            x = i8(1, a["H"], a["W"], a["C_in"])
            x8 = i8(8, a["H"], a["W"], a["C_in"])
            kw = dict(kh=a["kh"], kw=a["kw"], stride=a["stride"],
                      padding=a["padding"])
            K_ = a["kh"] * a["kw"] * a["C_in"]
            for B_, xb in ((1, x), (8, x8)):
                err = expect_equal(
                    torch, f"K2 path {st.batch.name} batch {B_}",
                    conv2d_int8(xb, w, m, **kw),
                    conv2d_int8_plain(xb, w, m, **kw))
                kernels["conv2d_int8"]["max_abs_err"] = max(
                    kernels["conv2d_int8"]["max_abs_err"], err)
            ms = graph_ms(torch, lambda: conv2d_int8(x, w, m, **kw))
            ms8 = graph_ms(torch, lambda: conv2d_int8(x8, w, m, **kw))
            sum8 += ms8
            grid1 = k2_grid(oh * ow, a["C_out"], K_)
            grid8 = k2_grid(8 * oh * ow, a["C_out"], K_)
            pms = graph_ms(torch, lambda: conv2d_int8_plain(x, w, m, **kw))
            xf = x.permute(0, 3, 1, 2).float().contiguous(
                memory_format=torch.channels_last)
            wf = w.reshape(a["kh"], a["kw"], a["C_in"], a["C_out"]).permute(
                3, 2, 0, 1).float().contiguous(
                memory_format=torch.channels_last)
            lib = graph_ms(torch, lambda: torch.nn.functional.conv2d(
                xf, wf, stride=a["stride"], padding=a["padding"]))
            key = "conv2d_int8"
            b = bounds[key].add(x.numel() + w.numel() + oh * ow * a["C_out"]
                                * (1 if m is not None else 4),
                                2 * oh * ow * a["C_out"] * K_)
            say(f"[K2 path] {st.batch.name}: M {oh * ow} K {K_} N "
                f"{a['C_out']}, equal at batch 1 and 8; grid {grid1[0]}x"
                f"{grid1[1]} (batch 8: {grid8[0]}x{grid8[1]}); kernel "
                f"{ms:.4f} ms (batch 8: {ms8:.4f}), plain {pms:.4f}, cuDNN "
                f"f32 {lib:.4f}, bound {b:.5f} ms")
        for j, v in enumerate((ms, pms, lib)):
            sums[key][j] += v
        report["checks"].append({"kernel": key, "tag": st.batch.name,
                                 "ms": ms, "plain_ms": pms,
                                 "library_ms": lib, "bound_ms": b})
        if key == "conv2d_int8":
            report["checks"][-1].update(batch8_ms=ms8, grid=grid1,
                                        grid_batch8=grid8, M=oh * ow,
                                        K=K_, N=a["C_out"])
    for key, (ms, pms, lib) in sums.items():
        bd = bounds[key]
        kernels[key].update(ms=ms, plain_ms=pms, library_ms=lib,
                            bound_ms=bd.ms, bound_by=bd.by)
        say(f"[path] {key} over the path's tiled shapes (batch 1, summed): "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, library {lib:.4f} ms, "
            f"bound {bd.ms:.5f} ms ({bd.by})")
    kernels["conv2d_int8"]["batch8_ms"] = sum8
    say(f"[path] conv2d_int8 over the same shapes at batch 8 (summed): "
        f"kernel {sum8:.4f} ms")
    # K2's per-shape table: the path's convs grouped by (M, K, N), times
    # averaged over the convs of a group
    groups: dict = {}
    for c in report["checks"]:
        if c["kernel"] == "conv2d_int8" and "grid_batch8" in c:
            groups.setdefault((c["M"], c["K"], c["N"]), []).append(c)
    for (M_, K_, N_), cs in sorted(groups.items(),
                                   key=lambda kv: (-kv[0][0], kv[0][1:])):
        def mean(key):
            return statistics.mean(c[key] for c in cs)
        say(f"[K2 table] M {M_} K {K_} N {N_} x{len(cs)}: grid "
            f"{cs[0]['grid'][0]}x{cs[0]['grid'][1]} (batch 8: "
            f"{cs[0]['grid_batch8'][0]}x{cs[0]['grid_batch8'][1]}); kernel "
            f"{mean('ms'):.4f} ms (batch 8: {mean('batch8_ms'):.4f}), cuDNN "
            f"f32 {mean('library_ms'):.4f}, bound {mean('bound_ms'):.5f}")

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
    for k in CNN_KERNELS:
        if serve_counts[k] == 0:
            fail(f"kernel {k} was not launched on the CNN serving path")

    # -- 6. LM: zamba2-1.2B through Server.register_decode ---------------------
    lm_counts = lm_phase(torch, np, rng, kernels, report, smi)

    # -- result lines ---------------------------------------------------------
    where = {
        "gemm_int8": ("src/repro_torch/csrc/gemm_int8.cu",
                      "src/repro/kernels/gemm_int8.py:120"),
        "conv2d_int8": ("src/repro_torch/csrc/conv2d_im2col.cu",
                        "src/repro/kernels/conv2d_im2col.py:82"),
        "megakernel": ("src/repro_torch/csrc/megakernel.cu",
                       "src/repro/core/megakernel.py:261"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:88"),
        "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan.py:53"),
    }
    launches = {**{k: serve_counts[k] for k in CNN_KERNELS},
                **{k: lm_counts[k] for k in LM_KERNELS}}
    line = {"kernels": []}
    for k in _lib.KERNELS:
        kd = kernels[k]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": where[k][0],
            "replaces": where[k][1], "launches": launches[k],
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
