#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU
    python3 chip_smoke.py --decode-turns TREE [TREE ...]   # e.g. A B B A
    python3 chip_smoke.py --yolov5s  # phases 1, 2 and 5d alone

The second form reads phases 6, 7 and 9's bf16 decode steps (zamba2-1.2B,
rwkv6-1.6B, seamless-m4t-medium) with the package of each TREE (the root
of an unpacked `git archive`), one fresh process per turn, in the order
given: the measuring code is this script's for every tree, so only the
package differs between turns. Results go to
chiprun_out/decode_turns.json. The third runs the environment, the build
and phase 5d, and ends with the same result lines, lut_int8 alone in
the kernels line.

Phases, each printing its own lines; any failure exits non-zero:

  1. environment: torch/CUDA versions, nvcc, the card's name and power limit;
  2. build: the CUDA kernels from src/repro_torch/csrc (one nvcc each, in
     parallel, for sm_90a), and the tensor-core instructions in their SASS
     (cuobjdump: HMMA in K4's 16-bit kernels, IMMA in K1, K2 and K3,
     IGMMA (int8 wgmma) and UTMALDG (TMA loads) in K6, and no dp4a left
     in K3);
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
     5b. resilience: ResNet50-224 ("detector", criticality 2) beside a small
     CNN ("lane", criticality 0) under a seeded fault plan on the lane
     (`enable_resilience`: retries, circuit breaker, straggler watchdog)
     for 10 hyperperiods: every ticket terminal, every detector ticket
     bit-exact, every recorded error an injected one, launches equal to
     the programs run times their launches per program, and a second
     Server from the same seed gives the same lane trace;
     5c. mode changes: "highway" (detector + lane) switched mid-hyperperiod
     to "parking" (detector at half the rate + a "park" CNN): the swap
     happens at the boundary only, queued lane tickets end "dropped",
     carried-over detector tickets run bit-exact on the staged deployment
     (K1-K3 launched after the swap), and an unschedulable mode is refused
     without touching the server;
     5d. YOLOv5s: `cnn.yolov5s()` at 640 x 640, 80 classes, through a
     `Server` on the graphed runner (batch-8 jobs, every served job a
     replay): each answer bit-exact against the plain "torch" backend on
     the card, two against the numpy oracle `run_numpy`; lut_int8 (the
     SiLU table) against its plain version at the largest and smallest
     SiLU of a batch-8 job, launches and bytes counted from zero around
     each, with the kernel's, the plain version's, `torch.index_select`'s
     and the bound's times; the answers' readback into the runner's
     page-locked host arrays (reads reused, made, pageable) and, on the
     same 68.5 MB, a copy into new pageable memory beside one into
     page-locked memory;
  6. LM: K4 (flash attention) and K5 (the gated scan) against their plain
     torch versions on the card (K4 in f32, bf16 and f16 on the CPU tests'
     shapes and on the moe and encdec paths' shapes: head dim 128 with 6 q
     heads per kv head, non-causal with Sq != Skv, Sq = 1), with times at
     every LM path's shapes beside the plain version's, the library
     call's and the bound (K5 and `torch.addcmul` at the decode step's
     shape in five alternating turns each, medians kept); zamba2-1.2B at full width as a float32
     copy: prefill of 32 tokens + 4 decode steps, card against CPU, then
     served through `Server.register_decode` (4 slots, 8 tickets, 4 of
     them arriving mid-stream), every stream equal token for token to the
     batch-to-completion oracle `ServeEngine.serve`; then the main path,
     zamba2-1.2B in bf16 through the same Server path, with prefill and
     decode-step times, launches per prefill (K4) and per decode step
     (K5), and the profiler's view of one decode step (its streams against
     the oracle are printed beside the bf16 noise, not held to it); then
     `PredictableEngine` on the same bf16 params (a deadline check per
     decode step, 6 K4 per prefill, 38 K5 per decode step), and the two
     CLIs: `repro_torch.launch.serve --analyze-only` and, in a subprocess,
     `python -m repro_torch.analysis` on the saved ResNet50-224 deployment;
  7. rwkv6-1.6B (RWKV, full width and depth): a float32 copy card against
     CPU (prefill 4 x 32 + 4 decode steps) and through
     `Server.register_decode` (8 of 8 streams equal `ServeEngine.serve`),
     then bf16 through the Server (8 tickets of 32 tokens); no kernel
     launches on this path (all counts 0);
  8. mixtral-8x22B (moe, full width, depth cut to 8 of 56 layers in bf16
     and 1 in float32): the float32 layer card against CPU (the routers'
     expert ids compared first; a near-tie flip is reported with its two
     probabilities) and through the Server against the oracle, then bf16
     through the Server; K4 8 times per prefill, never in a decode step;
  9. seamless-m4t-medium (encdec, full width and depth): a float32 copy
     card against CPU, then bf16 through `ServeEngine.serve` (8 requests
     of 16 tokens); K4 36 times per prefill and 12 per decode step;
     continuous batching and `PredictableEngine` refuse encdec, as in the
     JAX package;
 10. the cluster: ResNet50-224 compiled for the 1 x 1 mesh of
     scaled_paper_machine(64) and run on the "mesh" backend over a
     one-rank NCCL group, bit-exact against phase 4's megakernel outputs
     at batch 1 and 3, with 54 K6 launches (the tile-table int8 kernel,
     one per tiled op) per program (counters and profiler) and K6 against
     its plain version on rank 0's and rank 3's tiles of a 4-way split;
     the (1, 2) mesh in two processes on the card over gloo (this script
     with `--mesh-rank`), bit-exact against the 1 x 1 mesh, or the gloo
     probe's error; a `ClusterServer` of two replicas on the "cuda"
     backend (24 tickets, one replica shed for the last 8) and one on
     the 1 x 1 mesh, every ticket done and bit-exact, saved and linted by
     `python -m repro_torch.analysis`; the mesh program's latency beside
     the megakernel's, and K6 at each of the program's 54 tiled ops at
     batch 1 and 8 (int32-equal to its plain version, a `[K6 table]`
     line per op class with the kernel's, the bound's and torch._int_mm's
     times), summed over the program beside its bound, and the host's
     time to issue K6 over a program (`[K6 host]`: the wrapper, its plan
     lookup, its library call);
 11. training: K4 under autograd at smollm-135M's training shape (8, 9,
     3, 512, 64), f32 and bf16 (forward bit-equal to the no-grad launch,
     one launch per forward, f32 gradients within rtol 1e-4, atol 1e-5 of
     the plain version's autograd, bf16 within 5e-2 of max|grad| of the
     f32 ones); one float32 `train_step` of smollm-135M at full size, card
     against CPU (loss and gradient norm within rtol 1e-3, params within
     2.5 x the step's learning rate); 40 bf16 steps through
     `repro_torch.launch.train.main` (B 8, S 512: losses finite, the last
     below the first by more than 0.3, a checkpoint on disk, 60 K4
     launches a step); the same run with a failure injected after the
     step-24 checkpoint (one restart, 40 steps, losses after it within
     rtol 1e-2); the (2, 1) data mesh as two processes on the card over
     gloo (this script with `--train-rank`; 4 layers, float32, zero1:
     both ranks' params bit-equal and within rtol 1e-4 of one rank); a
     step's K4 launches (counters and profiler), median time, tokens/s,
     idle share, peak memory and share of the bf16 peak;
 12. tensor parallelism and the dry run: (a) smollm-135M at full width (4
     of 30 layers, float32) on the (1, 3) model mesh as three processes
     on the card over gloo (this script with `--tp-rank`; 3 q heads and 1
     kv head a rank): two ZeRO-1 train steps (whole-gathered leaves within
     rtol 1e-4 of one rank, replicated leaves bit-equal across ranks) and
     a prefill plus 2 decode steps (logits within rtol 1e-3, greedy
     tokens equal), K4 per rank per step (counters and profiler); on the
     same ranks seamless-m4t-medium at full width (2 + 2 layers, float32,
     B 8, source and prompt of 48, a cache of 54), whose 16 heads do not
     divide over 3, so its self-attention cache and its cross-attention
     keys and values are cut on positions: a prefill plus 2 decode steps
     against one rank (logits within rtol 1e-3, tokens equal, 6 K4 per
     prefill and 2 per decode step per rank: the cross attention gathers
     the encoder positions whole for K4); (d) smollm-135M at full width (4 layers, float32)
     with an int8 KV cache of 136 positions on the (1, 2) model mesh as
     two processes on the card (`--kv8-rank`): 3 kv heads do not divide
     over 2, so the cache and its scales are cut on positions; a prefill
     of 8 x 128 plus 2 decode steps against one rank (max |d logits| <=
     4e-3 x max |logits|, the int8 twin's bf16-ulp limit; tokens equal; 4
     K4 per prefill per rank; the gathered int8 cache within 1 of one
     rank's, the prefill's scales within rtol 1e-5 and the decode's within
     the logits' limit); K4 against its plain version at each of
     these paths' shapes; (b) the dry run (`launch.dryrun.lower_cell`,
     --device cuda) of smollm-135m train_4k at B 8 on the 1 x 1 mesh
     against the same step on the card (argument bytes and per-device
     FLOPs equal, predicted memory and the roofline bound printed beside
     the measured ones); and (c) two full-size production cells through
     `python -m repro_torch.launch.dryrun` on the host (smollm-135m
     train_4k on 16 x 16, zamba2-1.2b decode_32k on 2 x 16 x 16) with
     their seconds.

Each LM phase takes its admission period from the modeled bound it
prints, and prints its seconds and peak device memory. Then a `[phases]`
line with every phase's seconds and the run's, one JSON line with every
kernel's numbers, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Details go to chip_smoke.json in the output
directory. Weights and inputs are random, from seeds.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
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

# the SASS opcodes counted in the built libraries
SASS_OPS = ("HMMA", "IMMA", "IGMMA", "IDP", "UTMALDG")

# the kernels each main path must launch (counts read around that path)
CNN_KERNELS = ("gemm_int8", "conv2d_int8", "megakernel")
LM_KERNELS = ("flash_attention", "ssm_scan")

RUNS, WARM = 20, 3
SEED = 0


def fail(msg: str) -> None:
    """Print the failure on both streams (a caller that keeps only the
    end of standard error still sees it) and exit 1."""
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
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


class Clock:
    """Seconds of each phase of the run, taken as laps."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.laps: dict = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = round(now - self.last, 2)
        self.last = now

    def summary(self) -> dict:
        return {**self.laps,
                "total": round(time.perf_counter() - self.start, 2)}


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
    """HMMA / IMMA / IGMMA (int8 wgmma) / IDP (dp4a) / UTMALDG (TMA load)
    instructions in the built K4, K2, K1, K3 and K6 libraries: their
    counts and the distinct forms (opcode with its modifiers)."""
    from repro_torch.kernels import _lib
    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    counts = {}
    for src in ("flash_attention", "conv2d_im2col", "gemm_int8",
                "megakernel", "tiled_int8"):
        text = subprocess.run([str(tool), "-sass",
                               str(out_dir / f"lib{src}.so")],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[src] = {}
        for op in SASS_OPS:
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

# tiny spin kernels that open every profiled window: the profiler loses the
# records of a window's first kernel launches (a block of 14-20 late in a
# long run, whatever kernels they are, with or without idle host time
# before them), so these take the loss and are left out of the events
PROFILE_LEAD_IN = 128


def profile_once(torch, fn):
    """Profile one call of `fn` after a warm-up (a first profiled call
    absorbs the profiler's start-up and is discarded), in a window opened
    by PROFILE_LEAD_IN spin kernels. Returns (device events by kernel short
    name, busy us, profiled wall us of the call alone, events), without
    the spin kernels."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD_IN):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, by_name, names = 0.0, {}, []
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA") and \
                "spin_kernel" not in ev.name:
            us = ev.time_range.elapsed_us()
            busy_us += us
            names.append(ev.name)
            short = ev.name.replace("(anonymous namespace)::", "")
            short = short.split("(")[0].split("<")[0][-60:]
            by_name[short] = by_name.get(short, 0.0) + us
    return by_name, busy_us, wall_us, names


def profile_confirm(torch, fn, count, want, tries=3):
    """`profile_once(fn)` until `count(events)` equals `want` or the
    profiler records no device event, at most `tries` times: should the
    profiler lose more records than the lead-in absorbs, another try shows
    it, while a kernel that did not run is missing from every try. Returns
    profile_once's result of the last try and the counts of every try."""
    seen = []
    for _ in range(tries):
        res = profile_once(torch, fn)
        seen.append(count(res[3]))
        if seen[-1] == want or not res[3]:
            break
    return res, seen


# the K4 parameter sets of tests/test_torch_lm_kernels.py (B, Hq, Hkv, Sq,
# Skv, D), causal, window
K4_TEST_CASES = [((1, 4, 4, 64, 64, 32), True, None),
                 ((2, 8, 2, 100, 100, 64), True, None),
                 ((2, 8, 2, 100, 100, 64), True, 37),
                 ((1, 4, 1, 33, 77, 16), True, None),
                 ((2, 4, 4, 64, 64, 32), False, None),
                 ((2, 8, 2, 1, 100, 64), True, None)]
# K4 on the shapes and modes of the moe and encdec paths: mixtral-8x22b's
# prefill (head dim 128, 6 q heads per kv head, causal, with and without a
# window), seamless-m4t-medium's cross attention at prefill (Sq != Skv,
# non-causal) and in a decode step (Sq = 1, non-causal)
K4_PATH_CASES = [((1, 48, 8, 128, 128, 128), True, None),
                 ((1, 48, 8, 128, 128, 128), True, 37),
                 ((4, 16, 16, 32, 128, 64), False, None),
                 ((4, 16, 16, 1, 128, 64), False, None)]
# K4 timed at the LM paths' own shapes: (what, (B, Hq, Hkv, Sq, Skv, D),
# causal, window)
K4_TIMED = [("zamba2-1.2b prefill, batch 1", (1, 32, 32, 128, 128, 64), True,
             None),
            ("zamba2-1.2b prefill, batch 4", (4, 32, 32, 128, 128, 64), True,
             None),
            ("mixtral-8x22b prefill", (1, 48, 8, 128, 128, 128), True, 4096),
            ("seamless-m4t-medium encoder and cross prefill",
             (4, 16, 16, 128, 128, 64), False, None),
            ("seamless-m4t-medium decoder prefill", (4, 16, 16, 128, 128, 64),
             True, None),
            ("seamless-m4t-medium cross attention, decode step",
             (4, 16, 16, 1, 128, 64), False, None)]


def k4_bound(B, Hq, Hkv, Sq, Skv, D, causal, window, itemsize) -> Bound:
    """K4's bound: q, k, v read once and the output written once, against
    the 2 x 2 x D operations of each (q, kv) pair this mask lets through."""
    offs = Skv - Sq
    pairs = 0
    for i in range(Sq):
        hi = min(Skv - 1, i + offs) if causal else Skv - 1
        lo = max(0, i + offs - window + 1) if window is not None else 0
        pairs += max(0, hi - lo + 1)
    bd = Bound()
    bd.add((2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D) * itemsize,
           4 * B * Hq * D * pairs, PEAK_BF16_FLOPS)
    return bd


def sdpa_call(torch, q, k, v, causal):
    """`scaled_dot_product_attention` on K4's inputs: GQA heads through
    `enable_gqa` where this torch has it, else k and v repeated up front
    (outside the timed call)."""
    F = torch.nn.functional
    g = q.shape[1] // k.shape[1]
    if g > 1:
        try:
            F.scaled_dot_product_attention(q[:, :, :1], k, v,
                                           enable_gqa=True)
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)
        except TypeError:
            k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)


# -- LM serving helpers (zamba2-1.2B and the moe, RWKV and encdec phases) -----

def kernel_counts(per_prefill: dict, per_step: dict, prefills: int,
                  steps: int) -> dict:
    """The LM kernels' expected launches for `prefills` prefills and
    `steps` decode steps."""
    return {k: per_prefill[k] * prefills + per_step[k] * steps
            for k in LM_KERNELS}


def same_counts(counts: dict, want: dict) -> bool:
    """The LM kernels' launch counts in `counts` are `want`'s."""
    return all(counts[k] == want[k] for k in LM_KERNELS)


def admission_period(tag, cfg, params) -> tuple[float, float]:
    """A decode period from the modeled bound that admission computes for
    one slot-batched decode step (4 slots, a cache of 256) on
    scaled_paper_machine(64): twice the bound, rounded up to a millisecond.
    Returns (period_s, bound_s)."""
    from repro_torch.hw import scaled_paper_machine
    from repro_torch.serve import Server
    probe = Server(scaled_paper_machine(64), backend="cuda")
    v = probe.register_decode(tag, cfg, period_s=3600.0, params=params,
                              slots=4, prompt_len=128, max_new_tokens=8,
                              max_len=256)
    return math.ceil(v.response_bound_s * 2e3) / 1e3, v.response_bound_s


def serve_tickets(torch, tag, cfg, params, prompts, new_tokens, period_s,
                  per_prefill, per_step):
    """`Server.register_decode` with 4 slots: 4 tickets before the first
    step and 4 mid-stream, each done with `new_tokens` tokens. The launch
    counts are read around the serving loop alone, and must be the
    kernels' launches per prefill and per decode step times the prefills
    and decode steps run."""
    from repro_torch.hw import scaled_paper_machine
    from repro_torch.kernels import _lib
    from repro_torch.serve import Server
    srv = Server(scaled_paper_machine(64), backend="cuda")
    t0 = time.perf_counter()
    verdict = srv.register_decode(
        tag, cfg, period_s=period_s, params=params, slots=4,
        prompt_len=128, max_new_tokens=new_tokens, max_len=256)
    say(f"[lm] admitted {cfg.name} ({cfg.dtype}) in "
        f"{time.perf_counter() - t0:.2f} s: modeled bound of one decode "
        f"step on the modeled RISC-V machine "
        f"{verdict.response_bound_s * 1e3:.3f} ms, period "
        f"{period_s * 1e3:g} ms")
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    tickets = [srv.submit(tag, prompts[i]) for i in range(4)]
    jobs = 0
    while not all(t.terminal for t in tickets) or len(tickets) < 8:
        srv.step()
        jobs += 1
        if jobs == 3:                        # 4 arrive mid-stream
            tickets += [srv.submit(tag, prompts[i]) for i in range(4, 8)]
        if jobs > 1000:
            fail(f"the {cfg.name} server did not finish 8 tickets in 1000 "
                 f"jobs")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _lib.launch_counts()
    tele = srv.telemetry()["continuous"][tag]
    for t in tickets:
        if t.status != "done":
            fail(f"{cfg.name} ticket {t.tid} ended {t.status}: {t.error}")
        if len(t.result().output) != new_tokens:
            fail(f"{cfg.name} ticket {t.tid}: {len(t.result().output)} "
                 f"tokens")
    want = kernel_counts(per_prefill, per_step, tele["prefills"],
                         tele["decode_steps"])
    if not same_counts(counts, want):
        fail(f"{cfg.name} serving launched {counts} for {tele['prefills']} "
             f"prefills and {tele['decode_steps']} decode steps (expected "
             f"{per_prefill} per prefill, {per_step} per decode step)")
    return srv, verdict, tickets, jobs, wall_s, counts, tele


def oracle(cfg, params, prompts, new_tokens):
    """The streams of `ServeEngine.serve(batch_size=4)` on the card, every
    prompt left-padded to 128 tokens."""
    from repro_torch.serve.engine import Request, ServeEngine
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    ServeEngine(cfg, params, batch_size=4, max_len=256).serve(
        reqs, prompt_len=128)
    return [r.out for r in reqs]


def f32_server_equals_oracle(torch, tag, cfg32, p_dev, prompts, period_s,
                             per_prefill, per_step) -> float:
    """The continuous-batching path exactly: per-row pos, the clamped
    per-row cache writes and each slot's own state, on a float32 copy,
    where only the float32 rounding of another GEMM shape separates the
    Server's schedule from the oracle's. Every stream must be equal."""
    _, _, tickets, _, wall_s, _, _ = serve_tickets(
        torch, tag, cfg32, p_dev, prompts, 8, period_s, per_prefill,
        per_step)
    want = oracle(cfg32, p_dev, prompts, 8)
    for t, w in zip(tickets, want):
        if t.result().output != w:
            fail(f"{cfg32.name} float32 Server ticket {t.tid} gave "
                 f"{t.result().output}, ServeEngine.serve {w}")
    say(f"[lm] {cfg32.name} float32 through Server.register_decode: 8 of 8 "
        f"streams (8 tokens each, 4 tickets mid-stream) equal "
        f"ServeEngine.serve(batch_size=4) token for token ({wall_s:.2f} s)")
    return wall_s


class RouterLog:
    """Records the moe routers' expert ids and probabilities while active
    (wraps `repro_torch.models.moe._router`, which every dispatch calls)."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._orig = moe, moe._router

        def rec(p, x, cfg):
            gate, idx, aux = self._orig(p, x, cfg)
            probs = self.torch.softmax(x.float() @ p["router"].float(), -1)
            self.calls.append((idx.cpu(), probs.cpu()))
            return gate, idx, aux

        moe._router = rec
        return self

    def __exit__(self, *exc):
        self._moe._router = self._orig


# a routing difference between the card and the CPU is a near-tie flip if
# the two experts' probabilities differ by less than this on the CPU
FLIP_GAP = 1e-4


def card_vs_cpu(torch, lm, cfg32, p_dev, p_cpu, toks, steps, max_len):
    """Prefill of `toks` and `steps` greedy decode steps of a float32 copy,
    on the card and on the CPU (teacher-forced by the card's tokens): the
    logits within rtol 1e-3 / atol 1e-3 max|logits| and the greedy tokens
    equal. An encdec encoder reads `toks` as its source tokens. For moe,
    the routers' top-k expert ids are compared before the logits: a step
    whose routing differs at a near-tie (`FLIP_GAP`) is reported as a flip
    with the two probabilities, and its logits and those after it are not
    held. Returns the card's launch counts of the prefill and of each
    decode step."""
    from repro_torch.kernels import _lib
    from repro_torch.models import decode_step, init_cache, prefill_step
    dev = torch.device("cuda")
    B, S = toks.shape
    sides = {}
    for side, p_, d_ in (("card", p_dev, dev), ("cpu", p_cpu, "cpu")):
        with RouterLog(torch) as log:
            _lib.reset_launch_counts()
            t0 = time.perf_counter()
            batch = {"tokens": torch.as_tensor(toks, device=d_)}
            if cfg32.family == "encdec":
                batch["src_tokens"] = batch["tokens"]
            logits, cache = prefill_step(cfg32)(
                p_, batch, init_cache(cfg32, B, max_len, enc_len=S,
                                      device=d_))
            outs = [logits.cpu()]
            counts = [_lib.launch_counts()]
            for _ in range(steps):
                tok = torch.argmax(outs[-1][:, -1], dim=-1)[:, None]
                if side == "cpu":               # teacher-forced by the card
                    tok = torch.argmax(sides["card"]["logits"][len(outs) - 1]
                                       [:, -1], dim=-1)[:, None]
                _lib.reset_launch_counts()
                logits, cache = decode_step(cfg32)(p_, cache, tok.to(d_))
                outs.append(logits.cpu())
                counts.append(_lib.launch_counts())
        sides[side] = {"logits": outs, "counts": counts, "router": log.calls,
                       "s": time.perf_counter() - t0}
    held = steps + 1
    flips = []
    per_step = max(1, cfg32.num_layers)
    for c, ((ic, _), (iu, pu)) in enumerate(zip(sides["card"]["router"],
                                                sides["cpu"]["router"])):
        rows = (ic != iu).any(-1).reshape(-1)
        if not rows.any():
            continue
        flat_c, flat_u = ic.reshape(-1, ic.shape[-1]), iu.reshape(-1,
                                                                  iu.shape[-1])
        probs = pu.reshape(-1, pu.shape[-1])
        for t in rows.nonzero().reshape(-1).tolist():
            ids = sorted(set(flat_c[t].tolist()) ^ set(flat_u[t].tolist())
                         or set(flat_c[t].tolist()))
            a, b = ids[0], ids[-1]
            pa, pb = probs[t, a].item(), probs[t, b].item()
            flips.append({"step": c // per_step, "layer": c % per_step,
                          "token": t, "experts": [a, b], "probs": [pa, pb]})
            say(f"[lm] {cfg32.name} float32 router flip at step "
                f"{c // per_step}, layer {c % per_step}, token {t}: experts "
                f"{a} and {b} with CPU probabilities {pa:.9f} and {pb:.9f}")
            if abs(pa - pb) >= FLIP_GAP:
                fail(f"{cfg32.name} float32: card and CPU route token {t} "
                     f"of step {c // per_step} to different experts at a "
                     f"probability gap of {abs(pa - pb):.3g} (not a "
                     f"near-tie, < {FLIP_GAP})")
        held = min(held, c // per_step)
    for i, (ld, lc) in enumerate(zip(sides["card"]["logits"],
                                     sides["cpu"]["logits"])):
        if i >= held:
            break
        atol = 1e-3 * lc.abs().max().item()
        err = (ld - lc).abs().max().item()
        what = "prefill" if i == 0 else f"decode step {i}"
        if not torch.allclose(ld, lc, rtol=1e-3, atol=atol):
            fail(f"{cfg32.name} float32 {what}: card logits differ from the "
                 f"CPU's (max abs err {err}, atol {atol})")
        if not torch.equal(ld[:, -1].argmax(-1), lc[:, -1].argmax(-1)):
            fail(f"{cfg32.name} float32 {what}: greedy tokens differ")
        lm["checks"].append({"model": f"{cfg32.name} f32", "step": what,
                             "max_abs_err": err, "atol": atol})
    routed = (f"; routers' top-{cfg32.top_k} expert ids equal at every "
              f"layer and step" if cfg32.family == "moe" and not flips
              else f"; {len(flips)} router flips at near-ties, steps from "
              f"{held} on not held" if flips else "")
    say(f"[lm] {cfg32.name} float32: prefill ({B} x {S} tokens) + {steps} "
        f"decode steps, card logits within rtol 1e-3 / atol 1e-3 "
        f"max|logits| of the CPU's and greedy tokens equal{routed} (card "
        f"{sides['card']['s']:.2f} s, CPU {sides['cpu']['s']:.2f} s)")
    lm.setdefault("router_flips", {})[cfg32.name] = flips
    return sides["card"]["counts"]


def bf16_streams(torch, cfg, params, prompts, tickets, want) -> dict:
    """A diagnostic, not a gate: how far bf16 rounding carries the Server's
    streams from the oracle's. LMBackend prefills each prompt alone (GEMMs
    with M = 128), the oracle four at once (M = 512); with random weights
    the layers amplify bf16 rounding far beyond one ulp of the logits, so
    greedy streams flip wherever the top-2 margin is inside this noise."""
    from repro_torch.models import init_cache, prefill_step
    dev = torch.device("cuda")
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
    say(f"[lm] {cfg.name} bf16 prefill logits, batch 1 vs batch 4 on the "
        f"same 8 prompts: |difference| median {noise[0.5]:.4g}, 99th "
        f"percentile {noise[0.99]:.4g}, max {noise['max']:.4g} (max |logit| "
        f"{l4.abs().max().item():.3g})")
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
    say(f"[lm] {cfg.name} bf16: {same} of 8 streams equal ServeEngine.serve("
        f"batch_size=4) token for token; the rest first differ at top-2 "
        f"margins {[round(m_, 4) for m_ in margins]}, {inside} of them below "
        f"the 99th percentile of the noise (the float32 run holds this "
        f"path to the oracle exactly)")
    return {"streams_equal_oracle": same, "stream_margins": margins,
            "prefill_noise": {str(k_): v_ for k_, v_ in noise.items()}}


def backend_steps(backend, prompts):
    """A batch-1 prefill and one 4-slot decode step of a Server's
    `LMBackend`, the slots filled with the first four prompts."""
    import numpy as np
    cache = backend.init_cache()
    for slot in range(4):
        cache = backend.insert(backend.prefill(prompts[slot])[1], cache,
                               slot)
    prev = np.array([5, 6, 7, 8], np.int32)
    valid = np.ones(4, bool)
    lengths = np.ones(4, np.int32)
    return (lambda: backend.prefill(prompts[0]),
            lambda: backend.generate(cache, prev, valid, lengths))


def step_timings(torch, name, what_prefill, prefill_once, decode_once,
                 per_prefill, per_step, rows=4) -> dict:
    """Launches, host times (median of RUNS, to the result on the host or
    a synchronize) and the profiler's view of one prefill and one decode
    step of `rows` rows. The launches of each must be `per_prefill` and
    `per_step`, and the profiler must see the same."""
    from repro_torch.kernels import _lib
    got = {}
    for what, fn in (("prefill", prefill_once), ("decode step", decode_once)):
        _lib.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        got[what] = _lib.launch_counts()
    if not (same_counts(got["prefill"], per_prefill) and
            same_counts(got["decode step"], per_step)):
        fail(f"{name}: launches per prefill {got['prefill']}, per decode "
             f"step {got['decode step']}: expected {per_prefill} and "
             f"{per_step}")
    prefill_ms = host_ms(torch, prefill_once)
    step_ms = host_ms(torch, decode_once)
    say(f"[lm] {name}, {what_prefill}: {prefill_ms:.3f} ms (launches "
        f"{got['prefill']}); {rows}-row decode step: median {step_ms:.3f} ms "
        f"(launches {got['decode step']}), {rows * 1e3 / step_ms:.1f} "
        f"tokens/s")
    profiles = {}
    for what, fn, want, unprof_ms in (
            ("decode step", decode_once, per_step, step_ms),
            ("prefill", prefill_once, per_prefill, prefill_ms)):
        want_lm = {k: want[k] for k in LM_KERNELS}
        (by_name, busy_us, wall_us, names), tries = profile_confirm(
            torch, fn, lambda ns: {k: sum(f"{k}_kernel" in nm for nm in ns)
                                   for k in LM_KERNELS}, want_lm)
        seen = tries[-1]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        unprof_us = unprof_ms * 1e3
        say(f"[lm] {name} profiled {what}: {len(names)} device events, busy "
            f"{busy_us:.0f} us; profiled wall {wall_us:.0f} us, unprofiled "
            f"median {unprof_us:.0f} us (idle share "
            f"{1 - busy_us / unprof_us:.3f}); kernels seen {seen} "
            f"(profiled {len(tries)}x); top: "
            + "; ".join(f"{k} {v:.0f} us" for k, v in top))
        if names and seen != want_lm:
            fail(f"profiler saw {tries} kernel launches in one {name} {what} "
                 f"({len(tries)} tries), expected {want_lm}")
        if not names:
            say(f"[lm] profiler recorded no device events for the {what}; "
                "launches rest on the wrapper counters")
        profiles[what] = {"device_events": len(names), "busy_us": busy_us,
                          "profiled_wall_us": wall_us,
                          "unprofiled_us": unprof_us, "kernels_seen": seen,
                          "idle_share": 1 - busy_us / unprof_us,
                          "top_us": top}
    return {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "decode_tokens_per_s": rows * 1e3 / step_ms,
            "per_prefill": got["prefill"], "per_decode_step":
            got["decode step"], "profile": profiles}


def load_params(torch, tag, cfg, cut=""):
    """`init_params` on the card from the run's seed, with its size."""
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    p = init_params(cfg, torch.Generator("cuda").manual_seed(SEED))
    n = sum(t.numel() for t in _leaves(p))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(p))
    say(f"[{tag}] {cfg.name} {cfg.dtype}{cut}: {n / 1e9:.3f} B params, "
        f"{nbytes / 1e9:.1f} GB on the card in {time.perf_counter() - t0:.1f} "
        f"s")
    return p, n


def phase_end(torch, tag, t_phase, out: dict) -> None:
    """Print and keep a model phase's seconds and peak device memory (the
    largest `torch.cuda.max_memory_allocated()` read at its `free`s)."""
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{tag}] phase {out['phase_s']:.1f} s, "
        f"torch.cuda.max_memory_allocated {out['max_memory_allocated_gb']:.1f}"
        f" GB")


def free(torch, out: dict | None = None) -> None:
    """Release the card's cached blocks; first keep the peak since the last
    reset in `out["max_memory_allocated_gb"]` (the larger of the two)."""
    import gc
    if out is not None:
        out["max_memory_allocated_gb"] = max(
            out.get("max_memory_allocated_gb", 0.0),
            torch.cuda.max_memory_allocated() / 1e9)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def lm_phase(torch, np, rng, kernels, report, smi, rtdep, clock) -> dict:
    """Phase 6. Returns the kernel launch counts of the LM serving run."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
    from repro_torch.models import init_params, params_to

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
    for (B, Hq, Hkv, Sq, Skv, D), causal, window in (K4_TEST_CASES
                                                     + K4_PATH_CASES):
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
    say(f"[K4] f32: {n} checks on the CPU tests' and the moe and encdec "
        f"paths' shapes within atol 3e-5, "
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
        for (B, Hq, Hkv, Sq, Skv, D), causal, window in (K4_TEST_CASES
                                                         + K4_PATH_CASES):
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
        say(f"[K4] {name} (tensor cores): {n} checks on the CPU tests' and "
            f"the moe and encdec paths' shapes within atol {atol}, rtol "
            f"{rtol} (max abs err {worst:.3g})")
    for what, (B, Hq, Hkv, Sq, Skv, D), causal, window in K4_TIMED:
        q = randn(B, Hq, Sq, D, dtype=torch.bfloat16)
        k, v = (randn(B, Hkv, Skv, D, dtype=torch.bfloat16)
                for _ in range(2))
        shape = (B, Hq, Hkv, Sq, Skv, D)
        err = close(f"K4 bf16 {what} {shape}",
                    flash_attention(q, k, v, causal=causal, window=window),
                    flash_attention_plain(q, k, v, causal, window), 2e-2,
                    0.0 if what.startswith("zamba2") else 1e-2)
        k4["max_abs_err"] = max(k4["max_abs_err"], err)
        ms = graph_ms(torch, lambda: flash_attention(
            q, k, v, causal=causal, window=window))
        pms = graph_ms(torch, lambda: flash_attention_plain(
            q, k, v, causal, window))
        # the window of 4096 reaches past every row of a 128-token prompt:
        # SDPA's causal mask is the same mask there
        lib_ms = graph_ms(torch, sdpa_call(torch, q, k, v, causal))
        bd = k4_bound(*shape, causal, window, 2)
        say(f"[K4] bf16 {what} {shape} causal={causal} window={window}: "
            f"max abs err {err:.3g} (atol 2e-2); device time (CUDA "
            f"graph) kernel {ms:.4f} ms, plain {pms:.4f} ms, library "
            f"(scaled_dot_product_attention) {lib_ms:.4f} ms, bound "
            f"{bd.ms:.5f} ms ({bd.by})")
        lm["checks"].append({"kernel": "flash_attention", "path": what,
                             "shape": list(shape), "causal": causal,
                             "window": window, "dtype": "bf16",
                             "max_abs_err": err, "ms": ms, "plain_ms": pms,
                             "library_ms": lib_ms, "bound_ms": bd.ms,
                             "bound_by": bd.by})
        if what == "zamba2-1.2b prefill, batch 1":
            k4.update(ms=ms, plain_ms=pms, library_ms=lib_ms, bound_ms=bd.ms,
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
        k5_fns = [lambda s_=s_: ssm_scan(*s_) for s_ in sets]
        ms = graph_ms(torch, k5_fns)
        pms = graph_ms(torch, [lambda s_=s_: ssm_scan_plain(*s_)
                               for s_ in sets])
        lib_ms = None
        if T == 1 and with_h0:
            close("torch.addcmul as K5 at T = 1",
                  torch.addcmul(x, a, h0[:, None]),
                  ssm_scan_plain(a, x, h0), 1e-6, 1e-5)
            lib_fns = [lambda s_=s_: torch.addcmul(s_[1], s_[0],
                                                   s_[2][:, None])
                       for s_ in sets]
            # the two within 0.1 us of each other: five turns each, in
            # alternation, and the medians kept
            turns = {"k5": [], "addcmul": []}
            for _ in range(5):
                turns["k5"].append(graph_ms(torch, k5_fns))
                turns["addcmul"].append(graph_ms(torch, lib_fns))
            ms = statistics.median(turns["k5"])
            lib_ms = statistics.median(turns["addcmul"])
            k5["turns"] = turns
            say(f"[K5] against torch.addcmul at {(B, T, D)}, five turns "
                f"each (ms): K5 " + ", ".join(f"{t:.5f}" for t in
                                              turns["k5"])
                + "; addcmul " + ", ".join(f"{t:.5f}" for t in
                                           turns["addcmul"]))
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

    clock.lap("6a-6b LM kernels")

    # -- 6c. zamba2-1.2B at full width, float32 copy -------------------------
    cfg = get_config("zamba2-1.2b")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    # K4 once per shared-attention application (6), K5 once per Mamba2
    # layer in a decode step (38)
    n_k4, n_k5 = cfg.num_layers // cfg.attn_every, cfg.num_layers
    per_prefill = {"flash_attention": n_k4, "ssm_scan": 0}
    per_step = {"flash_attention": 0, "ssm_scan": n_k5}
    # the 8 prompts (16-128 tokens) that both Server runs below answer
    lens = rng.integers(16, 129, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]

    p_dev, _ = load_params(torch, "lm", cfg32, " copy")
    p_cpu = params_to(p_dev, "cpu")
    toks = rng.integers(1, cfg.vocab_size, (1, 32))
    counts = card_vs_cpu(torch, lm, cfg32, p_dev, p_cpu, toks, 4, 64)
    if counts[0]["flash_attention"] != n_k4:
        fail(f"zamba2 float32 prefill launched K4 "
             f"{counts[0]['flash_attention']} times, expected {n_k4}")
    del p_cpu
    wall_s = f32_server_equals_oracle(torch, "zamba2", cfg32, p_dev, prompts,
                                      0.1, per_prefill, per_step)
    lm["f32_server"] = {"streams_equal_oracle": 8, "wall_s": wall_s}
    del p_dev
    torch.cuda.empty_cache()

    # -- 6d. the main path: zamba2-1.2B in bf16 through the Server -----------
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED))
    srv, verdict, tickets, jobs, wall_s, lm_counts, tele = serve_tickets(
        torch, "zamba2", cfg, params, prompts, 32, 0.1, per_prefill,
        per_step)
    for k in LM_KERNELS:
        if lm_counts[k] == 0:
            fail(f"kernel {k} was not launched on the LM serving path")
    n_tok = sum(len(t.result().output) for t in tickets)
    say(f"[lm] Server: 8 tickets done, 32 tokens each, in {jobs} jobs "
        f"({tele['prefills']} prefills, {tele['decode_steps']} decode "
        f"steps, {wall_s:.2f} s, {n_tok / wall_s:.1f} tokens/s end to end); "
        f"launches {lm_counts}")
    streams = bf16_streams(torch, cfg, params, prompts, tickets,
                           oracle(cfg, params, prompts, 32))
    timing = step_timings(
        torch, "zamba2-1.2b bf16", "batch-1 prefill of 128 tokens",
        *backend_steps(srv._nets["zamba2"].cengine.backend, prompts),
        per_prefill, per_step)
    lm.update(serve={"jobs": jobs, "wall_s": wall_s, "tokens": n_tok,
                     "tokens_per_s": n_tok / wall_s, "launches": lm_counts,
                     "continuous": tele,
                     "streams_equal_oracle": streams["streams_equal_oracle"],
                     "bound_ms": verdict.response_bound_s * 1e3},
              card=smi, **timing,
              prefill_noise=streams["prefill_noise"],
              stream_margins=streams["stream_margins"])

    clock.lap("6c-6d zamba2-1.2b")

    # -- 6e. PredictableEngine on the same bf16 params; the two CLIs ---------
    predictable_step(torch, np, rng, cfg, params, rtdep, lm)
    clock.lap("6e predictable")
    return lm_counts


# the per-program launches of one ResNet50-224 program on the megakernel
# path: K1 (the classifier), K2 (50 tiled convs), K3 (3 fused segments)
DETECTOR_LAUNCHES = {"gemm_int8": 1, "conv2d_int8": 50, "megakernel": 3}
INJECTED = ("InjectedFailure", "InjectedTimeout")


def _cnn_launches(counts, checks, per_program) -> dict:
    """Expected launch counts of a CNN serving run: each network's
    executed programs (its monitor checks) times its launches per
    program."""
    return {k: sum(checks.get(n, 0) * per.get(k, 0)
                   for n, per in per_program.items())
            for k in counts}


def resilience_phase(torch, np, hw, g, params, frames, refs, report) -> dict:
    """Phase 5b. The Server's recovery layer on the card: ResNet50-224
    ("detector", criticality 2) beside a small CNN ("lane", criticality 0)
    under a seeded fault plan on the lane, with bounded retries, a circuit
    breaker and a straggler watchdog. Returns what the modes phase
    reuses."""
    from collections import Counter

    from repro_torch.core import cnn, init_params
    from repro_torch.kernels import _lib
    from repro_torch.serve import (AdmissionError, BreakerPolicy, FaultPlan,
                                   RetryPolicy, Server)

    t_phase = time.perf_counter()
    out_name = g.outputs[0]
    lane_g = cnn.small_cnn()
    lane_params = init_params(lane_g, seed=SEED + 1)
    lane_frames = np.random.default_rng(SEED + 2).integers(
        -64, 64, size=(8,) + lane_g.tensors["input"].shape).astype(np.int8)
    hyperperiods = 10

    def build():
        srv = Server(hw, backend="cuda", device="cuda", queue_capacity=4,
                     queue_policy="drop-oldest")
        srv.register("detector", g, period_s=0.1, slots=4, params=params,
                     criticality=2)
        # the shortest lane period the analysis admits beside the detector
        for period in (0.1, 0.2, 0.4):
            try:
                srv.register("lane", lane_g, period_s=period, slots=1,
                             params=lane_params, criticality=0)
                break
            except AdmissionError:
                continue
        else:
            fail("no lane period up to 0.4 s is admitted beside the "
                 "detector")
        srv.enable_resilience(
            faults=FaultPlan(seed=7, fail_rate=0.35, timeout_rate=0.15,
                             spike_rate=0.1, networks=("lane",)),
            retry=RetryPolicy(max_retries=1),
            breaker=BreakerPolicy(threshold=2, cooldown_jobs=2),
            watchdog_margin=3.0)
        return srv

    def drive(srv):
        det, lane = [], []
        for k in range(hyperperiods):
            det += [srv.submit("detector", frames[(4 * k + i) % len(frames)])
                    for i in range(4)]
            lane += [srv.submit("lane", lane_frames[(2 * k + i) % 8])
                     for i in range(2)]
            srv.run(hyperperiods=1)
        while any(srv.queue_depths().values()):
            srv.run(hyperperiods=1)
        torch.cuda.synchronize()
        return det, lane

    srv = build()
    rep = srv.report
    lane_period = srv._nets["lane"].spec.period_s
    say(f"[resil] admitted detector (ResNet50-224, 4 slots, period 100 ms, "
        f"bound {rep.bound('detector') * 1e3:.3f} ms) and lane (small_cnn, "
        f"1 slot, period {lane_period * 1e3:.0f} ms, bound "
        f"{rep.bound('lane') * 1e3:.3f} ms) on {hw.name}: modeled DMA "
        f"utilisation {rep.dma_utilization:.1%}, core utilisation "
        f"{rep.compute_utilization:.1%}")
    lane_runner = srv._nets["lane"].runner
    _lib.reset_launch_counts()
    lane_runner({"input": lane_frames[:1]})
    torch.cuda.synchronize()
    lane_per = _lib.launch_counts()
    per_program = {"detector": DETECTOR_LAUNCHES, "lane": lane_per}

    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    det, lane = drive(srv)
    wall_s = time.perf_counter() - t0
    counts = _lib.launch_counts()
    checks = dict(srv.monitor.checks)

    for t in det + lane:
        if not t.terminal:
            fail(f"[resil] ticket {t.tid} ({t.network}) ended {t.status}")
    for i, t in enumerate(det):
        if t.status != "done":
            fail(f"[resil] detector ticket {t.tid} ended {t.status}: "
                 f"{t.error}")
        if not np.array_equal(t.result().output[out_name],
                              refs[i % len(frames)][out_name]):
            fail(f"[resil] detector ticket {t.tid} differs from "
                 "reference_forward")
    events = srv.monitor.events
    det_events = events.get("detector", {})
    det_breaker = srv._nets["detector"].breaker
    if det_events.get("retry") or det_events.get("job_failed") or \
            det_breaker.transitions:
        fail(f"[resil] a fault reached the detector: events {det_events}, "
             f"breaker transitions {det_breaker.transitions}")
    errors = [t.error for t in det + lane if t.error is not None]
    foreign = [e for e in errors if not e.startswith(INJECTED)]
    if foreign:
        fail(f"[resil] the recovery layer absorbed errors that were not "
             f"injected (a device fault?): {foreign[:3]}")
    inj = dict(srv.resilience.injector.injected)
    failed_attempts = srv.metrics["retries"] + events.get(
        "lane", {}).get("job_failed", 0)
    if inj["fail"] + inj["timeout"] != failed_attempts:
        fail(f"[resil] {failed_attempts} failed attempts (retries + failed "
             f"jobs) but {inj['fail'] + inj['timeout']} injected raising "
             "faults: an executor call failed on its own")
    want = _cnn_launches(counts, checks, per_program)
    if any(counts[k] != want[k] for k in CNN_KERNELS):
        fail(f"[resil] launches {counts}, expected {want} for "
             f"{checks.get('detector', 0)} detector programs x "
             f"{DETECTOR_LAUNCHES} and {checks.get('lane', 0)} lane "
             f"programs x {lane_per}")

    again = build()
    det2, lane2 = drive(again)
    keys = ("retries", "degraded", "dropped")
    one = ([t.status for t in lane], {k: srv.metrics[k] for k in keys}, inj)
    two = ([t.status for t in lane2], {k: again.metrics[k] for k in keys},
           dict(again.resilience.injector.injected))
    if one != two or [t.status for t in det2] != ["done"] * len(det2):
        fail(f"[resil] a second Server from the same seed differs: {one} "
             f"vs {two}")
    del again

    verdicts = Counter(t.result().verdict.outcome for t in det)
    met = sum(t.result().verdict.met for t in det)
    stragglers = {n: e.get("straggler", 0) for n, e in events.items()
                  if n in ("detector", "lane")}
    lat = [t.result().latency_s * 1e3 for t in det]
    say(f"[resil] {hyperperiods} hyperperiods + drain in {wall_s:.2f} s: "
        f"{len(det)} detector tickets done, bit-exact vs reference_forward, "
        f"{met} of {len(det)} deadlines met (outcomes {dict(verdicts)}; "
        f"latency median {statistics.median(lat):.3f} ms, max "
        f"{max(lat):.3f} ms); lane statuses "
        f"{dict(Counter(t.status for t in lane))}")
    say(f"[resil] injected {inj}; metrics retries {srv.metrics['retries']}, "
        f"degraded {srv.metrics['degraded']}, dropped "
        f"{srv.metrics['dropped']}; lane events {events.get('lane', {})}; "
        f"stragglers {stragglers}; every recorded error injected "
        f"({len(errors)}); a second Server from seed 7 gives the same lane "
        f"statuses, counters and injections")
    say(f"[resil] launches {counts} = {checks.get('detector', 0)} detector "
        f"programs x {DETECTOR_LAUNCHES} + {checks.get('lane', 0)} lane "
        f"programs x {lane_per}; phase {time.perf_counter() - t_phase:.1f} s")
    report["resilience"] = {
        "lane_period_s": lane_period, "wall_s": wall_s, "launches": counts,
        "programs": checks, "injected": inj,
        "metrics": dict(srv.metrics), "events": events,
        "lane_statuses": one[0], "detector_met": met,
        "detector_latency_ms": lat, "stragglers": stragglers,
        "phase_s": time.perf_counter() - t_phase}
    return {"lane_g": lane_g, "lane_params": lane_params,
            "lane_frames": lane_frames, "lane_period": lane_period,
            "lane_per": lane_per}


def modes_phase(torch, np, hw, g, params, frames, refs, lane, report
                ) -> None:
    """Phase 5c. Atomic mode changes on the card: "highway" (detector +
    lane) switched mid-hyperperiod to "parking" (detector at half the rate
    + a "park" CNN), which applies only at the boundary; then an
    unschedulable mode, refused atomically."""
    from repro_torch.core import cnn, init_params
    from repro_torch.kernels import _lib
    from repro_torch.serve import AdmissionError, Mode, ModeNetwork, Server

    t_phase = time.perf_counter()
    out_name = g.outputs[0]
    park_g = cnn.small_cnn()
    park_params = init_params(park_g, seed=SEED + 3)
    highway = Mode("highway", (
        ModeNetwork("detector", g, period_s=0.1, slots=4, params=params,
                    criticality=2),
        ModeNetwork("lane", lane["lane_g"], period_s=lane["lane_period"],
                    params=lane["lane_params"]),
    ))
    parking = Mode("parking", (
        ModeNetwork("detector", g, period_s=0.2, slots=4, params=params,
                    criticality=2),
        ModeNetwork("park", park_g, period_s=0.2, params=park_params,
                    criticality=1),
    ))
    srv = Server(hw, backend="cuda", device="cuda")
    t0 = time.perf_counter()
    srv.switch_mode(highway)             # an idle server applies it now
    say(f"[modes] highway prepared and applied in "
        f"{time.perf_counter() - t0:.2f} s: "
        f"{len(srv.compiled.jobs)} jobs per hyperperiod")

    def check_det(t, i, what):
        if t.status != "done" or not np.array_equal(
                t.result().output[out_name], refs[i][out_name]):
            fail(f"[modes] {what} detector ticket {t.tid}: {t.status}, or "
                 "not bit-exact vs reference_forward")

    lane_t = srv.submit("lane", lane["lane_frames"][0])
    srv.step()                            # now mid-hyperperiod
    if srv._cursor == 0:
        fail("[modes] highway has one job per hyperperiod: no mid-point")
    t0 = time.perf_counter()
    staged_report = srv.switch_mode(parking)
    prepare_s = time.perf_counter() - t0
    staged = srv._staged_mode
    reused = staged.nets["detector"].deployment is \
        srv._nets["detector"].deployment
    devices = {n: st.deployment.device for n, st in staged.nets.items()}
    if set(devices.values()) != {"cuda"}:
        fail(f"[modes] the staged mode was compiled for {devices}")
    if srv.mode_name != "highway" or set(srv.networks) != {"detector",
                                                           "lane"} \
            or not srv.network_status("lane")["departing"]:
        fail("[modes] switch_mode applied before the boundary")
    say(f"[modes] parking staged mid-hyperperiod (cursor {srv._cursor}) in "
        f"{prepare_s:.3f} s (prepare_mode: admission + compile for "
        f"{devices}); detector deployment "
        + ("reused from the program cache (same graph and params)"
           if reused else "compiled anew")
        + f"; lane departing; parking bound of the detector "
        f"{staged_report.bound('detector') * 1e3:.3f} ms")
    while srv._cursor != 0:               # drain under the old schedule
        srv.step()
        if srv.mode_name != "highway":
            fail("[modes] the swap happened before the boundary")
    if lane_t.status != "done":
        fail(f"[modes] the lane ticket did not drain: {lane_t.status}")
    lane_late = [srv.submit("lane", lane["lane_frames"][i]) for i in (1, 2)]
    det_t = [srv.submit("detector", frames[i]) for i in range(4)]
    base_checks = dict(srv.monitor.checks)
    _lib.reset_launch_counts()
    srv.step()                            # the boundary: swap, then run
    if srv.mode_name != "parking" or set(srv.networks) != {"detector",
                                                           "park"}:
        fail(f"[modes] no swap at the boundary: mode {srv.mode_name}")
    park_t = srv.submit("park", lane["lane_frames"][3])
    srv.run(hyperperiods=2)
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    checks = {n: srv.monitor.checks.get(n, 0) - base_checks.get(n, 0)
              for n in ("detector", "park")}
    for t in lane_late:
        if t.status != "dropped":
            fail(f"[modes] lane ticket {t.tid} queued at the swap ended "
                 f"{t.status}")
    for i, t in enumerate(det_t):
        check_det(t, i, "carried-over")
        r = t.result()
        if not (r.release_s >= srv.clock_base_s > 0) or \
                r.response_bound_s != srv.report.bound("detector"):
            fail(f"[modes] detector ticket {t.tid}: release "
                 f"{r.release_s}, clock base {srv.clock_base_s}, bound "
                 f"{r.response_bound_s} (parking's "
                 f"{srv.report.bound('detector')})")
    if park_t.status != "done":
        fail(f"[modes] park ticket ended {park_t.status}")
    want = _cnn_launches(counts, checks, {"detector": DETECTOR_LAUNCHES,
                                          "park": lane["lane_per"]})
    if any(counts[k] == 0 or counts[k] != want[k] for k in CNN_KERNELS):
        fail(f"[modes] launches after the swap {counts}, expected {want}")
    say(f"[modes] swap at the boundary: mode {srv.mode_name}, 2 lane "
        f"tickets dropped, 4 carried-over detector tickets bit-exact under "
        f"parking (release >= clock base {srv.clock_base_s:.3f} s); "
        f"launches after the swap {counts} = {checks['detector']} detector "
        f"programs x {DETECTOR_LAUNCHES} + {checks['park']} park programs")

    nets, mode, rep = list(srv.networks), srv.mode_name, srv.report
    bound = rep.bound("detector")
    bad = Mode("impossible", (
        ModeNetwork("detector", g, period_s=bound / 2, slots=4,
                    params=params, criticality=2),))
    try:
        srv.switch_mode(bad)
        fail("[modes] a detector period of half its bound was admitted")
    except AdmissionError:
        pass
    if (list(srv.networks), srv.mode_name) != (nets, mode) or \
            srv.report is not rep or srv._staged_mode is not None:
        fail("[modes] the refused mode changed the server")
    t = srv.submit("detector", frames[4])
    srv.run(hyperperiods=1)
    torch.cuda.synchronize()
    check_det(t, 4, "post-refusal")
    say(f"[modes] a detector period of {bound / 2 * 1e3:.3f} ms (half its "
        f"bound) raises AdmissionError; networks, mode and serving "
        f"untouched (next ticket bit-exact); mode switches "
        f"{srv.metrics['mode_switches']}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    report["modes"] = {"prepare_s": prepare_s, "detector_reused": reused,
                       "launches_after_swap": counts, "programs": checks,
                       "clock_base_s": srv.clock_base_s,
                       "phase_s": time.perf_counter() - t_phase}


def predictable_step(torch, np, rng, cfg, params, rtdep, lm) -> None:
    """Phase 6e. `PredictableEngine` on the bf16 zamba2-1.2B params: every
    decode step checked against the per-token WCET bound; then the two
    CLIs, `repro_torch.launch.serve --analyze-only` and, in a subprocess,
    `python -m repro_torch.analysis` on the saved ResNet50-224
    deployment."""
    import contextlib
    import io
    import os

    from repro_torch.kernels import _lib
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import PredictableEngine, Request

    t_phase = time.perf_counter()
    n_k4, n_k5 = cfg.num_layers // cfg.attn_every, cfg.num_layers
    lens = rng.integers(16, 129, size=4)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    eng = PredictableEngine(cfg, params, batch_size=4, max_len=256)
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.generate([Request(rid=i, prompt=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _lib.launch_counts()
    m = eng.metrics
    if any(len(r.out) != 8 for r in done):
        fail(f"[predictable] streams of {[len(r.out) for r in done]} tokens")
    if eng.deadline_checks != m["decode_steps"]:
        fail(f"[predictable] {eng.deadline_checks} deadline checks for "
             f"{m['decode_steps']} decode steps")
    if counts["flash_attention"] != n_k4 * m["prefills"] or \
            counts["ssm_scan"] != n_k5 * m["decode_steps"]:
        fail(f"[predictable] launches {counts} for {m['prefills']} prefills "
             f"and {m['decode_steps']} decode steps (expected {n_k4} K4 per "
             f"prefill, {n_k5} K5 per decode step)")
    say(f"[predictable] PredictableEngine {cfg.name} {cfg.dtype}, 4 prompts "
        f"({sorted(int(n) for n in lens)} tokens), 8 new tokens: "
        f"{m['prefills']} prefill, {m['decode_steps']} decode steps, "
        f"{eng.deadline_checks} deadline checks, {eng.deadline_misses} "
        f"misses; per-token WCET {eng.report.per_token_wcet_s * 1e3:.3f} ms "
        f"on the modeled {eng.report.wcet.hw_name} (speed ratio "
        f"{eng.monitor.speed_ratio:.4g}); {wall_s:.2f} s; launches {counts}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", "zamba2-1.2b", "--analyze-only"])
    for line in out.getvalue().splitlines():
        say(f"[predictable] launch.serve --analyze-only: {line.strip()}")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          str(rtdep)], env=env, capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"[predictable] python -m repro_torch.analysis exited "
             f"{res.returncode}: {res.stdout[-500:]} {res.stderr[-500:]}")
    say(f"[predictable] python -m repro_torch.analysis "
        f"{rtdep.relative_to(ROOT)}: exit 0, "
        f"{res.stdout.strip().splitlines()[-1]}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    lm["predictable"] = {
        "prefills": m["prefills"], "decode_steps": m["decode_steps"],
        "deadline_checks": eng.deadline_checks,
        "deadline_misses": eng.deadline_misses,
        "per_token_wcet_s": eng.report.per_token_wcet_s,
        "speed_ratio": eng.monitor.speed_ratio, "wall_s": wall_s,
        "launches": counts, "phase_s": time.perf_counter() - t_phase}


def served_family(torch, rng, tag, out, cfg32, cfg16, toks, steps, per,
                  cut32=" copy", cut16=""):
    """A decoder-only family through the Server: a float32 copy (`cfg32`)
    card against CPU on `toks` with `steps` decode steps, and through
    `Server.register_decode` against `ServeEngine.serve`; then `cfg16`
    (bf16) through the Server, with the streams against the oracle beside
    the bf16 noise, step times and the profiler's view. `per(cfg)` gives
    the kernels' launches per prefill and per decode step. Each admission
    period comes from the modeled bound it prints. Returns the bf16 Server
    run's launch counts."""
    from repro_torch.models import params_to

    lens = rng.integers(16, 129, size=8)
    prompts = [rng.integers(1, cfg16.vocab_size, size=int(n)).tolist()
               for n in lens]
    p_dev, _ = load_params(torch, tag, cfg32, cut32)
    p_cpu = params_to(p_dev, "cpu")
    counts = card_vs_cpu(torch, out, cfg32, p_dev, p_cpu, toks, steps, 64)
    pre, step = per(cfg32)
    if not same_counts(counts[0], pre) or \
            not all(same_counts(c, step) for c in counts[1:]):
        fail(f"{cfg32.name} float32 launches {counts}: expected {pre} per "
             f"prefill and {step} per decode step")
    del p_cpu
    period, bound = admission_period(tag, cfg32, p_dev)
    say(f"[{tag}] float32 admission: modeled bound {bound * 1e3:.3f} ms, "
        f"period {period * 1e3:g} ms")
    out["f32_server_wall_s"] = f32_server_equals_oracle(
        torch, tag, cfg32, p_dev, prompts, period, pre, step)
    del p_dev
    free(torch, out)

    params, n_params = load_params(torch, tag, cfg16, cut16)
    pre, step = per(cfg16)
    period, bound = admission_period(tag, cfg16, params)
    say(f"[{tag}] bf16 admission: modeled bound {bound * 1e3:.3f} ms, period "
        f"{period * 1e3:g} ms")
    srv, verdict, tickets, jobs, wall_s, counts, tele = serve_tickets(
        torch, tag, cfg16, params, prompts, 32, period, pre, step)
    n_tok = sum(len(t.result().output) for t in tickets)
    none = "" if any(counts[k] for k in LM_KERNELS) else (
        " (plain torch on the card: no kernel of the port on this path)")
    say(f"[{tag}] Server bf16: 8 of 8 tickets done, 32 tokens each, in "
        f"{jobs} jobs ({tele['prefills']} prefills, {tele['decode_steps']} "
        f"decode steps, {wall_s:.2f} s, {n_tok / wall_s:.1f} tokens/s end "
        f"to end); launches {counts}{none}")
    streams = bf16_streams(torch, cfg16, params, prompts, tickets,
                           oracle(cfg16, params, prompts, 32))
    timing = step_timings(
        torch, f"{cfg16.name} bf16", "batch-1 prefill of 128 tokens",
        *backend_steps(srv._nets[tag].cengine.backend, prompts), pre, step)
    out.update(params=n_params, period_s=period, bound_ms=bound * 1e3,
               serve={"jobs": jobs, "wall_s": wall_s, "tokens": n_tok,
                      "tokens_per_s": n_tok / wall_s, "launches": counts,
                      "continuous": tele}, **streams, **timing)
    del params, srv
    free(torch, out)
    return counts


def rwkv_phase(torch, np, rng, report) -> dict:
    """Phase 7. rwkv6-1.6B (the RWKV `ssm` family) at full width and depth
    through `served_family`. The family launches no kernel (its WKV scan
    is plain torch, as it is plain JAX in the JAX package): every count
    stays 0."""
    import dataclasses

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    out: dict = {"checks": []}
    report["rwkv"] = out
    cfg = get_config("rwkv6-1.6b")
    zero = {k: 0 for k in LM_KERNELS}
    say(f"[rwkv] rwkv6-1.6b at full width and depth: {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}")
    counts = served_family(
        torch, rng, "rwkv", out, dataclasses.replace(cfg, dtype="float32"),
        cfg, rng.integers(1, cfg.vocab_size, (4, 32)), 4,
        lambda c: (zero, zero))
    phase_end(torch, "rwkv", t_phase, out)
    return counts


# mixtral-8x22b's depth cuts: 8 of 56 layers in bf16 for the served path,
# 1 layer in float32 for the card-vs-CPU check (the 56 layers, 140.6e9
# parameters, do not fit one 80 GB card)
MIXTRAL_LAYERS_BF16, MIXTRAL_LAYERS_F32 = 8, 1


def mixtral_phase(torch, np, rng, report) -> dict:
    """Phase 8. mixtral-8x22b (the moe family) at full width, depth cut,
    through `served_family`: 1 layer in float32 (routers compared before
    logits), 8 layers in bf16; K4 once per layer in a prefill and never in
    a decode step."""
    import dataclasses

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    out: dict = {"checks": []}
    report["mixtral"] = out
    cfg = get_config("mixtral-8x22b")
    say(f"[mixtral] mixtral-8x22b at full width: d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd}, "
        f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, top-{cfg.top_k}, "
        f"dispatch {cfg.moe_dispatch}, window {cfg.sliding_window}, vocab "
        f"{cfg.vocab_size}; depth cut to {MIXTRAL_LAYERS_BF16} of "
        f"{cfg.num_layers} layers in bf16 and {MIXTRAL_LAYERS_F32} in "
        f"float32 (all {cfg.num_layers}: {cfg.param_count() / 1e9:.1f} B "
        f"params, {cfg.param_count() * 2 / 1e9:.0f} GB in bf16, more than "
        f"one 80 GB card)")
    counts = served_family(
        torch, rng, "mixtral", out,
        dataclasses.replace(cfg, num_layers=MIXTRAL_LAYERS_F32,
                            dtype="float32"),
        dataclasses.replace(cfg, num_layers=MIXTRAL_LAYERS_BF16),
        rng.integers(1, cfg.vocab_size, (4, 16)), 2,
        lambda c: ({"flash_attention": c.num_layers, "ssm_scan": 0},
                   {"flash_attention": 0, "ssm_scan": 0}),
        f", {MIXTRAL_LAYERS_F32} layer", f", {MIXTRAL_LAYERS_BF16} layers")
    out["layers"] = MIXTRAL_LAYERS_BF16
    phase_end(torch, "mixtral", t_phase, out)
    return counts


def seamless_phase(torch, np, rng, report) -> dict:
    """Phase 9. seamless-m4t-medium (the encdec family) at full width and
    depth: a float32 copy card against CPU, then bf16 through
    `ServeEngine.serve`, K4 in every encoder, decoder and cross attention
    of a prefill (36) and in every cross attention of a decode step (12).
    Continuous batching and `PredictableEngine` refuse encdec in both
    packages. Returns the bf16 run's launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import (decode_step, init_cache, params_to,
                                    prefill_step)
    from repro_torch.serve import PredictableEngine
    from repro_torch.serve.continuous import LMBackend
    from repro_torch.serve.engine import Request, ServeEngine

    t_phase = time.perf_counter()
    out: dict = {"checks": []}
    report["seamless"] = out
    dev = torch.device("cuda")
    cfg = get_config("seamless-m4t-medium")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    pre = {"flash_attention": cfg.enc_layers + 2 * cfg.dec_layers,
           "ssm_scan": 0}
    step = {"flash_attention": cfg.dec_layers, "ssm_scan": 0}
    say(f"[seamless] seamless-m4t-medium at full width and depth: "
        f"{cfg.enc_layers} + {cfg.dec_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
        f"untied; the encoder reads the prompt as src_tokens (the audio "
        f"frontend is a stub)")

    p_dev, _ = load_params(torch, "seamless", cfg32, " copy")
    p_cpu = params_to(p_dev, "cpu")
    counts = card_vs_cpu(torch, out, cfg32, p_dev, p_cpu,
                         rng.integers(1, cfg.vocab_size, (4, 32)), 4, 64)
    if not same_counts(counts[0], pre) or \
            not all(same_counts(c, step) for c in counts[1:]):
        fail(f"seamless float32 launches {counts}: expected {pre} per "
             f"prefill and {step} per decode step")
    del p_cpu, p_dev
    free(torch, out)

    params, n_params = load_params(torch, "seamless", cfg)
    lens = rng.integers(16, 129, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    eng = ServeEngine(cfg, params, batch_size=4, max_len=256)
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.serve(reqs, prompt_len=128)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _lib.launch_counts()
    m = eng.metrics
    if len(done) != 8 or any(len(r.out) != 16 or not r.done for r in done):
        fail(f"seamless ServeEngine.serve: {[len(r.out) for r in done]} "
             f"tokens")
    want = kernel_counts(pre, step, m["prefills"], m["decode_steps"])
    if not same_counts(counts, want):
        fail(f"seamless serving launched {counts} for {m['prefills']} "
             f"prefills and {m['decode_steps']} decode steps (expected "
             f"{pre} per prefill, {step} per decode step)")
    n_tok = sum(len(r.out) for r in done)
    say(f"[seamless] ServeEngine.serve bf16: 8 of 8 requests done, 16 tokens "
        f"each ({m['prefills']} prefills of 4 x 128, {m['decode_steps']} "
        f"decode steps, {wall_s:.2f} s, {n_tok / wall_s:.1f} tokens/s end to "
        f"end); launches {counts}")

    padded = torch.tensor([[0] * (128 - len(p)) + p for p in prompts[:4]],
                          device=dev)
    batch = {"tokens": padded, "src_tokens": padded}
    _, cache = prefill_step(cfg)(params, batch,
                                 init_cache(cfg, 4, 256, enc_len=128,
                                            device=dev))
    tok = torch.tensor([[5], [6], [7], [8]], device=dev)
    timing = step_timings(
        torch, "seamless-m4t-medium bf16", "batch-4 prefill of 4 x 128",
        lambda: prefill_step(cfg)(params, batch, init_cache(
            cfg, 4, 256, enc_len=128, device=dev)),
        lambda: decode_step(cfg)(params, cache, tok), pre, step)

    try:
        LMBackend(cfg, params, slots=4, prompt_len=128, max_len=256)
        fail("continuous batching admitted encdec")
    except NotImplementedError:
        pass
    try:
        PredictableEngine(cfg, params, batch_size=4, max_len=256)
        fail("PredictableEngine was built for encdec, which the JAX "
             "package's analyze_decode refuses")
    except ZeroDivisionError:
        pass
    say("[seamless] continuous batching refuses encdec (per-request encoder "
        "state), and PredictableEngine cannot be built for it "
        "(analyze_decode divides by num_layers, 0 for encdec), as in the "
        "JAX package")
    out.update(params=n_params,
               serve={"wall_s": wall_s, "tokens": n_tok,
                      "tokens_per_s": n_tok / wall_s, "launches": counts,
                      "metrics": dict(m)}, **timing)
    del params, cache, eng
    free(torch, out)
    phase_end(torch, "seamless", t_phase, out)
    return counts


# -- 10. the cluster: mesh backend, K6, ClusterServer ------------------------

# the (data, model) mesh of phase 10b: two processes on the one card
MESH_B = (1, 2)


def yolov5s_phase(torch, np, rng, kernels, report) -> int:
    """Phase 5d: YOLOv5s at 640 through the Server, lut_int8 at the job's
    SiLU sizes, the answers' readback. Returns the served jobs' lut_int8
    launches."""
    import repro_torch
    from repro_torch.compiler.backends import GraphedRunner, HostOuts
    from repro_torch.core import cnn, init_params
    from repro_torch.core import compiled as C
    from repro_torch.core.quantize import silu_table
    from repro_torch.hw import scaled_paper_machine
    from repro_torch.kernels import _lib
    from repro_torch.kernels.lut_int8 import (lut_bytes, lut_int8,
                                              lut_int8_plain)
    from repro_torch.serve import Server

    t_phase = time.perf_counter()
    out: dict = {}
    dev = torch.device("cuda")
    hw = scaled_paper_machine(64)
    g = cnn.yolov5s()
    params = init_params(g, seed=SEED)
    out_name = g.outputs[0]
    B, n_jobs = 8, 6
    silus = [op for op in g.ops if op.kind == "silu"]
    per_job = {"lut_int8": len(silus),
               "bytes": sum(lut_bytes(B * g.tensors[op.outputs[0]].size)
                            for op in silus)}

    srv = Server(hw, backend="cuda", device="cuda")
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    verdict = srv.register("yolov5s", g, period_s=0.1, deadline_s=0.1,
                           slots=B, params=params)
    out["register_s"] = time.perf_counter() - t0
    say(f"[yolov5s] admitted {g.name} at 640 x 640, 80 classes: WCET bound "
        f"{verdict.response_bound_s * 1e3:.3f} ms, register (compile, "
        f"eager call, capture) {out['register_s']:.1f} s")
    primed = _lib.graph_counts()
    if primed != {"eager": 1, "captures": 1, "replays": 1,
                  "capture_failures": 0}:
        fail(f"[yolov5s] register did not capture the runner's graph: "
             f"{primed}")
    runner = srv._nets["yolov5s"].runner
    if not isinstance(runner, GraphedRunner):
        fail(f"[yolov5s] the served runner is a {type(runner).__name__}")
    xs = rng.integers(-64, 64, size=(n_jobs * B, 640, 640, 3)
                      ).astype(np.int8)
    answers, lat = [], []
    _lib.reset_launch_counts()
    for j in range(n_jobs):
        ts = [srv.submit("yolov5s", xs[j * B + i]) for i in range(B)]
        while not all(t.terminal for t in ts):
            srv.step()
        for t in ts:
            if t.status != "done":
                fail(f"[yolov5s] ticket {t.tid} ended {t.status}: {t.error}")
            r = t.result()
            answers.append(np.array(r.output[out_name]))
        lat.append(r.latency_s * 1e3)
        del ts, r, t                 # the job's host arrays go free
    torch.cuda.synchronize()
    served = _lib.graph_counts()
    launches = _lib.launch_counts()
    nbytes = _lib.byte_counts()["lut_int8"]
    jobs = srv.monitor.checks.get("yolov5s", 0)
    if jobs != n_jobs or served != {**served, "captures": 0, "eager": 0,
                                    "replays": jobs}:
        fail(f"[yolov5s] {jobs} jobs of {n_jobs} were not all graph "
             f"replays: {served}")
    if launches["lut_int8"] != jobs * per_job["lut_int8"] or \
            nbytes != jobs * per_job["bytes"]:
        fail(f"[yolov5s] lut_int8 launched {launches['lut_int8']} times "
             f"over {nbytes} bytes in {jobs} jobs, the plan says "
             f"{per_job['lut_int8']} and {per_job['bytes']} a job")
    hosts = [gr.host for gr in runner.graphs.values() if gr is not None]
    reads = {k: sum(getattr(h, k) for h in hosts)
             for k in ("made", "reused", "pageable")}
    pinned = all(t.is_pinned() for h in hosts for s in h.sets
                 for t, _ in s.values())
    say(f"[yolov5s] {jobs} batch-8 jobs, all graph replays ({served}); "
        f"launches a job {({k: v // jobs for k, v in launches.items()})}, "
        f"lut_int8 bytes a job {nbytes // jobs}; job latency median "
        f"{statistics.median(lat):.2f} ms ({', '.join(f'{v:.2f}' for v in lat)}"
        f"); readback host arrays {reads}, page-locked {pinned}")
    if reads["pageable"] or not pinned:
        fail("[yolov5s] answers dropped at once were read into pageable "
             "memory")

    # every answer against the plain torch program on the card, two
    # against the numpy oracle
    dep = repro_torch.compile(g, hw, backend="torch", params=params,
                              device="cuda")
    for j in range(n_jobs):
        want = dep.run({"input": xs[j * B:(j + 1) * B]}, batched=True)
        for i in range(B):
            if not np.array_equal(answers[j * B + i], want[out_name][i]):
                fail(f"[yolov5s] job {j} frame {i} differs from the torch "
                     "backend")
    t0 = time.perf_counter()
    for i in (0, n_jobs * B - 1):
        want = C.run_numpy(dep.program, {"input": xs[i]})[out_name]
        if not np.array_equal(answers[i], want):
            d = np.abs(answers[i].astype(np.int64) - want).max()
            fail(f"[yolov5s] frame {i} differs from run_numpy (max |d| {d})")
    out["oracle_s"] = time.perf_counter() - t0
    nz = float(np.mean(np.stack(answers) != 0))
    say(f"[yolov5s] {len(answers)} answers {answers[0].shape} "
        f"{answers[0].dtype} bit-exact against the torch backend, 2 "
        f"against run_numpy ({out['oracle_s']:.1f} s); nonzero share "
        f"{nz:.3f}")
    out.update(jobs=jobs, job_ms=lat, reads=reads, launches_per_job={
        k: v // jobs for k, v in launches.items()}, nonzero_share=nz,
        wcet_bound_ms=verdict.response_bound_s * 1e3)
    del srv, dep, answers
    free(torch, out)

    # lut_int8 at the largest and smallest SiLU of a batch-8 job
    table = torch.as_tensor(silu_table(1 / 16, 1 / 16)).to(dev)
    sizes = sorted({B * g.tensors[op.outputs[0]].size for op in silus})
    out["lut"] = []
    for n in (sizes[-1], sizes[0]):
        x = torch.as_tensor(rng.integers(-128, 128, size=n).astype(
            np.int8)).to(dev)
        _lib.reset_launch_counts()
        y = lut_int8(x, table)
        torch.cuda.synchronize()
        got = (_lib.launch_counts()["lut_int8"],
               _lib.byte_counts()["lut_int8"])
        if got != (1, lut_bytes(n)):
            fail(f"[lut_int8] n {n}: counted {got}, want "
                 f"(1, {lut_bytes(n)})")
        err = expect_equal(torch, f"lut_int8 n {n}", y,
                           lut_int8_plain(x, table))
        kernels["lut_int8"]["max_abs_err"] = max(
            kernels["lut_int8"]["max_abs_err"], err)
        idx = x.to(torch.int32) + 128
        if not torch.equal(torch.index_select(table, 0, idx), y):
            fail(f"[lut_int8] n {n}: torch.index_select disagrees")
        ms = graph_ms(torch, lambda: lut_int8(x, table))
        pms = graph_ms(torch, lambda: lut_int8_plain(x, table))
        lib = graph_ms(torch, lambda: torch.index_select(table, 0, idx))
        bd = Bound()
        b = bd.add(lut_bytes(n), 0)
        say(f"[lut_int8] n {n} ({lut_bytes(n) / 1e6:.2f} MB): equal, 1 "
            f"launch, {lut_bytes(n)} bytes counted; kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, library (torch.index_select, int32 "
            f"indices made beforehand) {lib:.4f} ms, bound {b:.5f} ms "
            f"(bytes): {100 * b / ms:.1f}% of it")
        c = {"kernel": "lut_int8", "n": n, "ms": ms, "plain_ms": pms,
             "library_ms": lib, "bound_ms": b, "bound_by": bd.by}
        out["lut"].append(c)
        report["checks"].append(c)
        del x, y, idx
    kernels["lut_int8"].update({k: out["lut"][0][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})

    # the answers' readback: a batch-8 job's 68.5 MB into new pageable
    # memory (as `to_numpy`), into page-locked memory, and through the
    # runner's reused host arrays
    dout = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, 25200, 85),
                         dtype=torch.int32, device=dev)
    pin = torch.empty(dout.shape, dtype=dout.dtype, pin_memory=True)
    h = HostOuts(dev)
    mb = dout.numel() * 4 / 1e6
    rb = {"mb": mb,
          "pageable_ms": host_ms(torch, lambda: dout.cpu().numpy()),
          "pinned_ms": host_ms(torch, lambda: pin.copy_(dout)),
          "host_outs_ms": host_ms(torch, lambda: h.read({"o": dout}, True))}
    if not np.array_equal(h.read({"o": dout}, True)["o"], dout.cpu().numpy()):
        fail("[yolov5s] HostOuts read back other values")
    say(f"[yolov5s] readback of {mb:.1f} MB: new pageable "
        f"{rb['pageable_ms']:.2f} ms ({mb / rb['pageable_ms']:.2f} GB/s), "
        f"page-locked {rb['pinned_ms']:.2f} ms "
        f"({mb / rb['pinned_ms']:.2f} GB/s), HostOuts "
        f"{rb['host_outs_ms']:.2f} ms (reads made {h.made}, reused "
        f"{h.reused}, pageable {h.pageable})")
    out["readback"] = rb
    del dout, pin, h
    free(torch, out)
    phase_end(torch, "yolov5s", t_phase, out)
    report["yolov5s"] = out
    return launches["lut_int8"]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_rank_main(rank: int, world: int, work: Path) -> None:
    """One rank of phase 10b (run as `chip_smoke.py --mesh-rank R W DIR`):
    join a gloo group on the card, probe it with one CUDA all_reduce, then
    run ResNet50-224 on the (1, 2) mesh at batch 1 and 3 and keep the
    outputs and this rank's K6 launches in DIR."""
    import datetime
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/rendezvous", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=180))
    out: dict = {}
    try:
        t = torch.full((4,), rank + 1, dtype=torch.int32, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out["probe"] = t.cpu().numpy()
    except Exception as e:           # noqa: BLE001 -- reported, not hidden
        (work / f"probe_error{rank}.txt").write_text(
            f"{type(e).__name__}: {e}")
        return
    import repro_torch
    from repro_torch.core import cnn, init_params
    from repro_torch.hw import scaled_paper_machine
    from repro_torch.kernels import _lib
    g = cnn.resnet50()
    dep = repro_torch.compile(
        g, scaled_paper_machine(64).with_mesh(*MESH_B), backend="mesh",
        params=init_params(g, seed=SEED), device="cuda")
    frames = np.load(work / "frames.npz")
    for key in ("b1", "b3"):
        _lib.reset_launch_counts()
        res = dep.run({"input": frames[key]}, batched=True)
        torch.cuda.synchronize()
        out[f"launches_{key}"] = np.array(_lib.launch_counts()["tiled_int8"])
        for k, v in res.items():
            out[f"{key}:{k}"] = v
    np.savez(work / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def two_process_mesh(np, frames: dict, want: dict) -> dict:
    """Phase 10b: two ranks of the (1, 2) mesh on the one card over gloo
    (NCCL refuses two ranks on one GPU), each bit-exact against 10a's
    outputs. Returns what it found; fails on anything but a refused
    probe."""
    work = ROOT / "build" / "cluster_two_process"
    if work.exists():
        for f in work.iterdir():
            f.unlink()
    work.mkdir(parents=True, exist_ok=True)
    np.savez(work / "frames.npz", **frames)
    world = MESH_B[0] * MESH_B[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), str(world), str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        fail("[cluster] a rank of the two-process mesh did not finish in "
             "300 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    probe = sorted(work.glob("probe_error*.txt"))
    if probe:
        err = probe[0].read_text().strip()
        say(f"[cluster] two-process gloo probe refused: {err}")
        return {"probe_error": err}
    if any(p.returncode != 0 for p in procs):
        fail("[cluster] two-process mesh failed:\n" + "\n".join(
            log[-3000:] for log in logs))
    found = {"seconds": time.perf_counter() - t0, "launches": []}
    for r in range(world):
        got = np.load(work / f"rank{r}.npz")
        if not np.array_equal(got["probe"], np.full(4, 3, np.int32)):
            fail(f"[cluster] rank {r}: gloo probe gave {got['probe']}")
        for key, ref in want.items():
            for k, v in ref.items():
                if not np.array_equal(got[f"{key}:{k}"], v):
                    fail(f"[cluster] rank {r} {key}: {k} differs from the "
                         "1 x 1 mesh")
        found["launches"].append(
            {key: int(got[f"launches_{key}"]) for key in want})
    say(f"[cluster] (1, 2) mesh, two processes on the card over gloo: "
        f"probe all_reduce 1 + 2 = 3 on both ranks; batch 1 and 3 "
        f"bit-exact vs the 1 x 1 mesh on both ranks; K6 launches per "
        f"program by rank {found['launches']}; "
        f"{found['seconds']:.1f} s with start-up")
    return found


def _partial_shape(C, b) -> tuple:
    """The (1, M, N) shape of a tiled op's int32 partial at batch 1."""
    a = b.attrs
    if b.kind == "gemm":
        return (1, a["M"], a["N"])
    oh, ow = C.conv_out_hw(a)
    return (1, oh * ow, a["C_out"])


def k6_class(b, M, N, K) -> str:
    """An op's class in the `[K6 table]`: kind, kernel and (M, N, K) at
    batch 1 (strides merged: a stride-2 3x3 conv to 7 x 7 joins the 7 x 7
    3x3 convs)."""
    if b.kind == "gemm":
        return f"gemm {M}x{N}x{K}"
    a = b.attrs
    return f"{a['kh']}x{a['kw']} conv {M}x{N}x{K}"


def k6_timings(torch, np, C, prog, tables, i8, kernels) -> dict:
    """K6 at every tiled op of a program (the 1 x 1 table of each), at
    batch 1 and 8: int32-equal to its plain version, with the kernel's
    and torch._int_mm's times and the bound per op; the plain version's
    time at batch 1. Prints a `[K6 table]` line per op class and batch.
    Returns batch 1's sums over the program (the JSON line's numbers),
    batch 8's, and the rows. K6 runs as the mesh path runs it, on the
    weights prepared once."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.tiled_int8 import (prepare_weights, tiled_int8,
                                                tiled_int8_plain)
    dev = torch.device("cuda")
    consts = C.device_consts(prog, dev)
    rows: list = []
    refused: list = []
    bounds = {1: Bound(), 8: Bound()}
    for b in prog.batches:
        if b.kind not in ("gemm", "conv2d"):
            continue
        a = b.attrs
        tiles, mask = tables[b.op_idx]
        w = consts.weights[b.w_idx]
        wt = prepare_weights(w)
        if b.kind == "gemm":
            M, K, N = a["M"], a["K"], a["N"]
            geo = {}
        else:
            geo = dict(kh=a["kh"], kw=a["kw"], stride=a["stride"],
                       padding=a["padding"])
            oh, ow = C.conv_out_hw(a)
            M, K, N = oh * ow, a["kh"] * a["kw"] * a["C_in"], a["C_out"]
        live = tiles[mask]
        area = int(((live[:, 1] - live[:, 0])
                    * (live[:, 3] - live[:, 2])).sum())
        for B in (1, 8):
            x = (i8(B, M, 1, K) if b.kind == "gemm"
                 else i8(B, a["H"], a["W"], a["C_in"]))
            got = tiled_int8(x, w, tiles, mask, wt=wt, **geo)
            err = expect_equal(torch, f"K6 {b.name} batch {B}", got,
                               tiled_int8_plain(x, w, tiles, mask, **geo))
            kernels["tiled_int8"]["max_abs_err"] = max(
                kernels["tiled_int8"]["max_abs_err"], err)
            row = {"op": b.name, "cls": k6_class(b, M, N, K), "B": B,
                   "ms": graph_ms(torch, lambda: tiled_int8(
                       x, w, tiles, mask, wt=wt, **geo)),
                   "plain_ms": None, "int_mm_ms": None}
            if B == 1:
                row["plain_ms"] = graph_ms(
                    torch, lambda: tiled_int8_plain(x, w, tiles, mask, **geo))
            # torch._int_mm on the im2col matrix, padded to its limits (M >
            # 16, K and N multiples of 8; cuBLASLt refused M = 3032 at K =
            # 64, so M is padded to a multiple of 32); the im2col itself is
            # not timed
            cols = kref.im2col_patches(x, geo.get("kh", 1), geo.get("kw", 1),
                                       geo.get("stride", 1),
                                       geo.get("padding", 0)).reshape(-1, K)
            Mp = -(-B * M // 32) * 32
            Kp, Np = -(-K // 8) * 8, -(-N // 8) * 8
            xp = torch.zeros(Mp, Kp, dtype=torch.int8, device=dev)
            wp = torch.zeros(Kp, Np, dtype=torch.int8, device=dev)
            xp[:B * M, :K], wp[:K, :N] = cols, w
            try:
                ref = torch._int_mm(xp, wp)
            except RuntimeError as e:    # cuBLASLt refuses some int8 shapes
                refused.append(f"{b.name} batch {B} ({Mp}x{Kp}x{Np}: "
                               f"{str(e).splitlines()[0][:120]})")
            else:
                if not torch.equal(ref[:B * M, :N], got.reshape(B * M, N)):
                    fail(f"torch._int_mm disagrees with K6 at {b.name} "
                         f"batch {B}")
                row["int_mm_ms"] = graph_ms(torch,
                                            lambda: torch._int_mm(xp, wp))
            row["bound_ms"] = bounds[B].add(
                x.numel() + w.numel() + 4 * B * M * N, 2 * B * area * K)
            rows.append(row)
    out = {"rows": rows, "int_mm_refused": refused}
    for B in (1, 8):
        mine = [r for r in rows if r["B"] == B]
        lib = [r["int_mm_ms"] for r in mine]
        out[f"b{B}"] = {
            "ms": sum(r["ms"] for r in mine),
            "int_mm_ms": sum(v for v in lib if v is not None),
            "ms_over_int_mm_ops": sum(r["ms"] for r in mine
                                      if r["int_mm_ms"] is not None),
            "library_ms": None if None in lib else sum(lib),
            "bound_ms": bounds[B].ms, "bound_by": bounds[B].by}
        classes: dict = {}
        for r in mine:
            classes.setdefault(r["cls"], []).append(r)
        for cls, rs in classes.items():
            lib_c = [r["int_mm_ms"] for r in rs]
            say(f"[K6 table] batch {B} {cls} x{len(rs)}: kernel "
                f"{sum(r['ms'] for r in rs):.4f} ms, bound "
                f"{sum(r['bound_ms'] for r in rs):.5f} ms, torch._int_mm "
                + (f"{sum(lib_c):.4f} ms" if None not in lib_c
                   else "refused"))
    b1 = out["b1"]
    # the library time stands for the whole program only where
    # torch._int_mm took every op; else it is kept beside K6's time over
    # the ops it took, and the JSON line has none
    out.update({"ms": b1["ms"], "int_mm_ms": b1["int_mm_ms"],
                "ms_over_int_mm_ops": b1["ms_over_int_mm_ops"],
                "library_ms": b1["library_ms"], "bound_ms": b1["bound_ms"],
                "bound_by": b1["bound_by"],
                "plain_ms": sum(r["plain_ms"] for r in rows if r["B"] == 1)})
    return out


def k6_host_us(torch, C, prog, tables, i8, calls: int = 50) -> dict:
    """The host's share of K6 on the mesh path, which is host-bound: at
    every tiled op of a batch-1 program (the 1 x 1 table of each), the
    time to issue one call on the host clock (the mean of `calls` calls,
    no synchronize between them), for the whole wrapper, its cached plan
    lookup alone and its library call alone (tensor maps and the launch),
    summed over the program (us)."""
    from repro_torch.kernels import _lib
    K6 = importlib.import_module("repro_torch.kernels.tiled_int8")
    consts = C.device_consts(prog, torch.device("cuda"))
    lib = _lib.load("tiled_int8")

    def issue_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
        return us

    sums = {"wrapper": 0.0, "plan": 0.0, "library": 0.0, "calls": 0}
    for b in prog.batches:
        if b.kind not in ("gemm", "conv2d"):
            continue
        a = b.attrs
        tiles, mask = tables[b.op_idx]
        w = consts.weights[b.w_idx]
        wt = K6.prepare_weights(w)
        geo = ({} if b.kind == "gemm" else
               dict(kh=a["kh"], kw=a["kw"], stride=a["stride"],
                    padding=a["padding"]))
        x = (i8(1, a["M"], 1, a["K"]) if b.kind == "gemm"
             else i8(1, a["H"], a["W"], a["C_in"]))
        B, H, W, Cin = x.shape
        K, N = w.shape
        kh, kw = geo.get("kh", 1), geo.get("kw", 1)
        stride, pad = geo.get("stride", 1), geo.get("padding", 0)
        oh, ow = K6._out_hw(H, W, kh, kw, stride, pad)
        out = K6.tiled_int8(x, w, tiles, mask, wt=wt, **geo)
        run = K6._launch_plan(tiles, mask, oh * ow, N, K, B, x.device)
        args = (x.data_ptr(), wt.data_ptr(), wt.shape[1],
                run.units.data_ptr(), run.units.shape[0], run.plan.items,
                run.plan.splits, run.plan.bn, out.data_ptr(), B, H, W, Cin,
                N, kh, kw, stride, pad, run.ws or None,
                run.counters or None, run.sms, _lib.stream_ptr(x))
        sums["wrapper"] += issue_us(
            lambda: K6.tiled_int8(x, w, tiles, mask, wt=wt, **geo))
        sums["plan"] += issue_us(
            lambda: K6._launch_plan(tiles, mask, oh * ow, N, K, B, x.device))
        sums["library"] += issue_us(lambda: lib.tiled_int8_launch(*args))
        sums["calls"] += 1
    return sums


def cluster_phase(torch, np, hw, g, params, inputs, mk_out, mk_fn, kernels,
                  report, smi) -> int:
    """Phase 10: the cluster. (a) ResNet50-224 on a 1 x 1 mesh over a
    one-rank NCCL group, bit-exact against the cuda backend's outputs of
    phase 4 at batch 1 and 3, 54 K6 launches per program (counters and
    profiler), K6 against its plain version on 4-way rank tables; (b) the
    (1, 2) mesh in two processes; (c) ClusterServer on the cuda backend
    (two replicas, one sheds resnet50) and on the 1 x 1 mesh, saved and
    linted; (d)
    times. Returns K6's launches on the phase's main path (the mesh
    ClusterServer)."""
    import torch.distributed as dist
    import repro_torch
    from repro_torch.cluster import ClusterServer
    from repro_torch.cluster import mesh as TM
    from repro_torch.core import compiled as C
    from repro_torch.core.cnn import small_cnn as cnn_small
    from repro_torch.core import init_params as init_params_np
    from repro_torch.core.compiled import partition_streams
    from repro_torch.kernels import _lib
    from repro_torch.kernels.tiled_int8 import tiled_int8, tiled_int8_plain
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out_name = g.outputs[0]
    rng = np.random.default_rng(SEED + 10)

    def i8(*shape):
        return torch.as_tensor(rng.integers(-128, 128, size=shape)
                               .astype(np.int8)).to(dev)

    # -- 10a. the 1 x 1 mesh over NCCL ---------------------------------------
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mhw = hw.with_mesh(1, 1)
        mdep = repro_torch.compile(g, mhw, backend="mesh", params=params,
                                   device="cuda")
        mprog = mdep.program
        frames = {"b1": inputs[1], "b3": inputs[8][:3]}
        want = {"b1": {out_name: mk_out[1][out_name]},
                "b3": {out_name: mk_out[8][out_name][:3]}}
        for key, x in frames.items():
            got = mdep.run({"input": x}, batched=True)
            if not np.array_equal(got[out_name], want[key][out_name]):
                fail(f"[cluster] 1 x 1 mesh {key}: differs from the cuda "
                     "backend")
        mesh, fn = TM._mesh_program(mprog, dev)[1]
        if not mesh.distributed:
            fail("[cluster] the 1 x 1 mesh did not join the NCCL group")
        n_tiled = sum(b.kind in ("gemm", "conv2d") for b in mprog.batches)
        per_program = {}
        for B in (1, 3):
            xin = C.to_device(mprog, {"input": frames[f"b{B}"]}, dev)
            _lib.reset_launch_counts()
            fn(xin)
            torch.cuda.synchronize()
            counts = _lib.launch_counts()
            per_program[B] = counts
            if counts["tiled_int8"] != n_tiled or n_tiled != 54 or \
                    sum(counts.values()) != n_tiled:
                fail(f"[cluster] mesh batch {B}: launches {counts}, want "
                     f"54 K6 (the program has {n_tiled} tiled ops)")
        say(f"[cluster] ResNet50-224 on {mhw.name}, NCCL group of 1 "
            f"(backend {dist.get_backend()}): bit-exact vs the cuda backend "
            f"at batch 1 and 3; launches per program {per_program[1]}")
        x1 = C.to_device(mprog, {"input": inputs[1]}, dev)
        (by_name, busy_us, wall_us, names), tries = profile_confirm(
            torch, lambda: fn(x1),
            lambda ns: sum("tiled_int8_kernel" in n for n in ns), n_tiled)
        nccl = sum("nccl" in n.lower() for n in names)
        if names and tries[-1] != n_tiled:
            fail(f"[cluster] profiler saw {tries} K6 launches "
                 f"({len(tries)} tries), want {n_tiled}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        say(f"[cluster] profiled mesh batch 1: {len(names)} device events "
            f"({tries[-1]} K6, profiled {len(tries)}x; {nccl} NCCL), busy "
            f"{busy_us:.0f} us of {wall_us:.0f} us wall (idle share "
            f"{1 - busy_us / wall_us:.3f}); top: "
            + "; ".join(f"{k} {v:.0f} us" for k, v in top))

        # K6 against its plain version on rank 0's and rank 3's tiles of
        # partition_streams(prog, 4), at a 3x3 conv and at the classifier
        parts = partition_streams(mprog, 4)
        picks = [b for b in mprog.batches if b.kind == "gemm"] + [
            next(b for b in mprog.batches
                 if b.kind == "conv2d" and b.attrs["kh"] == 3)]
        for b in picks:
            a = b.attrs
            tiles, mask = TM._stack_tiles(parts, b.op_idx)
            w = C.device_consts(mprog, dev).weights[b.w_idx]
            for B in (1, 3):
                if b.kind == "gemm":
                    x, geo = i8(B, a["M"], 1, a["K"]), {}
                else:
                    x = i8(B, a["H"], a["W"], a["C_in"])
                    geo = dict(kh=a["kh"], kw=a["kw"], stride=a["stride"],
                               padding=a["padding"])
                for r in (0, 3):
                    err = expect_equal(
                        torch, f"K6 {b.name} rank {r} of 4 batch {B}",
                        tiled_int8(x, w, tiles[r], mask[r], **geo),
                        tiled_int8_plain(x, w, tiles[r], mask[r], **geo))
                    kernels["tiled_int8"]["max_abs_err"] = max(
                        kernels["tiled_int8"]["max_abs_err"], err)
        say(f"[cluster] K6 equal to its plain version on rank 0's and rank "
            f"3's tiles of a 4-way split ({', '.join(b.name for b in picks)}"
            f", batch 1 and 3): "
            f"{[int(mask[r].sum()) for r in range(4)]} tiles of the last "
            "op by rank")

        laps = {"10a": time.perf_counter() - t_phase}
        # -- 10b. the (1, 2) mesh in two processes ---------------------------
        report["cluster_two_process"] = two_process_mesh(np, frames, want)
        laps["10b"] = time.perf_counter() - t_phase - sum(laps.values())

        # -- 10c. ClusterServer ----------------------------------------------
        cs = ClusterServer(hw, replicas=2, backend="cuda", device="cuda")
        cs.register("resnet50", g, period_s=0.1, slots=4, params=params)
        # a second network, so a replica may shed resnet50 (a Server
        # refuses to shed its only active network)
        lane = cnn_small()
        cs.register("lane", lane, period_s=0.1,
                    params=init_params_np(lane, seed=SEED))
        pool = inputs[8]
        ref8 = mk_out[8][out_name]
        tickets = [(i % 8, cs.submit("resnet50", pool[i % 8]))
                   for i in range(16)]
        cs.run(hyperperiods=2)
        before = list(cs.dispatched)
        cs.servers[1].shed("resnet50")
        tickets += [(i, cs.submit("resnet50", pool[i])) for i in range(8)]
        tel = cs.run(hyperperiods=2)
        after = [a - b for a, b in zip(cs.dispatched, before)]
        for i, t in tickets:
            if not t.terminal or t.status != "done":
                fail(f"[cluster] ticket {t!r} ended {t.status}")
            if not np.array_equal(t.result().output[out_name], ref8[i]):
                fail(f"[cluster] ticket {t!r}: differs from the cuda "
                     "backend")
        per = [s.monitor.checks.get("resnet50", 0) for s in cs.servers]
        if min(before) == 0 or after[1] != 0 or \
                tel["networks"]["resnet50"]["checks"] != sum(per) or \
                tel["metrics"]["tickets"] != 24 or \
                sum(tel["dispatched"]) != 24:
            fail(f"[cluster] routing or telemetry: dispatched {before} then "
                 f"{after}, checks {per} merged "
                 f"{tel['networks']['resnet50']['checks']}, tickets "
                 f"{tel['metrics']['tickets']}")
        say(f"[cluster] ClusterServer, 2 replicas on the cuda backend: 24 "
            f"tickets done and bit-exact; 16 dispatched {before}, then "
            f"replica 1 shed and 8 dispatched {after}; merged checks "
            f"{tel['networks']['resnet50']['checks']} = {per}")
        ms_cs = ClusterServer(mhw, replicas=2, backend="mesh",
                              device="cuda")
        ms_cs.register("resnet50", g, period_s=0.1, slots=2, params=params)
        mtickets = [(i, ms_cs.submit("resnet50", pool[i])) for i in range(4)]
        _lib.reset_launch_counts()
        ms_cs.run(hyperperiods=2)
        torch.cuda.synchronize()
        main_counts = _lib.launch_counts()
        for i, t in mtickets:
            if t.status != "done" or not np.array_equal(
                    t.result().output[out_name], ref8[i]):
                fail(f"[cluster] mesh ClusterServer ticket {t!r}: "
                     f"{t.status}, or differs from the cuda backend")
        jobs = sum(s.metrics["jobs"] for s in ms_cs.servers)
        if main_counts["tiled_int8"] == 0 or \
                main_counts["tiled_int8"] % 54 != 0:
            fail(f"[cluster] mesh ClusterServer launches {main_counts}")
        say(f"[cluster] ClusterServer, 2 replicas on the 1 x 1 mesh: 4 "
            f"tickets done and bit-exact; {jobs} jobs, launches "
            f"{main_counts}")
        art = ROOT / "build" / "resnet50_224.cluster"
        cs.save(str(art))
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", str(art)],
            env={**os.environ, "PYTHONPATH": str(SRC)},
            capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            fail(f"[cluster] python -m repro_torch.analysis {art.name} "
                 f"exited {res.returncode}: {res.stdout[-2000:]}"
                 f"{res.stderr[-2000:]}")
        say(f"[cluster] saved {art.relative_to(ROOT)}; python -m "
            f"repro_torch.analysis: exit 0, "
            f"{res.stdout.strip().splitlines()[-1]}")

        laps["10c"] = time.perf_counter() - t_phase - sum(laps.values())
        # -- 10d. times ------------------------------------------------------
        # the mesh program's host time split: the same program with its
        # collectives skipped, and its 54 all-reduces alone
        local = TM._mesh_body(mprog, dataclasses.replace(
            mesh, model_group=None, data_group=None), dev)
        accs = [torch.zeros(_partial_shape(C, b), dtype=torch.int32,
                            device=dev)
                for b in mprog.batches if b.kind in ("gemm", "conv2d")]

        def reduces():
            for a_ in accs:
                dist.all_reduce(a_, group=mesh.model_group)

        lat = {"mesh 1x1": [], "cuda megakernel": [],
               "mesh 1x1 without collectives": [], "54 all-reduces": []}
        xm = C.to_device(mprog, {"input": inputs[1]}, dev)
        for _ in range(3):
            lat["mesh 1x1"].append(host_ms(torch, lambda: fn(xm)))
            lat["cuda megakernel"].append(host_ms(torch, lambda: mk_fn(xm)))
            lat["mesh 1x1 without collectives"].append(
                host_ms(torch, lambda: local(xm)))
            lat["54 all-reduces"].append(host_ms(torch, reduces))
        tables = {}
        parts1 = partition_streams(mprog, 1)
        for b in mprog.batches:
            if b.kind in ("gemm", "conv2d"):
                tiles, mask = TM._stack_tiles(parts1, b.op_idx)
                tables[b.op_idx] = (tiles[0], mask[0])
        k6 = k6_timings(torch, np, C, mprog, tables, i8, kernels)
        kernels["tiled_int8"].update(k6)
        k6_host = k6_host_us(torch, C, mprog, tables, i8)
        say(f"[K6 host] issue time per batch-1 program ({k6_host['calls']} "
            f"calls, host clock, the mean of 50 calls at each op): wrapper "
            f"{k6_host['wrapper']:.1f} us, of it the plan lookup "
            f"{k6_host['plan']:.1f} us and the library call "
            f"{k6_host['library']:.1f} us (tensor maps and the launch)")
        cuda_k = (kernels["conv2d_int8"]["ms"] + kernels["gemm_int8"]["ms"]
                  + kernels["megakernel"]["ms"])
        say(f"[cluster] {smi}: batch-1 latency (host clock, median of 3 "
            f"rounds of {RUNS}): " + "; ".join(
                f"{k} {statistics.median(v):.3f} ms (rounds "
                f"{', '.join(f'{x:.3f}' for x in v)})"
                for k, v in lat.items()))
        taken = sum(r["int_mm_ms"] is not None for r in k6["rows"]
                    if r["B"] == 1)
        b8 = k6["b8"]
        say(f"[K6] over one batch-1 program (54 ops, summed): kernel "
            f"{k6['ms']:.4f} ms, plain {k6['plain_ms']:.4f} ms, "
            f"torch._int_mm {k6['int_mm_ms']:.4f} ms over the {taken} ops "
            f"it takes (K6 there {k6['ms_over_int_mm_ops']:.4f} ms; "
            f"refused: {'; '.join(k6['int_mm_refused']) or 'none'}), bound "
            f"{k6['bound_ms']:.5f} ms ({k6['bound_by']}); the cuda "
            f"backend's K2 over its 50 convs {kernels['conv2d_int8']['ms']:.4f}"
            f" ms (K1 + K2 + K3 {cuda_k:.4f} ms); at batch 8: kernel "
            f"{b8['ms']:.4f} ms, torch._int_mm {b8['int_mm_ms']:.4f} ms, "
            f"bound {b8['bound_ms']:.5f} ms")
        report["cluster"] = {
            "launches_per_program": per_program[1],
            "profile": {"busy_us": busy_us, "wall_us": wall_us,
                        "device_events": len(names), "k6_by_try": tries,
                        "nccl": nccl, "top_us": top},
            "latency_ms": lat, "k6": k6, "k6_host_us": k6_host,
            "cuda_k2_ms":
                kernels["conv2d_int8"]["ms"], "cuda_kernels_ms": cuda_k,
            "server_dispatched": [before, after],
            "mesh_server_launches": main_counts,
            "phase_s": time.perf_counter() - t_phase}
        laps["10d"] = time.perf_counter() - t_phase - sum(laps.values())
        report["cluster"]["laps_s"] = laps
    finally:
        dist.destroy_process_group()
    say(f"[cluster] phase {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in laps.items()) + ")")
    return main_counts["tiled_int8"]


# -- 11. training: smollm-135M through repro_torch.launch.train -----------------

# the training cell: smollm-135M at full size, bf16, batch 8 x 512 tokens
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 40
# the (2, 1) data mesh of phase 11e: two processes on the one card
TRAIN_MESH_LAYERS, TRAIN_MESH_STEPS, TRAIN_MESH_S = 4, 3, 128


class _GlobalBatch:
    """A data-parallel run's global batch for one rank: every shard of
    the same step, in rank order."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def batch(self, step, shard=0, n_shards=1):
        import numpy as np
        parts = [self.ds.batch(step, i, self.n) for i in range(self.n)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _train_mesh_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("smollm-135m"), dtype="float32",
                               num_layers=TRAIN_MESH_LAYERS)


def _train_mesh_run(mesh, data=None):
    """Phase 11e's run (zero1 on, float32): TRAIN_MESH_STEPS steps at
    global batch 8 on the card. Returns (params, losses)."""
    from repro_torch.train.loop import TrainConfig, train
    (params, _), m = train(
        _train_mesh_cfg(), mesh,
        tc=TrainConfig(num_steps=TRAIN_MESH_STEPS, zero1=True,
                       log_every=1000, seed=SEED),
        data=data, seq_len=TRAIN_MESH_S, global_batch=8, device="cuda")
    return params, m["losses"]


def train_rank_main(rank: int, world: int, work: Path) -> None:
    """One rank of phase 11e (run as `chip_smoke.py --train-rank R W
    DIR`): join a gloo group on the card, train on the (2, 1) data mesh and
    keep this rank's params and losses in DIR."""
    import datetime
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/rendezvous", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=180))
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import leaves
    params, losses = _train_mesh_run(make_host_mesh(data=world, model=1))
    np.savez(work / f"rank{rank}.npz", losses=np.array(losses),
             **{f"p{i}": p.cpu().numpy() for i, p in
                enumerate(leaves(params))})
    dist.barrier()
    dist.destroy_process_group()


def two_process_train(torch, np) -> dict:
    """Phase 11e: the (2, 1) data mesh as two processes on the card over
    gloo (zero1 on), against one rank at the same global batch."""
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import leaves
    work = ROOT / "build" / "train_two_process"
    t0 = time.perf_counter()
    _spawn_ranks("--train-rank", 2, work, 300)
    secs = time.perf_counter() - t0
    ranks = [np.load(work / f"rank{r}.npz") for r in range(2)]
    cfg = _train_mesh_cfg()
    data = _GlobalBatch(SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_MESH_S, global_batch=8,
        seed=SEED)), 2)
    params, losses = _train_mesh_run(make_host_mesh(1, 1), data)
    # tolerance: rtol 1e-4 and an atol of 1e-4 x the leaf's largest
    # magnitude (the gradient is summed in another order on two ranks)
    worst = 0.0
    for i, p in enumerate(leaves(params)):
        a, b = ranks[0][f"p{i}"], ranks[1][f"p{i}"]
        if not np.array_equal(a, b):
            fail(f"[train] (2, 1) mesh: leaf {i} differs between the ranks")
        want = p.float().cpu().numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(a - want).max())
        worst = max(worst, err / max(scale, 1e-30))
        if not np.allclose(a, want, rtol=1e-4, atol=1e-4 * scale):
            fail(f"[train] (2, 1) mesh: leaf {i} differs from one rank "
                 f"(max abs err {err}, max |leaf| {scale})")
    if not np.allclose(ranks[0]["losses"], losses, rtol=1e-4):
        fail(f"[train] (2, 1) mesh losses {ranks[0]['losses']} vs one rank "
             f"{losses}")
    say(f"[train] (2, 1) data mesh, two processes on the card over gloo, "
        f"smollm-135m {TRAIN_MESH_LAYERS} of 30 layers float32, zero1, "
        f"{TRAIN_MESH_STEPS} steps at global batch 8 x {TRAIN_MESH_S}: "
        f"params bit-equal across ranks, within rtol 1e-4 of one rank "
        f"(largest err / max|leaf| {worst:.3g}); losses {list(losses)}; "
        f"{secs:.1f} s with start-up")
    return {"seconds": secs, "worst_rel": worst, "losses": list(losses)}


def train_phase(torch, np, kernels, report, smi) -> int:
    """Phase 11. Returns K4's launches on the training main path (the
    entry point's 40 steps)."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (attention_reference,
                                                     flash_attention,
                                                     flash_attention_plain)
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params, params_to
    from repro_torch.train.fault import InjectedFailure
    from repro_torch.train.loop import TrainConfig, build_state, train
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(dev).manual_seed(SEED)
    out: dict = {}
    report["train"] = out
    k4 = kernels["flash_attention"]

    # -- 11a. K4 under autograd at smollm's training shape -----------------
    B, Hq, Hkv, S, D = TRAIN_B, 9, 3, TRAIN_S, 64
    f32 = [torch.randn(s, generator=gen, device=dev) for s in
           ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D))]
    # the forward against K4's plain version at this shape (6a's
    # tolerances: f32 atol 3e-5, rtol 1e-4; bf16 atol 2e-2, rtol 1e-2)
    grads, a_out, fwd_err = {}, {}, {}
    for dt, name, atol, rtol in ((torch.float32, "f32", 3e-5, 1e-4),
                                 (torch.bfloat16, "bf16", 2e-2, 1e-2)):
        q, k, v, dout = (t.to(dt) for t in f32)
        nograd = flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v).float()
        fwd_err[name] = (nograd.float() - want).abs().max().item()
        if not torch.allclose(nograd.float(), want, atol=atol, rtol=rtol):
            fail(f"[train] K4 {name} {(B, Hq, Hkv, S, D)} causal disagrees "
                 f"with its plain version (max abs err {fwd_err[name]}, "
                 f"atol {atol}, rtol {rtol})")
        del want
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        _lib.reset_launch_counts()
        o = flash_attention(qs, ks, vs)
        torch.cuda.synchronize()
        n = _lib.launch_counts()["flash_attention"]
        if n != 1:
            fail(f"[train] K4 under autograd ({name}): {n} launches for one "
                 "forward, want 1")
        if not torch.equal(o.detach(), nograd):
            fail(f"[train] K4 under autograd ({name}): the forward differs "
                 "from K4's no-grad output")
        o.backward(dout)
        grads[name] = [t.grad.float() for t in (qs, ks, vs)]
        a_out[name] = o.detach()
        if _lib.launch_counts()["flash_attention"] != 1:
            fail(f"[train] K4's backward ({name}) launched K4")
    # the backward's plumbing: dq/dk/dv are autograd of the plain attention
    # the backward recomputes, so this error is 0 unless the Function
    # loses or swaps a gradient; the kernel's own error is the forward's
    qr, kr, vr = (t.clone().requires_grad_(True) for t in f32[:3])
    attention_reference(qr, kr, vr).backward(f32[3])
    f32_err = 0.0
    for got, want in zip(grads["f32"], (qr.grad, kr.grad, vr.grad)):
        f32_err = max(f32_err, (got - want).abs().max().item())
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
            fail(f"[train] K4 f32 gradients differ from the plain "
                 f"version's autograd (max abs err {f32_err})")
    # bf16 against the f32 gradients: the largest difference over the
    # largest f32 gradient, held below 5e-2 (bf16 keeps 8 bits)
    spread = max((g16 - g32).abs().max().item() / g32.abs().max().item()
                 for g16, g32 in zip(grads["bf16"], grads["f32"]))
    if not spread < 5e-2:
        fail(f"[train] K4 bf16 gradients spread {spread} from the f32 ones")
    q, k, v = (t.to(torch.bfloat16) for t in f32[:3])
    ms = graph_ms(torch, lambda: flash_attention(q, k, v))
    pms = graph_ms(torch, lambda: flash_attention_plain(q, k, v))
    lib_ms = graph_ms(torch, sdpa_call(torch, q, k, v, True))
    bd = k4_bound(B, Hq, Hkv, S, S, D, True, None, 2)
    k4["max_abs_err"] = max(k4["max_abs_err"], *fwd_err.values())
    out["k4_autograd"] = {"shape": [B, Hq, Hkv, S, D], "forward_max_abs_err":
                          fwd_err, "grad_f32_max_abs_err": f32_err,
                          "bf16_spread": spread, "ms": ms,
                          "plain_ms": pms, "library_ms": lib_ms,
                          "bound_ms": bd.ms, "bound_by": bd.by}
    say(f"[train] K4 under autograd {(B, Hq, Hkv, S, D)} causal: forward "
        f"vs the plain version max abs err {fwd_err['f32']:.3g} f32 (atol "
        f"3e-5, rtol 1e-4), {fwd_err['bf16']:.3g} bf16 (atol 2e-2, rtol "
        f"1e-2); under autograd bit-equal to K4's no-grad output, 1 launch "
        f"per forward (f32, bf16); f32 dq/dk/dv vs the recomputed plain "
        f"attention's autograd max abs err {f32_err:.3g} (rtol 1e-4, atol "
        f"1e-5); bf16 vs f32 gradients spread {spread:.3g} of max|grad| "
        f"(< 5e-2)")
    say(f"[train] K4 bf16 forward at the training shape: kernel {ms:.4f} "
        f"ms, plain {pms:.4f} ms, library (scaled_dot_product_attention) "
        f"{lib_ms:.4f} ms, bound {bd.ms:.5f} ms ({bd.by}); {smi}")
    del f32, grads, a_out, qs, ks, vs, qr, kr, vr, o, nograd, q, k, v
    free(torch, out)

    # -- 11b. one train_step of a float32 copy, card against CPU ------------
    cfg32 = dataclasses.replace(get_config("smollm-135m"), dtype="float32")
    p_cpu = init_params(cfg32, torch.Generator().manual_seed(SEED), "cpu")
    p_dev = params_to(p_cpu, dev)
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg32.vocab_size, (2, 129))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])}
    opt = OptConfig()
    step = make_train_step(cfg32, opt)
    t0 = time.perf_counter()
    pc, oc, mc = step(p_cpu, init_opt_state(p_cpu), batch)
    cpu_s = time.perf_counter() - t0
    pd, od, md = step(p_dev, init_opt_state(p_dev),
                      {k_: v_.to(dev) for k_, v_ in batch.items()})
    lr0 = float(mc["lr"])
    for key in ("loss", "grad_norm"):
        a, b = float(md[key]), float(mc[key])
        if not math.isclose(a, b, rel_tol=1e-3):
            fail(f"[train] float32 train_step {key}: card {a}, CPU {b}")
    # updated params: AdamW's first step moves each element by about lr x
    # sign(g), so a near-zero gradient whose sign differs between the two
    # devices moves it 2 lr apart: held within 2.5 lr
    p_err, n_far, n_all = 0.0, 0, 0
    for a, b in zip(_leaves(pd), _leaves(pc)):
        d_ = (a.cpu() - b).abs()
        p_err = max(p_err, d_.max().item())
        n_far += int((d_ > 1e-6).sum())
        n_all += d_.numel()
    if p_err > 2.5 * lr0:
        fail(f"[train] float32 train_step params: card vs CPU max abs err "
             f"{p_err} > 2.5 lr ({2.5 * lr0})")
    # the first moment after step 1 is 0.1 x clip x g: the clipped gradient
    # itself, leaf by leaf. Held within rtol 1e-3 and an atol of 1e-3 of
    # the leaf's largest |mu| on the CPU (a gradient wrong in direction but
    # right in norm fails here, where the params' lr-sized step cannot see
    # it)
    mu_err = 0.0
    for i, (a, b) in enumerate(zip(_leaves(od["mu"]), _leaves(oc["mu"]))):
        a, top = a.cpu(), b.abs().max().item()
        err = ((a - b).abs().max().item() / top) if top > 0 else 0.0
        mu_err = max(mu_err, err)
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-3 * top):
            fail(f"[train] float32 train_step mu leaf {i}: card vs CPU max "
                 f"abs err {err} of the leaf's max (rtol 1e-3, atol 1e-3 "
                 f"x max)")
    out["card_vs_cpu"] = {"loss": [float(md["loss"]), float(mc["loss"])],
                          "grad_norm": [float(md["grad_norm"]),
                                        float(mc["grad_norm"])],
                          "param_max_abs_err": p_err, "lr": lr0,
                          "mu_max_err_of_leaf_max": mu_err,
                          "frac_over_1e-6": n_far / n_all, "cpu_s": cpu_s}
    say(f"[train] smollm-135m float32 full size, one train_step at B 2, S "
        f"128, card vs CPU: loss {float(md['loss']):.6f} / "
        f"{float(mc['loss']):.6f}, grad norm {float(md['grad_norm']):.6f} / "
        f"{float(mc['grad_norm']):.6f} (rtol 1e-3); params max abs err "
        f"{p_err:.3g} (<= 2.5 lr = {2.5 * lr0:.3g}), "
        f"{n_far / n_all:.2e} of elements apart by more than 1e-6; mu (the "
        f"clipped gradient) leaf by leaf max abs err {mu_err:.3g} of the "
        f"leaf's max (rtol 1e-3, atol 1e-3 x max)")
    del p_cpu, p_dev, pc, pd, oc, od, step
    free(torch, out)

    # -- 11c. the entry point: 40 steps of bf16 smollm-135M -----------------
    work = ROOT / "build" / "train_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    argv = ["--arch", "smollm-135m", "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--ckpt", str(work / "a"),
            "--out", str(work / "a.json")]
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    _, m1 = launch_train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    k4_main = _lib.launch_counts()["flash_attention"]
    losses = m1["losses"]
    if len(losses) != TRAIN_STEPS or m1["history"]["completed"] != \
            TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"[train] the entry point: {len(losses)} losses, history "
             f"{m1['history']}, finite {all(map(math.isfinite, losses))}")
    if not losses[-1] < losses[0] - 0.3:
        fail(f"[train] no learning: loss {losses[0]:.4f} -> "
             f"{losses[-1]:.4f}")
    ckpt_steps = sorted(int(p.name.split("_")[1]) for p in
                        (work / "a").glob("step_*"))
    if not ckpt_steps or not (work / "a" / "LATEST").exists() or \
            not (work / "a.json").exists():
        fail(f"[train] no checkpoint or metrics on disk ({ckpt_steps})")
    per_step = k4_main / TRAIN_STEPS
    out["entry_point"] = {"losses": losses, "history": m1["history"],
                          "seconds": run_s, "k4_launches": k4_main,
                          "checkpoints": ckpt_steps}
    say(f"[train] python -m repro_torch.launch.train {' '.join(argv)}: "
        f"{TRAIN_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"checkpoints {ckpt_steps}, {run_s:.1f} s with checkpoints; K4 "
        f"launches {k4_main} ({per_step:g} per step)")
    free(torch, out)

    # -- 11d. the same run with a failure injected after step 24's save ------
    cfg = get_config("smollm-135m")
    opt = OptConfig(lr=3e-4, schedule="cosine", total_steps=TRAIN_STEPS,
                    warmup_steps=max(1, TRAIN_STEPS // 20))
    _, m2 = train(cfg, make_host_mesh(1, 1), opt_cfg=opt,
                  tc=TrainConfig(num_steps=TRAIN_STEPS,
                                 ckpt_dir=str(work / "b")),
                  seq_len=TRAIN_S, global_batch=TRAIN_B, device="cuda",
                  fail_at={25: InjectedFailure("injected after step 24's "
                                               "checkpoint")})
    h = m2["history"]
    if h["restarts"] != 1 or h["completed"] != TRAIN_STEPS or \
            len(m2["losses"]) != TRAIN_STEPS:
        fail(f"[train] recovery: history {h}, {len(m2['losses'])} losses")
    after = np.array(m2["losses"][25:])
    want = np.array(losses[25:])
    diff = float(np.abs(after - want).max())
    if not np.allclose(after, want, rtol=1e-2, atol=0):
        fail(f"[train] recovery: losses from the restart {after} vs the "
             f"uninterrupted run's {want}")
    out["recovery"] = {"history": h, "losses": m2["losses"],
                       "max_abs_diff_after_restart": diff}
    say(f"[train] recovery: a failure injected at step 25 (after the step-"
        f"24 checkpoint): restarts {h['restarts']}, completed "
        f"{h['completed']}; losses of steps 25-39 within rtol 1e-2 of the "
        f"uninterrupted run's (largest difference {diff:.3g})")
    shutil.rmtree(work, ignore_errors=True)
    free(torch, out)

    # -- 11e. the (2, 1) data mesh, two processes on the card ---------------
    out["mesh"] = two_process_train(torch, np)
    free(torch, out)

    # -- 11f. launches and time of one training step -----------------------
    mesh = make_host_mesh(1, 1)
    params, opt_state, _ = build_state(cfg, mesh, zero1=False, seed=SEED,
                                       device="cuda")
    from repro_torch.data import DataConfig, SyntheticTokens
    ds = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_S, global_batch=TRAIN_B,
                                    seed=SEED))
    batch = {k_: torch.as_tensor(v_).to(dev) for k_, v_ in
             ds.batch(0).items()}
    step = make_train_step(cfg, opt)

    def one():
        return float(step(params, opt_state, batch)[2]["loss"])

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counted = _lib.launch_counts()["flash_attention"] / len(times)
    step_ms = statistics.median(times)
    mem_gb = torch.cuda.max_memory_allocated() / 1e9
    (by_name, busy_us, wall_us, names), tries = profile_confirm(
        torch, one, lambda ns: sum("flash_attention_kernel" in n
                                   for n in ns), int(counted))
    if names and tries[-1] != counted:
        fail(f"[train] profiler saw {tries} K4 launches in a step "
             f"({len(tries)} tries), the counters {counted}")
    if counted != 2 * cfg.num_layers or per_step != counted:
        fail(f"[train] K4 launches per step: counters {counted} (entry "
             f"point {per_step}), want {2 * cfg.num_layers} (30 forward + "
             "30 in the full remat's recomputation)")
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = TRAIN_B * TRAIN_S
    flops = 6 * n_params * tokens + \
        6 * cfg.num_layers * TRAIN_B * cfg.num_heads * TRAIN_S ** 2 * cfg.hd
    idle = 1 - busy_us / wall_us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out["step"] = {"step_ms": step_ms, "times_ms": times,
                   "tokens_per_s": tokens / step_ms * 1e3,
                   "k4_per_step": counted, "profiler_k4": tries,
                   "busy_us": busy_us, "profiled_wall_us": wall_us,
                   "idle_share": idle, "max_memory_allocated_gb": mem_gb,
                   "model_flops": flops, "n_params": n_params,
                   "bf16_peak_share": flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
                   "top": top}
    say(f"[train] smollm-135m bf16 B {TRAIN_B} S {TRAIN_S}, remat full: K4 "
        f"launches per step {counted:g} (counters), profiler {tries}; "
        f"{smi}")
    say(f"[train] step median {step_ms:.2f} ms over {len(times)} steps after "
        f"3 warm-up ({min(times):.2f}-{max(times):.2f}); {smi}")
    say(f"[train] tokens/s {tokens / step_ms * 1e3:.0f}; {smi}")
    say(f"[train] profiled step: busy {busy_us:.0f} us of {wall_us:.0f} us "
        f"wall, idle share {idle:.3f}; top: " + ", ".join(
            f"{n_} {us:.0f} us" for n_, us in top) + f"; {smi}")
    say(f"[train] torch.cuda.max_memory_allocated {mem_gb:.2f} GB; {smi}")
    say(f"[train] modeled FLOPs per step {flops / 1e12:.3f} T (6 x "
        f"{n_params / 1e6:.1f} M params x {tokens} tokens + causal "
        f"attention), {flops / (step_ms / 1e3) / 1e12:.1f} TFLOP/s = "
        f"{flops / (step_ms / 1e3) / PEAK_BF16_FLOPS:.4f} of the bf16 dense "
        f"peak (989 TFLOP/s); {smi}")
    del params, opt_state, step
    free(torch, out)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[train] phase {out['phase_s']:.1f} s, "
        f"torch.cuda.max_memory_allocated "
        f"{out['max_memory_allocated_gb']:.1f} GB")
    return k4_main


# -- 12. tensor parallelism on the card, and the dry run against it ----------

# the (1, 3) model mesh of phase 12a: three processes on the one card
TP_WORLD, TP_LAYERS, TP_B, TP_S, TP_STEPS, TP_NEW = 3, 4, 8, 128, 2, 2
# a first AdamW step maps a gradient g to about g / (|g| + eps): at the
# default eps 1e-8 a gradient that is 0 in exact arithmetic or a few 1e-9
# turns the summation order's rounding into a large part of a step, so the
# comparison takes eps 1e-3 (the gradients themselves, in the moments, are
# compared at the same tolerance); the same steps at the default eps are
# run too and their largest disagreement printed, not held
TP_EPS, DEFAULT_EPS = 1e-3, 1e-8


# phase 12a's encdec run on the same mesh: seamless-m4t-medium at full
# width (16 heads, which do not divide over 3: the self-attention cache
# and the cross-attention keys and values are cut on positions), 2
# encoder and 2 decoder layers, float32, B 8, source and prompt of 48, a
# cache of 54
S2S_LAYERS, S2S_S, S2S_LEN = 2, 48, 54
# the (1, 2) model mesh of phase 12d: two processes on the one card,
# smollm-135M at full width with an int8 KV cache (3 kv heads do not
# divide over 2: the cache and its scales are cut on positions), 4 of 30
# layers, float32, B 8, prompts of 128, a cache of 136; logits held to
# max|d| <= KV8_TOL x max|logits|: the int8 twin's bf16-ulp limit of
# tests/test_torch_models.py (4e-3)
KV8_WORLD, KV8_LEN, KV8_TOL = 2, 136, 4e-3


def _tp_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("smollm-135m"), dtype="float32",
                               num_layers=TP_LAYERS)


def _s2s_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("seamless-m4t-medium"),
                               dtype="float32", enc_layers=S2S_LAYERS,
                               dec_layers=S2S_LAYERS)


def _kv8_cfg():
    import dataclasses
    return dataclasses.replace(_tp_cfg(), kv_cache_dtype="int8")


def _serve_on_mesh(cfg, mesh, whole, batch, max_len, prefix="",
                   enc_len=0, keep_cache=False) -> dict:
    """A prefill and TP_NEW greedy decode steps of `cfg` from the whole
    params `whole` on this rank of `mesh` (its slices of the params and
    the cache, as `param_shardings` and `cache_shardings` cut them):
    `prefix` + logits{i} (gathered whole), tokens{i}, k4_prefill and
    k4_decode (K4's launches in the prefill and in each decode step on
    this rank), cut (the cache leaves cut on positions) and, with
    `keep_cache`, prefill_cache/{leaf} and cache/{leaf} (the cache after
    the prefill and after the last step, gathered whole)."""
    import numpy as np
    import torch
    from repro_torch.distribution.context import with_mesh_context
    from repro_torch.distribution.sharding import (NamedSharding, P,
                                                   cache_shardings,
                                                   param_shardings)
    from repro_torch.kernels import _lib
    from repro_torch.models import decode_step, init_cache, prefill_step
    from repro_torch.tree import tree_map
    B = batch["tokens"].shape[0]
    ps = param_shardings(cfg, mesh, whole)
    cache = init_cache(cfg, B, max_len, enc_len=enc_len, device="cuda")
    cs = cache_shardings(cfg, mesh, cache)
    p_loc = tree_map(lambda s_, x_: s_.shard(x_.cuda()), ps, whole)
    c_loc = {k: cs[k].shard(v) for k, v in cache.items()}
    rows = NamedSharding(mesh, P())
    out = {prefix + "cut": np.array(sorted(
        k for k, s_ in cs.items() if len(s_.spec) > 3 and s_.spec[3]))}
    _lib.reset_launch_counts()
    with torch.no_grad(), with_mesh_context(mesh, params=ps, cache=cs):
        logits, c_loc = prefill_step(cfg)(p_loc, batch, c_loc)
        torch.cuda.synchronize()
        out[prefix + "k4_prefill"] = np.array(
            _lib.launch_counts()["flash_attention"])
        if keep_cache:
            for k, v in c_loc.items():
                out[f"{prefix}prefill_cache/{k}"] = \
                    cs[k].gather(v).cpu().numpy()
        k4 = []
        for i in range(TP_NEW + 1):
            out[f"{prefix}logits{i}"] = rows.gather(
                logits).float().cpu().numpy()
            if i == TP_NEW:
                break
            tok = torch.argmax(logits[:, -1], -1, keepdim=True)
            out[f"{prefix}tokens{i}"] = tok.cpu().numpy()
            _lib.reset_launch_counts()
            logits, c_loc = decode_step(cfg)(p_loc, c_loc, tok)
            torch.cuda.synchronize()
            k4.append(_lib.launch_counts()["flash_attention"])
        out[prefix + "k4_decode"] = np.array(k4)
        if keep_cache:
            for k, v in c_loc.items():
                out[f"{prefix}cache/{k}"] = cs[k].gather(v).cpu().numpy()
    return out


def _tp_run(mesh, profile: bool = False) -> dict:
    """Phase 12a's run on this rank of `mesh`: TP_STEPS ZeRO-1 train steps,
    a prefill and TP_NEW greedy decode steps of smollm-135M (full width,
    TP_LAYERS layers, float32) on the card, every result gathered whole;
    this rank's replicated leaves and its K4 launches per step."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels import _lib
    from repro_torch.models.transformer import init_params
    from repro_torch.train.loop import build_state, sharded_train_step
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import flatten_with_path, path_str, tree_map
    cfg = _tp_cfg()
    whole = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    params, opt, (ps, os_) = build_state(cfg, mesh, params=whole,
                                         device="cuda")
    step = sharded_train_step(cfg, mesh, OptConfig(
        total_steps=10, warmup_steps=1, eps=TP_EPS), ps, os_)
    ds = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=TP_S,
                                    global_batch=TP_B, seed=SEED))
    out, k4 = {}, []
    for i in range(TP_STEPS):
        batch = {k: torch.as_tensor(v).cuda() for k, v in
                 ds.batch(i).items()}
        _lib.reset_launch_counts()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        k4.append(_lib.launch_counts()["flash_attention"])
        out[f"loss{i}"] = np.array(float(m["loss"]))
        out[f"grad_norm{i}"] = np.array(float(m["grad_norm"]))
    if profile:
        # every rank profiles the same steps (the step's collectives);
        # the step is pure, so the state stays as it was
        before = [x.clone() for x in _leaves(params)]
        by, busy, wall, names = profile_once(
            torch, lambda: step(params, opt, batch))
        out["profiler_k4"] = np.array(
            sum("flash_attention_kernel" in n for n in names))
        if not all(torch.equal(a, b) for a, b in zip(before,
                                                     _leaves(params))):
            fail("[tp] a train step changed its input params in place")
    for pth, x in flatten_with_path(tree_map(lambda s_, x_: s_.gather(x_),
                                             ps, params)):
        out["p/" + path_str(pth)] = x.float().cpu().numpy()
    for pth, x in flatten_with_path(tree_map(lambda s_, x_: s_.gather(x_),
                                             os_["mu"], opt["mu"])):
        out["mu/" + path_str(pth)] = x.float().cpu().numpy()
    for (pth, x), s_ in zip(flatten_with_path(params),
                            [s_ for _, s_ in flatten_with_path(ps)]):
        if not s_.cuts():
            out["local/" + path_str(pth)] = x.float().cpu().numpy()
    out["k4_train"] = np.array(k4)
    # the same steps at AdamW's default eps (printed, not held)
    params, opt, _ = build_state(cfg, mesh, params=whole, device="cuda")
    step = sharded_train_step(cfg, mesh, OptConfig(
        total_steps=10, warmup_steps=1, eps=DEFAULT_EPS), ps, os_)
    for i in range(TP_STEPS):
        params, opt, _ = step(params, opt, {
            k: torch.as_tensor(v).cuda() for k, v in ds.batch(i).items()})
    for pth, x in flatten_with_path(tree_map(lambda s_, x_: s_.gather(x_),
                                             ps, params)):
        out["eps8/" + path_str(pth)] = x.float().cpu().numpy()
    del params, opt, step
    rng = np.random.default_rng(SEED + 12)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TP_B, TP_S)),
                              device="cuda")
    out.update(_serve_on_mesh(cfg, mesh, whole, {"tokens": prompts},
                              TP_S + 8))
    del whole
    # seamless-m4t-medium on the same mesh, its caches cut on positions
    cfg = _s2s_cfg()
    whole = init_params(cfg, torch.Generator("cuda").manual_seed(SEED))
    src = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TP_B, S2S_S)),
                          device="cuda")
    out.update(_serve_on_mesh(cfg, mesh, whole, {"tokens": src,
                                                 "src_tokens": src},
                              S2S_LEN, "s2s/", enc_len=S2S_S))
    return out


def _kv8_run(mesh) -> dict:
    """Phase 12d's run on this rank of `mesh`: a prefill and TP_NEW
    greedy decode steps of smollm-135M (full width, TP_LAYERS layers,
    float32) over an int8 KV cache on the card."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import init_params
    cfg = _kv8_cfg()
    whole = init_params(cfg, torch.Generator("cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED + 13)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TP_B, TP_S)),
                              device="cuda")
    return _serve_on_mesh(cfg, mesh, whole, {"tokens": prompts}, KV8_LEN,
                          keep_cache=True)


def tp_rank_main(rank: int, world: int, work: Path) -> None:
    """One rank of phase 12a (run as `chip_smoke.py --tp-rank R W DIR`):
    join a gloo group on the card and run `_tp_run` on the (1, W) model
    mesh."""
    import datetime
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/rendezvous", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=180))
    from repro_torch.launch.mesh import make_host_mesh
    out = _tp_run(make_host_mesh(data=1, model=world), profile=True)
    np.savez(work / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def kv8_rank_main(rank: int, world: int, work: Path) -> None:
    """One rank of phase 12d (run as `chip_smoke.py --kv8-rank R W DIR`):
    join a gloo group on the card and run `_kv8_run` on the (1, W) model
    mesh."""
    import datetime
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/rendezvous", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=180))
    from repro_torch.launch.mesh import make_host_mesh
    out = _kv8_run(make_host_mesh(data=1, model=world))
    np.savez(work / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def _spawn_ranks(flag: str, world: int, work: Path, timeout: int):
    """Start `world` processes of this script with `flag R world work`
    together; fail with their output if one does not end well."""
    if work.exists():
        for f in work.iterdir():
            f.unlink()
    work.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(r),
         str(world), str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        fail(f"{flag}: a rank did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        fail(f"{flag}: a rank failed:\n" + "\n".join(
            log[-3000:] for log in logs))
    return logs


def _dryrun_cli(args: list) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(ROOT / "build" / "dryrun_smoke.jsonl")],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def tp_phase(torch, np, kernels, report, smi, parts: str = "abcd") -> int:
    """Phase 12 (its sub-phases `parts`). Returns K4's launches on the
    tensor-parallel paths of phases 12a (all ranks: the train steps and
    the two prefills) and 12d (all ranks' prefills)."""
    out = report.setdefault("tp", {})
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # (c) starts first: two production cells on the host, beside the rest
    cells = {"smollm-135m train_4k 16x16": _dryrun_cli(
                 ["--arch", "smollm-135m", "--shape", "train_4k", "--mesh",
                  "single"]),
             "zamba2-1.2b decode_32k 2x16x16": _dryrun_cli(
                 ["--arch", "zamba2-1.2b", "--shape", "decode_32k",
                  "--mesh", "multi"])} if "c" in parts else {}
    t_cells = time.perf_counter()
    k4_path = 0
    if "a" in parts:
        k4_path = _tp_mesh_check(torch, np, kernels, out, smi)
    if "d" in parts:
        k4_path += _kv8_mesh_check(torch, np, kernels, out, smi)
    if "b" in parts:
        _dryrun_check(torch, np, kernels, out, smi)
    for name, p in cells.items():
        out.setdefault("cells", {})[name] = _production_cell(name, p)
    out["cells_wall_s"] = time.perf_counter() - t_cells
    out["phase_s"] = time.perf_counter() - t_phase
    return k4_path


def k4_against_plain(torch, kernels, out, tag, shape, dtype, atol,
                     rtol, causal: bool = True, sq=None) -> float:
    """K4 against its plain version on card tensors of `dtype` at the
    shape (B, Hq, Hkv, S, D) that a phase-12 path gives it (`sq` q rows
    against S keys when given), causal or not; fail outside atol/rtol.
    Adds the error to K4's max_abs_err."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    B, Hq, Hkv, S, D = shape
    gen = torch.Generator("cuda").manual_seed(SEED + 12)
    q, k, v = (torch.randn(s_, generator=gen, device="cuda").to(dtype)
               for s_ in ((B, Hq, sq or S, D), (B, Hkv, S, D),
                          (B, Hkv, S, D)))
    got = flash_attention(q, k, v, causal=causal).float()
    want = flash_attention_plain(q, k, v, causal).float()
    err = (got - want).abs().max().item()
    mode = "causal" if causal else "non-causal"
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        fail(f"[{tag}] K4 {shape} {mode} {dtype} disagrees with its plain "
             f"version (max abs err {err}, atol {atol}, rtol {rtol})")
    k4 = kernels["flash_attention"]
    k4["max_abs_err"] = max(k4["max_abs_err"], err)
    out.setdefault("k4_against_plain", []).append(
        {"shape": list(shape), "sq": sq, "causal": causal,
         "dtype": str(dtype), "max_abs_err": err, "atol": atol,
         "rtol": rtol})
    rows = f" ({sq} q rows)" if sq else ""
    say(f"[{tag}] K4 at this path's shape {shape}{rows} {mode} {dtype}: "
        f"max abs err {err:.3g} against the plain version (atol {atol}, "
        f"rtol {rtol})")
    del q, k, v, got, want
    return err


def _tp_mesh_check(torch, np, kernels, out, smi) -> int:
    """Phase 12a: the (1, 3) model mesh, three processes on the card."""
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    work = ROOT / "build" / "tp_three_process"
    _spawn_ranks("--tp-rank", TP_WORLD, work, 420)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(TP_WORLD)]
    secs = time.perf_counter() - t0
    want = _tp_run(make_host_mesh(1, 1))
    worst = {"train": 0.0, "logits": 0.0, "s2s": 0.0}
    bad = []
    for r, got in enumerate(ranks):
        for k, w in want.items():
            if k.startswith(("p/", "mu/", "logits", "s2s/logits")):
                scale = float(np.abs(w).max()) or 1.0
                err = float(np.abs(got[k] - w).max())
                train = k.startswith(("p/", "mu/"))
                what = "train" if train else k.split("/")[0] \
                    if "/" in k else "logits"
                worst[what] = max(worst[what], err / scale)
                tol = (1e-4, 1e-5) if train else (1e-3, 1e-3)
                if not np.allclose(got[k], w, rtol=tol[0],
                                   atol=tol[1] * scale):
                    bad.append(f"rank {r} {k}: max abs err {err:.3g} "
                               f"(max |x| {scale:.3g})")
            elif k.startswith(("tokens", "loss", "grad_norm",
                               "s2s/tokens")) and \
                    not np.allclose(got[k], w, rtol=1e-5, atol=0):
                bad.append(f"rank {r} {k}: {got[k].ravel()[:8]} vs one "
                           f"rank's {w.ravel()[:8]}")
        for k in got:
            if k.startswith("local/") and not np.array_equal(
                    got[k], ranks[0][k]):
                bad.append(f"replicated leaf {k} differs between ranks 0 "
                           f"and {r}")
    if bad:
        fail(f"[tp] {len(bad)} disagreements with one rank:\n  "
             + "\n  ".join(bad[:24]))
    per_step = [int(x) for x in ranks[0]["k4_train"]]
    prof = int(ranks[0]["profiler_k4"])
    # 4 layers forward and 4 in the full remat's recomputation, each on
    # the rank's 3 q heads and 1 kv head
    if any(int(r_["k4_train"][i]) != 2 * TP_LAYERS for r_ in ranks
           for i in range(TP_STEPS)) or prof != 2 * TP_LAYERS:
        fail(f"[tp] K4 launches per rank per step: counters "
             f"{[list(r_['k4_train']) for r_ in ranks]}, profiler {prof}, "
             f"want {2 * TP_LAYERS}")
    if any(int(r_["k4_prefill"]) != TP_LAYERS for r_ in ranks):
        fail(f"[tp] K4 launches per prefill: "
             f"{[int(r_['k4_prefill']) for r_ in ranks]}, want {TP_LAYERS}")
    # seamless: each encoder layer's self attention, each decoder layer's
    # self and cross attention, on all 16 heads on every rank
    if any(list(r_["s2s/cut"]) != ["k", "v", "xk", "xv"] for r_ in ranks):
        fail(f"[tp] seamless: the ranks cut {list(ranks[0]['s2s/cut'])} on "
             f"positions, want k, v, xk and xv")
    s2s_k4 = [int(r_["s2s/k4_prefill"]) for r_ in ranks]
    if any(n != 3 * S2S_LAYERS for n in s2s_k4):
        fail(f"[tp] seamless K4 launches per prefill per rank: {s2s_k4}, "
             f"want {3 * S2S_LAYERS}")
    # each decoder layer's cross attention over the gathered encoder
    # positions; smollm's decode attends outside K4
    s2s_step = [[int(n) for n in r_["s2s/k4_decode"]] for r_ in ranks]
    if any(n != S2S_LAYERS for r_ in s2s_step for n in r_) or any(
            r_["k4_decode"].any() for r_ in ranks):
        fail(f"[tp] K4 launches per decode step per rank: seamless "
             f"{s2s_step} (want {S2S_LAYERS}), smollm "
             f"{[list(r_['k4_decode']) for r_ in ranks]} (want 0)")
    k4_path = sum(int(r_["k4_train"].sum()) + int(r_["k4_prefill"])
                  + int(r_["s2s/k4_prefill"]) + int(r_["s2s/k4_decode"].sum())
                  for r_ in ranks)
    # the default eps: the leaf that disagrees most with one rank
    eps8 = {"eps": DEFAULT_EPS, "err_over_max": -1.0}
    for r, got in enumerate(ranks):
        for k, w in want.items():
            if not k.startswith("eps8/"):
                continue
            scale = float(np.abs(w).max()) or 1.0
            err = float(np.abs(got[k] - w).max())
            if err / scale > eps8["err_over_max"]:
                eps8.update(leaf=k[5:], rank=r, max_abs_err=err,
                            err_over_max=err / scale,
                            outside_tolerance=int(np.sum(~np.isclose(
                                got[k], w, rtol=1e-4, atol=1e-5 * scale))))
    out["default_eps"] = eps8
    say(f"[tp] the same {TP_STEPS} train steps at AdamW eps {DEFAULT_EPS} "
        f"(not held): largest disagreement with one rank in {eps8['leaf']} "
        f"(rank {eps8['rank']}), max abs err {eps8['max_abs_err']:.3g} = "
        f"{eps8['err_over_max']:.3g} of its max, "
        f"{eps8['outside_tolerance']} elements outside rtol 1e-4 / atol "
        f"1e-5 x max")
    # K4 at the shape each rank gives it: its 3 q heads and 1 kv head
    cfg = _tp_cfg()
    k4_against_plain(torch, kernels, out, "tp", (
        TP_B, cfg.num_heads // TP_WORLD, cfg.num_kv_heads // TP_WORLD, TP_S,
        cfg.hd), torch.float32, 3e-5, 1e-4)
    s2s = _s2s_cfg()
    for causal in (True, False):
        k4_against_plain(torch, kernels, out, "tp", (
            TP_B, s2s.num_heads, s2s.num_kv_heads, S2S_S, s2s.hd),
            torch.float32, 3e-5, 1e-4, causal)
    # the decode step's cross attention: one q row per sequence
    k4_against_plain(torch, kernels, out, "tp", (
        TP_B, s2s.num_heads, s2s.num_kv_heads, S2S_S, s2s.hd),
        torch.float32, 3e-5, 1e-4, False, sq=1)
    out["mesh"] = {"seconds": secs, "worst_rel": worst,
                   "s2s_k4_per_prefill": s2s_k4,
                   "s2s_k4_per_decode_step": s2s_step,
                   "k4_per_rank_step": per_step, "profiler_k4": prof,
                   "losses": [float(ranks[0][f"loss{i}"])
                              for i in range(TP_STEPS)]}
    say(f"[tp] (1, {TP_WORLD}) model mesh, {TP_WORLD} processes on the card "
        f"over gloo, smollm-135m full width ({TP_LAYERS} of 30 layers, "
        f"float32, 3 q heads and 1 kv head a rank), zero1, B {TP_B} S "
        f"{TP_S}: {TP_STEPS} train steps, whole-gathered leaves within rtol "
        f"1e-4 of one rank (largest err / max|leaf| {worst['train']:.3g}), "
        f"replicated leaves bit-equal across ranks; prefill + {TP_NEW} "
        f"decode steps: logits within rtol 1e-3 (largest err / max|logit| "
        f"{worst['logits']:.3g}), greedy tokens equal; K4 per rank per step "
        f"{per_step} (counters), {prof} (profiler), {TP_LAYERS} per prefill; "
        f"{secs:.1f} s with start-up; {smi}")
    say(f"[tp] the same mesh serves seamless-m4t-medium at full width "
        f"(d_model {s2s.d_model}, {s2s.num_heads} heads, vocab "
        f"{s2s.vocab_size}; {S2S_LAYERS} + {S2S_LAYERS} layers, float32), "
        f"B {TP_B}, source and prompt {S2S_S}, a cache of {S2S_LEN}: "
        f"{s2s.num_heads} heads do not divide over {TP_WORLD}, so k/v and "
        f"xk/xv are cut on positions; prefill + {TP_NEW} decode steps: logits within "
        f"rtol 1e-3 (largest err / max|logit| {worst['s2s']:.3g}), greedy "
        f"tokens equal; K4 per rank: {s2s_k4} per prefill, {s2s_step} "
        f"per decode step (cross attention over the gathered encoder "
        f"positions); {smi}")
    free(torch, out)
    return k4_path


def _kv8_mesh_check(torch, np, kernels, out, smi) -> int:
    """Phase 12d: the (1, 2) model mesh over an int8 KV cache cut on
    positions, two processes on the card, against one rank. Returns K4's
    launches in the ranks' prefills."""
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    work = ROOT / "build" / "kv8_two_process"
    _spawn_ranks("--kv8-rank", KV8_WORLD, work, 300)
    ranks = [dict(np.load(work / f"rank{r}.npz"))
             for r in range(KV8_WORLD)]
    secs = time.perf_counter() - t0
    want = _kv8_run(make_host_mesh(1, 1))
    # the largest err / max|x| of each logits leaf; the cache's int8
    # elements that differ from one rank's (by 1 at most); the scales'
    # largest relative err at the prefill's positions and err / max at
    # the decode steps'
    worst, flips, scale_err, bad = {}, {}, {}, []
    pre = (slice(None),) * 3 + (slice(0, TP_S),)
    dec = (slice(None),) * 3 + (slice(TP_S, None),)
    for r, got in enumerate(ranks):
        for k, w in want.items():
            g_ = got[k]
            if k.startswith("logits"):
                scale = float(np.abs(w).max()) or 1.0
                err = float(np.abs(g_ - w).max())
                worst[k] = max(worst.get(k, 0.0), err / scale)
                if err > KV8_TOL * scale:
                    bad.append(f"rank {r} {k}: max abs err {err:.3g} "
                               f"(max |x| {scale:.3g})")
            elif k.startswith("tokens") and not np.array_equal(g_, w):
                bad.append(f"rank {r} {k}: {g_.ravel()} vs one rank's "
                           f"{w.ravel()}")
            elif k.startswith("cache/") and w.dtype == np.int8:
                d = np.abs(g_.astype(np.int32) - w.astype(np.int32))
                flips[k[6:]] = max(flips.get(k[6:], 0), int((d > 0).sum()))
                if d.max() > 1:
                    bad.append(f"rank {r} {k}: int8 elements differ by up "
                               f"to {d.max()}")
            elif k.startswith("cache/") and k.endswith("_scale"):
                rel = float((np.abs(g_[pre] - w[pre]) / w[pre]).max())
                top = float(np.abs(w[dec]).max()) or 1.0
                rel_dec = float(np.abs(g_[dec] - w[dec]).max()) / top
                was = scale_err.get(k[6:], (0.0, 0.0))
                scale_err[k[6:]] = (max(was[0], rel), max(was[1], rel_dec))
                if rel > 1e-5 or rel_dec > KV8_TOL:
                    bad.append(f"rank {r} {k}: relative err {rel:.3g} at "
                               f"the prefill's positions (rtol 1e-5), "
                               f"{rel_dec:.3g} of max at the decode's "
                               f"(limit {KV8_TOL})")
            elif k.startswith("cache/") and not np.array_equal(g_, w):
                bad.append(f"rank {r} {k} differs from one rank's")
    if bad:
        fail(f"[kv8] {len(bad)} disagreements with one rank:\n  "
             + "\n  ".join(bad[:24]))
    if any(list(r_["cut"]) != ["k", "k_scale", "v", "v_scale"]
           for r_ in ranks):
        fail(f"[kv8] the ranks cut {list(ranks[0]['cut'])} on positions, "
             f"want k, k_scale, v and v_scale")
    # every rank attends all 9 q heads in each layer of the prefill
    k4 = [int(r_["k4_prefill"]) for r_ in ranks]
    if any(n != TP_LAYERS for n in k4):
        fail(f"[kv8] K4 launches per prefill per rank: {k4}, want "
             f"{TP_LAYERS}")
    cfg = _kv8_cfg()
    k4_against_plain(torch, kernels, out, "kv8", (
        TP_B, cfg.num_heads, cfg.num_kv_heads, TP_S, cfg.hd),
        torch.float32, 3e-5, 1e-4)
    if any(r_["k4_decode"].any() for r_ in ranks):
        fail(f"[kv8] K4 launched in a decode step: "
             f"{[list(r_['k4_decode']) for r_ in ranks]}")
    # which part of logits1's difference the cache carries: one rank's
    # first decode step from the ranks' gathered prefill cache, against
    # one rank's own (the cache's share) and the ranks' (the decode's)
    from repro_torch.models import decode_step, init_params
    cfg = _kv8_cfg()
    whole = init_params(cfg, torch.Generator("cuda").manual_seed(SEED))
    cache = {k[len("prefill_cache/"):]: torch.as_tensor(v, device="cuda")
             for k, v in ranks[0].items() if k.startswith("prefill_cache/")}
    with torch.no_grad():
        lg, _ = decode_step(cfg)(whole, cache, torch.as_tensor(
            ranks[0]["tokens0"], device="cuda"))
    lg = lg.float().cpu().numpy()
    top = float(np.abs(want["logits1"]).max())
    share = {"cache": float(np.abs(lg - want["logits1"]).max()) / top,
             "decode": float(np.abs(lg - ranks[0]["logits1"]).max()) / top}
    if share["decode"] > KV8_TOL:
        fail(f"[kv8] one rank's decode from the ranks' prefill cache is "
             f"{share['decode']:.3g} of max from the ranks' (limit "
             f"{KV8_TOL})")
    del whole, cache
    out["kv8"] = {"seconds": secs, "worst_rel": worst,
                  "int8_elements_off_by_1": flips,
                  "scale_rel_err_prefill_decode": scale_err,
                  "logits1_share": share,
                  "k4_per_prefill": k4, "tolerance": KV8_TOL}
    say(f"[kv8] (1, {KV8_WORLD}) model mesh, {KV8_WORLD} processes on the "
        f"card over gloo, smollm-135m full width ({TP_LAYERS} of 30 layers, "
        f"float32, {cfg.num_heads} q heads and {cfg.num_kv_heads} kv heads) "
        f"with an int8 KV cache of {KV8_LEN} positions cut on positions "
        f"({cfg.num_kv_heads} kv heads do not divide over {KV8_WORLD}), B "
        f"{TP_B}, prompts of {TP_S}: "
        f"prefill + {TP_NEW} decode steps against one rank on the card, "
        f"largest err / max|logit| "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items()))
        + f" (limit {KV8_TOL}), greedy tokens equal; the gathered cache: "
        f"int8 elements off by 1 {flips}, the scales' largest relative "
        f"err at the prefill's positions and err / max at the decode's "
        + ", ".join(f"{k} {a:.3g} / {b:.3g}" for k, (a, b) in
                    sorted(scale_err.items()))
        + f"; logits1 from the ranks' prefill cache on one rank: "
        f"{share['cache']:.3g} of max from one rank's own (the cache's "
        f"share), {share['decode']:.3g} from the ranks' (the decode's); "
        f"K4 per prefill per rank {k4}; {secs:.1f} s with start-up; {smi}")
    free(torch, out)
    return sum(k4)


def _dryrun_check(torch, np, kernels, out, smi) -> None:
    """Phase 12b: the dry run of a training cell against the same step on
    the card."""
    from repro_torch.configs import SHAPES, get_config, input_specs
    from repro_torch.launch.analysis import analyze_counted, model_flops_for
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.hlo_count import OpCounter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import build_state, sharded_train_step
    from repro_torch.train.optimizer import OptConfig
    cfg = get_config("smollm-135m")
    mesh = make_host_mesh(1, 1)
    t0 = time.perf_counter()
    low = lower_cell(cfg, "train_4k", mesh, scale_batch=8 / 256,
                     device="cuda")
    dry_s = time.perf_counter() - t0
    params, opt, (ps, os_) = build_state(cfg, mesh, seed=SEED,
                                         device="cuda")
    spec = input_specs(cfg, "train_4k", scale_batch=8 / 256)["batch"]
    gen = torch.Generator("cuda").manual_seed(SEED)
    batch = {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                              generator=gen, device="cuda",
                              dtype=torch.int32) for k, v in spec.items()}
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in _leaves(tree))
    arg_bytes = nbytes(params) + nbytes(opt["mu"]) + nbytes(opt["nu"]) + \
        opt["step"].numel() * opt["step"].element_size() + nbytes(batch)
    if arg_bytes != low.memory["argument_bytes_per_dev"]:
        fail(f"[dryrun] argument bytes: dry run "
             f"{low.memory['argument_bytes_per_dev']}, card {arg_bytes}")
    step = sharded_train_step(cfg, mesh, OptConfig(), ps, os_,
                              low.microbatches)
    step(params, opt, batch)
    torch.cuda.synchronize()
    with OpCounter() as c:
        c.ignore((params, opt, batch))
        step(params, opt, batch)
    torch.cuda.synchronize()
    if c.cost.flops != low.cost.flops:
        top = sorted(set(c.by_op) | set(low.by_op), key=lambda k: -abs(
            c.by_op.get(k, 0) - low.by_op.get(k, 0)))[:6]
        fail(f"[dryrun] FLOPs per device: dry run {low.cost.flops}, card "
             f"{c.cost.flops}; ops that differ most: " + ", ".join(
                 f"{k} {low.by_op.get(k, 0)} vs {c.by_op.get(k, 0)}"
                 for k in top))
    if "repro_torch.flash_attention" not in c.by_op:
        fail("[dryrun] the card's step never reached K4's custom op")
    # K4 at the shape this step gives it: one microbatch's rows, bf16
    k4_against_plain(torch, kernels, out, "dryrun", (
        8 // low.microbatches, cfg.num_heads, cfg.num_kv_heads,
        SHAPES["train_4k"].seq_len, cfg.hd),
        cfg.torch_dtype, 2e-2, 1e-2)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    roof = analyze_counted("smollm-135m", "train_4k", "1x1", low.cost,
                           model_flops_for(cfg, SHAPES["train_4k"],
                                           cfg.active_param_count()), 1)
    mem = low.memory
    pred_peak = (mem["argument_bytes_per_dev"] + mem["temp_bytes_per_dev"]
                 + mem["output_bytes_per_dev"])
    out["dryrun"] = {
        "seconds": dry_s, "argument_bytes": arg_bytes,
        "flops": c.cost.flops, "microbatches": low.microbatches,
        "k4_flops": c.by_op["repro_torch.flash_attention"],
        "predicted_temp_bytes": mem["temp_bytes_per_dev"],
        "predicted_peak_bytes": pred_peak, "arguments_on_card": base,
        "max_memory_allocated": peak, "step_ms": step_ms, "times_ms": times,
        "bound_ms": roof.bound_s * 1e3, "dominant": roof.dominant,
        "terms_ms": {"compute": roof.t_compute * 1e3,
                     "memory": roof.t_memory * 1e3,
                     "collective": roof.t_collective * 1e3}}
    say(f"[dryrun] smollm-135m train_4k on the 1 x 1 mesh, B 8 S 4096, "
        f"{low.microbatches} microbatches, --device cuda ({dry_s:.1f} s on "
        f"the host): argument bytes {arg_bytes} equal on the card; FLOPs "
        f"per device {c.cost.flops:.6g} equal on the card (K4's formula "
        f"{c.by_op['repro_torch.flash_attention']:.6g})")
    say(f"[dryrun] memory: predicted temp "
        f"{mem['temp_bytes_per_dev'] / 1e9:.3f} GB, predicted peak {pred_peak / 1e9:.3f} GB; on the card "
        f"arguments {base / 1e9:.3f} GB, torch.cuda.max_memory_allocated "
        f"{peak / 1e9:.3f} GB; {smi}")
    say(f"[dryrun] time: H100 roofline bound {roof.bound_s * 1e3:.2f} ms "
        f"({roof.dominant}; compute {roof.t_compute * 1e3:.2f}, memory "
        f"{roof.t_memory * 1e3:.2f} ms) against the measured step "
        f"{step_ms:.2f} ms (median of 3); {smi}")
    del params, opt, step, batch
    free(torch, out)


def _production_cell(name: str, p: subprocess.Popen) -> dict:
    """Phase 12c: one full-size production cell of the dry run's CLI
    (started at the phase's beginning), on the host."""
    try:
        so, se = p.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        p.kill()
        fail(f"[dryrun] {name}: no result in 600 s")
    recs = [json.loads(x) for x in so.splitlines() if x.startswith("{")]
    if p.returncode != 0 or not recs or recs[-1]["status"] != "ok":
        fail(f"[dryrun] {name}: rc {p.returncode}: {so[-1500:]}"
             f"{se[-1500:]}")
    rec = recs[-1]
    r_ = rec["roofline"]
    say(f"[dryrun] {name}: ok in {rec['compile_s']} s; per device "
        f"arguments {rec['memory']['argument_bytes_per_dev'] / 1e9:.3f} "
        f"GB, temp {rec['memory']['temp_bytes_per_dev'] / 1e9:.3f} GB, "
        f"compute {r_['t_compute_s'] * 1e3:.3f} ms, memory "
        f"{r_['t_memory_s'] * 1e3:.3f} ms, collective "
        f"{r_['t_collective_s'] * 1e3:.3f} ms ({r_['dominant']})")
    return rec


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def decode_turn(tree: Path, dest: Path) -> None:
    """One turn of `--decode-turns` (run as `chip_smoke.py --decode-turn
    TREE DEST`): with the package of the checkout at TREE, `step_timings`
    of one bf16 4-row decode step of zamba2-1.2B and rwkv6-1.6B through a
    Server's backend (phases 6 and 7) and of seamless-m4t-medium's
    `decode_step` after a 4 x 128 prefill (phase 9), into DEST."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.hw import scaled_paper_machine
    from repro_torch.kernels import _lib
    from repro_torch.models import decode_step, init_cache, prefill_step
    from repro_torch.serve import Server
    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.build_all()
    rng = np.random.default_rng(SEED)
    res = {"tree": str(tree)}
    zero = {k: 0 for k in LM_KERNELS}
    z = get_config("zamba2-1.2b")
    for tag, cfg, pre, step in (
            ("zamba2", z, {**zero, "flash_attention": z.num_layers
                           // z.attn_every}, {**zero, "ssm_scan":
                                              z.num_layers}),
            ("rwkv", get_config("rwkv6-1.6b"), zero, zero)):
        params, _ = load_params(torch, tag, cfg)
        prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
                   for n in rng.integers(16, 129, size=8)]
        srv = Server(scaled_paper_machine(64), backend="cuda")
        srv.register_decode(tag, cfg, period_s=1.0, params=params, slots=4,
                            prompt_len=128, max_new_tokens=32, max_len=256)
        res[cfg.name] = step_timings(
            torch, f"{cfg.name} bf16", "batch-1 prefill of 128 tokens",
            *backend_steps(srv._nets[tag].cengine.backend, prompts), pre,
            step)
        del params, srv
        free(torch)
    cfg = get_config("seamless-m4t-medium")
    params, _ = load_params(torch, "seamless", cfg)
    src = torch.as_tensor(rng.integers(1, cfg.vocab_size, (4, 128)),
                          device="cuda")
    batch = {"tokens": src, "src_tokens": src}
    _, cache = prefill_step(cfg)(params, batch, init_cache(
        cfg, 4, 256, enc_len=128, device="cuda"))
    tok = torch.tensor([[5], [6], [7], [8]], device="cuda")
    res[cfg.name] = step_timings(
        torch, f"{cfg.name} bf16", "batch-4 prefill of 4 x 128",
        lambda: prefill_step(cfg)(params, batch, init_cache(
            cfg, 4, 256, enc_len=128, device="cuda")),
        lambda: decode_step(cfg)(params, cache, tok),
        {**zero, "flash_attention": cfg.enc_layers + 2 * cfg.dec_layers},
        {**zero, "flash_attention": cfg.dec_layers})
    dest.write_text(json.dumps(res))


def decode_turns(trees: list) -> None:
    """`--decode-turns TREE ...`: `decode_turn` of each tree in turn, each
    in a fresh process, with one line per turn and
    chiprun_out/decode_turns.json."""
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    turns = []
    for i, tree in enumerate(Path(t).resolve() for t in trees):
        dest = out_dir / f"decode_turn{i}.json"
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--decode-turn", str(tree), str(dest)],
                           text=True, capture_output=True)
        if r.returncode != 0:
            fail(f"decode turn {i} ({tree}) failed:\n{r.stdout[-3000:]}\n"
                 f"{r.stderr[-3000:]}")
        turns.append(json.loads(dest.read_text()))
        say(f"[decode turn {i}] {tree.name}: " + "; ".join(
            f"{name} step median {t['decode_step_ms']:.3f} ms, busy "
            f"{t['profile']['decode step']['busy_us']:.0f} us, idle "
            f"{t['profile']['decode step']['idle_share']:.3f}"
            for name, t in turns[-1].items() if isinstance(t, dict))
            + f"; {smi}")
    (out_dir / "decode_turns.json").write_text(json.dumps(
        {"card": smi, "turns": turns}, indent=1))


# each kernel's source and the TPU kernel it replaces
WHERE = {
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
    "tiled_int8": ("src/repro_torch/csrc/tiled_int8.cu",
                   "src/repro/cluster/mesh.py:106"),
    "lut_int8": ("src/repro_torch/csrc/lut_int8.cu",
                 "none: the JAX package has no table op"),
}


def result_lines(torch, report, kernels, launches, smi, clock) -> None:
    """The run's last lines: the phases' seconds, one JSON line with the
    numbers of each kernel in `launches`, the card, and the ok line; the
    whole report to chiprun_out/chip_smoke.json."""
    from repro_torch.kernels import _lib
    line = {"kernels": []}
    for k in _lib.KERNELS:
        if k not in launches:
            continue
        kd = kernels[k]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": WHERE[k][0],
            "replaces": WHERE[k][1], "launches": launches[k],
            "max_abs_err": kd["max_abs_err"], "ms": kd["ms"],
            "plain_ms": kd["plain_ms"], "bound_ms": kd["bound_ms"],
            "bound_by": kd["bound_by"],
            "library_ms": kd["library_ms"]})
    report["kernels"] = line["kernels"]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    report["phases_s"] = clock.summary()
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    say("[phases] " + json.dumps(report["phases_s"]))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main(yolo_only: bool = False) -> None:
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
    clock = Clock()

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
    clock.lap("1 env")

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
    say("[build] tensor-core, dp4a and TMA instructions in the SASS "
        "(cuobjdump -sass): " + "; ".join(
            f"lib{k}.so " + ", ".join(f"{op} x{v[op]}" for op in SASS_OPS)
            + f" ({', '.join(f for op in SASS_OPS for f in v[op + ' forms'])})"
            for k, v in sass.items()))
    say(f"[build] K6: IGMMA x{sass['tiled_int8']['IGMMA']}, TMA loads "
        f"(UTMALDG) x{sass['tiled_int8']['UTMALDG']}")
    # K6 multiplies with wgmma (IGMMA), K1-K3 with mma.sync (IMMA)
    if sass["flash_attention"]["HMMA"] == 0 or any(
            sass[k]["IMMA"] == 0 for k in ("conv2d_im2col", "gemm_int8",
                                           "megakernel")) or \
            sass["tiled_int8"]["IGMMA"] == 0 or \
            sass["tiled_int8"]["UTMALDG"] == 0:
        fail("K4's 16-bit kernels, K2, K1, K3 or K6 hold no tensor-core "
             "instruction, or K6 no TMA load")
    if sass["megakernel"]["IDP"]:
        fail("K3 still multiplies with dp4a")
    clock.lap("2 build")

    rng = np.random.default_rng(SEED)

    def i8(*shape):
        return torch.as_tensor(rng.integers(-128, 128, size=shape)
                               .astype(np.int8)).to(dev)

    def mults(n):
        return torch.as_tensor((0.002 + 0.001 * rng.random(n))
                               .astype(np.float32)).to(dev)

    kernels = {k: {"max_abs_err": 0} for k in _lib.KERNELS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if yolo_only:
        n_lut = yolov5s_phase(torch, np, rng, kernels, report)
        clock.lap("5d yolov5s")
        result_lines(torch, report, kernels, {"lut_int8": n_lut}, smi,
                     clock)
        return

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

    clock.lap("3 CNN kernels")

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
    mk_out = {}                  # the megakernel path's outputs (phase 10)
    for label, (backend, opts, make) in paths.items():
        d = dep.with_backend(backend, options=opts)
        for B in (1, 8):
            out = d.run({"input": inputs[B]}, batched=True)
            if label == "megakernel":
                mk_out[B] = out
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
    # the device time of one batch-1 megakernel program goes
    fn = MK.megakernel_batched(prog, dev)
    xin = C.to_device(prog, {"input": inputs[1]}, dev)
    (by_name, busy_us, wall_us, names), tries = profile_confirm(
        torch, lambda: fn(xin),
        lambda ns: {k: sum(f"{k}_kernel" in n for n in ns)
                    for k in _lib.KERNELS}, path_counts)
    seen, device_events = tries[-1], len(names)
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
        fail(f"profiler saw {tries} kernel launches ({len(tries)} tries), "
             f"counters say {path_counts}")
    else:
        say(f"[path] profiler confirms the launches: {seen}")

    clock.lap("4 CNN path")

    # -- 5. serving -----------------------------------------------------------
    from repro_torch.serve import Server
    srv = Server(hw, backend="cuda", device="cuda")
    _lib.reset_launch_counts()
    verdict = srv.register("resnet50", g, period_s=0.1, slots=4,
                           params=params)
    say(f"[serve] admitted resnet50: bound {verdict.response_bound_s * 1e3:.3f}"
        f" ms, deadline {verdict.deadline_s * 1e3:.1f} ms")
    primed = _lib.graph_counts()
    if primed != {"eager": 1, "captures": 1, "replays": 1,
                  "capture_failures": 0}:
        fail(f"[serve] register did not capture the runner's graph: "
             f"{primed}")
    xs = rng.integers(-64, 64, size=(8, 224, 224, 3)).astype(np.int8)
    tickets = [srv.submit("resnet50", xs[i]) for i in range(8)]
    _lib.reset_launch_counts()
    srv.run(hyperperiods=2)
    torch.cuda.synchronize()
    serve_counts = _lib.launch_counts()
    served = _lib.graph_counts()
    jobs = srv.monitor.checks.get("resnet50", 0)
    if served != {**served, "captures": 0, "eager": 0, "replays": jobs}:
        fail(f"[serve] {jobs} jobs were not all graph replays: {served}")
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
        if not r.deadline_met:
            fail(f"[serve] ticket {t.tid} missed its deadline with no "
                 "fault injected")
    tele = srv.telemetry()
    say(f"[serve] {tele['metrics']['tickets']} tickets, "
        f"{tele['metrics']['jobs']} jobs ({served['replays']} graph "
        f"replays), launches {serve_counts}")
    for k in CNN_KERNELS:
        if serve_counts[k] == 0:
            fail(f"kernel {k} was not launched on the CNN serving path")

    # a replay's launch counts are the ones its capture counted: the
    # profiler, which names the kernels a graph launches, holds them to
    # what one served job runs
    def served_job():
        ts = [srv.submit("resnet50", xs[i]) for i in range(4)]
        while not all(t.terminal for t in ts):
            srv.step()
    _lib.reset_launch_counts()
    served_job()
    torch.cuda.synchronize()
    job_counts = _lib.launch_counts()
    if _lib.graph_counts()["replays"] != 1:
        fail(f"[serve] the served job was no replay: {_lib.graph_counts()}")
    (by_name, busy_us, wall_us, names), tries = profile_confirm(
        torch, served_job,
        lambda ns: {k: sum(f"{k}_kernel" in n for n in ns)
                    for k in _lib.KERNELS}, job_counts)
    report["serve_profile"] = {"device_events": len(names),
                               "busy_us": busy_us, "wall_us": wall_us,
                               "kernels": tries[-1], "counters": job_counts}
    if not names:
        fail("[serve] the profiler recorded no device event of a replayed "
             "job")
    if tries[-1] != job_counts:
        fail(f"[serve] profiler saw {tries} kernel launches in a replayed "
             f"job ({len(tries)} tries), counters say {job_counts}")
    say(f"[serve] profiled replayed job: {len(names)} device events, busy "
        f"{busy_us:.0f} us of {wall_us:.0f} us; the profiler confirms the "
        f"launches: {tries[-1]}")

    clock.lap("5 serve")

    # -- 5b. resilience: faults, retries, breakers on the card ---------------
    lane = resilience_phase(torch, np, hw, g, params, inputs[8], refs[8],
                            report)
    clock.lap("5b resilience")

    # -- 5c. atomic mode changes on the card ---------------------------------
    modes_phase(torch, np, hw, g, params, inputs[8], refs[8], lane, report)
    rtdep = ROOT / "build" / "resnet50_224.rtdep"
    rtdep.parent.mkdir(exist_ok=True)
    dep.save(str(rtdep))
    clock.lap("5c modes")

    # -- 5d. YOLOv5s at 640 through the Server; lut_int8 -----------------
    yolo_lut = yolov5s_phase(torch, np, rng, kernels, report)
    clock.lap("5d yolov5s")

    # -- 6. LM: zamba2-1.2B through Server.register_decode ---------------------
    lm_counts = lm_phase(torch, np, rng, kernels, report, smi, rtdep, clock)
    del srv
    free(torch)

    # -- 7-9. the RWKV, moe and encdec families --------------------------------
    family_counts = {}
    for name, phase in (("7 rwkv6-1.6b", rwkv_phase),
                        ("8 mixtral-8x22b", mixtral_phase),
                        ("9 seamless-m4t-medium", seamless_phase)):
        family_counts[name] = phase(torch, np, rng, report)
        clock.lap(name)

    # -- 10. the cluster: mesh backend, K6, ClusterServer ------------------
    k6_launches = cluster_phase(torch, np, hw, g, params, inputs, mk_out,
                                MK.megakernel_batched(prog, dev), kernels,
                                report, smi)
    clock.lap("10 cluster")

    # -- 11. training: smollm-135M through repro_torch.launch.train ----------
    train_k4 = train_phase(torch, np, kernels, report, smi)
    clock.lap("11 train")

    # -- 12. tensor parallelism on the card and the dry run ------------------
    tp_k4 = tp_phase(torch, np, kernels, report, smi)
    clock.lap("12 tensor parallel")

    # an LM kernel's launches: its serving runs on the LM main paths
    # (zamba2-1.2b, rwkv6-1.6b and mixtral-8x22b through the Server,
    # seamless-m4t-medium through ServeEngine.serve) and, for K4, the
    # training entry point's 40 steps, each counted around its own run
    launches = {**{k: serve_counts[k] for k in CNN_KERNELS},
                **{k: lm_counts[k] + sum(c[k] for c in family_counts.values())
                   for k in LM_KERNELS},
                "tiled_int8": k6_launches}
    launches["flash_attention"] += train_k4 + tp_k4
    launches["lut_int8"] = yolo_lut
    report["launches_by_path"] = {"zamba2-1.2b": lm_counts, **family_counts,
                                  "train smollm-135m": {
                                      "flash_attention": train_k4},
                                  "tensor parallel (1, 3) and int8 KV "
                                  "cache (1, 2)": {
                                      "flash_attention": tp_k4},
                                  "yolov5s-640": {"lut_int8": yolo_lut}}
    result_lines(torch, report, kernels, launches, smi, clock)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    elif sys.argv[1:2] == ["--train-rank"]:
        train_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                        Path(sys.argv[4]))
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    elif sys.argv[1:2] == ["--kv8-rank"]:
        kv8_rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    elif sys.argv[1:2] == ["--decode-turn"]:
        decode_turn(Path(sys.argv[2]), Path(sys.argv[3]))
    elif sys.argv[1:2] == ["--decode-turns"]:
        decode_turns(sys.argv[2:])
    elif sys.argv[1:2] == ["--yolov5s"]:
        main(yolo_only=True)
    else:
        main()
