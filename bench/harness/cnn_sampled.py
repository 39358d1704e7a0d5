"""CNN cells whose answers are too large to keep them all: `cnn.py`'s
closed loop, keeping of the window's answers only the sample the check
compares, drawn as they arrive.

`cnn.py` keeps every answer of the window until its check after the
close. A YOLOv5s answer at 640 x 640 is (25200, 85) int32, 8.57 MB, and a
batch-8 job's answers share one 68.5 MB array: at the 1,000-1,200
frames/s of an H100 80GB HBM3 a 51 s window answers about 53,000 frames,
450 GB, far more than that card's 96 GiB host. Here each
served frame keeps its times and hands its answer to a reservoir of
`check` answers (Algorithm R, seeded from the run's seed); an answer not
taken, or later put out, goes with its ticket. At the close the reservoir
is a uniform sample of the answered frames, as `cnn.py`'s draw is. An
answer taken is copied out of its job's array, so the runner can reuse
that array for a later job (`GraphedRunner`'s page-locked `HostOuts`).

Set-up, warm-up, the loop, the trace, the frame's time (sent to its
answer on the host, at the end of the `Server.step` that served it) and
the record the readers read are `cnn.py`'s."""

from __future__ import annotations

import time

import numpy as np

from . import bounds, traffic, weights
from .cnn import (DRAIN_S, NET, SPAN_NAMES, WARM_JOBS, expected_names,
                  k2_shapes)
from .common import PEAKS, Spans, rate


class Reservoir:
    """A uniform sample of at most `k` of the items offered (Algorithm R):
    the i-th offer (from 0) is taken if i < k, and later with probability
    k / (i + 1), in the place of one drawn uniformly. An item taken is
    stored as `keep(item)`."""

    def __init__(self, k: int, rng, keep=lambda item: item):
        self.k, self.rng, self.keep, self.seen, self.items = \
            k, rng, keep, 0, []

    def offer(self, item) -> None:
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(self.keep(item))
            return
        j = int(self.rng.integers(i + 1))
        if j < self.k:
            self.items[j] = self.keep(item)


def run(ctx: dict) -> dict:
    import torch
    from repro_torch.core import cnn as port_cnn
    from repro_torch.hw import scaled_paper_machine
    from repro_torch.kernels import _lib
    from repro_torch.serve import Server

    cfg, mix, seed, device = ctx["config"], ctx["mix"], ctx["seed"], \
        ctx["device"]
    if mix["loop"] != "closed":
        raise ValueError(f"{__name__} serves closed-loop mixes, not "
                         f"{mix['loop']!r}")
    ref = ctx["reference"]
    args = cfg["graph"]["args"]
    net = ref.layers(**args)
    params = weights.cnn_params(ref.weight_specs(net), seed, device)
    g = getattr(port_cnn, cfg["graph"]["builder"])(**args)
    if set(params) != expected_names(g):
        raise RuntimeError("the reference's weights do not name the "
                           "program graph's: "
                           f"{sorted(set(params) ^ expected_names(g))[:8]}")
    srv = Server(scaled_paper_machine(cfg["machine_cores"]),
                 backend="cuda", device=device)
    verdict = srv.register(NET, g, period_s=cfg["period_s"],
                           deadline_s=cfg["deadline_s"], slots=mix["slots"],
                           params=params)
    if ctx.get("fault") is not None:
        ctx["fault"](srv)
    shape = (args.get("h", 224), args.get("w", 224), 3)
    pool = traffic.frames(mix, seed, shape)
    stream = traffic.Stream(mix, seed)
    spans = Spans(profile=bool(ctx["trace"]))
    rng = np.random.default_rng([int(seed), 3])
    # an answer taken is copied out of its job's array: the runner reuses
    # a job's host arrays once no answer of it is held
    sample = Reservoir(mix["check"], np.random.default_rng([int(seed), 4]),
                       keep=lambda item: (item[0], np.array(item[1])))
    out_name = g.outputs[0]

    # warm-up: the registered batch, the only shape the window runs
    for _ in range(WARM_JOBS):
        ts = [srv.submit(NET, pool[rng.integers(len(pool))])
              for _ in range(mix["slots"])]
        while not all(t.terminal for t in ts):
            srv.step()
    del ts
    if device != "cpu":
        torch.cuda.synchronize()
    frames: list[dict] = []          # every request of the window
    steps: list[list] = []           # [t0, t1, frames served]
    stretch = None
    trace_span = None
    seconds = ctx["seconds"]

    def serve_step(inflight):
        t0 = time.perf_counter()
        with spans.span("Server.step"):
            srv.step()
        t1 = time.perf_counter()
        n = 0
        for f in list(inflight):
            t = f["ticket"]
            if not t.terminal:
                continue
            del f["ticket"]              # the answer goes with its ticket
            f["done"], f["status"] = t1, t.status
            if t.status == "done":
                res = t.result()
                f["latency_ms"] = res.latency_s * 1e3
                sample.offer((f["frame"], res.output[out_name]))
            inflight.remove(f)
            n += 1
        steps.append([t0, t1, n])
        return n

    def send():
        req = stream.next()
        f = {"due": time.perf_counter(), "frame": req["frame"]}
        with spans.span("Server.submit"):
            f["ticket"] = srv.submit(NET, pool[req["frame"]])
        frames.append(f)
        return f

    if ctx["trace"]:
        from .trace import Stretch
        stretch = Stretch(torch, SPAN_NAMES)
        stretch.warm()
        trace_at = seconds - min(2.0, seconds * 0.25)
    _lib.reset_launch_counts()
    jobs0 = srv.metrics["jobs"] - srv.metrics["idle_jobs"]
    ctx["setup_s"] = time.perf_counter() - ctx["t_start"]
    t0 = time.perf_counter()
    inflight = [send() for _ in range(mix["clients"])]
    while True:
        now = time.perf_counter()
        if now >= t0 + seconds:
            break
        if stretch is not None and trace_span is None \
                and now - t0 >= trace_at:
            stretch.start()
            trace_span = [len(steps), None]
        for _ in range(serve_step(inflight)):
            inflight.append(send())
    t_end = steps[-1][1]
    if trace_span is not None:                # stopped once closed
        ctx["trace_out"] = stretch.stop()
        trace_span[1] = len(steps)
    launches = _lib.launch_counts()
    # lut_int8's bytes at the close, beside its launches (a program
    # without the byte counter has none)
    lut_bytes = getattr(_lib, "byte_counts", dict)().get("lut_int8")
    jobs = srv.metrics["jobs"] - srv.metrics["idle_jobs"] - jobs0
    # answers still owed: a minute past the close at most
    late = time.perf_counter() + DRAIN_S
    while inflight and time.perf_counter() < late:
        serve_step(inflight)
    if device != "cpu":
        torch.cuda.synchronize()
        ctx["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    dep = srv.executors[NET]
    slots = mix["slots"]
    k2 = k2_shapes(dep)
    k2_bound = bounds.Bound()
    for s in k2:
        bounds.k2_launch(k2_bound, slots, s["H"], s["W"], s["C_in"], s["M"],
                         s["K"], s["N"], s["requant"])
    ops = bounds.cnn_ops_per_frame(ref.conv_shapes(net))

    done = [f for f in frames if f.get("status") == "done"]
    win_steps = [s for s in steps if s[1] <= t_end]
    e2e = {"setup_s": ctx["setup_s"],
           "frames_per_s": rate(sum(f["done"] <= t_end for f in done),
                                t_end - t0)}
    rec = {"kind": "cnn", "frames": [
        {"latency_ms": f["latency_ms"],
         "total_ms": (f["done"] - f["due"]) * 1e3} for f in done],
        "jobs": jobs, "launches": launches, "lut_bytes": lut_bytes,
        "steps": [[a, b, n] for a, b, n in win_steps],
        "frames_served": sum(s[2] for s in win_steps),
        "ops_per_frame": ops, "peak": PEAKS["int8"],
        "k2_per_job": len(k2), "k2_bound_s": k2_bound.s,
        "trace": ctx.get("trace_out"),
        "trace_steps": None if trace_span is None else
        steps[trace_span[0]:trace_span[1]]}
    ctx["context"] = {"wcet_bound_ms": verdict.response_bound_s * 1e3,
                      "slots": slots, "jobs": jobs,
                      "launches": launches, "k2_bound_by": k2_bound.by}

    # the check: the reservoir's answers against the reference
    attempted = len(frames)
    missing = attempted - len(done)
    del srv, dep
    picked = sample.items
    n_check = len(picked)
    got = np.stack([np.asarray(a).reshape(-1) for _, a in picked]) \
        if picked else None
    idx = [i for i, _ in picked]
    del picked, sample
    t_check = time.perf_counter()
    worst, wrong = 0, 0
    if n_check:
        want = ref.forward(net, params, pool[idx])
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        worst, wrong = int(d.max()), int((d.max(axis=1) > 0).sum())
    ctx["check_s"] = time.perf_counter() - t_check
    checks = [("max_abs_diff", worst, 0), ("answers_differing", wrong, 0),
              ("answers_missing", missing, 0),
              ("answers_compared", n_check, f">= {min(attempted, 1)}")]
    correct = worst == 0 and wrong == 0 and missing == 0 and n_check > 0
    return {"correct": correct, "attempted": attempted,
            "failed": attempted - len(done), "e2e": e2e, "rec": rec,
            "checks": checks,
            "sample": {"net": net, "params": params, "frames": pool[idx],
                       "got": got}}
