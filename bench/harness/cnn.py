"""CNN cells: an int8 CNN compiled by `repro_torch.compile` into a static
schedule and served by `repro_torch.serve.Server`, frames submitted by the
mix's loop, every job one batched program of the registered slots.

The window drives `Server.submit` and `Server.step`; a frame's time runs
from when it was due (open loop) or sent (closed loop) to when its answer
is on the host, which the end of the `Server.step` that served it marks
(the runner's output is copied to the host inside the step)."""

from __future__ import annotations

import time

import numpy as np

from . import bounds, traffic, weights
from .common import PEAKS, Spans, percentile, rate

NET = "cnn"
SPAN_NAMES = ("Server.step", "Server.submit", "harness.wait")
WARM_JOBS = 3
DRAIN_S = 60.0          # how long past the close owed answers are waited for
# the last stretch before a due time is spun on the clock, not slept: a
# frame is charged from its due time, and on the one-card H100 hosts a
# 30 Hz sleep woke 0.64-0.80 ms late at the median, 1.1-3.3 ms at the
# 95th percentile, 3-6.4 ms at the 99th, from run to run
SPIN_S = 10e-3


def wait_until(due: float, clock=time.perf_counter, sleep=time.sleep
               ) -> float:
    """Return at `due` on `clock`, never before it: sleep until SPIN_S
    before it, then spin. Returns the clock's reading at the return."""
    left = due - SPIN_S - clock()
    if left > 0:
        sleep(left)
    now = clock()
    while now < due:
        now = clock()
    return now


def expected_names(g) -> set:
    """The weight and multiplier names the program's graph needs."""
    out = set()
    for op in g.ops:
        out.update(op.weights)
        if op.kind == "requant":
            out.add(f"{op.name}.mult")
    return out


def k2_shapes(dep) -> list[dict]:
    """The convs that the program launches K2 for, one per launch of a
    job: the tiled conv segments of its megakernel plan."""
    from repro_torch.core import megakernel as MK
    out = []
    for seg in MK.plan_segments(dep.program):
        if seg.kind != "tiled":
            continue
        st = seg.steps[0]
        if st.mode != "conv2d":
            continue
        a = st.batch.attrs
        oh = (a["H"] + 2 * a["padding"] - a["kh"]) // a["stride"] + 1
        ow = (a["W"] + 2 * a["padding"] - a["kw"]) // a["stride"] + 1
        out.append({"H": a["H"], "W": a["W"], "C_in": a["C_in"],
                     "M": oh * ow, "K": a["kh"] * a["kw"] * a["C_in"],
                     "N": a["C_out"], "requant": st.mult is not None})
    return out


def run(ctx: dict) -> dict:
    import torch
    from repro_torch.core import cnn as port_cnn
    from repro_torch.hw import scaled_paper_machine
    from repro_torch.kernels import _lib
    from repro_torch.serve import Server

    cfg, mix, seed, device = ctx["config"], ctx["mix"], ctx["seed"], \
        ctx["device"]
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

    # warm-up: the registered batch, the only shape the window runs
    for _ in range(WARM_JOBS):
        ts = [srv.submit(NET, pool[rng.integers(len(pool))])
              for _ in range(mix["slots"])]
        while not all(t.terminal for t in ts):
            srv.step()
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
            if f["ticket"].terminal:
                f["done"] = t1
                inflight.remove(f)
                n += 1
        steps.append([t0, t1, n])
        return n

    def prepare(due):
        """The next request's record, its frame ready to submit."""
        req = stream.next()
        return {"due": due, "frame": req["frame"],
                "input": pool[req["frame"]], "ticket": None}

    def send(f):
        with spans.span("Server.submit"):
            f["ticket"] = srv.submit(NET, f["input"])
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
    inflight: list[dict] = []
    if mix["loop"] == "open":
        # everything a frame needs is ready before its due time, so
        # nothing of the harness lies between the due time and the submit
        k = 0
        while True:
            due = t0 + stream.due_s(k)
            if due >= t0 + seconds:
                break
            if stretch is not None and trace_span is None \
                    and due - t0 >= trace_at:
                stretch.start()
                trace_span = [len(steps), None]
            f = prepare(due)
            with spans.span("harness.wait"):
                wait_until(due)
            inflight.append(send(f))
            while inflight:
                serve_step(inflight)
            k += 1
        t_end = t0 + seconds
    else:
        for _ in range(mix["clients"]):
            inflight.append(send(prepare(time.perf_counter())))
        while True:
            now = time.perf_counter()
            if now >= t0 + seconds:
                break
            if stretch is not None and trace_span is None \
                    and now - t0 >= trace_at:
                stretch.start()
                trace_span = [len(steps), None]
            n = serve_step(inflight)
            for _ in range(n):
                inflight.append(send(prepare(time.perf_counter())))
        t_end = steps[-1][1]
    if trace_span is not None:                # stopped once closed
        ctx["trace_out"] = stretch.stop()
        trace_span[1] = len(steps)
    launches = _lib.launch_counts()
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

    # the window's requests: due in it (open loop) or sent in it (closed)
    done = [f for f in frames if f["ticket"].status == "done"]
    lat = [(f["done"] - f["due"]) * 1e3 for f in done]
    win_steps = [s for s in steps if s[1] <= t_end]
    e2e = {"setup_s": ctx["setup_s"]}
    if mix["loop"] == "open":
        e2e["frame_p95_ms"] = percentile(lat, 95)
    else:
        e2e["frames_per_s"] = rate(sum(f["done"] <= t_end for f in done),
                                   t_end - t0)
    rec = {"kind": "cnn", "frames": [
        {"latency_ms": f["ticket"].result().latency_s * 1e3,
         "total_ms": (f["done"] - f["due"]) * 1e3} for f in done],
        "jobs": jobs, "launches": launches,
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

    # the check: a sample of the window's answers against the reference
    attempted = len(frames)
    missing = attempted - len(done)
    del srv, dep
    n_check = min(len(done), mix["check"])
    pick = sorted(rng.choice(len(done), size=n_check, replace=False)) \
        if n_check else []
    got = np.stack([np.asarray(done[i]["ticket"].result().output[
        g.outputs[0]]).reshape(-1) for i in pick]) if pick else None
    t_check = time.perf_counter()
    worst, wrong = 0, 0
    if pick:
        idx = [done[i]["frame"] for i in pick]
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
            "sample": {"net": net, "params": params,
                       "frames": pool[[done[i]["frame"] for i in pick]],
                       "got": got}}
