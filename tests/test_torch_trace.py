"""The port's span recorder (`repro_torch.trace`) on the CPU: off it records
nothing and opens no profiler range; on, every CNN job of a `Server` yields
one nested set of spans whose runner phases fit inside the ticket's
latency, each ticket one `serve.queue` span, the profiler's ranges match
the records one to one, and the plain-step counter counts the plan's
plain steps."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch import trace
from repro_torch.compiler.backends import BackendOptions
from repro_torch.core import cnn
from repro_torch.core import compiled as C
from repro_torch.core import megakernel as MK
from repro_torch.hw import scaled_paper_machine
from repro_torch.kernels import _lib, launch_counts, reset_launch_counts
from repro_torch.serve import Server

CHILDREN = ["serve.stack", "runner.upload", "runner.issue",
            "runner.readback", "serve.finish"]
RANGES = set(trace.NAMES) | set(trace.KERNEL_NAMES)
TINY_RESNET = dict(h=32, w=32, width=0.25, blocks=(1, 1, 1, 1),
                   num_classes=16)
SMALL_BUDGET = 4096          # scratchpad bytes that leave plain steps out
CORES = 64                   # launches a program may take at that budget


@pytest.fixture(autouse=True)
def recorder():
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def _server(backend="torch", slots=2, options=None, graph=None,
            cores=4):
    srv = Server(scaled_paper_machine(cores), backend=backend,
                 device="cpu", num_cores=cores, backend_options=options)
    srv.register("cnn", graph or cnn.small_cnn(), period_s=1 / 50,
                 slots=slots)
    return srv


def _serve(srv, n, seed=0):
    rng = np.random.default_rng(seed)
    ts = [srv.submit("cnn", rng.integers(-128, 128, (32, 32, 3),
                                         dtype=np.int8))
          for _ in range(n)]
    while not all(t.terminal for t in ts):
        srv.step()
    assert all(t.status == "done" for t in ts)
    return ts


def _ranges(prof):
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name in RANGES)


def test_off_records_nothing_and_opens_no_range():
    assert trace.span("serve.step") is trace.NOOP
    assert trace.span("serve.job", job=1, net="cnn") is trace.NOOP
    assert trace.kernel("conv2d_int8") is trace.NOOP
    assert trace.stamp() is None
    srv = _server()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ts = _serve(srv, 3)
    assert trace.records() == [] and trace.plain_steps() == 0
    assert all(t.submit_ns is None for t in ts)
    assert _ranges(prof) == []


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("slots", [1, 2])
def test_each_job_yields_one_nested_set_of_spans(backend, slots):
    srv = _server(backend, slots)
    _serve(srv, 1)                          # builds the runner
    trace.enable()
    ts = _serve(srv, 5, seed=1)
    trace.disable()
    recs = trace.records()
    steps = [i for i, r in enumerate(recs) if r.name == "serve.step"]
    jobs = [i for i, r in enumerate(recs) if r.name == "serve.job"]
    assert len(steps) == len(jobs) == -(-5 // slots)
    for s, j in zip(steps, jobs):
        step, job = recs[s], recs[j]
        assert job.parent == s and step.parent is None
        assert job.net == "cnn" and step.job == job.job
        kids = [r for r in recs if r.parent == j]
        assert [r.name for r in kids] == CHILDREN
        assert all(r.job == job.job for r in kids)
        assert step.start_ns <= job.start_ns <= kids[0].start_ns
        assert kids[-1].end_ns <= job.end_ns <= step.end_ns
        for a, b in zip(kids, kids[1:]):
            assert a.start_ns <= a.end_ns <= b.start_ns
        assert job.launches == 0 and job.launch_ns == 0   # plain versions
    assert [recs[j].job for j in jobs] == sorted({recs[j].job for j in jobs})
    # one serve.queue per ticket, ending where its job started
    queue = [r for r in recs if r.name == "serve.queue"]
    assert sorted(r.ticket for r in queue) == sorted(t.tid for t in ts)
    start = {recs[j].job: recs[j].start_ns for j in jobs}
    for q, t in zip(sorted(queue, key=lambda r: r.ticket), ts):
        assert q.start_ns == t.submit_ns and q.parent is None
        assert q.end_ns == start[q.job] and q.start_ns <= q.end_ns


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_runner_phases_fit_inside_the_tickets_latency(backend):
    srv = _server(backend, 2)
    _serve(srv, 2)
    trace.enable()
    ts = _serve(srv, 6, seed=2)
    trace.disable()
    recs = trace.records()
    runner = {}
    for r in recs:
        if r.name.startswith("runner."):
            runner[r.job] = runner.get(r.job, 0) + r.end_ns - r.start_ns
    queue = {r.ticket: r.job for r in recs if r.name == "serve.queue"}
    for t in ts:
        assert 0 < runner[queue[t.tid]] <= t.result().latency_s * 1e9


def test_profiler_ranges_match_the_records():
    srv = _server("cuda", 2)
    _serve(srv, 2)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(srv, 5, seed=3)
    trace.disable()
    recs = [r for r in trace.records() if r.name != "serve.queue"]
    every = _ranges(prof)
    ranges = [e for e in every if e[2] in trace.NAMES]
    assert [n for _, _, n in ranges] == [r.name for r in recs]
    # a kernel wrapper's range sits inside the program's issue
    issue = [(a, b) for a, b, n in ranges if n == "runner.issue"]
    kern = [(a, b) for a, b, n in every if n in trace.KERNEL_NAMES]
    assert kern and all(any(x <= a and b <= y for x, y in issue)
                        for a, b in kern)
    # the same nesting: each range's innermost enclosing range is its
    # record's parent
    index = {id(r): k for k, r in enumerate(recs)}
    full = trace.records()
    for k, (a, b, _) in enumerate(ranges):
        outer = [m for m in range(k) if ranges[m][0] <= a
                 and b <= ranges[m][1]]
        want = recs[k].parent
        assert (outer[-1] if outer else None) == (
            None if want is None else index[id(full[want])])


@pytest.mark.parametrize("path", ["megakernel", "kernel"])
def test_plain_step_counter_counts_the_plans_plain_steps(path):
    dep = repro_torch.compile(cnn.resnet50(**TINY_RESNET),
                              scaled_paper_machine(CORES), backend="cuda",
                              device="cpu")
    prog = dep.program
    if path == "megakernel":
        fn = MK.megakernel_batched(prog, "cpu", budget=SMALL_BUDGET)
        plain = sum(s.kind == "outside" for s in
                    MK.plan_segments(prog, budget=SMALL_BUDGET))
    else:
        fn = C.kernel_batched(prog, "cpu")
        plain = sum(s.mode == "torch" for s in C._kernel_plan(prog))
    assert plain > 0
    x = C.to_device(prog, {"input": np.zeros((2, 32, 32, 3), np.int8)},
                    torch.device("cpu"))
    reset_launch_counts()
    fn(x)
    assert trace.plain_steps() == 0          # off: nothing counted
    trace.enable()
    for _ in range(3):
        fn(x)
    assert trace.plain_steps() == 3 * plain
    assert sum(launch_counts().values()) == 0


def test_a_jobs_counters_sum_its_launches_and_plain_steps():
    """On the card each K1-K3 launch counts on the open serve.job (here a
    launch is counted by hand where the kernel would count it); a call
    that took the plain version adds nothing, and no job, nothing."""
    trace.enable()
    reset_launch_counts()
    try:
        with trace.kernel("conv2d_int8"):
            _lib.count_launch("conv2d_int8")           # outside any job
        with trace.span("serve.job", job=7, net="cnn"):
            for _ in range(3):
                with trace.kernel("conv2d_int8"):
                    _lib.count_launch("conv2d_int8")
            with trace.kernel("megakernel"):
                pass                                   # the plain version
            trace.plain_step()
            trace.plain_step()
    finally:
        reset_launch_counts()
    (job,) = trace.records()
    assert (job.name, job.job, job.net) == ("serve.job", 7, "cnn")
    assert job.launches == 3 and 0 < job.launch_ns <= (job.end_ns
                                                       - job.start_ns)
    assert job.plain_steps == 2 and trace.plain_steps() == 2


def test_a_served_jobs_plain_steps_equal_the_plan():
    opts = BackendOptions(scratchpad_budget=SMALL_BUDGET)
    srv = _server("cuda", 2, opts, cnn.resnet50(**TINY_RESNET), CORES)
    _serve(srv, 2)
    prog = srv.executors["cnn"].program
    plain = sum(s.kind == "outside" for s in
                MK.plan_segments(prog, budget=SMALL_BUDGET))
    assert plain > 0
    trace.enable()
    _serve(srv, 4, seed=4)
    trace.disable()
    jobs = [r for r in trace.records() if r.name == "serve.job"]
    assert [r.plain_steps for r in jobs] == [plain, plain]
    assert trace.plain_steps() == 2 * plain


def test_reset_drops_the_records_and_counters():
    trace.enable()
    with trace.span("serve.step"):
        trace.plain_step()
    assert len(trace.records()) == 1 and trace.plain_steps() == 1
    assert trace.records()[0].asdict() == {
        "name": "serve.step", "start_ns": trace.records()[0].start_ns,
        "end_ns": trace.records()[0].end_ns, "parent": None, "job": None,
        "ticket": None, "net": None, "launches": 0, "launch_ns": 0,
        "plain_steps": 0, "plain_kinds": {}, "replayed": 0}
    trace.reset()
    assert trace.records() == [] and trace.plain_steps() == 0
