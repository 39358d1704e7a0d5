"""The `cuda` backend's graphed runner (`compiler/backends.py::
GraphedRunner`): an input signature's first call runs eagerly, its second
captures the program into a CUDA graph, later calls replay it.

On the CPU, `torch.cuda.CUDAGraph` and `torch.cuda.graph` are replaced by a
recording fake: the program calls made while it captures are kept, and a
replay runs them again over the same static tensors, writing the static
outputs in place. That holds the runner's policy, its counters and the
recorder's `serve.job` fields; a CPU device itself never captures. The
`cuda`-marked tests hold the real graphs on the card bit-exact against the
eager programs and the numpy oracle, and skip without a card."""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import trace
from repro_torch.compiler import backends as B
from repro_torch.compiler.backends import BackendOptions, GraphedRunner
from repro_torch.core import cnn, init_params
from repro_torch.core import compiled as C
from repro_torch.core import megakernel as MK
from repro_torch.hw import scaled_paper_machine
from repro_torch.kernels import (_lib, graph_counts, launch_counts,
                                 reset_launch_counts)
from repro_torch.serve import Mode, ModeNetwork, Server

TINY_RESNET = dict(h=32, w=32, width=0.25, blocks=(1, 1, 1, 1),
                   num_classes=16)
SMALL_BUDGET = 4096          # scratchpad bytes that leave plain steps out
CORES = 64                   # launches a program may take at that budget
CPU = torch.device("cpu")
ZERO = {k: 0 for k in _lib.GRAPH_EVENTS}


def counts(**kw) -> dict:
    return {**ZERO, **kw}


class Fakes:
    """The recording stand-ins for `torch.cuda.CUDAGraph` (`Graph`) and
    `torch.cuda.graph` (`capture`): `made` lists the graphs made; with
    `fail` set, a capture raises at its end, as CUDA does when the stream
    capture was invalidated."""

    def __init__(self):
        self.made: list = []
        self.capturing = None
        self.fail = False
        fakes = self

        class Graph:
            def __init__(self):
                self.body: list = []       # (fn, static ins, static outs)
                self.replays = 0
                fakes.made.append(self)

            def replay(self):
                self.replays += 1
                with trace.Tally():        # a real replay runs no Python
                    for fn, ins, outs in self.body:
                        for k, v in fn(ins).items():
                            outs[k].copy_(v)

        class capture:
            def __init__(self, graph, **kw):
                self.graph = graph

            def __enter__(self):
                fakes.capturing = self.graph
                return self

            def __exit__(self, *exc):
                fakes.capturing = None
                if fakes.fail and exc[0] is None:
                    raise RuntimeError("operation not permitted when "
                                       "stream is capturing")
                return False

        self.Graph, self.capture = Graph, capture


class Body:
    """A program `fn` as the runner calls it, counting `launches` (kernel
    -> launches per call) inside `trace.kernel` as the card's wrappers
    would; while a fake captures, the call is recorded for its replays."""

    def __init__(self, fn, fakes: Fakes, launches: dict | None = None):
        self.fn, self.fakes, self.launches = fn, fakes, launches or {}
        self.calls = 0

    def __call__(self, ins: dict) -> dict:
        self.calls += 1
        for k, n in self.launches.items():
            with trace.kernel(k):
                for _ in range(n):
                    _lib.count_launch(k)
        out = self.fn(ins)
        if self.fakes.capturing is not None:
            self.fakes.capturing.body.append((self.fn, ins, out))
        return out


@pytest.fixture
def fakes(monkeypatch):
    f = Fakes()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", f.Graph)
    monkeypatch.setattr(torch.cuda, "graph", f.capture)
    return f


@pytest.fixture
def graphed(monkeypatch, fakes):
    """The `cuda` backend's batched runners are `GraphedRunner`s on the
    CPU too, over the recording fakes, as they are on the card."""
    def batched(prog, options=None, device="cuda"):
        fn = B._cuda_fn(prog, options or BackendOptions(), CPU)
        return GraphedRunner(Body(fn, fakes), prog, CPU, True)
    monkeypatch.setitem(B._REGISTRY, "cuda", dataclasses.replace(
        B.get_backend("cuda"), batched=batched))
    return fakes


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.reset()
    reset_launch_counts()
    yield
    trace.disable()
    trace.reset()
    reset_launch_counts()


@pytest.fixture(scope="module")
def tiny():
    g = cnn.resnet50(**TINY_RESNET)
    return repro_torch.compile(
        g, scaled_paper_machine(CORES), backend="cuda",
        params=init_params(g, seed=0), num_cores=CORES, device="cpu",
        backend_options=BackendOptions(scratchpad_budget=SMALL_BUDGET))


def _program(dep, megakernel: bool, device):
    opts = BackendOptions(scratchpad_budget=SMALL_BUDGET,
                          megakernel=None if megakernel else False)
    return B._cuda_fn(dep.program, opts, device)


def _frames(batch: int, seed: int, shape=(32, 32, 3)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, (batch, *shape), dtype=np.int8)


def _oracle(prog, x: np.ndarray, batched: bool = True) -> dict:
    xs = x if batched else x[None]
    outs = [C.run_numpy(prog, {"input": s}) for s in xs]
    got = {t: np.stack([o[t] for o in outs]) for t in prog.graph.outputs}
    return got if batched else {t: v[0] for t, v in got.items()}


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


# -- CPU, against the recording fake -----------------------------------------

@pytest.mark.parametrize("megakernel", [True, False])
def test_a_cpu_device_never_captures(fakes, tiny, megakernel):
    opts = BackendOptions(scratchpad_budget=SMALL_BUDGET,
                          megakernel=None if megakernel else False)
    run = B.get_backend("cuda").batched(tiny.program, opts, "cpu")
    assert not isinstance(run, GraphedRunner)
    for seed in range(3):
        x = _frames(2, seed)
        _same(run({"input": x}), _oracle(tiny.program, x))
    single = tiny.runner(device="cpu")
    _same(single({"input": x[0]}), _oracle(tiny.program, x[0], False))
    assert B.prime(run, 2) is run
    assert fakes.made == [] and graph_counts() == ZERO


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("megakernel", [True, False])
def test_a_signature_is_eager_then_captured_then_replayed(fakes, tiny,
                                                          megakernel,
                                                          batched):
    body = Body(_program(tiny, megakernel, CPU), fakes)
    run = GraphedRunner(body, tiny.program, CPU, batched)
    want = [counts(eager=1), counts(eager=1, captures=1, replays=1),
            counts(eager=1, captures=1, replays=2),
            counts(eager=1, captures=1, replays=3)]
    for seed, c in enumerate(want):
        x = _frames(2, seed + 10)
        if not batched:
            x = x[0]
        _same(run({"input": x}), _oracle(tiny.program, x, batched))
        assert graph_counts() == c
    assert len(fakes.made) == 1 and fakes.made[0].replays == 3
    assert body.calls == 2                # the eager call and the capture


@pytest.mark.parametrize("batched", [True, False])
def test_prime_captures_at_once_and_only_once(fakes, tiny, batched):
    body = Body(_program(tiny, True, CPU), fakes)
    run = GraphedRunner(body, tiny.program, CPU, batched)
    assert B.prime(run, 3) is run
    assert graph_counts() == counts(eager=1, captures=1, replays=1)
    B.prime(run, 3)
    assert graph_counts() == counts(eager=1, captures=1, replays=1)
    x = _frames(3, 7)
    if not batched:
        x = x[0]
    _same(run({"input": x}), _oracle(tiny.program, x, batched))
    assert graph_counts() == counts(eager=1, captures=1, replays=2)
    assert len(fakes.made) == 1 and body.calls == 2


def test_a_new_shape_starts_over(fakes, tiny):
    run = GraphedRunner(Body(_program(tiny, True, CPU), fakes),
                        tiny.program, CPU, True)
    for batch, seed in [(2, 0), (2, 1), (3, 2), (3, 3), (3, 4), (2, 5)]:
        x = _frames(batch, seed)
        _same(run({"input": x}), _oracle(tiny.program, x))
    assert graph_counts() == counts(eager=2, captures=2, replays=4)
    assert len(fakes.made) == 2


def test_a_capture_that_raises_leaves_the_shape_eager(fakes, tiny):
    fakes.fail = True
    body = Body(_program(tiny, True, CPU), fakes, {"conv2d_int8": 2})
    run = GraphedRunner(body, tiny.program, CPU, True)
    x = _frames(2, 0)
    _same(run({"input": x}), _oracle(tiny.program, x))
    x = _frames(2, 1)
    with pytest.warns(RuntimeWarning, match=tiny.graph.name) as caught:
        _same(run({"input": x}), _oracle(tiny.program, x))
    assert len(caught) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for seed in (2, 3):
            x = _frames(2, seed)
            _same(run({"input": x}), _oracle(tiny.program, x))
    assert graph_counts() == counts(eager=4, capture_failures=1)
    assert len(fakes.made) == 1 and fakes.made[0].replays == 0
    # the failed capture's launches came off: four eager calls ran
    assert launch_counts()["conv2d_int8"] == 4 * 2


def test_the_capture_adds_no_launches_and_each_replay_adds_them(fakes,
                                                                tiny):
    per_call = {"conv2d_int8": 3, "megakernel": 1}
    run = GraphedRunner(Body(_program(tiny, True, CPU), fakes, per_call),
                        tiny.program, CPU, True)
    for calls in range(1, 5):
        run({"input": _frames(2, calls)})
        got = launch_counts()
        assert {k: got[k] for k in per_call} == \
            {k: n * calls for k, n in per_call.items()}
        assert sum(got.values()) == 4 * calls


@pytest.mark.parametrize("megakernel", [True, False])
def test_a_replayed_job_carries_the_captured_counters(fakes, megakernel):
    opts = BackendOptions(scratchpad_budget=SMALL_BUDGET,
                          megakernel=None if megakernel else False)
    srv = Server(scaled_paper_machine(CORES), backend="cuda", device="cpu",
                 num_cores=CORES, backend_options=opts)
    srv.register("cnn", cnn.resnet50(**TINY_RESNET), period_s=1 / 50,
                 slots=2)
    st = srv._nets["cnn"]
    prog = srv.executors["cnn"].program
    per_call = {"conv2d_int8": 5, "gemm_int8": 1}
    st.runner = GraphedRunner(
        Body(B._cuda_fn(prog, opts, CPU), fakes, per_call), prog, CPU, True)
    trace.enable()
    rng = np.random.default_rng(3)
    for _ in range(4):
        # on the CPU a result is a view of the static outputs, which the
        # next replay overwrites (on the card the readback copies): check
        # each job's answers before the next job runs
        ts = [srv.submit("cnn", rng.integers(-128, 128, (32, 32, 3),
                                             dtype=np.int8))
              for _ in range(2)]
        while not all(t.terminal for t in ts):
            srv.step()
        for t in ts:
            assert t.status == "done"
            want = C.run_numpy(prog, {"input": t.payload})
            _same(t.result().output,
                  {k: want[k] for k in prog.graph.outputs})
    trace.disable()
    jobs = [r for r in trace.records() if r.name == "serve.job"]
    assert [r.replayed for r in jobs] == [0, 1, 1, 1]
    assert [r.launches for r in jobs] == [6] * 4
    plain = jobs[0].plain_steps
    if megakernel:
        assert plain == sum(s.kind == "outside" for s in
                            MK.plan_segments(prog, budget=SMALL_BUDGET))
    assert plain > 0 and [r.plain_steps for r in jobs] == [plain] * 4
    assert trace.plain_steps() == 4 * plain
    assert jobs[0].launch_ns > 0
    assert [r.launch_ns for r in jobs[1:]] == [0, 0, 0]
    recs = trace.records()
    phases = [[k.name for k in recs if k.parent == recs.index(r)
               and k.name.startswith("runner.")] for r in jobs]
    assert phases == [["runner.upload", "runner.issue", "runner.readback"],
                      ["runner.capture", "runner.upload", "runner.issue",
                       "runner.readback"]] + [phases[0]] * 2


@pytest.mark.parametrize("how", ["register", "switch_mode", "load"])
def test_a_server_captures_before_its_first_job(graphed, tmp_path, how):
    opts = BackendOptions(scratchpad_budget=SMALL_BUDGET)
    machine = scaled_paper_machine(CORES)
    g = cnn.resnet50(**TINY_RESNET)
    params = init_params(g, seed=7)
    srv = Server(machine, backend="cuda", device="cpu", num_cores=CORES,
                 backend_options=opts)
    if how == "switch_mode":
        srv.switch_mode(Mode("day", (ModeNetwork(
            "cnn", g, period_s=1 / 50, slots=2, params=params),)))
    else:
        srv.register("cnn", g, period_s=1 / 50, slots=2, params=params)
    if how == "load":
        srv.save(str(tmp_path / "bundle"))
        reset_launch_counts()
        srv = Server.load(str(tmp_path / "bundle"), machine=machine,
                          device="cpu")
    # built and primed at the slot count: eager once, captured, replayed
    assert graph_counts() == counts(eager=1, captures=1, replays=1)
    assert len(graphed.made) == (2 if how == "load" else 1)
    reset_launch_counts()
    prog = srv.executors["cnn"].program
    trace.enable()
    rng = np.random.default_rng(5)
    for _ in range(3):
        ts = [srv.submit("cnn", rng.integers(-128, 128, (32, 32, 3),
                                             dtype=np.int8))
              for _ in range(2)]
        while not all(t.terminal for t in ts):
            srv.step()
        for t in ts:                     # before the next replay (above)
            want = C.run_numpy(prog, {"input": t.payload})
            _same(t.result().output,
                  {k: want[k] for k in prog.graph.outputs})
    trace.disable()
    assert graph_counts() == counts(replays=3)
    jobs = [r for r in trace.records() if r.name == "serve.job"]
    assert [r.replayed for r in jobs] == [1, 1, 1]
    assert "runner.capture" not in {r.name for r in trace.records()}


# -- the card -----------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def resnet224(card):
    def make(seed):
        g = cnn.resnet50()
        return repro_torch.compile(g, scaled_paper_machine(64),
                                   backend="cuda",
                                   params=init_params(g, seed=seed),
                                   use_cache=False, device="cuda")
    return make(0), make(1)


def _eager(dep, megakernel: bool, card):
    fn = (MK.megakernel_batched(dep.program, card) if megakernel
          else C.kernel_batched(dep.program, card))

    def run(x):
        return C.to_numpy(fn(C.to_device(dep.program, {"input": x}, card)))
    return run


def _graphed(dep, megakernel: bool):
    opts = BackendOptions(megakernel=None if megakernel else False)
    run = B.get_backend("cuda").batched(dep.program, opts, "cuda")
    assert isinstance(run, GraphedRunner)
    return run


def _launched(fn):
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 8])
@pytest.mark.parametrize("megakernel", [True, False])
def test_graphs_on_the_card_equal_the_eager_program(resnet224, card,
                                                    megakernel, slots):
    dep = resnet224[0]
    eager, run = _eager(dep, megakernel, card), _graphed(dep, megakernel)
    hist = []
    for seed in range(5):
        x = _frames(slots, 100 + seed, (224, 224, 3))
        want, eager_n = _launched(lambda: eager(x))
        got, n = _launched(lambda: run({"input": x}))
        hist.append(graph_counts())
        _same(got, want)
        assert n == eager_n and sum(n.values()) > 0
        if seed in (0, 4):
            _same({k: v[:1] for k, v in got.items()},
                  _oracle(dep.program, x[:1]))
    # counts were zeroed per call: one eager call, then replays, the first
    # after its capture
    assert hist[0] == counts(eager=1)
    assert hist[1] == counts(captures=1, replays=1)
    assert hist[2:] == [counts(replays=1)] * 3


@pytest.mark.cuda
def test_two_deployments_interleaved_on_the_card_stay_exact(resnet224,
                                                            card):
    (a, b) = resnet224
    runs = [(_graphed(a, True), _eager(a, True, card), 8),
            (_graphed(b, False), _eager(b, False, card), 1),
            (_graphed(b, True), _eager(b, True, card), 8)]
    reset_launch_counts()
    for seed in range(4):
        for i, (run, eager, slots) in enumerate(runs):
            x = _frames(slots, 200 + 10 * seed + i, (224, 224, 3))
            _same(run({"input": x}), eager(x))
    assert graph_counts() == counts(eager=3, captures=3, replays=9)


@pytest.mark.cuda
def test_a_registered_server_serves_replays_that_meet_their_deadlines(
        resnet224, card):
    g = cnn.resnet50()
    srv = Server(scaled_paper_machine(64), backend="cuda", device="cuda")
    srv.register("resnet50", g, period_s=0.1, slots=4,
                 params=init_params(g, seed=2))
    # the capture happened at registration, before any job
    assert graph_counts() == counts(eager=1, captures=1, replays=1)
    reset_launch_counts()
    eager = _eager(srv.executors["resnet50"], True, card)
    xs = _frames(8, 300, (224, 224, 3))
    tickets = [srv.submit("resnet50", x) for x in xs]
    srv.run(hyperperiods=2)
    torch.cuda.synchronize()
    assert graph_counts() == counts(replays=2)
    assert srv.monitor.misses == {}
    for i, t in enumerate(tickets):
        assert t.status == "done" and t.result().deadline_met
        want = eager(xs[i // 4 * 4:i // 4 * 4 + 4])
        _same(t.result().output, {k: v[i % 4] for k, v in want.items()})
