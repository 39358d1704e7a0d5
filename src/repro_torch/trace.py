"""The serving path's span recorder: one per process, off by default.

    from repro_torch import trace
    trace.reset()
    trace.enable()
    ...                       # serve: Server.submit / Server.step
    trace.disable()
    for r in trace.records():
        print(r.name, r.end_ns - r.start_ns, r.parent, r.job, r.ticket)

Off, `span(...)` and `kernel(...)` return one shared no-op context
manager: a flag check, nothing allocated or recorded. On, each span appends
a `Record` on `time.perf_counter_ns()` to a list in memory; nothing is
written out, and the records stay until `reset()`. While torch's profiler
runs, each span also opens a `torch.profiler.record_function` range of the
same name, so the device trace holds the program's spans on the
profiler's own clock, beside the kernels.

The spans of a CNN job (`serve.*` in `serve/runtime.py::Server`, `runner.*`
in `compiler/backends.py::_numpy_io` and `GraphedRunner`):

    serve.step            the whole of `Server.step`
      serve.job           `_execute_job` for one job (job id, network)
        serve.stack       batch assembly and padding (`Server._stack`)
        runner.capture    a CUDA graph's capture (once per signature)
        runner.upload     the batch to the device (`to_device`, or a copy
                          into the graph's static inputs)
        runner.issue      the program's body: issues the launches and the
                          plain steps (or one graph replay), returns before
                          the device finishes
        runner.readback   `to_numpy`: the host waiting for the device, and
                          the copy of the output
        serve.finish      the deadline check and each ticket's result
    serve.queue           one per ticket: from `Server.submit` to the start
                          of the `serve.job` that served it

Counters, summed on the open `serve.job` record: `launches` and `launch_ns`
(the kernel launches of the K1-K3 and lut_int8 wrapper calls in the
program's body and the host time of those calls; `kernel(name)` times them
and, under the profiler, names them `kernel.<name>`), `plain_steps` (the
plain torch steps run between launches), `plain_kinds` (those steps by op
kind, e.g. {"upsample": 2, "pack": 1}) and `replayed`. `plain_steps()` and
`plain_kinds()` are the plain-step totals since `reset()`; they are apart
from `kernels.launch_counts()` and `kernels.byte_counts()`.

A job whose program the `cuda` backend replayed as a CUDA graph
(`compiler/backends.py::GraphedRunner`) runs no wrapper and no plain step
on the host: `runner.upload` copies into the graph's static inputs,
`runner.issue` is the replay, `replayed` reads 1, `launches`,
`plain_steps` and `plain_kinds` are the ones the graph's capture counted
(what the card runs), and `launch_ns` reads 0. The capture itself counts
nothing (`Tally`); its `runner.capture` span lies where the runner was primed
(`GraphedRunner.prime`, outside any job when a `Server` builds the
runner), or in the job that called a signature the second time.

One serving thread: the open spans are one stack for the process."""

from __future__ import annotations

from time import perf_counter_ns

import torch

from .kernels import _lib

NAMES = ("serve.step", "serve.job", "serve.stack", "runner.capture",
         "runner.upload", "runner.issue", "runner.readback", "serve.finish",
         "serve.queue")
KERNELS = ("gemm_int8", "conv2d_int8", "megakernel", "lut_int8")
KERNEL_NAMES = tuple(f"kernel.{k}" for k in KERNELS)

ON = False
_records: list = []
_open: list = []          # indices into _records of the open spans
_job = None               # the open serve.job record
_plain = 0
_kinds: dict = {}         # plain steps by op kind


FIELDS = ("name", "start_ns", "end_ns", "parent", "job", "ticket", "net",
          "launches", "launch_ns", "plain_steps", "plain_kinds", "replayed")


class Record:
    """One span: `name`, `start_ns` and `end_ns` on `perf_counter_ns`, the
    index of its `parent` in `records()` (None at the top), and the `job`
    and `ticket` ids it belongs to (None where it has none). A `serve.job`
    also carries its network (`net`) and counters: `launches`,
    `launch_ns`, `plain_steps`, `plain_kinds` ({op kind: plain steps}),
    and `replayed` (1 when its program was a graph replay). Entered
    (`span`), it is the open span."""

    __slots__ = FIELDS + ("_rf",)

    def __init__(self, name, start_ns=0, end_ns=None, job=None, ticket=None,
                 net=None):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent, self.job, self.ticket, self.net = None, job, ticket, net
        self.launches = self.launch_ns = self.plain_steps = 0
        self.plain_kinds: dict = {}
        self.replayed = 0
        self._rf = None

    def asdict(self) -> dict:
        return {k: getattr(self, k) for k in FIELDS}

    def __enter__(self):
        global _job
        self._rf = _range(self.name)
        if _open:
            self.parent = _open[-1]
            if self.job is None:
                self.job = _records[self.parent].job
        if self.name == "serve.job":
            for i in _open:               # the serve.step around it
                if _records[i].job is None:
                    _records[i].job = self.job
            _job = self
        _open.append(len(_records))
        _records.append(self)
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _job
        self.end_ns = perf_counter_ns()
        if _open:                         # a reset() inside drops it
            _open.pop()
        if _job is self:
            _job = None
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def reset() -> None:
    """Drop every record and zero the counters."""
    global _job, _plain, _kinds
    _records.clear()
    _open.clear()
    _job, _plain, _kinds = None, 0, {}


def records() -> list[Record]:
    """The records since `reset()`, in the order their spans opened."""
    return list(_records)


def plain_steps() -> int:
    """Plain torch steps the programs ran since `reset()`, while on."""
    return _plain


def plain_kinds() -> dict:
    """`plain_steps()` by op kind."""
    return dict(_kinds)


def _add_kinds(into: dict, kinds: dict) -> None:
    for k, n in kinds.items():
        into[k] = into.get(k, 0) + n


_profiling = torch.autograd._profiler_enabled


def _range(name: str):
    """The profiler's range of `name`, entered, or None when no profiler
    runs."""
    if not _profiling():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def span(name: str, *, job: int | None = None, ticket: int | None = None,
         net: str | None = None):
    """`with span(name):` records one span while on; `job`, `ticket` and
    `net` label it (a span without a job id takes its parent's). Inside
    `span("serve.job", ...)` the counters of `kernel` and `plain_step` add
    to that job's record."""
    if not ON:
        return NOOP
    return Record(name, job=job, ticket=ticket, net=net)


class _Kernel:
    """One per kernel, reused: a wrapper call does not nest in another."""

    __slots__ = ("kernel", "name", "rf", "n0", "t0")

    def __init__(self, kernel: str):
        self.kernel, self.name = kernel, "kernel." + kernel

    def __enter__(self):
        self.rf = _range(self.name)
        self.n0 = _COUNTS[self.kernel]
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = perf_counter_ns() - self.t0
        n = _COUNTS[self.kernel] - self.n0
        if _job is not None and n:
            _job.launches += n
            _job.launch_ns += dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def kernel(name: str):
    """`with kernel("conv2d_int8"):` around one kernel wrapper's call: its
    launches and their host time go to the open `serve.job` (a call that
    took the plain version launched nothing and adds nothing); under the
    profiler the call is the range `kernel.<name>`."""
    if not ON:
        return NOOP
    return _KERNEL[name]


_COUNTS = _lib._COUNTS         # the launch counters, read in place
_KERNEL = {k: _Kernel(k) for k in KERNELS}


def plain_step(kind: str | None = None) -> None:
    """Count one plain torch step of a program's body, of op `kind`."""
    global _plain
    if ON:
        _plain += 1
        if kind is not None:
            _kinds[kind] = _kinds.get(kind, 0) + 1
        if _job is not None:
            _job.plain_steps += 1
            if kind is not None:
                _job.plain_kinds[kind] = _job.plain_kinds.get(kind, 0) + 1


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - n for k, n in before.items() if after[k] != n}


class Tally:
    """`with Tally() as t:` around a program body that is captured into a
    CUDA graph and not run: what the body would run is counted into
    `t.launches` (kernel -> launches), `t.bytes` (kernel -> bytes, for
    `kernels._lib.BYTE_KERNELS`), `t.plain_steps` and `t.plain_kinds`,
    whether the recorder is on or not, and none of it reaches
    `kernels.launch_counts()`, `kernels.byte_counts()`, the open
    `serve.job`, `plain_steps()` or `plain_kinds()`. The body opens no
    span."""

    launches: dict = {}
    bytes: dict = {}
    plain_steps = 0
    plain_kinds: dict = {}

    def __enter__(self):
        global ON, _job, _plain, _kinds
        self._saved = ON, _job, _plain, _kinds
        self._counts = _lib.launch_counts()
        self._bytes = _lib.byte_counts()
        ON, _job, _plain, _kinds = True, None, 0, {}
        return self

    def __exit__(self, *exc):
        global ON, _job, _plain, _kinds
        self.launches = _delta(self._counts, _lib.launch_counts())
        self.bytes = _delta(self._bytes, _lib.byte_counts())
        _lib.add_launches({k: -n for k, n in self.launches.items()})
        _lib.add_bytes({k: -n for k, n in self.bytes.items()})
        self.plain_steps, self.plain_kinds = _plain, _kinds
        ON, _job, _plain, _kinds = self._saved
        return False


def replayed(launches: int, plain: int, kinds: dict | None = None) -> None:
    """Count one replay of a captured program body that launches
    `launches` kernels and runs `plain` plain steps (`kinds`: by op kind),
    while on: they add to the open `serve.job`, which reads `replayed` 1,
    and the plain steps to `plain_steps()` and `plain_kinds()`."""
    global _plain
    if ON:
        _plain += plain
        _add_kinds(_kinds, kinds or {})
        if _job is not None:
            _job.launches += launches
            _job.plain_steps += plain
            _add_kinds(_job.plain_kinds, kinds or {})
            _job.replayed = 1


def stamp() -> int | None:
    """The time of a submission while on (None while off)."""
    return perf_counter_ns() if ON else None


def queued(tickets) -> None:
    """One `serve.queue` record per ticket stamped at its submission (its
    `submit_ns`), ending where the open `serve.job` started."""
    if not ON or _job is None:
        return
    for t in tickets:
        if t.submit_ns is not None:
            _records.append(Record("serve.queue", t.submit_ns,
                                   _job.start_ns, job=_job.job,
                                   ticket=t.tid))
