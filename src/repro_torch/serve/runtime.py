"""`repro_torch.serve.Server` — the one front door of the serving layer.

What `repro_torch.compile` is to the compiler pipeline, `Server` is to
serving: compiled CNNs and LM decode networks execute against traffic
through one object with one lifecycle:

    srv = Server(machine, backend="cuda")                    # device="cuda"
    srv.register("detector", yolo_graph, period_s=1/30)     # admission-checked
    srv.register_decode("lm", lm_cfg, period_s=0.05,        # continuous
                        params=params)                       # batching
    t = srv.submit("detector", frame)                        # -> Ticket
    srv.run(hyperperiods=3)                                  # release order
    r = t.result()          # output + latency + bound + deadline verdict
    srv.save("fleet.bundle")                                 # AOT artifact dir

The pieces, mirroring the paper's deployment story:

  * **admission** — `register` runs the hyperperiod analysis
    (`repro_torch.core.wcet.analyze_taskset`) over the extended taskset and
    atomically rolls the server back if the addition is unschedulable or
    fails to compile: the previously admitted set keeps serving untouched.
  * **request queues** — each network gets a bounded `RequestQueue` with a
    backpressure policy ("reject" raises at `submit`, "drop-oldest" evicts
    the stalest ticket), feeding static batch slots (`slots=`): the
    deployment's batched runner is always invoked at the fixed slot count
    (short batches are zero-padded and masked out), so serving keeps the
    fixed shapes the WCET machinery was computed for. On the card that
    runner's CUDA graph at the slot count is captured where the runner is
    built (`register`, `load`, a mode's preparation), so every served job
    replays it.
  * **release-order execution** — `step()` executes the next job of the
    compiled hyperperiod program; `run()` continues across hyperperiod
    boundaries (the job cursor wraps, releases accumulate absolute time).
  * **deadline telemetry** — one shared `DeadlineMonitor` calibrates the
    machine-speed ratio and accounts per-network checks/misses/histograms;
    every `Ticket` carries its own `DeadlineVerdict`.
  * **bundles** — `save(dir)`/`Server.load(dir)` compose the per-network
    `Deployment` artifacts plus the taskset metadata into one multi-network
    bundle.

  * **continuous decode** — `register_decode` admits an LM config as one
    slot-batched decode step per period and serves it through a
    `ContinuousEngine` (requests enter and leave the batch mid-stream).

The resilience layer on top keeps those guarantees honest when the world
misbehaves:

  * **mixed-criticality shedding** — networks carry a criticality level;
    under overload (flooded queues or a rising windowed miss rate) the
    server sheds the lowest-criticality network at a hyperperiod boundary
    — its queue pauses and its requests resolve with a degraded
    `DeadlineVerdict` instead of a blanket `BackpressureError` — and
    re-runs the WCET analysis on the remaining set so the surviving
    verdicts stay sound; shed networks restore hysteretically when load
    recedes (`OverloadPolicy`);
  * **atomic mode changes** — `switch_mode(mode)` admission-checks an
    entire incoming taskset with atomic rollback, compiling it for the
    server's own device, then swaps it in ONLY at a hyperperiod boundary
    while in-flight tickets drain under the old schedule
    (`repro_torch.serve.modes`);
  * **fault injection + recovery** — `enable_resilience` arms a seeded
    `FaultPlan`, bounded retry-with-backoff per job, a per-network
    `CircuitBreaker` (trip -> degraded mode -> half-open probe), and a
    `StragglerWatchdog` per network, all counted in `DeadlineMonitor`
    telemetry (`repro_torch.serve.faults`, sharing `train/fault.py`
    machinery). A retry re-runs the same executor on the same device.

Every submitted ticket reaches a terminal state — "done", "degraded",
"dropped", or "failed" — so `Ticket.result()` can never hang on a request
the system gave up on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import time
from collections import deque
from typing import Callable

import numpy as np

from .. import trace
from ..core.compiled import resolve_device
from ..core.graph import Graph
from ..core.taskset import Job, NetworkSpec
from ..core.wcet import NetworkVerdict, TasksetReport, analyze_taskset
from ..core.lmgraph import lm_decode_graph
from ..hw import HardwareModel
from ..models.config import ModelConfig
from .monitor import DeadlineMonitor, DeadlineVerdict

class ServeError(RuntimeError):
    """Invalid serving-runtime usage (unknown network, pending ticket, ...)."""


class AdmissionError(ServeError):
    """Raised when a network cannot be admitted without breaking deadlines.

    When the rejection is an unschedulable analysis (rather than a compile
    failure), the offending `TasksetReport` is attached as `.report`."""

    def __init__(self, msg: str, report: TasksetReport | None = None):
        super().__init__(msg)
        self.report = report


class BackpressureError(ServeError):
    """A bounded request queue is full under the "reject" policy."""


# -- tickets ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TicketResult:
    """What a finished request carries: the output plus the real-time
    accounting the paper's pipeline makes possible per request."""

    output: object                       # {output_name: array} or step_fn value
    latency_s: float                     # host wall time of the serving job
    response_bound_s: float              # compiled WCET response bound
    verdict: DeadlineVerdict             # per-request deadline verdict
    release_s: float                     # absolute model-time job release

    @property
    def deadline_met(self) -> bool:
        return self.verdict.met


@dataclasses.dataclass
class Ticket:
    """Handle for one submitted request.

    Status: "queued" (waiting for its network's next job slot), "done"
    (result available), "dropped" (evicted from a bounded queue or left
    behind by a mode switch), "degraded" (resolved without executing —
    shed network, open circuit breaker, or exhausted retry budget),
    "failed" (the serving job raised; `error` holds the message).

    "done", "dropped" and "degraded" tickets all carry a `TicketResult`
    (non-"done" ones with `output=None` and a met=False verdict whose
    `outcome` says why), so `result()` answers for every request the
    server accepted — a ticket can never hang."""

    TERMINAL = ("done", "dropped", "degraded", "failed")

    tid: int
    network: str
    payload: object
    deadline_s: float | None = None      # per-request deadline (model time)
    status: str = "queued"
    error: str | None = None
    _result: TicketResult | None = dataclasses.field(default=None, repr=False)
    # perf_counter_ns at submission, stamped while `repro_torch.trace` is on
    submit_ns: int | None = dataclasses.field(default=None, repr=False,
                                              compare=False)

    @property
    def done(self) -> bool:
        return self.status == "done"

    @property
    def terminal(self) -> bool:
        return self.status in self.TERMINAL

    def result(self) -> TicketResult:
        if self._result is None:
            raise ServeError(f"ticket {self.tid} ({self.network}) is "
                             f"{self.status}"
                             + (f": {self.error}" if self.error else "")
                             + "; no result available")
        return self._result


# -- request queues -----------------------------------------------------------

class RequestQueue:
    """Bounded FIFO of tickets for one network.

    policy="reject": `push` raises `BackpressureError` when full (the caller
    owns retry/shed). policy="drop-oldest": the stalest queued ticket is
    evicted (marked "dropped") to make room — freshest-data semantics for
    periodic sensor-style traffic."""

    POLICIES = ("reject", "drop-oldest")

    def __init__(self, network: str, capacity: int = 64,
                 policy: str = "reject"):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown queue policy {policy!r} "
                             f"(choose from {self.POLICIES})")
        self.network = network
        self.capacity = capacity
        self.policy = policy
        self.dropped = 0
        self._q: deque[Ticket] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, ticket: Ticket) -> Ticket | None:
        """Enqueue; returns the evicted ticket under drop-oldest (else
        None). Raises `BackpressureError` when full under reject."""
        evicted = None
        if len(self._q) >= self.capacity:
            if self.policy == "reject":
                raise BackpressureError(
                    f"queue for {self.network!r} is full "
                    f"({self.capacity}); rejecting ticket {ticket.tid}")
            evicted = self._q.popleft()
            evicted.status = "dropped"
            self.dropped += 1
        self._q.append(ticket)
        return evicted

    def pop_upto(self, k: int) -> list[Ticket]:
        out = []
        while self._q and len(out) < k:
            out.append(self._q.popleft())
        return out


# -- overload + resilience policies -------------------------------------------

@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Hysteretic mixed-criticality overload control, evaluated once per
    hyperperiod boundary (`Server(overload=...)` arms it).

    *Shed* when any active network's queue depth reaches
    `shed_queue_frac` of its capacity OR its windowed miss rate
    (`DeadlineMonitor.recent_miss_rate` over `miss_window` checks) exceeds
    `shed_miss_rate`: the lowest-criticality active network
    (`TasksetReport.shed_order`) drops out of the hyperperiod program and
    the WCET analysis re-runs on the survivors. *Restore* the most
    critical shed network only after `restore_hyperperiods` CONSECUTIVE
    calm boundaries — every queue at or below `restore_queue_frac` of
    capacity and no miss-rate pressure — and only if the re-admitted
    taskset analyzes schedulable. The shed and restore thresholds are
    deliberately far apart (hysteresis): a system hovering at one
    threshold must not flap between modes every boundary."""

    shed_queue_frac: float = 0.75
    shed_miss_rate: float = 0.5
    miss_window: int = 16
    restore_queue_frac: float = 0.25
    restore_hyperperiods: int = 2

    def __post_init__(self):
        if not 0.0 < self.shed_queue_frac <= 1.0:
            raise ValueError(f"shed_queue_frac must be in (0, 1], "
                             f"got {self.shed_queue_frac}")
        if not 0.0 <= self.restore_queue_frac < self.shed_queue_frac:
            raise ValueError(
                f"restore_queue_frac ({self.restore_queue_frac}) must be in "
                f"[0, shed_queue_frac={self.shed_queue_frac}) — no hysteresis "
                f"band means mode flapping")
        if not 0.0 < self.shed_miss_rate <= 1.0:
            raise ValueError(f"shed_miss_rate must be in (0, 1], "
                             f"got {self.shed_miss_rate}")
        if self.restore_hyperperiods < 1:
            raise ValueError(f"restore_hyperperiods must be >= 1, "
                             f"got {self.restore_hyperperiods}")
        if self.miss_window < 1:
            raise ValueError(f"miss_window must be >= 1, "
                             f"got {self.miss_window}")


# -- the server ---------------------------------------------------------------

@dataclasses.dataclass
class Resilience:
    """The armed recovery configuration (`Server.enable_resilience`)."""

    injector: object = None              # faults.FaultInjector (None: no chaos)
    retry: object = None                 # faults.RetryPolicy
    breaker_policy: object = None        # faults.BreakerPolicy
    watchdog_margin: float | None = None  # StragglerWatchdog margin (None: off)


_GIVE_UP = object()    # sentinel: the retry budget is spent, tickets degraded


@dataclasses.dataclass
class _Network:
    """Per-network serving state (internal)."""

    spec: NetworkSpec
    slots: int = 1
    step_fn: Callable | None = None
    autorun: bool = False                # MultiModelEngine mode: jobs free-run
    params: dict | None = None
    deployment: object = None            # compiler Deployment (executable nets)
    runner: Callable | None = None       # batched runner at the slot count
    engine: object = None                # BatchedInferenceEngine (attach mode)
    queue: RequestQueue | None = None
    cengine: object = None               # ContinuousEngine (decode networks)
    sustained: object = None             # SustainedServeVerdict (if declared)
    inflight: dict = dataclasses.field(default_factory=dict)  # rid -> Ticket
    shed: bool = False                   # paused by overload control
    breaker: object = None               # faults.CircuitBreaker (resilience)
    watchdog: object = None              # StragglerWatchdog (resilience)
    jobs_done: int = 0                   # executed jobs (watchdog step index)


def _primed_runner(dep, backend: str, slots: int) -> Callable:
    """`dep`'s batched runner on `backend`, primed at `slots` rows
    (`compiler.backends.prime`): on the card its CUDA graph is captured
    now, so no served job runs eagerly or captures, and the deadline
    monitor calibrates on a replay."""
    from ..compiler.backends import prime
    return prime(dep.runner(batched=True, backend=backend), slots)


def _as_graph(net, name: str, *, batch: int, cache_len: int,
              max_layers: int | None) -> Graph:
    """Accept a Graph directly or lower a ModelConfig to one decode step
    (truncated to max_layers for tractable schedule construction)."""
    if isinstance(net, Graph):
        return net
    if isinstance(net, ModelConfig):
        L = (min(net.num_layers, max_layers) if max_layers is not None
             else net.num_layers)
        return lm_decode_graph(net, batch, cache_len, layers=L)
    raise TypeError(f"expected a Graph or ModelConfig for network "
                    f"{name!r}, got {type(net).__name__}")


class Server:
    """Unified real-time serving runtime over compiled Deployments.

    See the module docstring for the lifecycle. Constructor knobs:

      backend        any registered backend name ("numpy", "torch",
                     "cuda", third-party) — networks with a compiled
                     lowering get a Deployment + batched runner on it;
      backend_options
                     a `repro_torch.BackendOptions` with typed execution
                     knobs (megakernel on/off, tile overrides), validated
                     against the backend's capabilities up front and
                     persisted through `save`/`load`;
      device         where the deployments run: "cuda" (the default; raises
                     without a GPU) or "cpu";
      queue_capacity / queue_policy
                     bounded per-network request queues ("reject" |
                     "drop-oldest");
      speed_ratio    pin the host-vs-model speed ratio (None: calibrate on
                     the first real execution);
      slack_factor   wall-clock budget slack over the scaled bound;
      overload       an `OverloadPolicy` to arm hysteretic
                     mixed-criticality shedding (None: never shed).
    """

    def __init__(self, machine: HardwareModel, *, backend: str = "torch",
                 backend_options=None,
                 num_cores: int | None = None, arbitration: str = "static",
                 queue_capacity: int = 64, queue_policy: str = "reject",
                 speed_ratio: float | None = None,
                 slack_factor: float = 1.5,
                 overload: OverloadPolicy | None = None,
                 device: str = "cuda"):
        from ..compiler import BackendOptions, get_backend
        backend_options = backend_options or BackendOptions()
        self.device = str(resolve_device(device))
        # fail fast on unknown backend / unsupported options
        get_backend(backend).validate_options(backend_options, self.device)
        self.machine = machine
        self.backend = backend
        self.backend_options = backend_options
        self.num_cores = num_cores
        self.arbitration = arbitration
        self.queue_capacity = queue_capacity
        self.queue_policy = queue_policy
        self.overload = overload
        self.resilience: Resilience | None = None
        self.monitor = DeadlineMonitor(speed_ratio=speed_ratio,
                                       slack_factor=slack_factor)
        self.metrics = {"jobs": 0, "idle_jobs": 0, "tickets": 0,
                        "dropped": 0, "degraded": 0, "retries": 0,
                        "sheds": 0, "restores": 0, "mode_switches": 0}
        self._nets: dict[str, _Network] = {}
        self.report: TasksetReport | None = None
        self.compiled = None                 # CompiledTaskset after analyze()
        self._cursor = 0                     # next job in the hyperperiod
        self.hyperperiods_completed = 0
        self.clock_base_s = 0.0              # abs time across schedule changes
        self.mode_name: str | None = None    # current Mode (switch_mode)
        self._staged_mode = None             # modes.StagedMode awaiting boundary
        self._calm = 0                       # consecutive calm boundaries
        self._tids = itertools.count()

    # -- registration --------------------------------------------------------
    @property
    def specs(self) -> list[NetworkSpec]:
        return [st.spec for st in self._nets.values()]

    @property
    def active_specs(self) -> list[NetworkSpec]:
        """Specs currently in the hyperperiod program (shed ones excluded)."""
        return [st.spec for st in self._nets.values() if not st.shed]

    @property
    def networks(self) -> list[str]:
        return list(self._nets)

    @property
    def shed_networks(self) -> list[str]:
        """Networks currently shed by overload control (queues paused)."""
        return [n for n, st in self._nets.items() if st.shed]

    @property
    def executors(self) -> dict[str, object]:
        """Per-network executors: the `BatchedInferenceEngine` where one
        was attached (`attach_executors`), else the compiled Deployment."""
        return {n: (st.engine or st.deployment)
                for n, st in self._nets.items()
                if st.engine is not None or st.deployment is not None}

    def add(self, name: str, net, period_s: float,
            deadline_s: float | None = None, *,
            criticality: int = 0,
            step_fn: Callable | None = None, slots: int = 1,
            autorun: bool = False, params: dict | None = None,
            batch: int = 1, cache_len: int = 256,
            max_layers: int | None = 4) -> None:
        """Register WITHOUT admission control or executor building — the
        analysis is invalidated and re-run lazily. This is the unchecked
        path `MultiModelEngine.add_graph/add_model` ride on; new code
        should prefer `register`.

        autorun=True marks a free-running network (MultiModelEngine mode):
        its `step_fn` takes NO arguments and is invoked once per job;
        autorun networks refuse `submit` (queued serving uses the one-arg
        ``step_fn(payload)`` convention of `register`)."""
        if name in self._nets:
            raise ServeError(f"network {name!r} already registered")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        graph = _as_graph(net, name, batch=batch, cache_len=cache_len,
                          max_layers=max_layers)
        self._nets[name] = _Network(
            spec=NetworkSpec(name, graph, period_s, deadline_s,
                             criticality=criticality),
            slots=slots, step_fn=step_fn, autorun=autorun, params=params,
            queue=RequestQueue(name, self.queue_capacity, self.queue_policy))
        if self.resilience is not None:
            self._arm_networks()
        self._invalidate()

    def _invalidate(self) -> None:
        """Taskset changed: drop the analysis and restart the timeline."""
        self.report = None
        self.compiled = None
        self._cursor = 0
        self.hyperperiods_completed = 0
        self.clock_base_s = 0.0

    def analyze(self) -> TasksetReport:
        """(Re)run the hyperperiod analysis over the ACTIVE taskset (shed
        networks stay out of the program until restored)."""
        if not self._nets:
            raise AdmissionError("no networks registered")
        specs = self.active_specs
        if not specs:
            raise AdmissionError("every registered network is shed")
        self.report, self.compiled = analyze_taskset(
            specs, self.machine, self.num_cores,
            arbitration=self.arbitration)
        self._cursor = 0
        return self.report

    def register(self, name: str, net, period_s: float,
                 deadline_s: float | None = None, *,
                 criticality: int = 0,
                 step_fn: Callable | None = None, slots: int = 1,
                 params: dict | None = None, batch: int = 1,
                 cache_len: int = 256,
                 max_layers: int | None = 4) -> NetworkVerdict:
        """Admission-controlled registration (the front door).

        Extends the taskset with `net` (a Graph, or a ModelConfig lowered
        to one decode step), re-runs the hyperperiod analysis, and — only
        if the whole extended taskset stays schedulable — compiles the
        network's executable Deployment on the server backend. On an
        unschedulable verdict (`AdmissionError`, `.report` attached) or ANY
        failure along the way, the server atomically rolls back to the
        previously admitted set, which keeps serving untouched.

        Networks whose op kinds have no compiled lowering (LM decode
        graphs) are admitted for analysis and served through `step_fn`
        (one request per job: ``step_fn(payload) -> output``).

        `criticality` orders overload shedding: higher levels shed later
        (see `OverloadPolicy`).
        """
        snapshot = (dict(self._nets), self.report, self.compiled,
                    self._cursor, self.hyperperiods_completed,
                    self.clock_base_s)
        try:
            self.add(name, net, period_s, deadline_s,
                     criticality=criticality, step_fn=step_fn,
                     slots=slots, params=params, batch=batch,
                     cache_len=cache_len, max_layers=max_layers)
            report = self.analyze()
            if not report.schedulable:
                raise AdmissionError(
                    f"admitting {name!r} makes the taskset unschedulable:\n"
                    f"{report.summary()}", report=report)
            self._build_executor(name)
        except Exception:
            (self._nets, self.report, self.compiled,
             self._cursor, self.hyperperiods_completed,
             self.clock_base_s) = snapshot
            raise
        return report.verdict_of(name)

    def register_decode(self, name: str, cfg: ModelConfig, period_s: float,
                        deadline_s: float | None = None, *, params,
                        criticality: int = 0,
                        slots: int = 4, prompt_len: int = 16,
                        max_new_tokens: int = 32, max_len: int = 256,
                        arrival_rps: float | None = None,
                        tokens_per_request: float | None = None,
                        prefill_per_step: int = 1,
                        max_layers: int | None = 4) -> NetworkVerdict:
        """Admission-controlled registration of a *continuous-batching* LM
        decode network (`repro_torch.serve.continuous`).

        The network is analyzed as one slot-batched decode step per period
        (the fixed-shape graph the WCET bound holds for), then served by a
        `ContinuousEngine` over an `LMBackend` on the server's device
        (`params` are moved there): every `step()` job admits up to
        `prefill_per_step` queued tickets into free slots and runs ONE
        decode step for all occupied slots — requests enter and leave
        mid-stream, and each gets a `DeadlineVerdict` against its own
        deadline. Prompts are left-padded to `prompt_len` (longer ones fail
        their ticket), so each stream equals the batch-to-completion oracle
        `ServeEngine.serve`'s regardless of arrival order.

        Admission adds a *sustained-occupancy* check when the expected
        traffic is declared (`arrival_rps`, and `tokens_per_request` which
        defaults to `max_new_tokens`): offered token load must not exceed
        the slot pool's token capacity (`core.wcet.sustained_occupancy`),
        else `AdmissionError` — a loop that admits such traffic never
        drains its queue. Rollback semantics match `register`.

        Decode networks are analysis-only in bundles: `save` keeps the
        graph + taskset row, `load` restores them without the engine —
        re-register with `register_decode` to resume serving.
        """
        from ..core.wcet import sustained_occupancy
        from ..models import params_to
        from .continuous import ContinuousEngine, LMBackend
        snapshot = (dict(self._nets), self.report, self.compiled,
                    self._cursor, self.hyperperiods_completed,
                    self.clock_base_s)
        try:
            self.add(name, cfg, period_s, deadline_s,
                     criticality=criticality, slots=slots,
                     params=params, batch=slots, cache_len=max_len,
                     max_layers=max_layers)
            report = self.analyze()
            if not report.schedulable:
                raise AdmissionError(
                    f"admitting {name!r} makes the taskset unschedulable:\n"
                    f"{report.summary()}", report=report)
            st = self._nets[name]
            bound = report.bound(name)
            if arrival_rps is not None:
                st.sustained = sustained_occupancy(
                    name, slots=slots, period_s=period_s,
                    step_bound_s=bound, arrival_rps=arrival_rps,
                    tokens_per_request=(tokens_per_request
                                        or float(max_new_tokens)))
                if not st.sustained.schedulable:
                    raise AdmissionError(
                        f"admitting {name!r} oversubscribes the slot pool:\n"
                        f"{st.sustained.summary()}")
            backend = LMBackend(cfg, params_to(params, self.device),
                                slots=slots, prompt_len=prompt_len,
                                max_len=max_len)
            st.cengine = ContinuousEngine(
                backend, max_tokens=max_new_tokens,
                prefill_per_step=prefill_per_step, monitor=self.monitor,
                step_bound_s=bound, default_deadline_s=st.spec.deadline,
                network=name)
            if self.resilience is not None:
                self._arm_networks()
        except Exception:
            (self._nets, self.report, self.compiled,
             self._cursor, self.hyperperiods_completed,
             self.clock_base_s) = snapshot
            raise
        return report.verdict_of(name)

    def _build_executor(self, name: str) -> None:
        """Compile the network's Deployment + batched runner on the server
        backend (skipped for step_fn-driven and analysis-only networks)."""
        from ..compiler import compile as compile_deployment
        from ..core.compiled import supports_graph
        st = self._nets[name]
        if st.step_fn is not None or not supports_graph(st.spec.graph):
            return
        st.deployment = compile_deployment(
            st.spec.graph, self.machine, backend=self.backend,
            params=st.params, num_cores=self.num_cores,
            arbitration=self.arbitration,
            backend_options=self.backend_options, device=self.device)
        st.runner = _primed_runner(st.deployment, self.backend, st.slots)

    def attach(self, name: str, step_fn: Callable) -> None:
        """(Re)attach the execution callable of a step_fn-driven network —
        e.g. after `Server.load`, where callables cannot be serialized."""
        self._net(name).step_fn = step_fn

    def _net(self, name: str) -> _Network:
        try:
            return self._nets[name]
        except KeyError:
            raise ServeError(f"unknown network {name!r} "
                             f"(registered: {self.networks})") from None

    # -- request intake ------------------------------------------------------
    def submit(self, name: str, payload, deadline_s: float | None = None
               ) -> Ticket:
        """Enqueue one request for `name`; returns its `Ticket`.

        `payload` is {input_name: array} (or a bare per-sample array for
        single-input graphs) for compiled networks, or whatever the
        network's `step_fn` accepts. `deadline_s` (model-time seconds)
        overrides the network deadline for THIS request's verdict; the
        schedule-level enforcement vs the WCET bound is unaffected.
        Raises `BackpressureError` when the bounded queue is full under
        the reject policy; under drop-oldest the stalest ticket resolves
        terminally ("dropped", with a met=False verdict) instead.

        A shed network (overload control) or one whose circuit breaker is
        open accepts the request but resolves it immediately with a
        degraded verdict — degraded operation is a per-network property,
        not a blanket `BackpressureError` for everyone."""
        st = self._net(name)
        if st.autorun:
            raise ServeError(
                f"network {name!r} free-runs a no-arg step_fn every job "
                f"(MultiModelEngine mode) and does not take submissions")
        if st.runner is None and st.step_fn is None and \
                st.deployment is None and st.cengine is None:
            raise ServeError(
                f"network {name!r} has no executor: it was added without "
                f"admission (or is analysis-only) — register it through "
                f"Server.register, pass step_fn=, or call attach()")
        t = Ticket(tid=next(self._tids), network=name, payload=payload,
                   deadline_s=deadline_s, submit_ns=trace.stamp())
        if st.shed or (st.breaker is not None
                       and st.breaker.state == "open"):
            self._resolve_terminal(t, "degraded")
            return t
        evicted = st.queue.push(t)
        if evicted is not None:
            self._resolve_terminal(evicted, "dropped")
        return t

    def queue_depths(self) -> dict[str, int]:
        return {n: len(st.queue) for n, st in self._nets.items()}

    def network_status(self, name: str) -> dict:
        """One network's admission-relevant state, as a plain dict.

        A cluster router ranks replicas on this: queue depth/capacity and
        slots give the backlog, the WCET response bound and effective
        deadline give the headroom, and the shed/breaker/departing flags
        mark replicas that would resolve a submission degraded (shed, open
        breaker) or are draining toward a staged mode that no longer
        carries the network (`departing`).
        `bound_s` is None while the network is out of the analyzed program
        (e.g. shed: the report no longer carries a bound for it).
        """
        st = self._net(name)
        if self.report is None:
            self.analyze()
        try:
            bound = self.report.bound(name)
        except KeyError:
            bound = None
        return {
            "queue_depth": len(st.queue) if st.queue is not None else 0,
            "queue_capacity": (st.queue.capacity
                               if st.queue is not None else 0),
            "slots": st.slots,
            "shed": st.shed,
            "breaker_open": (st.breaker is not None
                             and st.breaker.state == "open"),
            "departing": (self._staged_mode is not None
                          and name not in self._staged_mode.nets),
            "bound_s": bound,
            "deadline_s": st.spec.deadline,
        }

    # -- release-order execution ---------------------------------------------
    def step(self) -> Job:
        """Execute the next job of the hyperperiod program (release order),
        serving that network's queued tickets in its static batch slots.
        Advances across hyperperiod boundaries; returns the executed Job.

        At each hyperperiod boundary (before the first job), boundary
        housekeeping runs: a staged mode switch applies and the overload
        control loop sheds/restores — both are forbidden mid-hyperperiod
        because they change the schedule the in-flight bounds assume."""
        with trace.span("serve.step"):
            if self.report is None:
                self.analyze()
            if self._cursor == 0:
                self._boundary()
            jobs = self.compiled.jobs
            job = jobs[self._cursor]
            release_abs = (self.clock_base_s + self.hyperperiods_completed
                           * self.compiled.hyperperiod_s + job.release)
            self._execute_job(job, release_abs)
            self._cursor += 1
            if self._cursor >= len(jobs):
                self._cursor = 0
                self.hyperperiods_completed += 1
        return job

    def _boundary(self) -> None:
        """Hyperperiod-boundary housekeeping (the only place the active
        schedule may change): apply a staged mode, then shed/restore."""
        if self._staged_mode is not None:
            self._apply_mode()
        if self.overload is not None:
            self._overload_control()

    def _now_s(self) -> float:
        """Absolute model time at the current boundary: completed
        hyperperiods of the current program plus the base carried across
        schedule changes (sheds, restores, mode switches)."""
        if self.compiled is None:
            return self.clock_base_s
        return (self.clock_base_s + self.hyperperiods_completed
                * self.compiled.hyperperiod_s)

    def _execute_job(self, job: Job, release_abs: float) -> None:
        self.metrics["jobs"] += 1
        with trace.span("serve.job", job=self.metrics["jobs"],
                        net=job.network):
            self._run_job(job, release_abs)

    def _run_job(self, job: Job, release_abs: float) -> None:
        st = self._nets[job.network]
        bound = self.report.bound(job.network)
        if st.breaker is not None and not st.autorun:
            action = st.breaker.on_release()
            if action == "skip":
                # open breaker: the network operates degraded — this
                # job's worth of queued tickets resolves now rather than
                # waiting behind a broken executor ("probe" falls through
                # so the half-open breaker has a real job to judge)
                k = 1 if (st.runner is None and st.cengine is None) \
                    else st.slots
                for t in st.queue.pop_upto(k):
                    self._resolve_terminal(t, "degraded")
                self.metrics["idle_jobs"] += 1
                return
        if st.autorun and st.step_fn is not None:
            # MultiModelEngine mode: every job free-runs its no-arg fn
            # (autorun networks never hold tickets — submit refuses them)
            out, dt = self._serve_call(st, [], st.step_fn)
            if out is _GIVE_UP:
                return
            self.monitor.check(job.network, dt, bound)
        elif st.runner is not None and len(st.queue) > 0:
            tickets = st.queue.pop_upto(st.slots)
            trace.queued(tickets)
            with self._failing(tickets), trace.span("serve.stack"):
                # malformed payloads are caller errors, not executor
                # faults: they fail the tickets and raise without
                # consuming the retry budget
                batch = self._stack(st, [t.payload for t in tickets])
            out, dt = self._serve_call(st, tickets,
                                       lambda: st.runner(batch))
            if out is _GIVE_UP:
                return
            with trace.span("serve.finish"):
                self.monitor.check(job.network, dt, bound)
                for i, t in enumerate(tickets):
                    self._finish(t, {k: v[i] for k, v in out.items()},
                                 dt, bound, release_abs)
        elif st.cengine is not None:
            self._step_continuous(st, release_abs, bound)
        elif st.step_fn is not None and len(st.queue) > 0:
            tickets = st.queue.pop_upto(1)
            trace.queued(tickets)
            (t,) = tickets
            out, dt = self._serve_call(st, tickets,
                                       lambda: st.step_fn(t.payload))
            if out is _GIVE_UP:
                return
            self.monitor.check(job.network, dt, bound)
            self._finish(t, out, dt, bound, release_abs)
        else:
            self.metrics["idle_jobs"] += 1

    def _step_continuous(self, st: _Network, release_abs: float,
                         bound: float) -> None:
        """One hyperperiod job of a continuous decode network: admit up to
        the engine's per-step prefill budget from the ticket queue, run one
        slot-batched decode step (the engine checks it against the WCET
        bound and records occupancy), finish tickets whose streams
        completed. A ticket's payload is the prompt (list of token ids) or
        ``{"prompt": [...], "max_new_tokens": n}``."""
        ce = st.cengine
        for t in st.queue.pop_upto(ce.admittable()):
            with self._failing([t]):
                if isinstance(t.payload, dict):
                    prompt = t.payload["prompt"]
                    max_new = t.payload.get("max_new_tokens")
                else:
                    prompt, max_new = t.payload, None
                ce.enqueue(prompt, max_new, rid=t.tid,
                           deadline_s=t.deadline_s)
            st.inflight[t.tid] = t
        if not ce.has_work:
            self.metrics["idle_jobs"] += 1
            return
        # a failed decode step keeps its in-flight requests in the engine
        # for the NEXT job (the stream is resumable), so no ticket fails or
        # degrades here — the breaker/retry accounting still applies
        info, _ = self._serve_call(st, [], ce.step)
        if info is _GIVE_UP:
            return
        for req in info.finished:
            # pop defensively: a shed or mode switch may have resolved the
            # ticket degraded while its stream was still in flight
            t = st.inflight.pop(req.rid, None)
            if t is None:
                continue
            t._result = TicketResult(
                output=list(req.out), latency_s=req.latency_s,
                response_bound_s=bound * req.steps_held,
                verdict=req.verdict, release_s=release_abs)
            t.status = "done"
            self.metrics["tickets"] += 1

    @contextlib.contextmanager
    def _failing(self, tickets: list[Ticket]):
        """Popped tickets must never be silently lost: if serving them
        raises, they are marked "failed" (with the error) before the
        exception propagates to the `step()`/`run()` caller."""
        try:
            yield
        except Exception as e:
            for t in tickets:
                t.status = "failed"
                t.error = f"{type(e).__name__}: {e}"
            raise

    def _stack(self, st: _Network, payloads: list) -> dict:
        """Short batches are padded to the static slot count (fixed shapes
        for the compiled runner); padded rows are computed and discarded."""
        graph = st.spec.graph
        dicts = [(p if isinstance(p, dict) else {graph.inputs[0]: p})
                 for p in payloads]
        batch = {}
        for name in graph.inputs:
            try:
                arrs = [np.asarray(d[name]) for d in dicts]
            except KeyError:
                raise ServeError(
                    f"payload for {st.spec.name!r} is missing input "
                    f"{name!r} (graph inputs: {list(graph.inputs)})"
                ) from None
            arrs += [np.zeros_like(arrs[0])] * (st.slots - len(arrs))
            batch[name] = np.stack(arrs)
        return batch

    def _finish(self, t: Ticket, output, dt: float, bound: float,
                release_abs: float) -> None:
        deadline = (t.deadline_s if t.deadline_s is not None
                    else self._nets[t.network].spec.deadline)
        verdict = self.monitor.judge(t.network, dt, bound, deadline)
        t._result = TicketResult(output=output, latency_s=dt,
                                 response_bound_s=bound, verdict=verdict,
                                 release_s=release_abs)
        t.status = "done"
        self.metrics["tickets"] += 1

    # -- resilience: faults, retries, breakers -------------------------------
    def enable_resilience(self, *, faults=None, retry=None, breaker=None,
                          watchdog_margin: float | None = None,
                          overload: OverloadPolicy | None = None) -> None:
        """Arm the recovery layer (see `repro_torch.serve.faults`):

          faults           a `FaultPlan` — seeded injection of failures /
                           timeouts / latency spikes into executor calls
                           (None: no chaos, recovery machinery only);
          retry            a `RetryPolicy` — bounded retry-with-backoff
                           per serving job (default: 2 retries, no wait);
          breaker          a `BreakerPolicy` — per-network circuit
                           breaking: N consecutive failed jobs trip the
                           network into degraded mode, a half-open probe
                           job decides recovery;
          watchdog_margin  arm a per-network `StragglerWatchdog` flagging
                           jobs slower than margin x rolling median
                           (counted as "straggler" events; None: off);
          overload         convenience: also arm/replace the
                           `OverloadPolicy` (same as the constructor
                           knob).

        With resilience armed, an executor failure no longer fails its
        tickets and propagates: the job retries within its budget (the
        same executor on the same device), then its tickets resolve
        degraded, carrying the error, and the breaker counts the failure.
        Caller errors (malformed payloads) still raise."""
        from .faults import BreakerPolicy, RetryPolicy
        self.resilience = Resilience(
            injector=faults.injector() if faults is not None else None,
            retry=retry or RetryPolicy(),
            breaker_policy=breaker or BreakerPolicy(),
            watchdog_margin=watchdog_margin)
        if overload is not None:
            self.overload = overload
        self._arm_networks()

    def _arm_networks(self) -> None:
        """(Re)build per-network breakers/watchdogs for the current set
        (idempotent; also run when networks are added or a mode applies)."""
        from .faults import CircuitBreaker, StragglerWatchdog
        res = self.resilience
        for name, st in self._nets.items():
            if st.breaker is None:
                st.breaker = CircuitBreaker(name, res.breaker_policy,
                                            monitor=self.monitor)
            if res.watchdog_margin is not None and st.watchdog is None:
                st.watchdog = StragglerWatchdog(margin=res.watchdog_margin)

    def _serve_call(self, st: _Network, tickets: list[Ticket],
                    thunk: Callable):
        """One executor call for a job. Returns (output, dt_s).

        Without resilience a raising executor marks the popped tickets
        "failed" and the exception propagates to the `step()`/`run()`
        caller. With resilience armed the call goes through
        `_call_resilient` (injection, retries, breaker, watchdog) and a job
        that exhausts its retry budget resolves its tickets degraded and
        returns `(_GIVE_UP, 0.0)` instead of raising — serving continues."""
        if self.resilience is None:
            with self._failing(tickets):
                t0 = time.perf_counter()
                out = thunk()
                return out, time.perf_counter() - t0
        out, dt, error = self._call_resilient(st, thunk)
        if error is None:
            return out, dt
        for t in tickets:
            self._resolve_terminal(t, "degraded", error=error)
        return _GIVE_UP, 0.0

    def _call_resilient(self, st: _Network, thunk: Callable):
        """Run `thunk` under the armed resilience: one seeded fault draw
        per attempt (raising faults raise BEFORE the real call, so state
        is untouched and the retry is clean), bounded retry-with-backoff,
        breaker and watchdog outcome recording. Returns
        `(out, dt_s, None)` on success — dt inflated by the spike factor
        when a latency spike was drawn — or `(None, 0.0, error)` once the
        budget is spent (ONE breaker failure per job: the breaker counts
        consecutive failed *jobs*, not attempts). `error` names the
        exception's type, so a caller can tell an injected fault from a
        real executor (device) error."""
        res = self.resilience
        name = st.spec.name
        error = None
        for attempt in range(1 + res.retry.max_retries):
            if attempt:
                self.metrics["retries"] += 1
                self.monitor.record_event(name, "retry")
                backoff = res.retry.backoff(attempt)
                if backoff > 0:
                    time.sleep(backoff)
            try:
                spike = (res.injector.before_call(name)
                         if res.injector is not None else None)
                t0 = time.perf_counter()
                out = thunk()
                dt = time.perf_counter() - t0
            except Exception as e:
                error = f"{type(e).__name__}: {e}"
                continue
            if spike == "spike":
                dt *= res.injector.plan.spike_factor
            if st.breaker is not None:
                st.breaker.record_success()
            st.jobs_done += 1
            if st.watchdog is not None and st.watchdog.observe(
                    st.jobs_done, dt):
                self.monitor.record_event(name, "straggler")
            return out, dt, None
        if st.breaker is not None:
            st.breaker.record_failure()
        self.monitor.record_event(name, "job_failed")
        return None, 0.0, error

    def _resolve_terminal(self, t: Ticket, outcome: str,
                          error: str | None = None) -> None:
        """Resolve a ticket the system gave up on ("dropped"/"degraded")
        with a terminal result — output=None and a met=False verdict
        carrying the outcome — so `Ticket.result()` answers for every
        accepted request instead of hanging forever."""
        spec = self._nets[t.network].spec
        try:
            bound = (self.report.bound(t.network)
                     if self.report is not None else spec.deadline)
        except KeyError:                 # shed nets are not in the report
            bound = spec.deadline
        deadline = t.deadline_s if t.deadline_s is not None \
            else spec.deadline
        verdict = DeadlineVerdict(
            network=t.network, latency_s=0.0, response_bound_s=bound,
            deadline_s=deadline, budget_s=0.0, met=False, outcome=outcome)
        t._result = TicketResult(output=None, latency_s=0.0,
                                 response_bound_s=bound, verdict=verdict,
                                 release_s=self._now_s())
        t.status = outcome
        t.error = error
        self.metrics[outcome] += 1
        self.monitor.record_event(t.network, outcome)

    # -- resilience: mixed-criticality overload control ----------------------
    def shed(self, name: str) -> None:
        """Shed `name` into degraded mode: its queued and in-flight
        tickets resolve degraded, its queue pauses (submissions resolve
        degraded immediately), its jobs leave the hyperperiod program,
        and the WCET analysis re-runs on the remaining active set so the
        survivors' response bounds stay sound. Refuses to shed the last
        active network."""
        st = self._net(name)
        if st.shed:
            return
        if len(self.active_specs) <= 1:
            raise ServeError(f"cannot shed {name!r}: it is the only "
                             f"active network")
        self.metrics["sheds"] += 1
        self.monitor.record_event(name, "shed")
        for t in st.queue.pop_upto(len(st.queue)):
            self._resolve_terminal(t, "degraded")
        for t in list(st.inflight.values()):
            self._resolve_terminal(t, "degraded")
        st.inflight.clear()
        st.shed = True
        self._reanalyze_active()

    def restore(self, name: str | None = None) -> str | None:
        """Re-admit a shed network (the most critical one by default) —
        but only if the restored taskset re-analyzes schedulable, which
        keeps a restore from immediately re-triggering the overload it
        was shed for. Returns the restored name, or None."""
        shed = self.shed_networks
        if not shed:
            return None
        if name is not None:
            if not self._net(name).shed:
                raise ServeError(f"network {name!r} is not shed")
            candidates = [name]
        else:
            candidates = sorted(
                shed, key=lambda n: (-self._nets[n].spec.criticality, n))
        for cand in candidates:
            st = self._nets[cand]
            trial = self.active_specs + [st.spec]
            report, _ = analyze_taskset(trial, self.machine,
                                        self.num_cores,
                                        arbitration=self.arbitration)
            if not report.schedulable:
                continue
            st.shed = False
            self.metrics["restores"] += 1
            self.monitor.record_event(cand, "restore")
            self._reanalyze_active()
            return cand
        return None

    def _reanalyze_active(self) -> None:
        """Re-run the analysis over the active set after a shed/restore,
        carrying the absolute clock forward so `release_s` timestamps
        stay monotonic across the schedule change."""
        if self.compiled is not None:
            self.clock_base_s += (self.hyperperiods_completed
                                  * self.compiled.hyperperiod_s)
        self.hyperperiods_completed = 0
        self.report, self.compiled = analyze_taskset(
            self.active_specs, self.machine, self.num_cores,
            arbitration=self.arbitration)
        self._cursor = 0

    def _overload_control(self) -> None:
        """The per-boundary shed/restore decision (see `OverloadPolicy`)."""
        if self._overloaded():
            self._calm = 0
            order = [n for n in self.report.shed_order()
                     if not self._nets[n].shed]
            if len(order) > 1:           # never shed the last network
                self.shed(order[0])
        elif self.shed_networks and self._calm_now():
            self._calm += 1
            if self._calm >= self.overload.restore_hyperperiods:
                if self.restore() is not None:
                    self._calm = 0
        else:
            self._calm = 0

    def _overloaded(self) -> bool:
        pol = self.overload
        for n, st in self._nets.items():
            if st.shed:
                continue
            if len(st.queue) >= pol.shed_queue_frac * st.queue.capacity:
                return True
            if self.monitor.recent_miss_rate(
                    n, pol.miss_window) > pol.shed_miss_rate:
                return True
        return False

    def _calm_now(self) -> bool:
        """Calm = every active queue at/below the restore threshold and
        no miss-rate pressure (the low side of the hysteresis band)."""
        pol = self.overload
        for n, st in self._nets.items():
            if st.shed:
                continue
            if len(st.queue) > pol.restore_queue_frac * st.queue.capacity:
                return False
            if self.monitor.recent_miss_rate(
                    n, pol.miss_window) > pol.shed_miss_rate:
                return False
        return True

    # -- resilience: atomic mode changes -------------------------------------
    def switch_mode(self, mode) -> "TasksetReport":
        """Atomically switch the whole admitted taskset to `mode` (a
        `repro_torch.serve.modes.Mode`), at a hyperperiod boundary ONLY.

        The incoming taskset is admission-checked and compiled NOW, for
        this server's backend and device (`modes.prepare_mode`) — an
        unschedulable or uncompilable mode raises and the current taskset
        keeps serving untouched (the same atomic contract as `register`).
        The prepared mode is then staged: the remaining jobs of the
        current hyperperiod drain their queued tickets under the old
        schedule, and exactly at the boundary the server swaps — queues of
        networks present in both modes carry over, tickets of departing
        networks resolve terminally ("dropped"), and the timeline
        continues on the new hyperperiod program with the absolute clock
        carried forward. Returns the new mode's (schedulable)
        `TasksetReport`.

        Decode networks (`register_decode`) cannot ride through a switch;
        re-register them afterwards (the `Server.load` rule)."""
        from .modes import prepare_mode
        staged = prepare_mode(self, mode)
        self._staged_mode = staged
        # idle server or one already sitting at a boundary: apply now
        # (step() applies staged modes only at cursor 0 otherwise)
        if self.compiled is None or not self._nets or self._cursor == 0:
            self._apply_mode()
        return staged.report

    def _apply_mode(self) -> None:
        """Swap in the staged mode (hyperperiod boundary only)."""
        staged = self._staged_mode
        self._staged_mode = None
        new = staged.nets
        for name, st in self._nets.items():
            if name in new:
                # persisting network: its queued requests survive the
                # switch and serve under the NEW mode's bounds
                new[name].queue = st.queue
            else:
                for t in st.queue.pop_upto(len(st.queue)):
                    self._resolve_terminal(t, "dropped")
                for t in list(st.inflight.values()):
                    self._resolve_terminal(t, "dropped")
                st.inflight.clear()
        if self.compiled is not None:
            self.clock_base_s += (self.hyperperiods_completed
                                  * self.compiled.hyperperiod_s)
        self._nets = new
        self.report = staged.report
        self.compiled = staged.compiled
        self._cursor = 0
        self.hyperperiods_completed = 0
        self._calm = 0
        self.mode_name = staged.mode.name
        self.metrics["mode_switches"] += 1
        self.monitor.record_event(staged.mode.name, "mode_switch")
        if self.resilience is not None:
            self._arm_networks()

    def run(self, hyperperiods: int | None = None,
            duration_s: float | None = None, *,
            restart: bool = False) -> dict:
        """Serve `hyperperiods` whole hyperperiods of jobs (or enough to
        cover `duration_s` of modeled time; default 1), continuing from the
        current job cursor — back-to-back calls give sustained operation.
        Returns the telemetry snapshot (see `telemetry()`).

        Counts *boundary crossings* rather than a precomputed number of
        jobs: a mid-run mode switch or overload shed changes the job
        count per hyperperiod, and the run still serves the requested
        number of whole hyperperiods of whatever schedule is active."""
        if self.report is None:
            self.analyze()
        if restart:
            self._cursor = 0
        if duration_s is not None:
            if hyperperiods is not None:
                raise ValueError("pass hyperperiods= or duration_s=, not both")
            hyperperiods = max(1, math.ceil(
                duration_s / self.compiled.hyperperiod_s))
        crossed = 0
        while crossed < (hyperperiods or 1):
            self.step()
            if self._cursor == 0:
                crossed += 1
        return self.telemetry()

    # -- telemetry -----------------------------------------------------------
    def telemetry(self) -> dict:
        """Deadline accounting + queue/serving counters, machine-readable."""
        snap = {**self.monitor.snapshot(),
                "metrics": dict(self.metrics),
                "queue_depths": self.queue_depths(),
                "dropped": {n: st.queue.dropped
                            for n, st in self._nets.items()},
                "shed": self.shed_networks,
                "mode": self.mode_name,
                "breakers": {n: st.breaker.state
                             for n, st in self._nets.items()
                             if st.breaker is not None},
                "hyperperiods_completed": self.hyperperiods_completed}
        continuous = {n: {**st.cengine.metrics,
                          "occupancy": st.cengine.state.occupancy,
                          "slots": st.cengine.state.slots,
                          "pending": len(st.cengine.pending)}
                      for n, st in self._nets.items()
                      if st.cengine is not None}
        if continuous:
            snap["continuous"] = continuous
        sustained = {n: {"occupancy": st.sustained.occupancy,
                         "token_capacity_tps":
                             st.sustained.token_capacity_tps,
                         "offered_load_tps": st.sustained.offered_load_tps,
                         "schedulable": st.sustained.schedulable}
                     for n, st in self._nets.items()
                     if st.sustained is not None}
        if sustained:
            snap["sustained"] = sustained
        return snap

    def summary(self) -> str:
        lines = [f"Server[{len(self._nets)} nets @ {self.machine.name}, "
                 f"backend={self.backend}, device={self.device}, "
                 f"queue={self.queue_capacity} "
                 f"({self.queue_policy})]"]
        if self.report is not None:
            lines.append(self.report.summary())
        lines.append(self.monitor.summary())
        lines.append(f"  jobs={self.metrics['jobs']} "
                     f"(idle {self.metrics['idle_jobs']}), "
                     f"tickets={self.metrics['tickets']}, "
                     f"queued={self.queue_depths()}, "
                     f"hyperperiods={self.hyperperiods_completed}")
        m = self.metrics
        if any(m[k] for k in ("dropped", "degraded", "retries", "sheds",
                              "restores", "mode_switches")) or self.mode_name:
            lines.append(
                f"  mode={self.mode_name or '-'} shed={self.shed_networks} "
                f"dropped={m['dropped']} degraded={m['degraded']} "
                f"retries={m['retries']} sheds={m['sheds']} "
                f"restores={m['restores']} "
                f"mode_switches={m['mode_switches']}")
        return "\n".join(lines)

    # -- MultiModelEngine-compat executor attachment -------------------------
    def attach_executors(self, params_by_net: dict | None = None,
                         inputs_by_net: dict | None = None,
                         backend: str | None = None,
                         seed: int = 0) -> dict[str, object]:
        """Install compiled-deployment engines as free-running step_fns for
        every executable network that has none (the
        `MultiModelEngine.attach_compiled_executors` path): each job
        instance replays the network's Deployment on a fixed input. Returns
        the per-network `BatchedInferenceEngine`s."""
        from ..compiler import compile as compile_deployment
        from ..core.compiled import supports_graph
        from ..core.executor import init_params
        from .engine import BatchedInferenceEngine
        backend = backend or self.backend
        params_by_net = params_by_net or {}
        inputs_by_net = inputs_by_net or {}
        engines: dict[str, object] = {}
        rng = np.random.default_rng(seed)
        for name, st in self._nets.items():
            if st.step_fn is not None or not supports_graph(st.spec.graph):
                continue
            graph = st.spec.graph
            params = (params_by_net.get(name) or st.params
                      or init_params(graph))
            inp = inputs_by_net.get(name)
            if inp is None:
                inp = {t: rng.integers(
                           -64, 64, size=(1,) + graph.tensors[t].shape
                       ).astype(np.int8)
                       for t in graph.inputs}
            dep = compile_deployment(graph, self.machine, backend=backend,
                                     params=params,
                                     num_cores=self.num_cores,
                                     arbitration=self.arbitration,
                                     backend_options=self.backend_options,
                                     device=self.device)
            eng = BatchedInferenceEngine.from_deployment(dep)
            rows = np.shape(next(iter(inp.values())) if isinstance(inp, dict)
                            else inp)[0]
            _primed_runner(dep, dep.backend, rows)    # the engine's runner
            st.step_fn = (lambda e=eng, x=inp: e.infer(x))
            st.autorun = True
            st.deployment = dep          # the artifact (bundles save this)
            st.engine = eng
            engines[name] = eng
        return engines

    # -- static analysis -----------------------------------------------------
    def verify(self, *, suppress: tuple = ()):
        """Run the schedule sanitizer (`repro_torch.analysis`) over the active
        taskset: the hyperperiod WCET schedule, every subtask's scratchpad
        residency, the admission report's soundness, and each executable
        network's deployment artifact. Returns the `AnalysisReport`;
        `save` refuses to write a bundle whose report is not `ok`."""
        import types
        from ..analysis import AnalysisReport, parse_suppressions
        from ..analysis.runner import taskset_diagnostics
        if self.report is None:
            self.analyze()
        shim = types.SimpleNamespace(
            taskset=self.compiled, machine=self.machine, report=self.report,
            deployments={n: st.deployment for n, st in self._nets.items()
                         if st.deployment is not None})
        t0 = time.perf_counter()
        report = AnalysisReport(
            subject=f"server@{self.machine.name}",
            diagnostics=taskset_diagnostics(shim),
            suppressions=parse_suppressions(tuple(suppress)))
        report.duration_s = time.perf_counter() - t0
        return report

    # -- bundles -------------------------------------------------------------
    def save(self, dirpath: str) -> str:
        """Write the whole serving configuration as a multi-network bundle:
        one `Deployment` artifact per executable network plus the
        taskset/queue metadata and (pickled) the machine and the graphs of
        analysis-only networks. step_fn callables are NOT serialized —
        reattach them after `load` (via its `step_fns=` or `attach`).

        The schedule sanitizer gates the write: a serving configuration
        carrying an unsuppressed error-severity diagnostic is refused."""
        from ..compiler import ArtifactError, save_bundle
        if self.report is None:
            self.analyze()
        analysis = self.verify()
        if not analysis.ok:
            raise ArtifactError(
                f"{dirpath}: refusing to save a serving bundle that fails "
                f"the schedule sanitizer:\n{analysis.summary()}")
        deployments = {n: st.deployment for n, st in self._nets.items()
                       if st.deployment is not None}
        extra = {
            "server": {"backend": self.backend,
                       "backend_options": self.backend_options.to_manifest(),
                       "num_cores": self.num_cores,
                       "arbitration": self.arbitration,
                       "queue_capacity": self.queue_capacity,
                       "queue_policy": self.queue_policy,
                       "speed_ratio": (self.monitor.speed_ratio
                                       if self.monitor.pinned else None),
                       "slack_factor": self.monitor.slack_factor},
            "networks": [{"name": n, "period_s": st.spec.period_s,
                          "deadline_s": st.spec.deadline_s,
                          "criticality": st.spec.criticality,
                          "slots": st.slots,
                          "executable": n in deployments,
                          "step_fn": st.step_fn is not None,
                          "continuous": st.cengine is not None}
                         for n, st in self._nets.items()],
            "machine_fingerprint": self.machine.fingerprint(),
            "hyperperiod_s": self.compiled.hyperperiod_s,
            "schedulable": self.report.schedulable,
        }
        objects = {"machine": self.machine,
                   "graphs": {n: st.spec.graph
                              for n, st in self._nets.items()
                              if n not in deployments}}
        return save_bundle(dirpath, deployments, extra=extra,
                           objects=objects)

    @classmethod
    def load(cls, dirpath: str, *, machine: HardwareModel | None = None,
             step_fns: dict[str, Callable] | None = None,
             device: str = "cuda") -> "Server":
        """Reload a saved serving configuration.

        Every member artifact is validated on load (signatures,
        fingerprints — optionally against `machine`); executable networks
        serve their saved Deployments directly (bit-exact with the saved
        server), analysis-only networks get their step_fns from
        `step_fns=` (or later via `attach`). The hyperperiod analysis is
        re-derived — deterministically, so the saved verdict is reproduced
        on the saved machine."""
        from ..compiler import ArtifactError, load_bundle
        deployments, extra, objects = load_bundle(dirpath, machine=machine,
                                                  device=device)
        cfg = extra.get("server", {})
        objects = objects or {}
        hw = machine or objects.get("machine")
        if hw is None:
            raise ArtifactError(f"{dirpath}: bundle carries no machine; "
                                f"pass machine= explicitly")
        want_fp = extra.get("machine_fingerprint")
        if want_fp and hw.fingerprint() != want_fp:
            raise ArtifactError(
                f"{dirpath}: serving bundle was saved for machine "
                f"{want_fp}, refusing {hw.name} ({hw.fingerprint()})")
        from ..compiler import BackendOptions
        srv = cls(hw, backend=cfg.get("backend", "torch"),
                  backend_options=BackendOptions.from_manifest(
                      cfg.get("backend_options")),
                  num_cores=cfg.get("num_cores"),
                  arbitration=cfg.get("arbitration", "static"),
                  queue_capacity=cfg.get("queue_capacity", 64),
                  queue_policy=cfg.get("queue_policy", "reject"),
                  speed_ratio=cfg.get("speed_ratio"),
                  slack_factor=cfg.get("slack_factor", 1.5),
                  device=device)
        step_fns = step_fns or {}
        for net in extra.get("networks", []):
            name = net["name"]
            if net.get("executable"):
                dep = deployments[name]
                srv.add(name, dep.graph, net["period_s"], net["deadline_s"],
                        criticality=net.get("criticality", 0),
                        slots=net.get("slots", 1))
                st = srv._nets[name]
                st.deployment = dep
                st.runner = _primed_runner(dep, srv.backend, st.slots)
            else:
                graph = objects.get("graphs", {}).get(name)
                if graph is None:
                    raise ArtifactError(
                        f"{dirpath}: bundle lists network {name!r} but "
                        f"carries neither its artifact nor its graph")
                srv.add(name, graph, net["period_s"], net["deadline_s"],
                        criticality=net.get("criticality", 0),
                        slots=net.get("slots", 1),
                        step_fn=step_fns.get(name))
        srv.analyze()
        return srv
