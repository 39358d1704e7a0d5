"""Paper-mode serving wrappers over the unified runtime.

Deadline accounting and machine-speed calibration live in ONE place
(`repro_torch.serve.monitor.DeadlineMonitor`) behind ONE runtime
(`repro_torch.serve.runtime.Server`); the classes here are thin entry
points over them:

  * `PredictableEngine` — `ServeEngine` whose every decode step is timed
    individually against the per-token WCET bound from the paper pipeline
    (checks AND misses count per step, so the miss rate is no longer
    structurally understated);
  * `MultiModelEngine` — the taskset-of-models adapter: registration,
    admission control, executor attachment and hyperperiod execution all
    delegate to a private `Server`, keeping the historical call surface
    (`add_graph`/`admit_graph`/`run_hyperperiod`/...) intact.

New code should use `repro_torch.serve.Server` directly — it adds
request queues, tickets with per-request deadline verdicts, sustained
multi-hyperperiod operation, and serving bundles.

The WCET bounds here are the modeled machine's (`hw.TPU_V5E` by default, a
roofline model in `hw.py`), not a measurement of the device the engine
runs on; the monitor scales them to that device by its measured (or
pinned) speed ratio.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..core.graph import Graph
from ..core.lmgraph import lm_decode_graph
from ..core.taskset import CompiledTaskset, NetworkSpec
from ..core.wcet import TasksetReport, WCETReport, analyze
from ..hw import HardwareModel, TPU_V5E
from ..models.config import ModelConfig
from .engine import Request, ServeEngine                      # noqa: F401
from .monitor import DeadlineMonitor
from .runtime import AdmissionError, Server                   # noqa: F401


@dataclasses.dataclass
class PredictableServeReport:
    wcet: WCETReport
    per_token_wcet_s: float
    layers_modeled: int
    scaled_to_layers: int

    def summary(self) -> str:
        return (f"{self.wcet.summary()}\n"
                f"  per-token WCET (scaled x"
                f"{self.scaled_to_layers}/{self.layers_modeled} layers): "
                f"{self.per_token_wcet_s * 1e3:.3f} ms")


def analyze_decode(cfg: ModelConfig, batch: int, cache_len: int,
                   hw: HardwareModel = TPU_V5E,
                   num_cores: int | None = None,
                   max_layers: int = 4,
                   arbitration: str = "static") -> PredictableServeReport:
    """WCET bound for one decode step of `cfg` on `hw`.

    Deep archs are analyzed on a representative truncated stack and scaled
    linearly (sound: per-layer structure is identical, the schedule is
    periodic; the lm_head is included in the truncated graph so the
    non-recurring part is not scaled)."""
    L = min(cfg.num_layers, max_layers)
    g = lm_decode_graph(cfg, batch, cache_len, layers=L)
    report, sched, subtasks, mapping = analyze(
        g, hw, num_cores=num_cores, arbitration=arbitration)
    scale = cfg.num_layers / L
    per_token = report.wcet_total_s * scale
    return PredictableServeReport(report, per_token, L, cfg.num_layers)


class PredictableEngine(ServeEngine):
    """ServeEngine + per-step WCET deadline accounting.

    Each decode step is timed at its sync point and checked by the shared
    `DeadlineMonitor` against the per-token WCET bound scaled by the
    machine-speed ratio (measured on the first step unless pinned).
    `deadline_checks`/`deadline_misses` both count per step. The engine
    runs where `params` live (the CUDA kernels for params on the card)."""

    def __init__(self, cfg: ModelConfig, params, batch_size: int = 4,
                 max_len: int = 256, hw: HardwareModel = TPU_V5E,
                 speed_ratio: float | None = None,
                 slack_factor: float = 1.5, **kw):
        super().__init__(cfg, params, batch_size, max_len, **kw)
        self.report = analyze_decode(cfg, batch_size, max_len, hw)
        self.monitor = DeadlineMonitor(speed_ratio=speed_ratio,
                                       slack_factor=slack_factor)

    def _record_decode_step(self, dt_s: float) -> None:
        self.monitor.check("decode", dt_s, self.report.per_token_wcet_s)

    @property
    def deadline_checks(self) -> int:
        return self.monitor.checks.get("decode", 0)

    @property
    def deadline_misses(self) -> int:
        return self.monitor.misses.get("decode", 0)


class MultiModelEngine:
    """Deadline-enforcing multi-model serving on one shared machine — the
    historical adapter over `repro_torch.serve.Server`.

    Networks (CNN inference graphs, LM decode steps) are registered with a
    period/deadline; `compile()` runs the hyperperiod analysis; `admit_*`
    reject additions that would break schedulability (atomic rollback);
    `run_hyperperiod()` executes one hyperperiod of jobs in release order
    with deadline accounting. All of it delegates to the unified runtime;
    the engine only keeps the original call/return conventions.
    `backend` and `device` are the server's ("cuda" on the card unless the
    caller asks for another backend or "cpu").
    """

    def __init__(self, hw: HardwareModel = TPU_V5E,
                 num_cores: int | None = None,
                 arbitration: str = "static", *, backend: str = "cuda",
                 device: str = "cuda"):
        self.hw = hw
        self.num_cores = num_cores
        self.arbitration = arbitration
        self.server = Server(hw, backend=backend, num_cores=num_cores,
                             arbitration=arbitration, device=device)

    # -- delegated state (historical attribute surface) ----------------------
    @property
    def specs(self) -> list[NetworkSpec]:
        return self.server.specs

    @property
    def step_fns(self) -> dict[str, Callable | None]:
        return {n: st.step_fn for n, st in self.server._nets.items()}

    @property
    def report(self) -> TasksetReport | None:
        return self.server.report

    @property
    def compiled(self) -> CompiledTaskset | None:
        return self.server.compiled

    @property
    def executors(self) -> dict[str, object]:
        return self.server.executors

    @property
    def deadline_checks(self) -> dict[str, int]:
        return dict(self.server.monitor.checks)

    @property
    def deadline_misses(self) -> dict[str, int]:
        return dict(self.server.monitor.misses)

    # -- registration --------------------------------------------------------
    def add_graph(self, name: str, graph: Graph, period_s: float,
                  deadline_s: float | None = None,
                  step_fn: Callable[[], object] | None = None) -> None:
        """Register a network without (re)compiling or admission control."""
        self.server.add(name, graph, period_s, deadline_s, step_fn=step_fn,
                        autorun=True)

    def add_model(self, name: str, cfg: ModelConfig, period_s: float,
                  batch: int = 1, cache_len: int = 256,
                  max_layers: int | None = 4,
                  deadline_s: float | None = None,
                  step_fn: Callable[[], object] | None = None) -> None:
        """Register one decode step of an LM architecture as a periodic job.

        max_layers truncates very deep stacks for tractable schedule
        construction (the analyzed job is the truncated decode step; pass
        None to analyze the full depth)."""
        self.server.add(name, cfg, period_s, deadline_s, step_fn=step_fn,
                        autorun=True, batch=batch, cache_len=cache_len,
                        max_layers=max_layers)

    # -- admission control ---------------------------------------------------
    def compile(self) -> TasksetReport:
        """Hyperperiod analysis of the currently registered taskset."""
        return self.server.analyze()

    def _admit(self, name: str, net, period_s: float,
               deadline_s: float | None, step_fn: Callable | None,
               **kw) -> bool:
        try:
            self.server.register(name, net, period_s, deadline_s,
                                 step_fn=step_fn, **kw)
        except AdmissionError as e:
            if e.report is not None:         # analyzed but unschedulable
                return False
            raise
        self.server._nets[name].autorun = True
        return True

    def admit_graph(self, name: str, graph: Graph, period_s: float,
                    deadline_s: float | None = None,
                    step_fn: Callable[[], object] | None = None) -> bool:
        """Add the network only if the extended taskset stays schedulable.

        On rejection — or on any compile error (duplicate name, graph that
        doesn't partition, ...) — the previously admitted set and its
        analysis are restored untouched."""
        return self._admit(name, graph, period_s, deadline_s, step_fn)

    def admit_model(self, name: str, cfg: ModelConfig, period_s: float,
                    batch: int = 1, cache_len: int = 256,
                    max_layers: int | None = 4,
                    deadline_s: float | None = None,
                    step_fn: Callable[[], object] | None = None) -> bool:
        """`admit_graph` for an LM architecture: the `ModelConfig` is
        lowered to one decode step (like `add_model`) and admitted through
        the same atomic-rollback hyperperiod analysis — LM models no longer
        have to enter unchecked via `add_model`."""
        return self._admit(name, cfg, period_s, deadline_s, step_fn,
                           batch=batch, cache_len=cache_len,
                           max_layers=max_layers)

    # -- compiled execution --------------------------------------------------
    def attach_compiled_executors(self,
                                  params_by_net: dict[str, dict] | None = None,
                                  inputs_by_net: dict[str, dict] | None = None,
                                  backend: str | None = None,
                                  seed: int = 0) -> dict[str, object]:
        """Install compiled-deployment executors as step_fns for every
        registered network that doesn't have one.

        Each network is compiled ONCE through `repro_torch.compile`
        (deployment cache keyed on graph signature + machine fingerprint +
        backend + device) and every hyperperiod job instance of it replays
        the same `Deployment` on the engine's device. `backend` names any
        registered backend ("numpy", "torch", "cuda", or a third-party
        entry; default: the engine's); missing params/inputs are
        synthesized. Networks with analysis-only op kinds (LM decode
        graphs) are left untouched. Returns the per-network
        `BatchedInferenceEngine`s (each exposing its `.deployment`)."""
        return self.server.attach_executors(params_by_net, inputs_by_net,
                                            backend=backend, seed=seed)

    # -- execution -----------------------------------------------------------
    def run_hyperperiod(self, speed_ratio: float | None = None,
                        slack_factor: float = 1.5) -> dict:
        """Execute one hyperperiod of jobs in release order with deadline
        accounting. Returns per-network miss/check counters.

        The machine-speed ratio is calibrated on the first job that runs a
        real step_fn (a no-op placeholder must not set the budget scale);
        jobs without a step_fn are executed for ordering but not checked."""
        if self.server.report is None:
            self.compile()
        mon = self.server.monitor
        mon.pin(speed_ratio)
        mon.slack_factor = slack_factor
        self.server.run(hyperperiods=1, restart=True)
        return {"misses": dict(mon.misses), "checks": dict(mon.checks),
                "speed_ratio": mon.speed_ratio}
