"""Serving substrate — fronted by ONE runtime: `repro_torch.serve.Server`.

    srv = Server(machine, backend="cuda")          # device="cuda"
    srv.register("net", graph, period_s=1/30)      # admission-controlled
    ticket = srv.submit("net", frame)
    srv.run(hyperperiods=3)
    ticket.result()        # output + latency + WCET bound + deadline verdict

`BatchedInferenceEngine` / `ServeEngine` remain as thin wrappers (batched
CNN inference, LM prefill/decode); all deadline accounting lives in
`DeadlineMonitor`, all multi-network execution in `Server`. LM decode
traffic is served *continuously* (`repro_torch.serve.continuous`):
`Server.register_decode` installs a slot-indexed `ContinuousEngine` where
requests enter and leave the batch mid-stream. `PredictableEngine` checks
every decode step against its per-token WCET bound, and `MultiModelEngine`
is the historical taskset adapter over a private `Server`.

Degraded operation is first-class: mixed-criticality overload shedding
(`OverloadPolicy`), atomic hyperperiod-boundary mode changes
(`repro_torch.serve.modes.Mode` / `Server.switch_mode`), and seeded fault
injection with bounded retries and per-network circuit breaking
(`repro_torch.serve.faults` / `Server.enable_resilience`).
"""

from .continuous import (ContinuousEngine, ContinuousRequest, DecodeState,
                         LMBackend, ResultTokens, SlotError, StepInfo,
                         ToyBackend)
from .engine import BatchedInferenceEngine, Request, ServeEngine
from .faults import (BreakerPolicy, CircuitBreaker, FaultInjector,
                     FaultPlan, InjectedFailure, InjectedTimeout,
                     RetryPolicy, StragglerWatchdog)
from .modes import Mode, ModeChangeError, ModeNetwork
from .monitor import DeadlineMonitor, DeadlineVerdict
from .predictable import (AdmissionError, MultiModelEngine,
                          PredictableEngine, PredictableServeReport,
                          analyze_decode)
from .runtime import (BackpressureError, OverloadPolicy, RequestQueue,
                      ServeError, Server, Ticket, TicketResult)

__all__ = ["Server", "Ticket", "TicketResult", "RequestQueue",
           "ServeError", "AdmissionError", "BackpressureError",
           "DeadlineMonitor", "DeadlineVerdict",
           "OverloadPolicy", "Mode", "ModeNetwork", "ModeChangeError",
           "FaultPlan", "FaultInjector", "InjectedFailure",
           "InjectedTimeout", "RetryPolicy", "BreakerPolicy",
           "CircuitBreaker", "StragglerWatchdog",
           "BatchedInferenceEngine", "Request", "ServeEngine",
           "PredictableEngine", "PredictableServeReport", "analyze_decode",
           "MultiModelEngine",
           "ContinuousEngine", "ContinuousRequest", "DecodeState",
           "LMBackend", "ResultTokens", "SlotError", "StepInfo",
           "ToyBackend"]
