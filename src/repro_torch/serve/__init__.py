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
requests enter and leave the batch mid-stream. Fault injection and mode
changes arrive with a later slice of the port.
"""

from .continuous import (ContinuousEngine, ContinuousRequest, DecodeState,
                         LMBackend, ResultTokens, SlotError, StepInfo,
                         ToyBackend)
from .engine import BatchedInferenceEngine, Request, ServeEngine
from .monitor import DeadlineMonitor, DeadlineVerdict
from .runtime import (AdmissionError, BackpressureError, OverloadPolicy,
                      RequestQueue, ServeError, Server, Ticket, TicketResult)

__all__ = ["Server", "Ticket", "TicketResult", "RequestQueue",
           "ServeError", "AdmissionError", "BackpressureError",
           "DeadlineMonitor", "DeadlineVerdict", "OverloadPolicy",
           "BatchedInferenceEngine", "Request", "ServeEngine",
           "ContinuousEngine", "ContinuousRequest", "DecodeState",
           "LMBackend", "ResultTokens", "SlotError", "StepInfo",
           "ToyBackend"]
