"""Serving substrate — fronted by ONE runtime: `repro_torch.serve.Server`.

    srv = Server(machine, backend="cuda")          # device="cuda"
    srv.register("net", graph, period_s=1/30)      # admission-controlled
    ticket = srv.submit("net", frame)
    srv.run(hyperperiods=3)
    ticket.result()        # output + latency + WCET bound + deadline verdict

`BatchedInferenceEngine` is the thin batched-CNN wrapper; all deadline
accounting lives in `DeadlineMonitor`, all multi-network execution in
`Server`. LM decode serving, fault injection and mode changes arrive with
later slices of the port.
"""

from .engine import BatchedInferenceEngine
from .monitor import DeadlineMonitor, DeadlineVerdict
from .runtime import (AdmissionError, BackpressureError, OverloadPolicy,
                      RequestQueue, ServeError, Server, Ticket, TicketResult)

__all__ = ["Server", "Ticket", "TicketResult", "RequestQueue",
           "ServeError", "AdmissionError", "BackpressureError",
           "DeadlineMonitor", "DeadlineVerdict", "OverloadPolicy",
           "BatchedInferenceEngine"]
