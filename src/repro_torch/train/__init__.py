"""Training substrate. Ported so far: the fault-tolerance pieces the
serving runtime shares (`InjectedFailure`, `StragglerWatchdog`). The
optimizer, step, loop and checkpoints wait for their port (ROADMAP.md,
queue 1, item 15); `run_with_recovery` and `elastic_remesh` raise
`NotImplementedError` naming that item."""

from .fault import (InjectedFailure, StragglerReport, StragglerWatchdog,
                    elastic_remesh, run_with_recovery)

__all__ = ["InjectedFailure", "StragglerReport", "StragglerWatchdog",
           "elastic_remesh", "run_with_recovery"]
