"""repro_torch.compiler — the paper's compiler as a staged, pluggable
pipeline.

Public surface:

  * `compile(graph_or_taskset, machine, *, backend="torch", deadline=None,
    device="cuda")` -> `Deployment` / `TasksetDeployment` — the single
    entry point (also re-exported as `repro_torch.compile`);
  * `Deployment` — serializable (program, schedule, WCET bound, machine
    fingerprint) bundle with `run` / `save` / `load`;
  * the backend registry (`register_backend`, `get_backend`,
    `list_backends`) — numpy / torch / cuda built in, third-party
    backends pluggable by name;
  * the pass pipeline (`Pass`, `PassManager`, `PassContext`,
    `default_passes`) for custom compile flows and per-stage inspection.
"""

from .api import clear_deployment_cache, compile                # noqa: A004
from .backends import (Backend, BackendCapabilities, BackendError,
                       BackendOptions, get_backend, list_backends,
                       register_backend, unregister_backend)
from .deployment import (ARTIFACT_FORMAT, BUNDLE_FORMAT, ArtifactError,
                         Deployment, TasksetDeployment, load_bundle,
                         save_bundle)
from .pipeline import (DeadlineError, LowerPass, MapPass, PartitionPass,
                       Pass, PassContext, PassManager, PipelineError,
                       QuantizePass, SchedulePass, StageRecord,
                       VerificationError, VerifyPass, WCETPass,
                       default_passes)

__all__ = [
    "compile", "clear_deployment_cache",
    "Deployment", "TasksetDeployment", "ArtifactError", "ARTIFACT_FORMAT",
    "save_bundle", "load_bundle", "BUNDLE_FORMAT",
    "Backend", "BackendCapabilities", "BackendOptions", "BackendError",
    "register_backend", "unregister_backend",
    "get_backend", "list_backends",
    "Pass", "PassManager", "PassContext", "StageRecord", "default_passes",
    "QuantizePass", "PartitionPass", "MapPass", "SchedulePass", "WCETPass",
    "LowerPass", "VerifyPass", "PipelineError", "DeadlineError",
    "VerificationError",
]
