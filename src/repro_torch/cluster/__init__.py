"""repro_torch.cluster — scale the paper's architecture out over a device
mesh.

The paper's machine is a fleet of predictable worker cores fed by one
management core through a static schedule. This package is the
torch-native analogue at two levels:

  * **mesh execution** (`repro_torch.cluster.mesh`, backend "mesh") — the
    compiled per-core instruction streams of ONE network are partitioned
    along the mesh's model axis (`core.compiled.partition_streams`) and
    executed over `torch.distributed`, one process per rank: each rank
    computes the tiles of a contiguous block of the paper's cores (K6, one
    launch per op), and an int32 all-reduce over the model group plays
    the role of the shared-memory writeback, bit-exact vs the
    single-device torch backend.
  * **replica fleet** (`ClusterServer` + `Router`) — N data-parallel
    `serve.Server` replicas of the same bundle behind a WCET-aware
    admission router: the management core's dispatch role, lifted across
    replicas. Telemetry merges via `DeadlineMonitor.merge`; the
    every-ticket-terminal invariant holds cluster-wide.

See docs/cluster.md for the full mapping onto the paper (written for the
JAX package; the mapping is the same).
"""

from .fleet import ClusterError, ClusterServer, ClusterTicket
from .mesh import mesh_axes, mesh_batched_runner, mesh_single_runner
from .router import NoReplicaError, Router

__all__ = [
    "ClusterError",
    "ClusterServer",
    "ClusterTicket",
    "NoReplicaError",
    "Router",
    "mesh_axes",
    "mesh_batched_runner",
    "mesh_single_runner",
]
