"""ClusterServer: N data-parallel `serve.Server` replicas behind the
WCET-aware `Router`.

Every replica serves the same taskset on the same machine (the paper's
fleet story scaled one level up: N copies of the whole 16-core machine,
each with its own management core, behind one admission front door).
Replicas keep their own `DeadlineMonitor`s, queues, breakers and overload
state — a fault on one replica degrades that replica only — and the
cluster view is derived, never stored: routing reads live
`network_status` dicts; telemetry merges the per-replica monitors with
`DeadlineMonitor.merge`.

Invariants preserved cluster-wide:

  * **every ticket is terminal** — `submit` always lands a request on a
    replica that will resolve it ("done", "dropped", "degraded" or
    "failed"), or raises `NoReplicaError` without creating a ticket;
  * **determinism** — same submissions + same replica states → same
    routing (`Router`'s tie-break is by replica index), so cluster runs
    replay exactly;
  * **artifact discipline** — `save`/`load` round-trip one replica bundle
    plus a cluster manifest carrying the machine fingerprint and replica
    count; a mismatched machine (including a wrong mesh shape — the
    fingerprint folds `mesh_shape` in) refuses to load.
"""

from __future__ import annotations

import json
import os
from typing import Callable

from ..hw import HardwareModel
from ..serve.monitor import DeadlineMonitor
from ..serve.runtime import Server, Ticket
from .router import Router

CLUSTER_MANIFEST = "cluster.json"
REPLICA_BUNDLE = "replica.bundle"
CLUSTER_FORMAT = 1


class ClusterError(RuntimeError):
    """Replica divergence or a malformed cluster artifact."""


class ClusterTicket:
    """A `Ticket` plus the replica index the router placed it on."""

    __slots__ = ("replica", "ticket")

    def __init__(self, replica: int, ticket: Ticket):
        self.replica = replica
        self.ticket = ticket

    @property
    def tid(self) -> int:
        return self.ticket.tid

    @property
    def network(self) -> str:
        return self.ticket.network

    @property
    def status(self) -> str:
        return self.ticket.status

    @property
    def done(self) -> bool:
        return self.ticket.done

    @property
    def terminal(self) -> bool:
        return self.ticket.terminal

    def result(self):
        return self.ticket.result()

    def __repr__(self) -> str:
        return (f"ClusterTicket(replica={self.replica}, "
                f"tid={self.tid}, network={self.network!r}, "
                f"status={self.status!r})")


class ClusterServer:
    """N identical `Server` replicas + router-fronted admission.

    Constructor arguments mirror `Server` (they are forwarded verbatim to
    every replica); `replicas` sets the fleet size. Registration and
    lifecycle calls fan out to all replicas so they stay structurally
    identical; per-replica *state* (queues, sheds, breakers, calibration)
    is free to diverge — that is what the router balances over.
    """

    def __init__(self, machine: HardwareModel, *, replicas: int = 2,
                 **server_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.machine = machine
        self.servers = [Server(machine, **server_kwargs)
                        for _ in range(replicas)]
        self.router = Router()
        self.dispatched = [0] * replicas     # router placements per replica

    @property
    def replicas(self) -> int:
        return len(self.servers)

    @property
    def networks(self) -> list[str]:
        return self.servers[0].networks

    # -- registration (fans out; replicas stay structurally identical) -------
    def register(self, name: str, net, period_s: float,
                 deadline_s: float | None = None, **kw) -> None:
        """Admission-checked registration on every replica.

        Replica 0 registers first: an admission failure there propagates
        cleanly before any other replica changed. A failure on a *later*
        replica (impossible for identical replicas, short of a bug) is
        escalated to `ClusterError` — the fleet would be divergent."""
        self.servers[0].register(name, net, period_s, deadline_s, **kw)
        for idx, srv in enumerate(self.servers[1:], start=1):
            try:
                srv.register(name, net, period_s, deadline_s, **kw)
            except Exception as e:
                raise ClusterError(
                    f"replica {idx} diverged from replica 0 registering "
                    f"{name!r}: {e}") from e

    def attach(self, name: str, step_fn: Callable) -> None:
        for srv in self.servers:
            srv.attach(name, step_fn)

    def analyze(self):
        """The fleet's admission report (identical on every replica; the
        first replica's is returned)."""
        return self.servers[0].analyze()

    # -- admission ------------------------------------------------------------
    def network_statuses(self, name: str) -> list[dict]:
        return [srv.network_status(name) for srv in self.servers]

    def submit(self, name: str, payload,
               deadline_s: float | None = None) -> ClusterTicket:
        """Route one request to the best replica (WCET headroom, then
        queue depth, then replica index) and submit it there. Raises
        `NoReplicaError` when every replica is saturated — no ticket is
        created in that case."""
        idx = self.router.pick(name, self.network_statuses(name))
        t = self.servers[idx].submit(name, payload, deadline_s)
        self.dispatched[idx] += 1
        return ClusterTicket(idx, t)

    def routing(self, name: str) -> list[dict]:
        """The router's current ranking for `name` (telemetry)."""
        return self.router.explain(name, self.network_statuses(name))

    # -- execution ------------------------------------------------------------
    def step(self) -> list:
        """One hyperperiod job on every replica (replica order). Replicas
        advance in lockstep through the same static program; their queues
        differ, so the jobs serve different tickets."""
        return [srv.step() for srv in self.servers]

    def run(self, hyperperiods: int = 1) -> dict:
        """`hyperperiods` full hyperperiods on every replica, then the
        merged telemetry snapshot."""
        for srv in self.servers:
            srv.run(hyperperiods=hyperperiods)
        return self.telemetry()

    # -- lifecycle fan-out -----------------------------------------------------
    def shed(self, name: str) -> None:
        for srv in self.servers:
            srv.shed(name)

    def restore(self, name: str | None = None) -> None:
        for srv in self.servers:
            srv.restore(name)

    def switch_mode(self, mode) -> None:
        """Stage `mode` on every replica (each applies it at its own next
        hyperperiod boundary). While staged, the router treats networks
        the new mode drops as departing and routes around them."""
        for srv in self.servers:
            srv.switch_mode(mode)

    def enable_resilience(self, **kw) -> None:
        for srv in self.servers:
            srv.enable_resilience(**kw)

    # -- telemetry -------------------------------------------------------------
    def telemetry(self) -> dict:
        """Fleet-wide snapshot: per-replica monitors merged into one
        (`DeadlineMonitor.merge`), metrics summed, plus per-replica rows
        and the router's placement counts."""
        merged = DeadlineMonitor(
            slack_factor=self.servers[0].monitor.slack_factor)
        for srv in self.servers:
            merged.merge(srv.monitor)
        metrics: dict[str, int] = {}
        for srv in self.servers:
            for k, v in srv.metrics.items():
                metrics[k] = metrics.get(k, 0) + v
        return {
            **merged.snapshot(),
            "replicas": self.replicas,
            "metrics": metrics,
            "dispatched": list(self.dispatched),
            "per_replica": [
                {"queue_depths": srv.queue_depths(),
                 "shed": srv.shed_networks,
                 "mode": srv.mode_name,
                 "hyperperiods_completed": srv.hyperperiods_completed,
                 "metrics": dict(srv.metrics)}
                for srv in self.servers],
        }

    def summary(self) -> str:
        t = self.telemetry()
        lines = [f"ClusterServer[{self.replicas} replicas @ "
                 f"{self.machine.name}, dispatched={t['dispatched']}]"]
        merged = DeadlineMonitor(
            slack_factor=self.servers[0].monitor.slack_factor)
        for srv in self.servers:
            merged.merge(srv.monitor)
        lines.append(merged.summary())
        return "\n".join(lines)

    # -- artifacts -------------------------------------------------------------
    def save(self, dirpath: str) -> str:
        """Persist as one replica bundle + a cluster manifest.

        Replicas are identical by construction, so one bundle suffices;
        the manifest pins the replica count, backend, and the machine
        fingerprint (which includes the mesh shape) for load-time
        verification."""
        os.makedirs(dirpath, exist_ok=True)
        self.servers[0].save(os.path.join(dirpath, REPLICA_BUNDLE))
        manifest = {
            "format": CLUSTER_FORMAT,
            "kind": "cluster",
            "replicas": self.replicas,
            "backend": self.servers[0].backend,
            "machine_fingerprint": self.machine.fingerprint(),
            "machine_name": self.machine.name,
            "router": {"policy": "wcet-headroom",
                       "tie_break": "replica-index"},
        }
        with open(os.path.join(dirpath, CLUSTER_MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        return dirpath

    @classmethod
    def load(cls, dirpath: str, *, machine: HardwareModel | None = None,
             replicas: int | None = None,
             step_fns: dict[str, Callable] | None = None,
             device: str = "cuda") -> "ClusterServer":
        """Rebuild the fleet from `save`'s layout.

        Each replica loads the same bundle through `Server.load`, which
        verifies every member artifact's machine fingerprint — a machine
        compiled for a different mesh shape fingerprints differently and
        is refused (`ArtifactError`). `replicas` overrides the saved
        fleet size (scaling a saved cluster up/down is explicit).
        `device` is where every replica runs, as in `Server.load`."""
        manifest_path = os.path.join(dirpath, CLUSTER_MANIFEST)
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise ClusterError(
                f"{dirpath}: not a cluster artifact "
                f"({CLUSTER_MANIFEST}: {e})") from e
        if manifest.get("kind") != "cluster":
            raise ClusterError(
                f"{dirpath}: manifest kind "
                f"{manifest.get('kind')!r} != 'cluster'")
        if machine is not None:
            want = manifest.get("machine_fingerprint")
            if want and machine.fingerprint() != want:
                from ..compiler import ArtifactError
                raise ArtifactError(
                    f"{dirpath}: cluster artifact was saved for machine "
                    f"{manifest.get('machine_name')} ({want}), refusing "
                    f"{machine.name} ({machine.fingerprint()})")
        n = replicas if replicas is not None else int(
            manifest.get("replicas", 1))
        if n < 1:
            raise ClusterError(f"{dirpath}: replica count {n} < 1")
        bundle = os.path.join(dirpath, REPLICA_BUNDLE)
        servers = [Server.load(bundle, machine=machine, step_fns=step_fns,
                               device=device)
                   for _ in range(n)]
        obj = cls.__new__(cls)
        obj.machine = servers[0].machine
        obj.servers = servers
        obj.router = Router()
        obj.dispatched = [0] * n
        return obj
