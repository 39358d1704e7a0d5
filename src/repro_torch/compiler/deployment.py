"""Deployment: the generate-once / deploy-many artifact of the compiler.

The paper's unit of deployment is the bundle its compiler emits — per-core
programs, the static DMA schedule, and the WCET bound for one machine.
`Deployment` is that bundle as a first-class object:

  * `run(inputs)`      — execute through any registered backend, on the
    deployment's torch device ("cuda" unless the caller asked for "cpu");
  * `save(path)`       — serialize the whole artifact (zip: JSON manifest
    + pickled payload) for ahead-of-time compilation;
  * `Deployment.load(path)` — reload and validate: the manifest's graph
    signature and machine fingerprint are re-derived from the embedded
    objects and (optionally) checked against the machine/graph the caller
    intends to deploy on — a stale or foreign artifact refuses to load
    instead of silently producing bounds for the wrong machine.

Artifact format (version 1): a ZIP archive with
    manifest.json   format version, graph name + signature, machine name +
                    fingerprint, backend, WCET bound, core count, and the
                    sha256 of payload.pkl (checked before unpickling)
    payload.pkl     pickled {program, schedule, report, machine, stages,
                    artifacts} — the CompiledProgram drops its device
                    caches on pickling and rebuilds them lazily after load;
                    the device is not part of the artifact.

The payload is a pickle: the sha256 check catches corruption and
accidental tampering *before* any byte is deserialized, but pickle
fundamentally executes code on load, so — like torch checkpoints — only
load artifacts you produced or trust.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import re
import zipfile

from ..core.compiled import (CompiledProgram, graph_signature,
                             resolve_device)
from ..core.graph import Graph
from ..core.schedule import StaticSchedule
from ..core.taskset import CompiledTaskset
from ..core.wcet import TasksetReport, WCETReport
from ..hw import HardwareModel
from .backends import BackendOptions, get_backend
from .pipeline import StageRecord

ARTIFACT_FORMAT = 1


class ArtifactError(ValueError):
    """A saved deployment failed validation (stale, foreign, or corrupt)."""


@dataclasses.dataclass
class Deployment:
    """One compiled network, ready to run, save, or inspect."""

    program: CompiledProgram
    schedule: StaticSchedule
    report: WCETReport
    machine: HardwareModel
    backend: str = "torch"
    options: BackendOptions = dataclasses.field(
        default_factory=BackendOptions)
    stages: list[StageRecord] = dataclasses.field(default_factory=list)
    artifacts: dict = dataclasses.field(default_factory=dict)
    # analyzer waivers ("RULE" / "RULE@scope"); persisted with the
    # artifact so save/load gate against the same set the compile did
    suppressions: tuple = ()
    # where runners execute; chosen by the caller, never persisted
    device: str = "cuda"
    _runners: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    # -- identity ------------------------------------------------------------
    @property
    def graph(self) -> Graph:
        return self.program.graph

    @property
    def graph_signature(self) -> str:
        return self.program.signature

    @property
    def machine_fingerprint(self) -> str:
        return self.machine.fingerprint()

    @property
    def wcet_bound_s(self) -> float:
        return self.report.wcet_total_s

    # -- execution -----------------------------------------------------------
    def runner(self, *, batched: bool = False, backend: str | None = None,
               device: str | None = None):
        """The raw runner callable ({name: array} -> {name: array}) for hot
        loops; built once per (backend, batched, options, device) and
        cached. `backend` and `device` default to the deployment's."""
        name = backend or self.backend
        dev = str(device or self.device)
        key = (name, bool(batched), self.options.cache_key(), dev)
        if key not in self._runners:
            be = get_backend(name)
            be.validate_options(self.options, dev)
            be.validate_machine(self.machine)
            make = be.batched if batched else be.single
            self._runners[key] = make(self.program, self.options, dev)
        return self._runners[key]

    def run(self, inputs, *, batched: bool = False,
            backend: str | None = None, device: str | None = None) -> dict:
        """Execute the deployment. `inputs` is {input_name: array} or a
        bare array for single-input graphs; returns {output_name: array}.
        `backend` and `device` override the deployment's for this call."""
        if not isinstance(inputs, dict):
            (name,) = self.graph.inputs
            inputs = {name: inputs}
        return self.runner(batched=batched, backend=backend,
                           device=device)(inputs)

    def with_backend(self, name: str,
                     options: BackendOptions | None = None) -> "Deployment":
        """A view of the same compiled artifact on another backend (shares
        the program, so device caches are shared too).

        Validated at swap time, not on first `run`: the target backend must
        exist in the registry AND support the deployment's options (its
        `BackendCapabilities`) — an invalid swap raises `BackendError`
        here, before the view is ever handed to a serving loop."""
        be = get_backend(name)                  # fail fast if unknown
        opts = self.options if options is None else options
        be.validate_options(opts, self.device)  # capability check at swap
        be.validate_machine(self.machine)       # mesh pairing check too
        return dataclasses.replace(self, backend=name, options=opts)

    # -- reporting -----------------------------------------------------------
    def summary(self) -> str:
        lines = [f"Deployment[{self.graph.name} @ {self.machine.name} "
                 f"x{self.program.num_cores}, backend={self.backend}, "
                 f"device={self.device}, "
                 f"sig={self.graph_signature}, "
                 f"machine={self.machine_fingerprint}]",
                 self.report.summary()]
        if self.stages:
            lines.append("compile stages:")
            lines += ["  " + s.row() for s in self.stages]
        return "\n".join(lines)

    # -- serialization -------------------------------------------------------
    def _manifest(self) -> dict:
        return {
            "format": ARTIFACT_FORMAT,
            "graph": self.graph.name,
            "graph_signature": self.graph_signature,
            "machine": self.machine.name,
            "machine_fingerprint": self.machine_fingerprint,
            "backend": self.backend,
            "backend_options": self.options.to_manifest(),
            "num_cores": self.program.num_cores,
            "wcet_total_s": self.report.wcet_total_s,
        }

    def save(self, path: str, *, force: bool = False) -> str:
        """Write the artifact (ZIP manifest + payload). Returns `path`.

        The schedule sanitizer runs first: an artifact carrying an
        unsuppressed error-severity diagnostic is refused (the paper's
        predictability claims don't survive a corrupt schedule reaching
        disk). `force=True` skips the gate — for operators triaging a
        bad artifact, and for tests that need to persist corruptions.
        """
        if not force:
            from ..analysis import analyze_deployment
            analysis = analyze_deployment(self)
            if not analysis.ok:
                raise ArtifactError(
                    f"{path}: refusing to persist a deployment with "
                    f"unsuppressed error diagnostics "
                    f"(save(force=True) overrides):\n{analysis.summary()}")
        payload = {
            "program": self.program, "schedule": self.schedule,
            "report": self.report, "machine": self.machine,
            "backend": self.backend,
            "backend_options": self.options.to_manifest(),
            "stages": self.stages,
            "artifacts": self.artifacts,
            "suppressions": tuple(self.suppressions),
        }
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        manifest = {**self._manifest(),
                    "payload_sha256": hashlib.sha256(blob).hexdigest()}
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("manifest.json", json.dumps(manifest, indent=2))
            z.writestr("payload.pkl", blob)
        return path

    @classmethod
    def load(cls, path: str, *, machine: HardwareModel | None = None,
             graph: Graph | None = None,
             verify: bool = True, device: str = "cuda") -> "Deployment":
        """Reload a saved deployment, refusing stale artifacts.

        The payload's sha256 is checked against the manifest BEFORE
        unpickling (corruption never reaches the deserializer); the graph
        signature and machine fingerprint are then re-derived from the
        embedded payload and checked against the manifest (detects
        signature drift across code versions). If `machine` / `graph` are
        given, the artifact must additionally match them — the
        ahead-of-time contract: an artifact compiled for machine A never
        silently deploys on machine B. The payload is still a pickle, so
        only load artifacts from trusted sources (see module docstring).

        With `verify` (the default) the schedule sanitizer then re-checks
        the artifact's invariants — a hand-edited or force-saved artifact
        with unsuppressed errors refuses to deploy; `verify=False` loads
        it anyway (how a linter opens artifacts it is diagnosing).

        `device` is where the loaded deployment runs ("cuda" by default; it
        is validated by `repro_torch.core.resolve_device`).
        """
        device = str(resolve_device(device))
        try:
            with zipfile.ZipFile(path) as z:
                manifest = json.loads(z.read("manifest.json"))
                if manifest.get("format") != ARTIFACT_FORMAT:
                    raise ArtifactError(
                        f"{path}: unsupported artifact format "
                        f"{manifest.get('format')!r} "
                        f"(expected {ARTIFACT_FORMAT})")
                blob = z.read("payload.pkl")
                digest = hashlib.sha256(blob).hexdigest()
                if digest != manifest.get("payload_sha256"):
                    raise ArtifactError(
                        f"{path}: payload hash mismatch (manifest "
                        f"{manifest.get('payload_sha256')!r}, payload "
                        f"hashes to {digest}) — corrupt artifact")
                payload = pickle.loads(blob)
            dep = cls(program=payload["program"],
                      schedule=payload["schedule"],
                      report=payload["report"], machine=payload["machine"],
                      backend=payload["backend"],
                      options=BackendOptions.from_manifest(
                          payload.get("backend_options")),
                      stages=payload["stages"],
                      artifacts=payload.get("artifacts", {}),
                      suppressions=tuple(payload.get("suppressions", ())),
                      device=device)
            manifest_sig = manifest["graph_signature"]
            manifest_fp = manifest["machine_fingerprint"]
        except (zipfile.BadZipFile, KeyError, pickle.UnpicklingError,
                TypeError,                   # payload not a dict
                EOFError,                    # truncated payload
                AttributeError, ModuleNotFoundError, ImportError,
                json.JSONDecodeError) as e:  # class moved / stale pickle
            raise ArtifactError(f"{path}: not a deployment artifact "
                                f"({e})") from e
        sig = graph_signature(dep.program.graph)
        if sig != manifest_sig:
            raise ArtifactError(
                f"{path}: graph signature mismatch (artifact "
                f"{manifest_sig}, embedded graph hashes to "
                f"{sig}) — stale artifact, recompile")
        fp = dep.machine.fingerprint()
        if fp != manifest_fp:
            raise ArtifactError(
                f"{path}: machine fingerprint mismatch (artifact "
                f"{manifest_fp}, embedded machine "
                f"hashes to {fp}) — stale artifact, recompile")
        if machine is not None and machine.fingerprint() != fp:
            raise ArtifactError(
                f"{path}: compiled for {manifest.get('machine')} ({fp}), "
                f"refusing to deploy on {machine.name} "
                f"({machine.fingerprint()})")
        if graph is not None and graph_signature(graph) != sig:
            raise ArtifactError(
                f"{path}: compiled for graph {manifest.get('graph')} "
                f"({sig}), refusing to deploy graph {graph.name} "
                f"({graph_signature(graph)})")
        if verify:
            from ..analysis import analyze_deployment
            analysis = analyze_deployment(dep)
            if not analysis.ok:
                raise ArtifactError(
                    f"{path}: artifact fails the schedule sanitizer "
                    f"(load(verify=False) to inspect it anyway):\n"
                    f"{analysis.summary()}")
        return dep


# -- multi-network bundles ----------------------------------------------------
#
# A *bundle* composes several single-network artifacts (each a full
# `Deployment.save` ZIP, individually validated on load) into one on-disk
# directory, plus a manifest and optional side payloads — the unit a whole
# serving configuration (`repro_torch.serve.Server.save`) is shipped as.

BUNDLE_FORMAT = 1
BUNDLE_MANIFEST = "bundle.json"
BUNDLE_OBJECTS = "objects.pkl"


def _member_filename(index: int, name: str) -> str:
    """Stable, filesystem-safe member file name (manifest maps it back)."""
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", name) or "net"
    return f"{index:02d}_{safe}.rtdep"


def save_bundle(dirpath: str, deployments: dict[str, Deployment], *,
                extra: dict | None = None, objects: object = None) -> str:
    """Write a multi-network bundle directory. Returns `dirpath`.

    Layout: `bundle.json` (manifest: format, member table with per-artifact
    signatures/fingerprints, shared machine fingerprint, caller `extra`
    JSON) + one `<nn>_<name>.rtdep` per deployment + optionally
    `objects.pkl` (pickled caller payload, sha256-pinned in the manifest —
    same trust model as the per-deployment payloads)."""
    fps = {d.machine_fingerprint for d in deployments.values()}
    if len(fps) > 1:
        raise ArtifactError(
            f"bundle members compiled for different machines: {sorted(fps)}")
    os.makedirs(dirpath, exist_ok=True)
    members = {}
    for i, (name, dep) in enumerate(sorted(deployments.items())):
        fname = _member_filename(i, name)
        dep.save(os.path.join(dirpath, fname))
        members[name] = {"file": fname,
                         "graph_signature": dep.graph_signature,
                         "machine_fingerprint": dep.machine_fingerprint,
                         "backend": dep.backend,
                         "backend_options": dep.options.to_manifest(),
                         "wcet_total_s": dep.wcet_bound_s}
    manifest = {"format": BUNDLE_FORMAT, "members": members,
                "machine_fingerprint": next(iter(fps), None),
                "extra": extra or {}}
    if objects is not None:
        blob = pickle.dumps(objects, protocol=pickle.HIGHEST_PROTOCOL)
        manifest["objects_sha256"] = hashlib.sha256(blob).hexdigest()
        with open(os.path.join(dirpath, BUNDLE_OBJECTS), "wb") as f:
            f.write(blob)
    with open(os.path.join(dirpath, BUNDLE_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return dirpath


def load_bundle(dirpath: str, *, machine: HardwareModel | None = None,
                verify: bool = True, device: str = "cuda"
                ) -> tuple[dict[str, Deployment], dict, object]:
    """Reload a bundle -> (deployments, extra, objects).

    Every member goes through `Deployment.load` (full signature/fingerprint
    validation, optionally against `machine`, plus — with `verify`, the
    default — the schedule sanitizer); the side payload's sha256 is
    checked against the manifest before unpickling. Raises `ArtifactError`
    on any stale, foreign, or corrupt piece."""
    mpath = os.path.join(dirpath, BUNDLE_MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ArtifactError(f"{dirpath}: not a bundle ({e})") from e
    if manifest.get("format") != BUNDLE_FORMAT:
        raise ArtifactError(f"{dirpath}: unsupported bundle format "
                            f"{manifest.get('format')!r} "
                            f"(expected {BUNDLE_FORMAT})")
    deployments = {}
    for name, m in manifest.get("members", {}).items():
        dep = Deployment.load(os.path.join(dirpath, m["file"]),
                              machine=machine, verify=verify, device=device)
        if dep.graph_signature != m.get("graph_signature"):
            raise ArtifactError(
                f"{dirpath}: member {name!r} signature drifted from the "
                f"bundle manifest — stale bundle, re-save")
        deployments[name] = dep
    fps = {d.machine_fingerprint for d in deployments.values()}
    if len(fps) > 1 or (fps and manifest.get("machine_fingerprint")
                        not in fps):
        raise ArtifactError(
            f"{dirpath}: member machine fingerprints disagree with the "
            f"manifest ({sorted(fps)} vs "
            f"{manifest.get('machine_fingerprint')!r})")
    objects = None
    opath = os.path.join(dirpath, BUNDLE_OBJECTS)
    if manifest.get("objects_sha256") is not None:
        try:
            with open(opath, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise ArtifactError(f"{dirpath}: missing {BUNDLE_OBJECTS} "
                                f"({e})") from e
        digest = hashlib.sha256(blob).hexdigest()
        if digest != manifest["objects_sha256"]:
            raise ArtifactError(
                f"{dirpath}: {BUNDLE_OBJECTS} hash mismatch (manifest "
                f"{manifest['objects_sha256']!r}, payload hashes to "
                f"{digest}) — corrupt bundle")
        try:
            objects = pickle.loads(blob)
        except (pickle.UnpicklingError, EOFError, AttributeError,
                ModuleNotFoundError, ImportError) as e:
            raise ArtifactError(f"{dirpath}: undecodable {BUNDLE_OBJECTS} "
                                f"({e})") from e
    return deployments, manifest.get("extra", {}), objects


@dataclasses.dataclass
class TasksetDeployment:
    """A compiled multi-network taskset: the hyperperiod analysis plus one
    executable `Deployment` per network with a compiled lowering (networks
    with analysis-only op kinds — LM decode graphs — are analyzed in the
    schedulability report but get no executable deployment)."""

    report: TasksetReport
    taskset: CompiledTaskset
    deployments: dict[str, Deployment]
    machine: HardwareModel
    backend: str = "torch"
    options: BackendOptions = dataclasses.field(
        default_factory=BackendOptions)
    suppressions: tuple = ()
    analysis: object = None              # AnalysisReport when verified

    @property
    def schedulable(self) -> bool:
        return self.report.schedulable

    @property
    def hyperperiod_s(self) -> float:
        return self.taskset.hyperperiod_s

    @property
    def machine_fingerprint(self) -> str:
        return self.machine.fingerprint()

    def run(self, network: str, inputs, **kw) -> dict:
        """Run one sample through a member network's deployment."""
        try:
            dep = self.deployments[network]
        except KeyError:
            raise KeyError(
                f"network {network!r} has no executable deployment "
                f"(available: {sorted(self.deployments)})") from None
        return dep.run(inputs, **kw)

    def summary(self) -> str:
        lines = [self.report.summary()]
        if self.deployments:
            lines.append("executable deployments: "
                         + ", ".join(sorted(self.deployments)))
        return "\n".join(lines)
