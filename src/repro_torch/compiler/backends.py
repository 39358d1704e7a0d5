"""Backend registry: capability-aware execution strategies over a
CompiledProgram.

One lowered program, many ways to replay it. Each backend is registered by
name and provides two factories — `single` (one sample) and `batched`
(leading batch axis) — that take a `CompiledProgram`, a `BackendOptions`
and a torch device and return a runner with the uniform serving contract:

    runner({input_name: np.ndarray, ...}) -> {output_name: np.ndarray, ...}

numpy in, numpy out, graph outputs only, blocking until the result is
ready. `Deployment.run` / `BatchedInferenceEngine` / the executor benchmark
all go through this table, so a third-party backend (a new kernel library,
a remote accelerator client) plugs in with one `register_backend` call and
is immediately selectable as `repro_torch.compile(..., backend="mine")`.

Every backend carries a `BackendCapabilities` descriptor so callers can
validate a (backend, options) pair *before* building a runner —
`Deployment.with_backend` checks at swap time, `repro_torch.compile` at compile
time — instead of failing on the first `run`. Execution knobs travel as a
typed, frozen `BackendOptions` (accepted as
``repro_torch.compile(..., backend_options=...)``, carried through
`Deployment` save/load and `Server`).

The device (``"cuda"`` by default, ``"cpu"`` on request) is not an option:
it is where a deployment runs, chosen by the caller at compile, load or
runner time, and never persisted.

Built-in backends (see repro_torch/core/compiled.py for their numerics):

  * ``numpy`` — vectorized fused-tile replay on the host; bit-exact oracle
    twin (it ignores the device).
  * ``torch`` — the whole program as one torch function over a natively
    batched leading axis; plain torch, no hand-written kernel.
  * ``cuda``  — the fused per-core megakernel over the hand-written CUDA
    kernels (`repro_torch.core.megakernel`): <= num_cores launches per
    program, requant fused in epilogues, scratchpad-budgeted segments.
    ``megakernel=False`` in the options selects the per-op kernel path. On
    a CUDA device the runner replays the program as a CUDA graph
    (`GraphedRunner`): an input signature's first call runs eagerly, its
    second captures the program and every later one replays it, each
    graph holding about one job's activations until the runner goes. A
    `Server` makes those two calls when it builds the runner, at its slot
    count (`prime`), so the jobs it serves are all replays. On
    a CPU device every kernel wrapper takes its plain version, and
    nothing is captured.
  * ``mesh``  — the program sharded over a `torch.distributed` mesh
    (`repro_torch.cluster.mesh`): each rank runs its core block's tiles on
    K6 and all-reduces them; needs a machine with a mesh shape.

Factories take ``(prog, options, device)``; a factory with only
``(prog, options)`` runs on whatever device its own code picks, and the
legacy single-argument ``factory(prog)`` is wrapped with a shim that emits
a `DeprecationWarning` at registration.
"""

from __future__ import annotations

import dataclasses
import inspect
import sys
import warnings
from typing import Callable

import numpy as np
import torch

from .. import trace
from ..core import compiled as _C
from ..core import megakernel as _MK
from ..kernels import _lib

Runner = Callable[[dict], dict]


class BackendError(KeyError):
    """Unknown backend, conflicting registration, or an option the target
    backend does not support."""


@dataclasses.dataclass(frozen=True)
class BackendOptions:
    """Typed execution knobs, validated against a backend's capabilities.

    All fields default to None ("backend decides"), so a default instance
    is valid for every backend. Fields:

      megakernel         — fused per-core megakernel on/off (None: on for
                           the cuda backend).
      scratchpad_budget  — bytes; overrides the machine scratchpad capacity
                           the megakernel planner and kernel tile
                           derivation use (the tile-override knob).
      max_kernels        — cap on kernel launches per program
                           (None: the program's core count).

    The JAX package's Pallas-only `interpret` knob does not exist here;
    `from_manifest` ignores it, like any unknown key of an artifact.
    """

    megakernel: bool | None = None
    scratchpad_budget: int | None = None
    max_kernels: int | None = None

    def set_fields(self) -> tuple[str, ...]:
        """Names of explicitly-set (non-None) fields — what capability
        validation checks against `supported_options`."""
        return tuple(f.name for f in dataclasses.fields(self)
                     if getattr(self, f.name) is not None)

    def cache_key(self) -> tuple:
        """Hashable identity for runner/deployment caches."""
        return tuple((f.name, getattr(self, f.name))
                     for f in dataclasses.fields(self))

    def to_manifest(self) -> dict:
        """JSON-safe dict of the set fields (deployment artifacts)."""
        return {name: getattr(self, name) for name in self.set_fields()}

    @classmethod
    def from_manifest(cls, d: dict | None) -> "BackendOptions":
        """Lenient inverse of `to_manifest`: unknown keys (newer artifacts)
        are ignored, absent ones default."""
        d = d or {}
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a backend can do — checked before runners are built.

    supports_batched_native — the batched factory is a real batched
        lowering, not the per-sample fallback loop.
    supports_decode — usable for LM decode step functions (serving loops).
    requires_device — the torch device type its kernels launch on (e.g.
        "cuda"); asking for that device without one present fails
        validation. On a CPU device the backend runs its kernels' plain
        versions.
    supported_options — `BackendOptions` field names this backend honors;
        explicitly-set fields outside this set fail validation.
    mesh — executes across a device mesh: requires (and is required
        by) a machine whose `HardwareModel.mesh_shape` is set —
        `repro_torch.compile` enforces the pairing both ways.
    """

    supports_batched_native: bool = False
    supports_decode: bool = False
    requires_device: str | None = None
    supported_options: frozenset = frozenset()
    mesh: bool = False


@dataclasses.dataclass(frozen=True)
class Backend:
    """A named pair of options-aware runner factories + capabilities."""

    name: str
    single: Callable[..., Runner]
    batched: Callable[..., Runner]
    capabilities: BackendCapabilities = BackendCapabilities()

    def validate_options(self, options: BackendOptions,
                         device=None) -> None:
        """Raise `BackendError` if `options` sets a knob this backend does
        not support, or if `device` is the backend's required device type
        and torch sees no such device. A default (all-None) options object
        always validates."""
        unsupported = [f for f in options.set_fields()
                       if f not in self.capabilities.supported_options]
        if unsupported:
            raise BackendError(
                f"backend {self.name!r} does not support option(s) "
                f"{unsupported}; supported: "
                f"{sorted(self.capabilities.supported_options)}")
        dev = self.capabilities.requires_device
        if device is not None and dev == "cuda":
            if (torch.device(device).type == "cuda"
                    and not torch.cuda.is_available()):
                raise BackendError(
                    f"backend {self.name!r} on device {str(device)!r} "
                    f"requires a CUDA device, and torch sees none; pass "
                    f"device='cpu' to run the kernels' plain versions")

    def validate_machine(self, machine) -> None:
        """Raise `BackendError` when the backend/machine mesh pairing is
        inconsistent: a mesh backend needs a machine carrying a mesh shape
        (`HardwareModel.with_mesh`), and a single-device backend refuses a
        mesh machine. Enforced at compile time, per-call backend override,
        and `with_backend` swap — an invalid pairing never reaches a
        runner."""
        mesh_shape = getattr(machine, "mesh_shape", None)
        if self.capabilities.mesh and mesh_shape is None:
            raise BackendError(
                f"backend {self.name!r} executes across a device mesh but "
                f"machine {machine.name!r} has no mesh shape; target it "
                f"with machine.with_mesh(data, model)")
        if mesh_shape is not None and not self.capabilities.mesh:
            raise BackendError(
                f"machine {machine.name!r} targets mesh shape {mesh_shape} "
                f"but backend {self.name!r} is single-device; use "
                f'backend="mesh" (or a machine without a mesh shape)')


_REGISTRY: dict[str, Backend] = {}


def _adapt_factory(factory, name: str, which: str):
    """Accept the factory signatures (prog, options, device), (prog,
    options) and legacy (prog), and return one taking all three.

    Legacy single-argument factories are wrapped to drop the options and
    warned about once, at registration."""
    try:
        sig = inspect.signature(factory)
    except (TypeError, ValueError):
        return factory                       # builtins etc.: assume new
    params = list(sig.parameters.values())
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return factory
    positional = [p for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if len(positional) >= 3:
        return factory
    if len(positional) == 2:
        def two(prog, options, device):
            return factory(prog, options)
        return two
    warnings.warn(
        f"backend {name!r} {which} factory takes only (prog); factories "
        "should accept (prog, options: BackendOptions). The legacy "
        "signature is wrapped for now and will stop working in a future "
        "release.", DeprecationWarning, stacklevel=3)

    def adapted(prog, options, device):
        return factory(prog)
    return adapted


def register_backend(name: str, *,
                     single: Callable,
                     batched: Callable | None = None,
                     capabilities: BackendCapabilities | None = None,
                     overwrite: bool = False) -> Backend:
    """Register (or replace, with overwrite=True) an execution backend.

    `batched` defaults to a per-sample loop over `single` — correct for any
    backend, so plugins only need the single-sample runner. Factories take
    ``(prog, options, device)`` or ``(prog, options)``; the legacy
    ``(prog)`` signature still works via a deprecation shim."""
    if name in _REGISTRY and not overwrite:
        raise BackendError(
            f"backend {name!r} already registered; pass overwrite=True")
    single = _adapt_factory(single, name, "single")
    has_native_batched = batched is not None
    if batched is None:
        batched = _loop_batched(single)
    else:
        batched = _adapt_factory(batched, name, "batched")
    caps = capabilities or BackendCapabilities(
        supports_batched_native=has_native_batched)
    be = Backend(name=name, single=single, batched=batched,
                 capabilities=caps)
    _REGISTRY[name] = be
    return be


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise BackendError(
            f"unknown backend {name!r}; registered: {list_backends()}"
        ) from None


def list_backends() -> list[str]:
    return sorted(_REGISTRY)


def _loop_batched(single_factory):
    """Default batched factory: run `single` per sample and stack."""
    def factory(prog: _C.CompiledProgram,
                options: BackendOptions | None = None,
                device="cuda") -> Runner:
        single = single_factory(prog, options or BackendOptions(), device)

        def run(batch: dict) -> dict:
            B = next(iter(batch.values())).shape[0]
            outs = [single({k: v[b] for k, v in batch.items()})
                    for b in range(B)]
            return {t: np.stack([o[t] for o in outs])
                    for t in prog.graph.outputs}
        return run
    return factory


# -- built-in backends --------------------------------------------------------
# Builtin factories default `options` and `device` so the direct-invocation
# form (`get_backend("numpy").single(prog)`) keeps working alongside the
# registry's (prog, options, device) calls.

def _numpy_single(prog: _C.CompiledProgram,
                  options: BackendOptions | None = None,
                  device="cuda") -> Runner:
    def run(inputs: dict) -> dict:
        vals = _C.run_numpy(prog, inputs)      # exposes every buffer
        return {t: vals[t] for t in prog.graph.outputs}
    return run


def _numpy_io(fn, prog: _C.CompiledProgram, device, batched: bool) -> Runner:
    """numpy in/out around a batched torch program on `device` (a single
    sample gets a leading batch axis of 1), run eagerly on every call: the
    `torch` backend's runner, and the `cuda` backend's on a CPU device and
    for a signature's first call (`GraphedRunner`). Blocks until the
    result is on the host. Its three phases are the spans `runner.upload`,
    `runner.issue` (the program returns before the device finishes) and
    `runner.readback` (`repro_torch.trace`)."""
    def run(inputs: dict) -> dict:
        with trace.span("runner.upload"):
            x = _C.to_device(prog, inputs, device, batched)
        with trace.span("runner.issue"):
            out = fn(x)
        with trace.span("runner.readback"):
            return _C.to_numpy(out, batched)
    return run


def _torch_factory(batched: bool):
    def factory(prog: _C.CompiledProgram,
                options: BackendOptions | None = None,
                device="cuda") -> Runner:
        dev = _C.resolve_device(device)
        return _numpy_io(_C.torch_batched(prog, dev), prog, dev, batched)
    return factory


def _cuda_fn(prog: _C.CompiledProgram, options: BackendOptions, device):
    """The batched kernel program for `options`: megakernel by default,
    per-op kernels when megakernel=False."""
    if options.megakernel is False:
        return _C.kernel_batched(prog, device)
    return _MK.megakernel_batched(prog, device,
                                  budget=options.scratchpad_budget,
                                  max_kernels=options.max_kernels)


class HostOuts:
    """The host arrays a graph's outputs are read back into: page-locked
    on a CUDA device, so the copy runs at the link's rate rather than
    through the driver's staging into pageable memory, and reused.

    A set of arrays is reused only while nothing outside it refers to any
    of them: the arrays a read returns, and every numpy view of them (a
    ticket's answer is one), hold their set, so an answer the caller keeps
    is never overwritten. At most `SETS` sets are made: a caller that
    drops each answer before the next read needs one, and one more leaves
    room for an answer kept a while. When each is held,
    the read copies into new pageable arrays (`to_numpy`) as an eager
    call does. `reused`, `made` and `pageable` count the reads of each
    kind."""

    SETS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.sets: list[dict] = []       # name -> (host tensor, its array)
        self.free_refs = 0               # `_refs` of a set nobody holds
        self.reused = self.made = self.pageable = 0

    @staticmethod
    def _refs(s: dict) -> int:
        return max(sys.getrefcount(a) for _, a in s.values())

    def read(self, outs: dict, batched: bool) -> dict:
        s = next((s for s in self.sets if self._refs(s) <= self.free_refs),
                 None)
        if s is not None:
            self.reused += 1
        elif len(self.sets) < self.SETS:
            pin = self.device.type == "cuda"
            s = {}
            for k, v in outs.items():
                t = torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
                s[k] = (t, t.numpy())
            self.sets.append(s)
            self.free_refs = self._refs(s)
            self.made += 1
        else:
            self.pageable += 1
            return _C.to_numpy(outs, batched)
        for k, v in outs.items():
            s[k][0].copy_(v, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return {k: a if batched else a[0] for k, (_, a) in s.items()}


@dataclasses.dataclass
class _Graph:
    """One signature's captured program: the graph, its static input and
    output tensors, what one replay runs (launches and bytes by kernel,
    plain steps, and those by op kind), and the host arrays its outputs
    are read into."""

    graph: torch.cuda.CUDAGraph
    ins: dict
    outs: dict
    launches: dict
    bytes: dict
    plain: int
    kinds: dict
    host: HostOuts


class GraphedRunner:
    """The `cuda` backend's runner on a CUDA device: `_numpy_io` around
    the program `fn`, with each input signature's program captured once
    into a `torch.cuda.CUDAGraph` and replayed.

    A signature is every input's shape and dtype, leading batch axis
    included. Its first call runs `fn` eagerly (`_numpy_io`), which builds
    the kernels and fills the program's device cache and the split
    workspaces at that size. Its second call captures `fn` over static
    input tensors, on the side stream that `torch.cuda.graph` opens (span
    `runner.capture`; nothing runs), and replays the graph; so does every
    later call: the batch copied into the static inputs (`runner.upload`),
    one replay on the current stream (`runner.issue`), the static outputs
    read back (`runner.readback`: into the graph's `HostOuts`, page-locked
    and reused once the caller lets go of them; the read waits, so no
    replay overwrites an answer not yet on the host). A signature that never
    repeats is never captured. A capture that raises leaves its signature
    eager for the runner's life: one warning, one "capture_failures"
    count, no retry. `prime(batch)` makes the eager call and the capture
    at once, on zeros: a `Server` primes each runner at its slot count
    when it builds it, so its served jobs are all replays.

    Each graph keeps its static inputs, outputs and intermediates in a
    private memory pool while the runner lives: about one job's
    activations per signature; and on the host at most two sets of its
    outputs.

    Counts follow what the card runs: the launches (and lut_int8's bytes)
    counted while capturing come off `kernels.launch_counts()` (and
    `kernels.byte_counts()`), and each replay adds them back; under the
    recorder a replay adds the launches and plain steps to the open
    `serve.job` (`trace.replayed`). `kernels.graph_counts()`
    counts the calls ("eager" or "replays") and the "captures" and
    "capture_failures". A replay's counts are the ones its capture counted,
    not read anew: the card runs what was captured.

    One thread drives a runner. The runners of a device share K1-K3's
    split workspaces, so their programs run on one stream at a time."""

    def __init__(self, fn, prog: _C.CompiledProgram, device, batched: bool):
        self.fn, self.prog, self.device, self.batched = \
            fn, prog, device, batched
        self.eager = _numpy_io(fn, prog, device, batched)
        self.dtypes = {name: _C._NP_DT[prog.buffers[i][2]]
                       for name, i in prog.input_idx.items()}
        self.seen: set = set()       # signatures called once
        self.graphs: dict = {}       # signature -> _Graph, None: eager

    def _host(self, inputs: dict) -> tuple[dict, tuple]:
        """The inputs as the program's arrays, batch axis included, and
        their signature."""
        host = {name: np.asarray(inputs[name], dt)
                for name, dt in self.dtypes.items()}
        if not self.batched:
            host = {name: v[None] for name, v in host.items()}
        return host, tuple((name, v.shape, v.dtype.str)
                           for name, v in host.items())

    def __call__(self, inputs: dict) -> dict:
        host, sig = self._host(inputs)
        g = self.graphs.get(sig)
        if g is None and sig in self.seen and sig not in self.graphs:
            g = self._capture(sig, host)
        if g is None:
            self.seen.add(sig)
            _lib.count_graph("eager")
            return self.eager(inputs)
        with trace.span("runner.upload"):
            for name, v in host.items():
                g.ins[name].copy_(torch.from_numpy(v))
        with trace.span("runner.issue"):
            g.graph.replay()
            _lib.count_graph("replays")
            _lib.add_launches(g.launches)
            _lib.add_bytes(g.bytes)
            trace.replayed(sum(g.launches.values()), g.plain, g.kinds)
        with trace.span("runner.readback"):
            return g.host.read(g.outs, self.batched)

    def _capture(self, sig: tuple, host: dict) -> _Graph | None:
        """Capture `fn` over new static inputs of the signature's shapes;
        None (and eager from then on) if the capture raised."""
        with trace.span("runner.capture"):
            ins = {name: torch.empty_like(torch.from_numpy(v),
                                          device=self.device)
                   for name, v in host.items()}
            graph = torch.cuda.CUDAGraph()
            try:
                with trace.Tally() as tally, torch.cuda.graph(graph):
                    outs = self.fn(ins)
            except RuntimeError as e:
                outs = None          # the capture can fail at its end
                warnings.warn(
                    f"cuda backend: capturing program "
                    f"{self.prog.graph.name!r} at {sig} failed ({e}); that "
                    "signature runs eagerly from now on", RuntimeWarning,
                    stacklevel=3)
            if outs is None:
                _lib.count_graph("capture_failures")
                self.graphs[sig] = None
                return None
            _lib.count_graph("captures")
            g = self.graphs[sig] = _Graph(graph, ins, outs, tally.launches,
                                          tally.bytes, tally.plain_steps,
                                          tally.plain_kinds,
                                          HostOuts(self.device))
            return g

    def prime(self, batch: int) -> None:
        """Capture the graph of the signature of `batch` rows (a batched
        runner; a single-sample runner ignores `batch`) now, on zero
        inputs: the eager call and the capture that the signature's first
        two calls would make, or what of them has not happened yet. A
        server primes its runners when it builds them, so no served job
        runs eagerly or captures."""
        lead = (batch,) if self.batched else ()
        zeros = {name: np.zeros(lead + tuple(self.prog.buffers[i][1]),
                                self.dtypes[name])
                 for name, i in self.prog.input_idx.items()}
        sig = self._host(zeros)[1]
        for _ in range(2):
            if sig not in self.graphs:
                self(zeros)


def prime(runner: Runner, batch: int) -> Runner:
    """`runner`, with the CUDA graph of its `batch`-row signature captured
    now if it is a `GraphedRunner` (`GraphedRunner.prime`); any other
    runner is returned as it is."""
    if isinstance(runner, GraphedRunner):
        runner.prime(batch)
    return runner


def _cuda_factory(batched: bool):
    def factory(prog: _C.CompiledProgram,
                options: BackendOptions | None = None,
                device="cuda") -> Runner:
        dev = _C.resolve_device(device)
        fn = _cuda_fn(prog, options or BackendOptions(), dev)
        if dev.type != "cuda":
            return _numpy_io(fn, prog, dev, batched)
        return GraphedRunner(fn, prog, dev, batched)
    return factory


def _mesh_factory(batched: bool):
    def factory(prog: _C.CompiledProgram,
                options: BackendOptions | None = None,
                device="cuda") -> Runner:
        from ..cluster.mesh import mesh_batched_runner, mesh_single_runner
        make = mesh_batched_runner if batched else mesh_single_runner
        return make(prog, device)
    return factory


register_backend("numpy", single=_numpy_single,
                 capabilities=BackendCapabilities())
register_backend("torch", single=_torch_factory(False),
                 batched=_torch_factory(True),
                 capabilities=BackendCapabilities(
                     supports_batched_native=True, supports_decode=True))
register_backend("cuda", single=_cuda_factory(False),
                 batched=_cuda_factory(True),
                 capabilities=BackendCapabilities(
                     supports_batched_native=True,
                     requires_device="cuda",
                     supported_options=frozenset(
                         {"megakernel", "scratchpad_budget",
                          "max_kernels"})))
register_backend("mesh", single=_mesh_factory(False),
                 batched=_mesh_factory(True),
                 capabilities=BackendCapabilities(
                     supports_batched_native=True, supports_decode=True,
                     requires_device="cuda", mesh=True))
