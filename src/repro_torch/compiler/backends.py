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
    a CPU device every kernel wrapper takes its plain version.

Factories take ``(prog, options, device)``; a factory with only
``(prog, options)`` runs on whatever device its own code picks, and the
legacy single-argument ``factory(prog)`` is wrapped with a shim that emits
a `DeprecationWarning` at registration.
"""

from __future__ import annotations

import dataclasses
import inspect
import warnings
from typing import Callable

import numpy as np

from ..core import compiled as _C
from ..core import megakernel as _MK

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
        `repro_torch.compile` enforces the pairing both ways. (No mesh
        backend is ported yet.)
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
            import torch
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
                f"but backend {self.name!r} is single-device (the mesh "
                f"backend is not ported yet); use a machine without a "
                f"mesh shape")


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
    sample gets a leading batch axis of 1). Blocks until the result is on
    the host."""
    def run(inputs: dict) -> dict:
        out = fn(_C.to_device(prog, inputs, device, batched))
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


def _cuda_factory(batched: bool):
    def factory(prog: _C.CompiledProgram,
                options: BackendOptions | None = None,
                device="cuda") -> Runner:
        dev = _C.resolve_device(device)
        fn = _cuda_fn(prog, options or BackendOptions(), dev)
        return _numpy_io(fn, prog, dev, batched)
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
