"""`repro_torch.compile()` — one entry point for the whole compiler pipeline.

    deploy = repro_torch.compile(graph, machine, backend="cuda")
    y = deploy.run(x)                        # any registered backend
    deploy.save("net.rtdep")                 # ahead-of-time artifact
    deploy = repro_torch.Deployment.load("net.rtdep", machine=machine)

Accepts either a single `Graph` (returns `Deployment`) or a periodic
taskset — a list of `NetworkSpec` — (returns `TasksetDeployment` with the
hyperperiod schedulability report plus per-network deployments).

Deployments are cached on (graph signature, machine fingerprint, backend,
backend options, cores, arbitration, validate, params identity, device)
through the same LRU discipline as the program cache in
`repro_torch.core.compiled`; `repro_torch.core.clear_program_cache` clears
both.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

from ..core.compiled import (_CACHE_CLEAR_HOOKS, graph_signature,
                             resolve_device, supports_graph)
from ..core.graph import Graph
from ..core.taskset import NetworkSpec
from ..core.wcet import analyze_taskset
from ..hw import HardwareModel
from .backends import BackendOptions, get_backend
from .deployment import Deployment, TasksetDeployment
from .pipeline import PassContext, PassManager, default_passes

# key -> (params, Deployment); params pinned for the same id()-recycling
# reason as the program cache (see repro_torch/core/compiled.py). A params key of
# None means "synthesized defaults" (deterministic, so sharing is sound).
_DEPLOYMENT_CACHE: "OrderedDict[tuple, tuple[dict | None, Deployment]]" = \
    OrderedDict()
_DEPLOYMENT_CACHE_CAP = 64

_CACHE_CLEAR_HOOKS.append(_DEPLOYMENT_CACHE.clear)


def compile(graph_or_taskset, machine: HardwareModel, *,   # noqa: A001
            backend: str = "torch", deadline: float | None = None,
            params: dict | None = None, num_cores: int | None = None,
            arbitration: str = "static", validate: bool = True,
            use_cache: bool = True,
            backend_options: BackendOptions | None = None,
            verify: bool = True, strict: bool = False,
            suppress: tuple = (), device: str = "cuda"):
    """Compile a graph (or taskset) for `machine` into a deployment.

    Single network: runs the staged pass pipeline (quantize -> partition ->
    map -> schedule -> wcet -> lower -> verify) and returns a
    `Deployment`. `params`
    may be a complete weights dict, a partial one (missing entries are
    synthesized), or None. `deadline` (seconds) makes compilation fail with
    `DeadlineError` if the WCET bound exceeds it. `backend_options` (a
    `BackendOptions`) carries typed execution knobs —
    megakernel on/off, tile overrides — validated here against the
    backend's capabilities and persisted with the deployment artifact.

    `verify` runs the schedule sanitizer (`repro_torch.analysis`) as the final
    pass: any unsuppressed error-severity diagnostic — a DMA-window
    overlap, a scratchpad overrun, an unsound WCET bound — fails the
    compile with `VerificationError`; `strict=True` fails on warnings
    too. `suppress` waives specific findings ("RULE" or "RULE@scope",
    see docs/analysis.md); the directives are persisted on the artifact
    so `Deployment.save`/`load` honor the same waivers.

    Taskset (a sequence of `NetworkSpec`): runs the hyperperiod analysis
    and compiles an executable `Deployment` for every member network whose
    op kinds have a lowering; returns a `TasksetDeployment`. `params` is
    then a {network_name: params_dict} mapping and per-network deadlines
    come from the specs (the `deadline` argument must be None).

    `device` is where the deployment runs: "cuda" (the default) needs a
    GPU and raises without one; "cpu" runs on the host (the kernels'
    plain versions on the "cuda" backend).
    """
    device = str(resolve_device(device))
    options = backend_options or BackendOptions()
    # fail fast on unknown backend / unsupported options / mismatched
    # mesh pairing — the mesh shape is part of the machine fingerprint,
    # so letting either half through alone would mint artifacts that
    # misdescribe how they execute
    be = get_backend(backend)
    be.validate_options(options, device)
    be.validate_machine(machine)
    if isinstance(graph_or_taskset, Graph):
        return _compile_graph(graph_or_taskset, machine, backend=backend,
                              deadline=deadline, params=params,
                              num_cores=num_cores, arbitration=arbitration,
                              validate=validate, use_cache=use_cache,
                              options=options, verify=verify, strict=strict,
                              suppress=tuple(suppress), device=device)
    if (isinstance(graph_or_taskset, Sequence)
            and graph_or_taskset
            and all(isinstance(s, NetworkSpec) for s in graph_or_taskset)):
        if deadline is not None:
            raise TypeError(
                "taskset deadlines are per-network (NetworkSpec.deadline_s);"
                " the deadline= argument applies to single graphs only")
        return _compile_taskset(list(graph_or_taskset), machine,
                                backend=backend, params_by_net=params or {},
                                num_cores=num_cores, arbitration=arbitration,
                                validate=validate, use_cache=use_cache,
                                options=options, verify=verify,
                                strict=strict, suppress=tuple(suppress),
                                device=device)
    raise TypeError(
        "repro_torch.compile expects a Graph or a non-empty sequence of "
        f"NetworkSpec, got {type(graph_or_taskset).__name__}")


def _compile_graph(graph: Graph, machine: HardwareModel, *, backend: str,
                   deadline: float | None, params: dict | None,
                   num_cores: int | None, arbitration: str, validate: bool,
                   use_cache: bool,
                   options: BackendOptions | None = None,
                   verify: bool = True, strict: bool = False,
                   suppress: tuple = (), device: str = "cuda") -> Deployment:
    options = options or BackendOptions()
    params_key = None if params is None else id(params)
    key = (graph_signature(graph), machine.fingerprint(), backend,
           options.cache_key(), num_cores, arbitration, bool(validate),
           params_key, bool(verify), bool(strict), tuple(suppress), device)
    if use_cache:
        hit = _DEPLOYMENT_CACHE.get(key)
        if hit is not None and hit[0] is params:
            _DEPLOYMENT_CACHE.move_to_end(key)
            _check_deadline(hit[1], deadline)
            return hit[1]

    passes = default_passes()
    if not verify:
        passes = [p for p in passes if getattr(p, "name", "") != "verify"]
    ctx = PassContext(graph=graph, hw=machine,
                      params=dict(params) if params else {},
                      num_cores=num_cores, arbitration=arbitration,
                      deadline=deadline, validate=validate, strict=strict,
                      suppress=tuple(suppress), backend_options=options)
    PassManager(passes).run(ctx)
    dep = Deployment(program=ctx.program, schedule=ctx.schedule,
                     report=ctx.report, machine=machine, backend=backend,
                     options=options, stages=ctx.stages,
                     artifacts=ctx.artifacts,
                     suppressions=tuple(suppress), device=device)
    if use_cache:
        _DEPLOYMENT_CACHE[key] = (params, dep)
        while len(_DEPLOYMENT_CACHE) > _DEPLOYMENT_CACHE_CAP:
            _DEPLOYMENT_CACHE.popitem(last=False)
    return dep


def _check_deadline(dep: Deployment, deadline: float | None) -> None:
    """Re-enforce the deadline on cache hits (the cached pipeline may have
    been compiled under a laxer or absent deadline)."""
    from .pipeline import check_deadline
    check_deadline(dep.report, deadline, dep.graph.name, dep.machine.name)


def _compile_taskset(specs: list[NetworkSpec], machine: HardwareModel, *,
                     backend: str, params_by_net: dict,
                     num_cores: int | None, arbitration: str,
                     validate: bool, use_cache: bool,
                     options: BackendOptions | None = None,
                     verify: bool = True, strict: bool = False,
                     suppress: tuple = (), device: str = "cuda"
                     ) -> TasksetDeployment:
    options = options or BackendOptions()
    report, compiled = analyze_taskset(specs, machine, num_cores,
                                       arbitration=arbitration,
                                       validate=validate)
    deployments: dict[str, Deployment] = {}
    for spec in specs:
        if not supports_graph(spec.graph):
            continue                        # analysis-only (LM decode etc.)
        deployments[spec.name] = _compile_graph(
            spec.graph, machine, backend=backend, deadline=None,
            params=params_by_net.get(spec.name), num_cores=num_cores,
            arbitration=arbitration, validate=validate, use_cache=use_cache,
            options=options, verify=verify, strict=strict,
            suppress=suppress, device=device)
    tdep = TasksetDeployment(report=report, taskset=compiled,
                             deployments=deployments, machine=machine,
                             backend=backend, options=options,
                             suppressions=tuple(suppress))
    if verify:
        from ..analysis import analyze_taskset_deployment
        from .pipeline import VerificationError
        analysis = analyze_taskset_deployment(tdep)
        tdep.analysis = analysis
        blocking = analysis.unsuppressed() if strict else analysis.errors
        if blocking:
            shown = "\n".join("  " + d.row() for d in blocking[:10])
            raise VerificationError(
                f"taskset on {machine.name}: schedule sanitizer found "
                f"{len(blocking)} blocking diagnostic(s):\n{shown}")
    return tdep


def clear_deployment_cache() -> None:
    """Drop cached deployments (also run by
    repro_torch.core.clear_program_cache)."""
    _DEPLOYMENT_CACHE.clear()
