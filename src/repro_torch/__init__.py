"""repro_torch: predictable NN inference (Kirschner et al. 2024) in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100 (Hopper, sm_90a) —
static DMA scheduling + compositional WCET as a first-class framework
feature, plus the serving runtime around it.

The compiler front door lives here:

    import repro_torch
    deploy = repro_torch.compile(graph, machine, backend="cuda")
    y = deploy.run(x)                          # on the GPU by default

`repro_torch.compile` / `repro_torch.Deployment` / `repro_torch.Server` are
loaded lazily, so importing the bare package loads no torch code; no import
builds or loads a CUDA kernel (they build at their first launch)."""

__version__ = "1.1.0"

_COMPILER_EXPORTS = ("compile", "Deployment", "TasksetDeployment",
                     "BackendOptions", "BackendCapabilities", "BackendError",
                     "compiler")
_SERVE_EXPORTS = ("Server",)


def __getattr__(name):
    if name in _SERVE_EXPORTS:
        import importlib
        return getattr(importlib.import_module(".serve", __name__), name)
    if name in _COMPILER_EXPORTS:
        # importlib (not `from . import compiler`): the from-import form
        # re-enters this __getattr__ before the submodule is bound on the
        # package, recursing forever.
        import importlib
        compiler = importlib.import_module(".compiler", __name__)
        if name == "compiler":
            return compiler
        return getattr(compiler, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_COMPILER_EXPORTS)
                  + list(_SERVE_EXPORTS))
