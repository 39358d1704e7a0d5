"""Mesh context for model-internal SPMD decisions.

Launchers wrap execution in `with_mesh_context(mesh, **layouts)` and code
that needs the mesh asks `current_mesh()`; the mesh is the port's
`HostMesh` (`launch/mesh.py`). The JAX package also falls back to JAX's
trace-time abstract mesh; torch has none, so the context is the only
source here.

Where the JAX package hands GSPMD the shardings of a step's inputs
(`jax.jit(..., in_shardings=...)`), the port's steps run on this rank's
slices and read their layouts here: `layouts` names trees of
`NamedSharding` shaped like the step's inputs, `params` (the param tree,
`param_shardings`) and `cache` (the decode cache, `cache_shardings`).
`current_layout(name)` returns one, or None when the caller gave none
(everything whole).
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


@contextlib.contextmanager
def with_mesh_context(mesh, **layouts):
    prev = (getattr(_state, "mesh", None), getattr(_state, "layouts", {}))
    _state.mesh, _state.layouts = mesh, layouts
    try:
        yield mesh
    finally:
        _state.mesh, _state.layouts = prev


def current_mesh():
    return getattr(_state, "mesh", None)


def current_layout(name: str):
    return getattr(_state, "layouts", {}).get(name)


def current_context() -> tuple:
    """(mesh, layouts) of this thread's context, for `with_mesh_context(
    mesh, **layouts)` in another thread: autograd runs a CUDA backward,
    and the recomputation of a checkpointed layer, in a thread of its
    own, which sees none of the caller's context."""
    return current_mesh(), dict(getattr(_state, "layouts", {}))
