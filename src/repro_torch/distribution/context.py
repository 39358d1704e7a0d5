"""Mesh context for model-internal SPMD decisions.

Launchers wrap execution in `with_mesh_context(mesh)` and code that needs
the mesh asks `current_mesh()`; the mesh is the port's `HostMesh`
(`launch/mesh.py`). The JAX package also falls back to JAX's trace-time
abstract mesh; torch has none, so the context is the only source here.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


@contextlib.contextmanager
def with_mesh_context(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def current_mesh():
    return getattr(_state, "mesh", None)
