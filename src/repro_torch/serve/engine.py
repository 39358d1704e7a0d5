"""Batched CNN serving engine over a compiled deployment.

Static batch slots (fixed shapes -> fixed dataflow -> the paper's WCET
machinery applies per batch). The LM half of the JAX package's engine
module (`ServeEngine`: prefill/decode over a request queue) arrives with
slice 2 of the port.
"""

from __future__ import annotations

import numpy as np

from ..compiler import compile as compile_deployment
from ..core.graph import Graph
from ..hw import HardwareModel, TPU_V5E


class BatchedInferenceEngine:
    """Batched CNN inference over a compiled
    `repro_torch.compiler.Deployment`.

    The network is compiled once through `repro_torch.compile` (deployment
    cache keyed on graph signature + machine fingerprint + backend + device)
    and every batch replays the deployment's batched runner from the
    backend registry: ``"torch"`` (the whole program as one torch function
    over the batch axis), ``"numpy"`` (vectorized per-sample replay on the
    host), ``"cuda"`` (the hand-written CUDA kernels: the megakernel by
    default), or any third-party backend registered via
    `repro_torch.compiler.register_backend`. All built-ins are bit-exact vs
    ``reference_forward``. `device` ("cuda" unless the caller asks for
    "cpu") is where a network compiled here runs; a given deployment runs
    on its own device.

    An engine can also be built straight from a saved artifact:
    ``BatchedInferenceEngine.from_deployment(Deployment.load(path))``.
    """

    def __init__(self, graph: Graph, params: dict,
                 hw: HardwareModel = TPU_V5E,
                 num_cores: int | None = None, backend: str = "torch",
                 backend_options=None,
                 deployment=None,
                 fault_hook=None, device: str = "cuda"):
        self.graph = graph
        self.params = params
        self.backend = backend
        if deployment is None:
            deployment = compile_deployment(graph, hw, backend=backend,
                                            params=params,
                                            num_cores=num_cores,
                                            backend_options=backend_options,
                                            device=device)
        elif backend_options is not None:
            # precompiled artifact: re-key with the requested options
            # (validated against the backend's capabilities at swap time)
            deployment = deployment.with_backend(backend,
                                                 options=backend_options)
        self.deployment = deployment
        self.options = deployment.options
        self.program = deployment.program
        self.device = deployment.device
        self._fn = deployment.runner(batched=True, backend=backend)
        # fault-injection point for standalone engines: called before the
        # runner, so a raising hook costs no state
        self.fault_hook = fault_hook
        self.metrics = {"batches": 0, "samples": 0}

    @classmethod
    def from_deployment(cls, deployment, backend: str | None = None,
                        backend_options=None) -> "BatchedInferenceEngine":
        """Serve a precompiled (e.g. `Deployment.load`-ed) artifact, on
        the device it was compiled or loaded for."""
        return cls(deployment.graph, None,
                   backend=backend or deployment.backend,
                   backend_options=backend_options,
                   deployment=deployment)

    def infer(self, batch: dict[str, np.ndarray] | np.ndarray
              ) -> dict[str, np.ndarray]:
        """batch: {input_name: (B, ...)} (or a bare array for single-input
        graphs) -> {output_name: (B, ...)}."""
        if not isinstance(batch, dict):
            (name,) = self.graph.inputs
            batch = {name: batch}
        B = next(iter(batch.values())).shape[0]
        if self.fault_hook is not None:
            self.fault_hook()
        res = self._fn(batch)
        self.metrics["batches"] += 1
        self.metrics["samples"] += B
        return res
