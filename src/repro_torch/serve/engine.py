"""Batched serving engines: CNN inference over a compiled deployment, and
LM prefill/decode over a request batch.

  * `BatchedInferenceEngine` — static batch slots over a compiled
    `Deployment` (fixed shapes -> fixed dataflow -> the paper's WCET
    machinery applies per batch);
  * `ServeEngine` — `models.prefill_step` fills the KV/state cache for a
    batch of prompts, then `models.decode_step` emits one token for the
    whole batch per call (greedy), until every request has its tokens.
    `serve` is the batch-to-completion oracle the continuous loop
    (`serve/continuous.py`) is held against.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

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


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Greedy LM generation for a batch of up to `batch_size` requests, on
    the device the params live on (the CUDA kernels on the card, their
    plain versions on the CPU)."""

    def __init__(self, cfg, params, batch_size: int = 4,
                 max_len: int = 256, greedy: bool = True):
        from ..models import decode_step, prefill_step
        from .continuous import params_device
        self.cfg = cfg
        self.params = params
        self.B = batch_size
        self.max_len = max_len
        self.greedy = greedy
        self.device = params_device(params)
        self._prefill = prefill_step(cfg)
        self._decode = decode_step(cfg)
        self.metrics = {"prefills": 0, "decode_steps": 0, "tokens": 0}

    def _pad_prompts(self, prompts: list[list[int]]) -> np.ndarray:
        L = max(len(p) for p in prompts)
        arr = np.zeros((self.B, L), np.int64)
        for i, p in enumerate(prompts):
            arr[i, L - len(p):] = p          # left-pad (right-aligned)
        return arr

    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve a batch of requests to completion (greedy decode)."""
        from ..models import init_cache
        if len(requests) > self.B:
            raise ValueError(f"{len(requests)} requests for a batch of "
                             f"{self.B}")
        while len(requests) < self.B:       # pad batch with dummies
            requests = requests + [Request(rid=-1, prompt=[0],
                                           max_new_tokens=0)]
        prompts = self._pad_prompts([r.prompt for r in requests])
        S = prompts.shape[1]
        cache = init_cache(self.cfg, self.B, self.max_len, enc_len=S,
                           device=self.device)
        batch = {"tokens": torch.as_tensor(prompts, device=self.device)}
        if self.cfg.family == "encdec":
            # the encoder reads the prompt too (the audio frontend is a stub)
            batch["src_tokens"] = batch["tokens"]
        logits, cache = self._prefill(self.params, batch, cache)
        self.metrics["prefills"] += 1

        max_new = max(r.max_new_tokens for r in requests)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        for r, t in zip(requests, tok.cpu().numpy()):
            if r.rid >= 0 and r.max_new_tokens > 0:
                r.out.append(int(t))
        for _ in range(1, max_new):
            t0 = time.perf_counter()
            logits, cache = self._decode(self.params, cache, tok[:, None])
            self.metrics["decode_steps"] += 1
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            tok_host = tok.cpu().numpy()     # sync: result materialized
            self._record_decode_step(time.perf_counter() - t0)
            for r, t in zip(requests, tok_host):
                if r.rid >= 0 and len(r.out) < r.max_new_tokens:
                    r.out.append(int(t))
                    self.metrics["tokens"] += 1
        for r in requests:
            r.done = True
        return [r for r in requests if r.rid >= 0]

    def _record_decode_step(self, dt_s: float) -> None:
        """Per-decode-step timing hook (each step individually, measured at
        its sync point). `PredictableEngine` overrides this to feed the
        `DeadlineMonitor`; the base engine keeps no deadline state."""

    def serve(self, requests: list[Request],
              prompt_len: int | None = None) -> list[Request]:
        """Batch-to-completion oracle: FIFO groups of <= `batch_size`, each
        run to completion with `generate`.

        Every prompt is left-padded to ONE fixed `prompt_len` (default: the
        longest prompt in the set), so each request's context — and hence
        its greedy token stream — is independent of how requests are
        grouped into batches. That makes this the arrival-order-independent
        ground truth the continuous-batching loop
        (`repro_torch.serve.continuous`) is differentially tested against.
        """
        P = prompt_len or max((len(r.prompt) for r in requests), default=1)
        for r in requests:
            if len(r.prompt) > P:
                raise ValueError(f"request {r.rid}: prompt length "
                                 f"{len(r.prompt)} exceeds prompt_len {P}")
        done: list[Request] = []
        for i in range(0, len(requests), self.B):
            group = requests[i:i + self.B]
            padded = [dataclasses.replace(
                r, prompt=[0] * (P - len(r.prompt)) + r.prompt, out=[])
                for r in group]
            for orig, p in zip(group, self.generate(padded)):
                orig.out = p.out
                orig.done = True
                done.append(orig)
        return done
