"""Continuous-batching decode loop: slot-indexed `DecodeState` over the
port's LM step functions (JetStream-shaped).

The static serving model fills batch slots once per release and runs the
batch to completion, so one long generation stalls every new arrival. This
module makes the decode loop *continuous*: requests enter and leave the
batch per-slot at ANY decode step, prefill of a new arrival never blocks
the in-flight decode rows, and the per-step device->host traffic is ONE
packed array copy (tokens + validity + lengths behind index ranges, the
`ResultTokens` trick) instead of per-request copies.

The pieces, mirroring JetStream's `engine_api`:

  * `DecodeState`  — slot-indexed host bookkeeping (per-slot token buffer,
    length, validity, request/network id) plus the device cache;
    insert/evict are per-slot and an evicted slot is immediately reusable;
  * `ResultTokens` — the packed per-step result transfer;
  * `DecodeBackend` — the three device functions a continuous loop
    needs: `prefill` (batch 1), `insert` (write one prefix into one slot
    of the slot-batched cache), `generate` (one decode step for all slots,
    packed transfer);
  * `LMBackend`    — the port's LM families (`models.prefill_step` /
    `models.decode_step`) behind that protocol. Decode runs the family's
    step once over all slots with a per-slot `pos` vector (the step
    batches natively over rows where the JAX package vmaps a batch-1 step);
  * `ToyBackend`   — a deterministic integer model (numpy or torch) for
    cheap differential testing of the loop itself;
  * `ContinuousEngine` — the interleaved prefill/decode scheduler over a
    backend + `DecodeState`, with optional `DeadlineMonitor` accounting
    (per-decode-step WCET checks, per-request verdicts for requests that
    enter mid-stream).

Exactness contract: prompts are left-padded to one fixed `prompt_len`, so
a request's context — and hence its greedy token stream — is independent
of arrival time, slot placement, and batch composition. Under that
convention the continuous loop gives the token streams of the
batch-to-completion oracle `ServeEngine.serve` (the differential suite
compares token-for-token under randomized arrival orders and slot
capacities).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from .monitor import DeadlineMonitor, DeadlineVerdict


class SlotError(RuntimeError):
    """Invalid slot operation (insert into occupied, evict free, overflow)."""


# -- packed result transfer ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResultTokens:
    """One decode step's results, packed into ONE host copy.

    Everything the host needs from a step — next token, row validity,
    post-step length per slot — travels in a single `(slots, width)` int32
    array: copying one array device->host is much faster than three small
    copies, and the index ranges say which columns hold what. The ranges
    must exactly partition the width (property-tested).
    """

    data: np.ndarray                     # (slots, width) int32, on host
    tokens_idx: tuple[int, int]
    valid_idx: tuple[int, int]
    length_idx: tuple[int, int]

    @property
    def slots(self) -> int:
        return self.data.shape[0]

    def tokens(self) -> np.ndarray:
        return self.data[:, self.tokens_idx[0]:self.tokens_idx[1]]

    def valid(self) -> np.ndarray:
        return self.data[:, self.valid_idx[0]:self.valid_idx[1]]

    def lengths(self) -> np.ndarray:
        return self.data[:, self.length_idx[0]:self.length_idx[1]]

    def check_partition(self) -> None:
        """The three index ranges must exactly partition the data columns
        (no gap, no overlap) — the packed copy carries nothing else."""
        ranges = sorted([self.tokens_idx, self.valid_idx, self.length_idx])
        lo = 0
        for a, b in ranges:
            if a != lo or b <= a:
                raise SlotError(
                    f"packed index ranges {ranges} do not partition "
                    f"width {self.data.shape[1]}")
            lo = b
        if lo != self.data.shape[1]:
            raise SlotError(
                f"packed index ranges {ranges} do not cover "
                f"width {self.data.shape[1]}")


def pack_result(next_tokens, valid, lengths) -> Any:
    """Device-side packing: [tokens | valid | lengths] as one (S, 3) int32
    array (numpy or torch, as given). The caller materializes it on host
    (ONE copy) and wraps it in `ResultTokens` via `result_from_packed`."""
    if isinstance(next_tokens, torch.Tensor):
        return torch.stack([next_tokens.to(torch.int32), valid, lengths],
                           dim=1)
    return np.stack([next_tokens.astype(np.int32), valid, lengths], axis=1)


def result_from_packed(packed) -> ResultTokens:
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    return ResultTokens(data=np.asarray(packed).astype(np.int32),
                        tokens_idx=(0, 1), valid_idx=(1, 2),
                        length_idx=(2, 3))


# -- slot-indexed decode state ------------------------------------------------

class DecodeState:
    """Slot-indexed continuous-batching state.

    Host side: per-slot token buffer, generated length, validity and
    request/network ids. Device side: the backend's cache pytree (opaque
    here). Invariants (pinned by tests/test_continuous_properties.py):

      * `insert` targets a free slot and fully resets it; `evict` frees a
        slot for immediate reuse;
      * a slot's token buffer is only ever written by its own request
        (no cross-slot contamination);
      * `lengths[slot]` is monotone non-decreasing while the slot stays
        occupied;
      * `append` consumes a packed `ResultTokens` whose index ranges
        exactly partition the copied buffer.
    """

    def __init__(self, slots: int, max_tokens: int, cache: Any = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        self.slots = slots
        self.max_tokens = max_tokens
        self.tokens = np.zeros((slots, max_tokens), np.int32)
        self.lengths = np.zeros(slots, np.int32)
        self.valid = np.zeros(slots, bool)
        self.request_ids = np.full(slots, -1, np.int64)
        self.net_ids = np.full(slots, -1, np.int32)
        self.cache = cache

    @property
    def occupancy(self) -> int:
        return int(self.valid.sum())

    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots) if not self.valid[i]]

    def slot_of(self, request_id: int) -> int:
        hits = np.flatnonzero(self.valid & (self.request_ids == request_id))
        if hits.size != 1:
            raise SlotError(f"request {request_id} holds {hits.size} slots")
        return int(hits[0])

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.slots:
            raise SlotError(f"slot {slot} out of range [0, {self.slots})")

    def insert(self, slot: int, request_id: int, *, net_id: int = 0,
               first_token: int | None = None) -> None:
        """Claim a free slot for `request_id`, fully resetting its buffer.
        `first_token` seeds the buffer with the prefill's first generated
        token (length 1)."""
        self._check_slot(slot)
        if self.valid[slot]:
            raise SlotError(
                f"slot {slot} is occupied by request "
                f"{int(self.request_ids[slot])}; evict before insert")
        self.tokens[slot] = 0
        self.lengths[slot] = 0
        self.valid[slot] = True
        self.request_ids[slot] = request_id
        self.net_ids[slot] = net_id
        if first_token is not None:
            self.tokens[slot, 0] = first_token
            self.lengths[slot] = 1

    def evict(self, slot: int) -> np.ndarray:
        """Free an occupied slot; returns a copy of its generated tokens.
        The slot is immediately reusable by `insert`."""
        self._check_slot(slot)
        if not self.valid[slot]:
            raise SlotError(f"slot {slot} is already free")
        out = self.tokens[slot, :int(self.lengths[slot])].copy()
        self.valid[slot] = False
        self.request_ids[slot] = -1
        self.net_ids[slot] = -1
        self.lengths[slot] = 0
        return out

    def append(self, result: ResultTokens) -> np.ndarray:
        """Fold one packed step result into the slot buffers: every slot
        the packed validity marks live gets its next token appended.
        Returns the boolean mask of slots that were appended to."""
        result.check_partition()
        if result.slots != self.slots:
            raise SlotError(f"packed result has {result.slots} slots, "
                            f"state has {self.slots}")
        tok = result.tokens()[:, 0]
        live = result.valid()[:, 0].astype(bool) & self.valid
        new_len = result.lengths()[:, 0]
        if np.any(self.lengths[live] >= self.max_tokens):
            raise SlotError("token buffer overflow: a live slot already "
                            f"holds {self.max_tokens} tokens")
        idx = np.flatnonzero(live)
        self.tokens[idx, self.lengths[idx]] = tok[idx]
        self.lengths[idx] += 1
        if not np.array_equal(new_len[idx], self.lengths[idx]):
            raise SlotError("packed lengths disagree with host lengths "
                            f"({new_len[idx]} vs {self.lengths[idx]})")
        return live

    def summary(self) -> str:
        rows = [f"DecodeState[{self.occupancy}/{self.slots} slots live, "
                f"max_tokens={self.max_tokens}]"]
        for i in range(self.slots):
            if self.valid[i]:
                rows.append(f"  slot {i}: rid={int(self.request_ids[i])} "
                            f"net={int(self.net_ids[i])} "
                            f"len={int(self.lengths[i])}")
        return "\n".join(rows)


# -- backend protocol ---------------------------------------------------------

class DecodeBackend:
    """The accelerator functions a continuous-batching loop needs
    (JetStream's `engine_api` shape):

      prefill(prompt)            -> (first_token, prefix)      # batch 1
      insert(prefix, cache, i)   -> cache'                     # one slot
      generate(cache, prev, valid, lengths) -> (cache', ResultTokens)

    `generate` advances ALL slots by one token with fixed shapes and
    returns the packed single-copy result; invalid rows decode garbage
    that is masked out and overwritten at the next insert.
    """

    slots: int = 0

    def init_cache(self) -> Any:
        raise NotImplementedError

    def validate_prompt(self, prompt: list[int]) -> None:
        """Reject a prompt this backend cannot prefill (raise ValueError).
        Called at enqueue time so bad requests fail at intake, not while
        they hold a slot."""
        if not prompt:
            raise ValueError("empty prompt")

    def prefill(self, prompt: list[int]) -> tuple[int, Any]:
        raise NotImplementedError

    def insert(self, prefix: Any, cache: Any, slot: int) -> Any:
        raise NotImplementedError

    def generate(self, cache: Any, prev_tokens: np.ndarray,
                 valid: np.ndarray, lengths: np.ndarray
                 ) -> tuple[Any, ResultTokens]:
        raise NotImplementedError


class LMBackend(DecodeBackend):
    """The port's LM families behind the continuous protocol.

    Prefill runs `models.prefill_step` at batch 1 on the prompt left-padded
    to `prompt_len` (fixed shapes; pad-invariant outputs per request, see
    module docstring). Decode runs `models.decode_step` once over all
    slots with a per-slot `pos` vector (`cache["pos"]` of shape
    `(slots,)`), so each slot advances at its own position; every other
    cache leaf carries its batch axis at index 1. The backend runs where
    `params` live (the card, or the CPU for the plain versions).

    The encdec family needs per-request encoder state and is not supported.
    """

    def __init__(self, cfg, params, *, slots: int, prompt_len: int,
                 max_len: int, pad_id: int = 0):
        from ..models import decode_step, prefill_step
        if cfg.family == "encdec":
            raise NotImplementedError(
                "continuous batching does not support the encdec family "
                "(per-request encoder state)")
        if max_len < prompt_len + 1:
            raise ValueError(f"max_len={max_len} leaves no decode room "
                             f"past prompt_len={prompt_len}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.prompt_len = prompt_len
        self.max_len = max_len
        self.pad_id = pad_id
        self.device = params_device(params)
        self._prefill_fn = prefill_step(cfg)
        self._decode_fn = decode_step(cfg)

    def init_cache(self) -> Any:
        from ..models import init_cache
        cache = init_cache(self.cfg, self.slots, self.max_len,
                           device=self.device)
        # per-slot decode positions instead of the shared scalar
        cache["pos"] = torch.zeros((self.slots,), dtype=torch.int32,
                                   device=self.device)
        return cache

    def validate_prompt(self, prompt: list[int]) -> None:
        if not 0 < len(prompt) <= self.prompt_len:
            raise ValueError(f"prompt length {len(prompt)} not in "
                             f"[1, {self.prompt_len}]")

    def prefill(self, prompt: list[int]) -> tuple[int, Any]:
        from ..models import init_cache
        prompt = list(prompt)
        self.validate_prompt(prompt)
        padded = [self.pad_id] * (self.prompt_len - len(prompt)) + prompt
        cache1 = init_cache(self.cfg, 1, self.max_len, device=self.device)
        tokens = torch.tensor([padded], dtype=torch.long, device=self.device)
        logits, cache1 = self._prefill_fn(self.params, {"tokens": tokens},
                                          cache1)
        first = int(torch.argmax(logits[0, -1, :]).item())
        return first, cache1

    def insert(self, prefix: Any, cache: Any, slot: int) -> Any:
        """Write a batch-1 prefix into `slot` of the slot-batched cache, in
        place (the engine owns the cache; no copy of the other slots)."""
        for k, v in cache.items():
            if k == "pos":
                v[slot] = prefix[k]
            else:
                v[:, slot] = prefix[k][:, 0].to(v.dtype)
        return cache

    def generate(self, cache, prev_tokens, valid, lengths):
        dev = self.device
        prev = torch.as_tensor(prev_tokens, device=dev).long()[:, None]
        valid_t = torch.as_tensor(valid.astype(np.int32), device=dev)
        lengths_t = torch.as_tensor(lengths.astype(np.int32), device=dev)
        logits, new_cache = self._decode_fn(self.params, cache, prev)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        nxt = torch.where(valid_t > 0, nxt, torch.zeros_like(nxt))
        packed = torch.stack([nxt, valid_t, lengths_t + valid_t], dim=1)
        # the ONE device->host copy of this step
        return new_cache, result_from_packed(packed)


def params_device(params) -> torch.device:
    """The device of the first tensor leaf of a params tree."""
    node = params
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.device


class ToyBackend(DecodeBackend):
    """Deterministic integer 'LM' for testing the loop itself.

    Per-slot recurrent state: a rolling hash of all consumed tokens.
    next = (A*state + B*prev + C) mod vocab; state' = (state*MULT + next)
    mod MOD. Pure int32 modular arithmetic, so the numpy and torch variants
    are exactly equal and the pure-python oracle (`toy_reference`) is a
    bit-exact batch-to-completion ground truth.
    """

    MOD, MULT, A, B, C = 9973, 31, 389, 571, 7

    def __init__(self, slots: int, vocab: int = 211, xp: str = "numpy"):
        self.slots = slots
        self.vocab = vocab
        self.xp_name = xp
        if xp not in ("numpy", "torch"):
            raise ValueError(f"unknown array module {xp!r}")

    def _hash(self, state: int, tok: int) -> int:
        return (state * self.MULT + tok) % self.MOD

    def _next(self, state: int, prev: int) -> int:
        return (self.A * state + self.B * prev + self.C) % self.vocab

    def _array(self, a: np.ndarray):
        a = np.asarray(a, np.int32)
        return torch.from_numpy(a.copy()) if self.xp_name == "torch" else a

    def init_cache(self) -> Any:
        return {"state": self._array(np.zeros(self.slots, np.int32))}

    def prefill(self, prompt: list[int]) -> tuple[int, Any]:
        state = 0
        for t in prompt:
            state = self._hash(state, t)
        first = self._next(state, prompt[-1])
        return first, {"state": self._hash(state, first)}

    def insert(self, prefix: Any, cache: Any, slot: int) -> Any:
        state = cache["state"].copy() if self.xp_name == "numpy" \
            else cache["state"].clone()
        state[slot] = prefix["state"]
        return {"state": state}

    def generate(self, cache, prev_tokens, valid, lengths):
        xp = np if self.xp_name == "numpy" else torch
        state = cache["state"]
        prev = self._array(prev_tokens)
        nxt = (self.A * state + self.B * prev + self.C) % self.vocab
        valid_i = self._array(valid.astype(np.int32))
        nxt = xp.where(valid_i > 0, nxt, 0)
        new_state = xp.where(valid_i > 0,
                             (state * self.MULT + nxt) % self.MOD, state)
        packed = pack_result(nxt, valid_i, self._array(lengths) + valid_i)
        return {"state": new_state}, result_from_packed(packed)


def toy_reference(prompts: list[list[int]], max_new_tokens: list[int],
                  vocab: int = 211) -> list[list[int]]:
    """Batch-to-completion oracle for `ToyBackend`: pure-python ints,
    independent of batching, arrival order and slot placement."""
    b = ToyBackend(slots=1, vocab=vocab)
    outs = []
    for prompt, max_new in zip(prompts, max_new_tokens):
        state = 0
        for t in prompt:
            state = b._hash(state, t)
        out, prev = [], prompt[-1]
        for _ in range(max_new):
            tok = b._next(state, prev)
            state = b._hash(state, tok)
            out.append(tok)
            prev = tok
        outs.append(out)
    return outs


# -- the continuous engine ----------------------------------------------------

@dataclasses.dataclass
class ContinuousRequest:
    """One request flowing through the continuous loop."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    net_id: int = 0
    deadline_s: float | None = None
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: int = -1
    steps_held: int = 0                  # engine steps the request held a slot
    submit_t: float = 0.0
    insert_t: float = 0.0
    done_t: float = 0.0
    verdict: DeadlineVerdict | None = None

    @property
    def latency_s(self) -> float:
        return self.done_t - self.submit_t


@dataclasses.dataclass
class StepInfo:
    """What one `ContinuousEngine.step()` did."""

    prefills: int
    decoded: bool
    occupancy: int                       # live slots during the decode
    decode_dt_s: float
    finished: list[ContinuousRequest]


class ContinuousEngine:
    """Interleaved prefill/decode scheduling over a `DecodeBackend`.

    Each `step()`:

      1. admits up to `prefill_per_step` pending arrivals into free slots
         (prefill at batch 1 + per-slot insert) — bounding the prefill work
         per step is what keeps new arrivals from ever stalling the
         in-flight decode rows;
      2. runs ONE decode step for all occupied slots (fixed shapes — the
         WCET bound for the slot-batched decode graph applies per step);
      3. makes ONE packed device->host transfer (`ResultTokens`), folds it
         into the `DecodeState`, and evicts finished slots (immediately
         refillable at the next step).

    With a `DeadlineMonitor` attached, every decode step is checked
    against `step_bound_s` (checks AND misses count per step), per-step
    occupancy is recorded, and each finished request gets a
    `DeadlineVerdict` against its OWN deadline (requests entering
    mid-stream included) without touching the step counters.

    Fault hooks (for chaos runs outside a `Server`, whose resilience
    layer injects at the job level instead): `fault_hook` is called at
    the very top of `step()` — BEFORE any state mutation, so a raising
    hook (`faults.FaultInjector.before_call`) leaves the loop resumable
    and a clean retry is just calling `step()` again. A hook returning
    "spike" inflates the measured decode latency by `spike_factor`
    before the monitor check. A `StragglerWatchdog` on `watchdog`
    observes every decode step's latency and counts flagged steps as
    "straggler" events on the monitor.
    """

    def __init__(self, backend: DecodeBackend, *, max_tokens: int,
                 prefill_per_step: int = 1,
                 monitor: DeadlineMonitor | None = None,
                 step_bound_s: float | None = None,
                 default_deadline_s: float | None = None,
                 network: str = "decode",
                 clock: Callable[[], float] = time.perf_counter,
                 fault_hook: Callable[[], str | None] | None = None,
                 spike_factor: float = 1.0,
                 watchdog: object = None):
        if prefill_per_step < 1:
            raise ValueError("prefill_per_step must be >= 1")
        self.backend = backend
        self.state = DecodeState(backend.slots, max_tokens,
                                 cache=backend.init_cache())
        self.max_tokens = max_tokens
        self.prefill_per_step = prefill_per_step
        self.monitor = monitor
        self.step_bound_s = step_bound_s
        self.default_deadline_s = default_deadline_s
        self.network = network
        self.clock = clock
        self.fault_hook = fault_hook
        self.spike_factor = spike_factor
        self.watchdog = watchdog
        self.pending: deque[ContinuousRequest] = deque()
        self.active: dict[int, ContinuousRequest] = {}
        self.completed: list[ContinuousRequest] = []
        self.prev_tokens = np.zeros(backend.slots, np.int32)
        self.metrics = {"steps": 0, "prefills": 0, "decode_steps": 0,
                        "tokens": 0, "evictions": 0, "slot_steps": 0}
        self._rids = 0

    # -- intake --------------------------------------------------------------
    def enqueue(self, prompt: list[int], max_new_tokens: int | None = None,
                *, rid: int | None = None,
                deadline_s: float | None = None) -> ContinuousRequest:
        max_new = self.max_tokens if max_new_tokens is None else max_new_tokens
        if not 1 <= max_new <= self.max_tokens:
            raise ValueError(f"max_new_tokens {max_new} not in "
                             f"[1, {self.max_tokens}]")
        self.backend.validate_prompt(list(prompt))
        if rid is None:
            rid = self._rids
            self._rids += 1
        req = ContinuousRequest(rid=rid, prompt=list(prompt),
                                max_new_tokens=max_new,
                                deadline_s=deadline_s,
                                submit_t=self.clock())
        self.pending.append(req)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or bool(self.active)

    def admittable(self) -> int:
        """How many more requests could enter at the NEXT step: free slots
        not already spoken for by pending arrivals, capped by the per-step
        prefill budget."""
        free = self.state.slots - self.state.occupancy - len(self.pending)
        return max(0, min(free, self.prefill_per_step - len(self.pending)))

    # -- the loop ------------------------------------------------------------
    def step(self) -> StepInfo:
        # injection point: before any state mutation, so a raising hook
        # leaves the loop resumable (retry = call step() again)
        spike = self.fault_hook() if self.fault_hook is not None else None
        self.metrics["steps"] += 1
        finished: list[ContinuousRequest] = []
        prefills = 0
        while (self.pending and self.state.free_slots()
               and prefills < self.prefill_per_step):
            req = self.pending.popleft()
            slot = self.state.free_slots()[0]
            first, prefix = self.backend.prefill(req.prompt)
            self.state.cache = self.backend.insert(prefix, self.state.cache,
                                                   slot)
            self.state.insert(slot, req.rid, net_id=req.net_id,
                              first_token=first)
            req.out.append(first)
            req.slot = slot
            req.steps_held = 1
            req.insert_t = self.clock()
            self.prev_tokens[slot] = first
            self.active[slot] = req
            self.metrics["prefills"] += 1
            self.metrics["tokens"] += 1
            prefills += 1
            if len(req.out) >= req.max_new_tokens:
                self._finish(req, finished)

        occupancy = self.state.occupancy
        decoded = False
        dt = 0.0
        if occupancy:
            t0 = self.clock()
            cache, result = self.backend.generate(
                self.state.cache, self.prev_tokens,
                self.state.valid, self.state.lengths)
            dt = self.clock() - t0
            if spike == "spike":
                dt *= self.spike_factor
            self.state.cache = cache
            live = self.state.append(result)
            tok = result.tokens()[:, 0]
            decoded = True
            self.metrics["decode_steps"] += 1
            self.metrics["slot_steps"] += occupancy
            if self.watchdog is not None and self.watchdog.observe(
                    self.metrics["decode_steps"], dt):
                if self.monitor is not None:
                    self.monitor.record_event(self.network, "straggler")
            if self.monitor is not None and self.step_bound_s is not None:
                self.monitor.check(self.network, dt, self.step_bound_s)
            if self.monitor is not None:
                self.monitor.record_occupancy(self.network, occupancy,
                                              self.state.slots)
            for slot in np.flatnonzero(live):
                req = self.active[int(slot)]
                req.out.append(int(tok[slot]))
                req.steps_held += 1
                self.prev_tokens[slot] = tok[slot]
                self.metrics["tokens"] += 1
                if len(req.out) >= req.max_new_tokens:
                    self._finish(req, finished)
        return StepInfo(prefills=prefills, decoded=decoded,
                        occupancy=occupancy, decode_dt_s=dt,
                        finished=finished)

    def _finish(self, req: ContinuousRequest,
                finished: list[ContinuousRequest]) -> None:
        generated = self.state.evict(req.slot)
        if list(generated) != req.out:
            raise SlotError(
                f"slot {req.slot} buffer {list(generated)} disagrees with "
                f"request {req.rid} stream {req.out}")
        self.prev_tokens[req.slot] = 0
        del self.active[req.slot]
        self.metrics["evictions"] += 1
        req.done = True
        req.done_t = self.clock()
        req.slot = -1
        if self.monitor is not None and self.step_bound_s is not None:
            deadline = (req.deadline_s if req.deadline_s is not None
                        else self.default_deadline_s)
            req.verdict = self.monitor.judge(
                self.network, req.latency_s,
                self.step_bound_s * req.steps_held, deadline)
        finished.append(req)
        self.completed.append(req)

    def drain(self, max_steps: int = 100_000) -> list[ContinuousRequest]:
        """Step until every pending/active request completed; returns the
        requests finished during this call, in completion order."""
        done: list[ContinuousRequest] = []
        for _ in range(max_steps):
            if not self.has_work:
                return done
            done.extend(self.step().finished)
        raise RuntimeError(f"drain did not converge in {max_steps} steps "
                           f"({len(self.pending)} pending, "
                           f"{len(self.active)} active)")

    def summary(self) -> str:
        m = self.metrics
        return (f"ContinuousEngine[{self.network}: "
                f"{self.state.occupancy}/{self.state.slots} slots live, "
                f"{len(self.pending)} pending] steps={m['steps']} "
                f"prefills={m['prefills']} decode_steps={m['decode_steps']} "
                f"tokens={m['tokens']} "
                f"mean_occ={m['slot_steps'] / max(1, m['decode_steps']):.2f}")
