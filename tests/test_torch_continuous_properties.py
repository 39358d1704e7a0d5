"""Property twins (hypothesis) of `tests/test_continuous_properties.py`:
the port's `DecodeState`, `ResultTokens` and `ContinuousEngine` against
the JAX package's under generated insert/evict/append interleavings,
packed index ranges and arrival patterns.

Each drawn script runs on both packages' objects side by side: every
operation must succeed or raise `SlotError` in both, leave equal slot
tables, and keep the invariants the reference checks (no cross-slot
contamination, monotone lengths, immediate slot reuse, exact
partitions, the batch-to-completion oracle's tokens). The port's toy
backend runs on torch, the JAX package's on jax.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")

import hypothesis.strategies as st          # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402

import repro.serve.continuous as J          # noqa: E402
import repro_torch.serve.continuous as T    # noqa: E402


@st.composite
def op_sequences(draw):
    """A DecodeState geometry plus a random op script over it."""
    slots = draw(st.integers(1, 5))
    max_tokens = draw(st.integers(2, 6))
    ops = draw(st.lists(
        st.one_of(
            st.tuples(st.just("insert"), st.integers(0, slots - 1),
                      st.integers(1, 1000)),
            st.tuples(st.just("evict"), st.integers(0, slots - 1),
                      st.just(0)),
            st.tuples(st.just("append"), st.just(0),
                      st.integers(1, 1000))),
        min_size=1, max_size=30))
    return slots, max_tokens, ops


def _table(state):
    return (state.valid.tolist(), state.lengths.tolist(),
            state.request_ids.tolist(), state.tokens.tolist())


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seq=op_sequences())
def test_slot_isolation_and_monotone_lengths(seq):
    slots, max_tokens, ops = seq
    states = (J.DecodeState(slots, max_tokens),
              T.DecodeState(slots, max_tokens))
    shadow = {}                          # slot -> (rid, expected tokens)
    next_rid = 0
    for op, slot, arg in ops:
        state = states[1]
        if op == "insert":
            if state.valid[slot]:
                for M, s in zip((J, T), states):
                    with pytest.raises(M.SlotError):
                        s.insert(slot, next_rid)
                    s.evict(slot)
                shadow.pop(slot)
            for s in states:
                s.insert(slot, next_rid, first_token=arg)
            shadow[slot] = (next_rid, [arg])
            next_rid += 1
        elif op == "evict":
            if not state.valid[slot]:
                for M, s in zip((J, T), states):
                    with pytest.raises(M.SlotError):
                        s.evict(slot)
                continue
            got = [list(s.evict(slot)) for s in states]
            assert got[0] == got[1] == shadow.pop(slot)[1]
        else:                            # append one packed step
            room = state.valid & (state.lengths < max_tokens)
            if not room.all() and state.valid[~room].any():
                continue                 # a full slot would overflow
            before = state.lengths.copy()
            toks = np.arange(slots, dtype=np.int32) + arg
            packed = np.stack([toks, state.valid.astype(np.int32),
                               before + state.valid], axis=1)
            for M, s in zip((J, T), states):
                s.append(M.result_from_packed(packed))
            for s in range(slots):
                if state.valid[s]:
                    shadow[s][1].append(int(toks[s]))
                    assert state.lengths[s] == before[s] + 1
                else:
                    assert state.lengths[s] == 0
        assert _table(states[0]) == _table(states[1])
    state = states[1]
    for s, (rid, toks) in shadow.items():
        assert state.request_ids[s] == rid
        assert list(state.tokens[s, :len(toks)]) == toks
    free = sorted(s for s in range(slots) if s not in shadow)
    assert sorted(state.free_slots()) == free
    assert sorted(states[0].free_slots()) == free


@settings(max_examples=30, deadline=None)
@given(slots=st.integers(1, 8), width=st.integers(1, 6),
       cuts=st.tuples(st.integers(0, 6), st.integers(0, 6)),
       order=st.permutations([0, 1, 2]))
def test_packed_ranges_must_exactly_partition(slots, width, cuts, order):
    a, b = sorted(cuts)
    ranges = [(0, a), (a, b), (b, width)]
    named = [ranges[i] for i in order]
    for M in (J, T):
        rt = M.ResultTokens(np.zeros((slots, width), np.int32), *named)
        if 0 < a < b < width:
            rt.check_partition()
        else:
            with pytest.raises(M.SlotError):
                rt.check_partition()


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data(), slots=st.integers(1, 4),
       prefill_per_step=st.integers(1, 3))
def test_toy_engine_always_matches_reference(data, slots, prefill_per_step):
    n = data.draw(st.integers(1, 8))
    prompts = [data.draw(st.lists(st.integers(1, 200), min_size=1,
                                  max_size=5)) for _ in range(n)]
    max_new = [data.draw(st.integers(1, 6)) for _ in range(n)]
    steps_after = [data.draw(st.booleans()) for _ in range(n)]
    outs = []
    for M, xp in ((J, "jax"), (T, "torch")):
        eng = M.ContinuousEngine(M.ToyBackend(slots=slots, xp=xp),
                                 max_tokens=6,
                                 prefill_per_step=prefill_per_step)
        reqs = []
        for p, m, step in zip(prompts, max_new, steps_after):
            reqs.append(eng.enqueue(p, m))
            if step:
                eng.step()
        eng.drain()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1] == T.toy_reference(prompts, max_new)
