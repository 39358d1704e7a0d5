"""The port's op counter (`repro_torch.launch.hlo_count`) against the
hand-computed programs of tests/test_hlo_count.py, rewritten in torch.

Each case of the JAX package's file has a twin here with the same totals:
its `lax.scan`s become Python loops over the same shapes (an eager step
runs each op, so the counter sees every trip), the batched dot, the bytes
floor, the one-row update charged by its slice, and the collectives'
formats as a run on a fake process group that issues the sample's shapes.
For FLOPs the JAX package's own `analyze_hlo_text` on the JAX twin program
gives the same number as the port's counter for a program of dots; a
scan's HLO adds its scalar loop counter (one add and one compare a trip),
which `_same_dots` allows and nothing else.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.launch.hlo_count import analyze_hlo_text
from repro_torch.distribution.collectives import (all_gather_cat,
                                                  all_reduce, ring_shift)
from repro_torch.launch.analysis import collective_bytes
from repro_torch.launch.hlo_count import OpCounter, count


def _jax_flops(fn, *args):
    return analyze_hlo_text(jax.jit(fn).lower(*args).compile().as_text()
                            ).flops


def _same_dots(jax_flops, port_flops, trips=0):
    """Equal but for at most 2 scalar ops per loop trip in the HLO."""
    assert port_flops <= jax_flops <= port_flops + 2 * trips + 2


def test_scan_flops_exact():
    W = torch.zeros((7, 256, 512))
    x0 = torch.zeros((128, 256))
    P = torch.zeros((512, 256))

    def f(x, Ws):
        c = x
        for w in Ws:                       # the scan over W's 7 slices
            c = (c @ w) @ P
        return c @ torch.zeros((256, 64))

    cost, _ = count(f, x0, W.unbind(0))
    expected = 7 * (2 * 128 * 256 * 512 + 2 * 128 * 512 * 256) \
        + 2 * 128 * 256 * 64
    assert abs(cost.flops - expected) / expected < 1e-6

    Pj = jnp.zeros((512, 256), jnp.float32)

    def fj(x, Ws):
        def body(c, w):
            return (c @ w) @ Pj, None
        c, _ = jax.lax.scan(body, x, Ws)
        return c @ jnp.zeros((256, 64), jnp.float32)

    _same_dots(_jax_flops(fj, jnp.zeros((128, 256), jnp.float32),
                          jnp.zeros((7, 256, 512), jnp.float32)),
               cost.flops, trips=7)


def test_nested_scan_flops_exact():
    x0 = torch.zeros((128, 256))

    def g(x):
        c = x
        for _ in range(5):
            for _ in range(3):
                c = c @ torch.zeros((256, 256))
        return c

    cost, _ = count(g, x0)
    expected = 5 * 3 * 2 * 128 * 256 * 256
    assert abs(cost.flops - expected) / expected < 1e-6

    def gj(x):
        def outer(c, _):
            def inner(c2, _):
                return c2 @ jnp.zeros((256, 256)), None
            c, _ = jax.lax.scan(inner, c, None, length=3)
            return c, None
        c, _ = jax.lax.scan(outer, x, None, length=5)
        return c

    _same_dots(_jax_flops(gj, jnp.zeros((128, 256))), cost.flops,
               trips=5 + 5 * 3)


def test_batched_dot_flops():
    a = torch.zeros((4, 32, 64))
    b = torch.zeros((4, 64, 16))
    cost, _ = count(torch.bmm, a, b)
    expected = 2 * 4 * 32 * 64 * 16
    assert abs(cost.flops - expected) / expected < 1e-6
    _same_dots(_jax_flops(lambda x, y: jax.lax.dot_general(
        x, y, (((2,), (1,)), ((0,), (0,)))),
        jnp.zeros((4, 32, 64)), jnp.zeros((4, 64, 16))), cost.flops)


def test_bytes_floor():
    """Program must be charged at least its inputs+outputs once."""
    a = torch.zeros((1024, 1024))
    cost, _ = count(lambda x: x @ x, a)
    floor = 2 * 1024 * 1024 * 4
    assert cost.bytes >= floor


def test_dus_charged_by_slice():
    """Updating one row of a big buffer must not charge the whole buffer."""
    buf = torch.zeros((1024, 1024))
    row = torch.ones((1, 1024))

    def f(b, r, i):
        out = b.clone()                    # the functional update's copy
        for t in range(8):
            out[i + t:i + t + 1] = r
        return out

    cost, _ = count(f, buf, row, 3)
    # 8 updates of 4KB-row + buffer in/out(+copy slack) << 8 x 4MB
    assert cost.adjusted_bytes < 8 * 1024 * 1024 * 4 * 2


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_collective_parser_formats(fake_group):
    """The sample HLO's collectives, issued on a fake 4-rank group: an
    all-reduce of f32[4,4096], one all-reduce of a (f32[4,4096,48],
    f32[4,4096,16]) tuple, an all-gather to f32[4,4096,192], a
    collective-permute of f32[4,1,4096,16] and an all-reduce of f32[8,8]
    (the HLO's async start/done pair is one op)."""
    g = fake_group
    with OpCounter() as c:
        all_reduce(torch.zeros(4, 4096), g)
        dist.all_reduce_coalesced([torch.zeros(4, 4096, 48),
                                   torch.zeros(4, 4096, 16)], group=g)
        all_gather_cat(torch.zeros(4, 4096, 48), 2, g)
        ring_shift(torch.zeros(4, 1, 4096, 16), g)
        all_reduce(torch.zeros(8, 8), g)
    cb = collective_bytes(c.cost)
    assert cb["all-reduce"] == (4 * 4096 + 4 * 4096 * 48 + 4 * 4096 * 16
                                + 64) * 4
    assert cb["all-gather"] == 4 * 4096 * 192 * 4
    assert cb["collective-permute"] == 4 * 4096 * 16 * 4
    assert cb["count"] == 5           # 2 ar + ar-start + ag + cp


def test_parse_hlo_structure():
    """No HLO to parse: the counter sees a non-empty op stream."""
    cost, c = count(lambda x: torch.tanh(x @ x), torch.zeros((64, 64)))
    assert c.n_ops > 0 and cost.flops > 0
