"""Property twins (hypothesis) of `tests/test_partition_properties.py`: the
port's partitioner against the JAX package's on random GEMM and conv
shapes. The subtasks must be identical in both packages, and the port's
must tile the output exactly and keep the raw transfer within im2col's.
`max_examples` stays modest: every example runs twice.
"""

from __future__ import annotations

import types

import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")

import hypothesis.strategies as st          # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402

import repro.core.graph as rgraph           # noqa: E402
import repro.core.partition as rpartition   # noqa: E402
import repro.hw as rhw                      # noqa: E402
import repro_torch.core.graph as tgraph     # noqa: E402
import repro_torch.core.partition as tpartition  # noqa: E402
import repro_torch.hw as thw                # noqa: E402

PKGS = (types.SimpleNamespace(graph=rgraph, part=rpartition, hw=rhw),
        types.SimpleNamespace(graph=tgraph, part=tpartition, hw=thw))
QUICK = dict(deadline=None, suppress_health_check=[HealthCheck.too_slow])


@st.composite
def gemm_shape(draw):
    return (draw(st.sampled_from([1, 7, 64, 300, 1024])),
            draw(st.sampled_from([16, 147, 576, 4608])),
            draw(st.sampled_from([8, 64, 100, 512])))


@settings(max_examples=12, **QUICK)
@given(shape=gemm_shape(), cores=st.sampled_from([2, 16]),
       spad=st.sampled_from([256 * 1024, 1024 * 1024]))
def test_gemm_tiles_cover_output_exactly(shape, cores, spad):
    M, K, N = shape
    out = []
    for P in PKGS:
        g = P.graph.Graph("g")
        g.add_tensor("x", (M, K), "int8", is_input=True)
        g.mark_output(P.graph.linear(g, "fc", "x", N))
        hw = P.hw.scaled_paper_machine(cores, scratchpad_bytes=spad)
        part = P.part.Partitioner(hw)
        subtasks = part.partition(g)
        rows: dict = {}
        for stk in subtasks:
            t = stk.tile
            assert stk.working_set <= part.budget
            assert t["K"] == K
            for m in range(t["m0"], t["m1"]):
                rows.setdefault(m, []).append((t["n0"], t["n1"]))
        assert set(rows) == set(range(M))
        for m, spans in rows.items():
            spans.sort()
            assert spans[0][0] == 0 and spans[-1][1] == N
            for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
                assert a1 == b0, f"gap/overlap at row {m}: {spans}"
        total = sum(stk.flops for stk in subtasks)
        assert abs(total - 2.0 * M * K * N) / (2.0 * M * K * N) < 1e-9
        out.append([repr(s) for s in subtasks])
    assert out[0] == out[1]


@settings(max_examples=8, **QUICK)
@given(hw_cores=st.sampled_from([4, 16]), c_in=st.sampled_from([3, 16, 64]),
       c_out=st.sampled_from([8, 32, 64]), k=st.sampled_from([1, 3, 5]),
       stride=st.sampled_from([1, 2]))
def test_conv_raw_transfer_never_exceeds_im2col(hw_cores, c_in, c_out, k,
                                                stride):
    out = []
    for P in PKGS:
        g = P.graph.Graph("g")
        g.add_tensor("x", (24, 24, c_in), "int8", is_input=True)
        g.mark_output(P.graph.conv2d(g, "c", "x", c_out, k, stride=stride))
        subtasks = P.part.Partitioner(
            P.hw.scaled_paper_machine(hw_cores)).partition(g)
        for stk in subtasks:
            for ld in stk.loads:
                if ld.kind == "act" and k > 1:
                    assert ld.nbytes <= ld.sp_bytes * k
        total = sum(stk.flops for stk in subtasks)
        oh = (24 + 2 * (k // 2) - k) // stride + 1
        expect = 2.0 * oh * oh * k * k * c_in * c_out
        assert abs(total - expect) / expect < 1e-6
        out.append([repr(s) for s in subtasks])
    assert out[0] == out[1]
