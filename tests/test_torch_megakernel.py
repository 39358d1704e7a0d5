"""The port's megakernel against the JAX package's.

The segment planner is a copy, so its plans must be IDENTICAL to the
reference's on every preset and option set (the port calls the plain-torch
fallback mode "torch" where the reference says "jax"). K3's plain version
(the path the "cuda" backend takes for CPU tensors) must be bit-exact
(`np.array_equal`: integer arithmetic throughout) against the reference's
`megakernel_batched` in Pallas interpret mode, and the launch invariant —
at most `num_cores` (or `max_kernels`) launches per program — holds on the
calls of the kernel wrappers.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import repro.core as R
import repro.hw as RH
import repro_torch.core as T
import repro_torch.hw as TH
from repro.core import megakernel as RMK
from repro_torch.core import compiled as TC
from repro_torch.core import megakernel as TMK
from repro_torch.kernels import launch_counts, reset_launch_counts

PRESETS = {
    "small_cnn": (lambda m: m.cnn.small_cnn(), (32, 32, 3)),
    "resnet50": (lambda m: m.cnn.resnet50(h=32, w=32, width=0.25,
                                          blocks=(1, 1, 1, 1),
                                          num_classes=16), (32, 32, 3)),
    "yolov5s": (lambda m: m.cnn.yolov5s_backbone(h=64, w=64, width=0.25),
                (64, 64, 3)),
}
CPU = torch.device("cpu")


def _programs(preset, cores=4, seed=1):
    out = []
    for core, hw in ((R, RH), (T, TH)):
        g = PRESETS[preset][0](core)
        m = hw.scaled_paper_machine(cores)
        rep, sched, subtasks, mapping = core.analyze(g, m, num_cores=cores)
        params = core.init_params(g, seed=seed)
        out.append(core.lower_program(g, params, subtasks, mapping, sched,
                                      hw=m))
    return out


def _plan_key(segments):
    mode = {"jax": "torch"}
    return [(s.kind, s.core, [(st.batch.name, mode.get(st.mode, st.mode),
                               st.out_idx, st.blocks,
                               None if st.mult is None
                               else np.asarray(st.mult).tolist())
                              for st in s.steps])
            for s in segments]


OPTION_SETS = [{}, {"budget": 64 * 1024}, {"budget": 4096},
               {"max_kernels": 1}, {"max_kernels": 2},
               {"budget": 1 << 22, "max_kernels": 3}]


@pytest.mark.parametrize("cores", [1, 4, 16])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_plan_segments_identical(preset, cores):
    rprog, tprog = _programs(preset, cores)
    for kw in OPTION_SETS:
        r = RMK.plan_segments(rprog, **kw)
        t = TMK.plan_segments(tprog, **kw)
        assert _plan_key(r) == _plan_key(t), kw
        for rs, ts in zip(r, t):
            if rs.kind == "fused":
                assert (RMK.segment_footprint(rprog, rs)
                        == TMK.segment_footprint(tprog, ts))
                assert RMK.segment_io(rprog, rs) == TMK.segment_io(tprog, ts)


@pytest.fixture(scope="module")
def jax_outputs():
    """The reference's megakernel (interpret mode, vmapped) per preset and
    option set, on one batch of 3 inputs."""
    import jax.numpy as jnp
    cache = {}

    def get(preset, kw):
        key = (preset, tuple(sorted(kw.items())))
        if key not in cache:
            rprog, _ = _programs(preset)
            shape = PRESETS[preset][1]
            xb = np.random.default_rng(5).integers(
                -64, 64, size=(3,) + shape).astype(np.int8)
            fn = RMK.megakernel_batched(rprog, interpret=True, **kw)
            out = fn({"input": jnp.asarray(xb)})
            cache[key] = xb, {k: np.asarray(v) for k, v in out.items()}
        return cache[key]
    return get


@pytest.mark.parametrize("kw", [{}, {"budget": 64 * 1024},
                                {"max_kernels": 1}],
                         ids=["default", "budget64k", "one-kernel"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_megakernel_plain_bit_exact_vs_jax(preset, kw, jax_outputs):
    xb, want = jax_outputs(preset, kw)
    _, tprog = _programs(preset)
    got = TMK.run_megakernel(tprog, {"input": xb}, batched=True,
                             device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("kw", [{}, {"budget": 64 * 1024},
                                {"max_kernels": 1}, {"max_kernels": 2}])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_launch_invariant_on_counters(preset, kw, monkeypatch):
    """Calls of the kernel wrappers (each one launch on the card; on the
    CPU the plain version, which the launch counters do not count) per
    program: exactly the plan's kernel-emitting segments, at most the cap,
    and fewer than the per-op path's."""
    spies = []
    for mod, name in ((TMK, "run_fused"), (TC, "gemm_int8"),
                      (TC, "conv2d_int8")):
        spies.append(mock.Mock(wraps=getattr(mod, name)))
        monkeypatch.setattr(mod, name, spies[-1])

    def wrapper_calls():
        n_ = sum(s.call_count for s in spies)
        for s in spies:
            s.reset_mock()
        return n_

    _, tprog = _programs(preset)
    fn = TMK.megakernel_batched(tprog, "cpu", **kw)
    x = torch.zeros((2,) + PRESETS[preset][1], dtype=torch.int8)
    reset_launch_counts()
    wrapper_calls()
    fn({"input": x})
    n = wrapper_calls()
    segments = TMK.plan_segments(tprog, **kw)
    assert n == sum(s.emits_call for s in segments)
    assert 1 <= n <= kw.get("max_kernels", tprog.num_cores)
    TC.kernel_batched(tprog, "cpu")({"input": x})
    n_perop = wrapper_calls()
    if preset == "resnet50":
        assert n <= tprog.num_cores < n_perop
    assert sum(launch_counts().values()) == 0


def test_segment_cores_round_robin():
    _, tprog = _programs("resnet50")
    segments = [s for s in TMK.plan_segments(tprog) if s.emits_call]
    assert [s.core for s in segments] == [i % 4 for i in
                                          range(len(segments))]


def _mixed(core):
    """Every K3 step kind in one segment: gemm, conv, standalone requant
    (the accumulators are also graph outputs), relu, int8 and int32 add,
    max and avg pool, gap, concat."""
    from importlib import import_module
    gm = import_module(core.__name__ + ".graph")
    g = gm.Graph("mixed")
    g.add_tensor("input", (20, 20, 8), "int8", is_input=True)
    y = gm.conv2d(g, "c1", "input", 16, 3)
    g.mark_output(y)
    yq = gm.requant(g, "c1.rq", y)
    p = gm.pool2d(g, "ap", "avgpool", yq, 3, 1, padding=1)
    z = gm.conv2d(g, "c2", p, 16, 3, stride=2)
    zq = gm.requant(g, "c2.rq", z)
    a = gm.pool2d(g, "mp", "maxpool", yq, 2, 2)
    s = gm.eltwise(g, "add", "add", [zq, a])
    g.mark_output(gm.eltwise(g, "add32", "add", [z, z]))
    r = gm.eltwise(g, "relu", "relu", [s])
    c = core.cnn.concat(g, "cat", [r, a])
    g.mark_output(gm.linear(g, "fc", gm.global_avg_pool(g, "gap", c), 10))
    g.validate()
    return g


def test_mixed_step_kinds_bit_exact_and_tabled():
    import jax.numpy as jnp
    xb = np.random.default_rng(9).integers(-128, 128,
                                           (2, 20, 20, 8)).astype(np.int8)
    progs = []
    for core, hw in ((R, RH), (T, TH)):
        g = _mixed(core)
        m = hw.scaled_paper_machine(2)
        rep, sched, subtasks, mapping = core.analyze(g, m, num_cores=2)
        params = core.init_params(g, seed=4)
        progs.append(core.lower_program(g, params, subtasks, mapping, sched,
                                        hw=m))
    rprog, tprog = progs
    want = RMK.megakernel_batched(rprog, interpret=True)(
        {"input": jnp.asarray(xb)})
    got = TMK.run_megakernel(tprog, {"input": xb}, batched=True,
                             device="cpu")
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k]))
    # the K3 step table holds every step kind, with the concat split into
    # one channel copy per input
    consts = TC.device_consts(tprog, CPU)
    kinds = set()
    for seg in TMK.plan_segments(tprog):
        if seg.kind == "fused":
            tab = TMK.build_segment_table(tprog, seg, consts, CPU)
            assert tab.table.shape == (tab.n_rows, TMK.ROW)
            kinds |= set(tab.table[:, TMK.F_KIND].tolist())
    assert kinds == set(TMK.KIND.values())
