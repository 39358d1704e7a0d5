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
from repro_torch.kernels.conv2d_im2col import TILE_M, TILE_N, conv_splits

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


def _lowered(build, cores, seed):
    """(reference, port) programs of the graph `build(core)` on
    scaled_paper_machine(cores)."""
    progs = []
    for core, hw in ((R, RH), (T, TH)):
        g = build(core)
        m = hw.scaled_paper_machine(cores)
        rep, sched, subtasks, mapping = core.analyze(g, m, num_cores=cores)
        params = core.init_params(g, seed=seed)
        progs.append(core.lower_program(g, params, subtasks, mapping, sched,
                                        hw=m))
    return progs


def test_mixed_step_kinds_bit_exact_and_tabled():
    import jax.numpy as jnp
    xb = np.random.default_rng(9).integers(-128, 128,
                                           (2, 20, 20, 8)).astype(np.int8)
    rprog, tprog = _lowered(_mixed, 2, 4)
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


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_mixed_split_steps_never_share_the_region_unbarriered(batch):
    """K3's conv and gemm rows of the mixed segment split K at launch by
    K2's rule, and all of them use one partial region in turn: every conv
    and gemm row carries a grid barrier, so no two split rows meet without
    one between them, and the region holds the largest split row's
    partial tiles and counters."""
    _, tprog = _lowered(_mixed, 2, 4)
    consts = TC.device_consts(tprog, CPU)
    n_split = 0
    for seg in TMK.plan_segments(tprog):
        if seg.kind != "fused":
            continue
        tab = TMK.build_segment_table(tprog, seg, consts, CPU)
        table = tab.table
        splits, n_ws, n_cnt = TMK.split_plan(tab, batch, 132)
        assert sorted(splits) == [row for row, *_ in tab.mm]
        for row, m, n, k in tab.mm:
            assert table[row, TMK.F_KIND] in (TMK.KIND["gemm"],
                                              TMK.KIND["conv2d"])
            assert table[row, TMK.F_BARRIER] == 1
            assert splits[row] == conv_splits(batch * m, n, k)
        rows = [r for r, S in sorted(splits.items()) if S > 1]
        for i, j in zip(rows, rows[1:]):
            assert any(table[r, TMK.F_BARRIER] for r in range(i, j))
        need = [(-(-batch * m // TILE_M) * -(-n // TILE_N), splits[row])
                for row, m, n, k in tab.mm if splits[row] > 1]
        assert n_ws == max([t * S * TILE_M * TILE_N for t, S in need],
                           default=0)
        assert n_cnt == max([t for t, _ in need], default=0)
        n_split += len(rows)
    assert n_split >= (2 if batch <= 2 else 1)


@pytest.fixture(scope="module")
def path_tables():
    """The fused segments of ResNet50-224 on scaled_paper_machine(64) (the
    port's main path) with their K3 step tables, built on the CPU."""
    import repro_torch
    g = T.cnn.resnet50()
    dep = repro_torch.compile(g, TH.scaled_paper_machine(64), backend="cuda",
                              params=T.init_params(g, seed=0), device="cpu")
    prog = dep.program
    consts = TC.device_consts(prog, CPU)
    return [(seg, TMK.build_segment_table(prog, seg, consts, CPU))
            for seg in TMK.plan_segments(prog) if seg.kind == "fused"]


@pytest.mark.parametrize("batch,splits", [(1, 6), (8, 1)])
def test_path_segments_split_as_k2_splits_the_conv(path_tables, batch,
                                                   splits):
    """Each of the path's three fused segments is one 3x3 conv row,
    28x28x128 -> 128 (784 rows per sample, K 1152, N 128), with no barrier
    run; the kernel splits it 6 ways at batch 1 (26 tiles x 6 = 156 work
    items) and not at batch 8 (196 tiles), as K2 splits the same conv."""
    assert [[s.batch.name for s in seg.steps] for seg, _ in path_tables] \
        == [["s1.b1.c2"], ["s1.b2.c2"], ["s1.b3.c2"]]
    for _, tab in path_tables:
        assert tab.n_rows == 1 and tab.mm == [(0, 784, 128, 1152)]
        assert tab.table[0, TMK.F_KIND] == TMK.KIND["conv2d"]
        S, n_ws, n_cnt = TMK.split_plan(tab, batch, 132)
        assert S == {0: splits} == {0: conv_splits(batch * 784, 128, 1152)}
        tiles = -(-batch * 784 // TILE_M) * 2
        assert tiles * splits >= 132
        assert (n_ws, n_cnt) == ((tiles * splits * TILE_M * TILE_N, tiles)
                                 if splits > 1 else (0, 0))


def _path_segment(core):
    """One 3x3 conv with C 128 -> 128 and its requant, the shape of the
    path's fused segments on a small map."""
    from importlib import import_module
    gm = import_module(core.__name__ + ".graph")
    g = gm.Graph("path_segment")
    g.add_tensor("input", (6, 6, 128), "int8", is_input=True)
    g.mark_output(gm.requant(g, "c.rq", gm.conv2d(g, "c", "input", 128, 3)))
    g.validate()
    return g


@pytest.mark.parametrize("batch", [1, 3])
def test_path_shaped_segment_plain_bit_exact_vs_jax(batch):
    """K3's plain version on a fused segment of one 3x3 conv (C 128, the
    requant fused) against the reference's megakernel in interpret mode."""
    import jax.numpy as jnp
    rprog, tprog = _lowered(_path_segment, 4, 3)
    segs = TMK.plan_segments(tprog)
    assert [(s.kind, [st.mode for st in s.steps]) for s in segs] == \
        [("fused", ["conv2d"])]
    assert segs[0].steps[0].mult is not None
    xb = np.random.default_rng(11).integers(
        -128, 128, (batch, 6, 6, 128)).astype(np.int8)
    want = RMK.megakernel_batched(rprog, interpret=True)(
        {"input": jnp.asarray(xb)})
    got = TMK.run_megakernel(tprog, {"input": xb}, batched=True,
                             device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype
        assert np.array_equal(got[k], np.asarray(want[k]))
