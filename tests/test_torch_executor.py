"""The port's schedule replay against the JAX package's: a twin of each
test of `tests/test_executor.py`.

The twins run the same network, parameters and frame through both
packages' `execute_schedule` (and the port's through its own schedule)
and require equal outputs, bit for bit, and equal to the JAX package's
`reference_forward`.
"""

import numpy as np
import pytest

import repro.core as R
import repro.core.executor as RE
import repro.hw as RH
import repro_torch.core as T
import repro_torch.core.executor as TE
import repro_torch.hw as TH
from repro.core.mapping import map_round_robin as r_round_robin
from repro.core.partition import Partitioner as RPartitioner
from repro.core.schedule import compute_schedule as r_compute
from repro_torch.core.mapping import map_round_robin as t_round_robin
from repro_torch.core.partition import Partitioner as TPartitioner
from repro_torch.core.schedule import compute_schedule as t_compute


def _frame(seed, shape):
    return np.random.default_rng(seed).integers(
        -64, 64, size=shape).astype(np.int8)


def _replay_both(make_graph, cores, pseed, x, **kw):
    """The graph's schedule replayed in both packages, beside the JAX
    package's whole-graph oracle: (reference, jax replay, port replay)."""
    outs = []
    for core, hw in ((R, RH), (T, TH)):
        g = make_graph(core.cnn)
        rep, sched, subtasks, mapping = core.analyze(
            g, hw.scaled_paper_machine(cores), num_cores=cores, **kw)
        params = core.init_params(g, seed=pseed)
        outs.append(core.execute_schedule(g, params, {"input": x}, subtasks,
                                          mapping, sched))
    g = make_graph(R.cnn)
    ref = R.reference_forward(g, R.init_params(g, seed=pseed), {"input": x})
    return g, ref, outs[0], outs[1]


def _assert_all_equal(g, ref, rout, tout):
    for t in g.outputs:
        assert np.array_equal(ref[t], tout[t])
        assert np.array_equal(rout[t], tout[t])


@pytest.mark.parametrize("cores", [1, 3, 8])
def test_small_cnn_bit_exact(cores):
    _assert_all_equal(*_replay_both(lambda c: c.small_cnn(), cores, 1,
                                    _frame(2, (32, 32, 3))))


def test_round_robin_mapping_also_exact():
    x = _frame(4, (24, 24, 3))
    outs = []
    for core, hw, part, rr, comp in (
            (R, RH, RPartitioner, r_round_robin, r_compute),
            (T, TH, TPartitioner, t_round_robin, t_compute)):
        g = core.cnn.small_cnn(h=24, w=24)
        m = hw.scaled_paper_machine(4)
        subtasks = part(m).partition(g)
        mapping = rr(subtasks, m)
        sched = comp(subtasks, mapping, m)
        params = core.init_params(g, seed=3)
        outs.append((dict(mapping.core_of), core.execute_schedule(
            g, params, {"input": x}, subtasks, mapping, sched)))
    assert outs[0][0] == outs[1][0]
    g = R.cnn.small_cnn(h=24, w=24)
    ref = R.reference_forward(g, R.init_params(g, seed=3), {"input": x})
    _assert_all_equal(g, ref, outs[0][1], outs[1][1])


def test_yolo_reduced_graph_builds_and_schedules():
    def make(c):
        return c.yolov5s_backbone(h=64, w=64, width=0.25)
    reps = [core.analyze(make(core.cnn), hw.scaled_paper_machine(4),
                         num_cores=4)[0] for core, hw in ((R, RH), (T, TH))]
    assert reps[1].wcet_total_s == reps[0].wcet_total_s > 0
    _assert_all_equal(*_replay_both(make, 4, 5, _frame(6, (64, 64, 3))))


def test_replay_band_expansion_regression_16_cores():
    """The port's replay expands only a tile's own input band: full-width
    ResNet50 at 160 x 160 on 16 cores, bit-exact against the JAX
    package's oracle (the case that caught the seed's whole-op cache)."""
    x = _frame(8, (160, 160, 3))
    g = T.cnn.resnet50(h=160, w=160, width=1.0)
    rep, sched, subtasks, mapping = T.analyze(
        g, TH.scaled_paper_machine(16), num_cores=16, validate=False)
    params = T.init_params(g, seed=7)
    out = T.execute_schedule(g, params, {"input": x}, subtasks, mapping,
                             sched)
    rg = R.cnn.resnet50(h=160, w=160, width=1.0)
    ref = R.reference_forward(rg, R.init_params(rg, seed=7), {"input": x})
    for t in g.outputs:
        assert np.array_equal(ref[t], out[t])


@pytest.mark.parametrize("shape,kh,kw,stride,pad",
                         [((8, 8, 3), 3, 3, 1, 1),
                          ((9, 7, 2), 3, 3, 2, 0),
                          ((16, 16, 4), 5, 5, 2, 2),
                          ((7, 7, 1), 1, 1, 1, 0),
                          ((12, 10, 3), 7, 7, 2, 3),
                          ((6, 6, 2), 2, 3, 1, 1)])
def test_im2col_vectorized_matches_reference(shape, kh, kw, stride, pad):
    x = np.random.default_rng(0).integers(
        -128, 128, size=shape).astype(np.int8)
    got = TE.im2col(x, kh, kw, stride, pad)
    assert np.array_equal(got, TE.im2col_reference(x, kh, kw, stride, pad))
    assert np.array_equal(got, RE.im2col(x, kh, kw, stride, pad))


def test_execute_schedule_setup_is_hoisted():
    g = T.cnn.small_cnn()
    rep, sched, subtasks, mapping = T.analyze(g, TH.scaled_paper_machine(3),
                                              num_cores=3)
    params = T.init_params(g, seed=1)
    rng = np.random.default_rng(2)
    x1 = rng.integers(-64, 64, size=(32, 32, 3)).astype(np.int8)
    x2 = rng.integers(-64, 64, size=(32, 32, 3)).astype(np.int8)
    out1 = T.execute_schedule(g, params, {"input": x1}, subtasks, mapping,
                              sched)
    rp = TE._REPLAYERS.get(sched)
    assert rp is not None
    out2 = T.execute_schedule(g, params, {"input": x2}, subtasks, mapping,
                              sched)
    assert TE._REPLAYERS.get(sched) is rp
    rg = R.cnn.small_cnn()
    rparams = R.init_params(rg, seed=1)
    for x, out in ((x1, out1), (x2, out2)):
        ref = R.reference_forward(rg, rparams, {"input": x})
        for t in g.outputs:
            assert np.array_equal(ref[t], out[t])


def test_resnet50_reduced_bit_exact():
    _assert_all_equal(*_replay_both(
        lambda c: c.resnet50(h=32, w=32, width=0.25, blocks=(1, 1, 1, 1),
                             num_classes=16), 4, 7, _frame(8, (32, 32, 3))))
