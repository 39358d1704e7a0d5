"""CPU tests of the YOLOv5s cell's plain reference, its driver and its
reader: at a reduced size the reference agrees with the port run on the
CPU, it imports nothing of the port, it counts the published network's
operations and weights, the control (int4 weights) reads far from the
program, a run whose timed path is broken underneath comes out not
correct, the driver keeps no more answers than it checks, and the SiLU
roofline reads the port's byte counter."""

from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

import control  # noqa: E402
import run as R  # noqa: E402
from harness import cnn_sampled, weights  # noqa: E402

CELL = "yolov5s-640-int8.rig8-b8"
SMALL = {"num_classes": 8, "width": 0.25}
SEED = 2 ** 31 + 4343


def ref():
    return R.load_file(BENCH / "configs" / "ref_yolov5s_int8.py",
                       "bench_ref_ref_yolov5s_int8")


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse((BENCH / "configs" / "ref_yolov5s_int8.py")
                     .read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods <= {"__future__", "math", "numpy", "torch"}
    r = ref()
    import torch
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    # the table by the reference's own formula equals the port's
    from repro_torch.core.quantize import silu_table
    assert np.array_equal(r.silu_table().numpy(),
                          silu_table(r.SILU_SCALE, r.SILU_SCALE))


@pytest.mark.parametrize("hw", [64, 96])
def test_reference_equals_the_ports(hw):
    """The reference against the port's oracle and its compiled CPU
    program (the cuda backend's megakernel plan on the kernels' plain
    versions), bit for bit, on the harness's weights."""
    import repro_torch
    from repro_torch.core import cnn
    from repro_torch.core.executor import reference_forward
    from repro_torch.hw import scaled_paper_machine
    r = ref()
    args = dict(h=hw, w=hw, **SMALL)
    net = r.layers(**args)
    params = weights.cnn_params(r.weight_specs(net), SEED, "cpu")
    g = cnn.yolov5s(**args)
    assert set(params) == cnn_sampled.expected_names(g)
    x = np.random.default_rng(0).integers(-128, 128, (3, hw, hw, 3),
                                          dtype=np.int8)
    got = r.forward(net, params, x)
    dep = repro_torch.compile(g, scaled_paper_machine(64), backend="cuda",
                              params=params, device="cpu")
    served = dep.run({"input": x}, batched=True)[g.outputs[0]]
    for b in range(3):
        want = reference_forward(g, params, {"input": x[b]})[g.outputs[0]]
        assert np.array_equal(got[b], want.reshape(-1))
        assert np.array_equal(served[b], want)
    assert got.dtype == np.int32 and got.shape == (3, want.size)


def test_reference_counts_the_published_network():
    """At 640 x 640 with 80 classes: the conv operations the graph counts
    (16.43 GOP), its weights (7,215,616), and the SiLU bytes of a batch-8
    job as the port's byte counter adds them up."""
    from repro_torch.core import cnn
    from repro_torch.kernels.lut_int8 import lut_bytes
    r = ref()
    net, g = r.layers(), cnn.yolov5s()
    ops = sum(2 * s["M"] * s["K"] * s["N"] for s in r.conv_shapes(net))
    assert ops == sum(op.flops(g) for op in g.ops if op.kind == "conv2d") \
        == 16_433_561_600
    assert sum(np.prod(s[0]) for s in r.weight_specs(net).values()
               if s[1] == "w") == g.total_weight_bytes() == 7_215_616
    assert r.silu_bytes(net, 8) == sum(
        lut_bytes(8 * g.tensors[op.outputs[0]].size) for op in g.ops
        if op.kind == "silu")


def _spec(**mix):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = R.cell_spec(bench, CELL)
    spec["config"]["graph"]["args"] = dict(h=64, w=64, **SMALL)
    spec["mix"].update(mix)
    return spec


def test_the_cell_takes_its_metrics():
    spec = _spec()
    assert {m["name"] for m in spec["e2e"]} == {"frames_per_s", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == {
        "silu_roofline.y8", "conv_roofline.y8", "device_idle.y8",
        "job_ms.y8", "mfu.y8"}
    assert spec["config"]["system"] == "cnn_sampled"


def test_control_reads_far_from_the_program():
    """The control at a test's size: the reference with int4 weights, on
    the program's own sample, is off where the program is exact."""
    out = R.run_cell(_spec(), seed=SEED, seconds=0.5, trace=False,
                     device="cpu")
    assert out["correct"] and control.control_reading(out) > 0


def _alter_one_answer(srv):
    st = srv._nets["cnn"]
    runner = st.runner

    def broken(batch):
        out = runner(batch)
        return {k: np.where(np.arange(v.shape[0])[:, None, None] == 0,
                            v + 1, v) for k, v in out.items()}
    st.runner = broken


def _drop_half_the_batch(srv):
    st = srv._nets["cnn"]
    runner = st.runner

    def broken(batch):
        out = runner({k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return {k: np.concatenate([v, v]) for k, v in out.items()}
    st.runner = broken


def _repeat_the_first_answer(srv):
    st = srv._nets["cnn"]
    runner = st.runner
    first = []

    def broken(batch):
        out = runner(batch)
        if not first:
            first.append(out)
        return first[0]
    st.runner = broken


def _zero_the_smallest_map(srv):
    """The stride-32 head's rows (the pack's last) read zero."""
    st = srv._nets["cnn"]
    runner = st.runner

    def broken(batch):
        out = runner(batch)
        for v in out.values():
            v[:, -12:] = 0
        return out
    st.runner = broken


@pytest.mark.parametrize("fault", [_alter_one_answer, _drop_half_the_batch,
                                   _repeat_the_first_answer,
                                   _zero_the_smallest_map])
def test_a_broken_timed_path_is_not_correct(fault):
    spec = _spec(check=64)
    out = R.run_cell(spec, seed=SEED, seconds=2.0, trace=False,
                     device="cpu", fault=fault)
    assert out["correct"] is False
    out = R.run_cell(spec, seed=SEED, seconds=2.0, trace=False,
                     device="cpu", fault=None)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("name", ["m11", "m22"])
def test_a_broken_neck_is_not_correct(monkeypatch, name):
    """A fault inside the served graph's neck, not at its outputs: the
    m11 upsample (P5 to P4) or the m22 concat (the P5 head's input) one
    row off. The check reads the deep half on activations that keep their
    spread, so either reads not correct."""
    import torch
    from repro_torch.core import compiled as C
    op, hit = C._torch_op, []

    def broken(b, vals, prog, consts):
        out = op(b, vals, prog, consts)
        if b.name != name:
            return out
        hit.append(b.name)
        return torch.roll(out, 1, dims=1)
    monkeypatch.setattr(C, "_torch_op", broken)
    out = R.run_cell(_spec(check=64), seed=SEED, seconds=1.0, trace=False,
                     device="cpu")
    assert hit and out["correct"] is False


def test_the_driver_keeps_only_the_answers_it_checks(monkeypatch):
    """Of a window's answers the driver holds at most `check` at once, and
    the one offered: a served ticket's answer is gone unless the
    reservoir took it."""
    import weakref
    refs = []
    offer = cnn_sampled.Reservoir.offer

    def root(a):
        while isinstance(a.base, np.ndarray):
            a = a.base
        return a

    def spy(self, item):
        refs.append(weakref.ref(root(item[1])))
        alive = {id(r()) for r in refs if r() is not None}
        assert len(alive) <= self.k + 1
        offer(self, item)
    monkeypatch.setattr(cnn_sampled.Reservoir, "offer", spy)
    out = R.run_cell(_spec(check=4, slots=1), seed=SEED, seconds=1.5,
                     trace=False, device="cpu")
    assert out["correct"] and len(refs) > 8
    assert len(out["sample"]["got"]) == 4


def test_the_reservoir_samples_uniformly():
    counts = np.zeros(50)
    for s in range(2000):
        res = cnn_sampled.Reservoir(5, np.random.default_rng(s))
        for i in range(50):
            res.offer(i)
        assert len(set(res.items)) == 5
        counts[res.items] += 1
    # each of 50 items is taken with probability 1/10
    assert np.abs(counts / 2000 - 0.1).max() < 0.03


def test_silu_roofline_reads_the_byte_counter():
    """The reader divides the record's bytes a launch (the port's byte
    counter at the window's close) over 3.35 TB/s by the traced time; it
    reads no process state, and nothing where the program has no counter
    or launched no lut_int8."""
    read = R.reader("silu_roofline.y8").read
    rec = {"kind": "cnn", "launches": {"lut_int8": 4},
           "lut_bytes": 4 * 33_500_000, "trace": {"kernels": {
               "lut_int8_kernel": [10, 2e-4], "conv2d_int8_kernel": [5, 1.0]}}}
    # 33.5 MB a launch is 10 us at 3.35 TB/s; 10 launches in 200 us
    assert read(rec) == pytest.approx(50.0)
    assert read({**rec, "trace": None}) is None
    assert read({**rec, "launches": {"lut_int8": 0}}) is None
    assert read({**rec, "lut_bytes": None}) is None   # no byte counter
    assert read({**rec, "launches": {}}) is None      # no such kernel
    # the driver puts the port's counter into the record
    out = R.run_cell(_spec(), seed=SEED, seconds=0.5, trace=False,
                     device="cpu")
    r = out["rec"]
    # on the CPU the wrapper takes its plain version: no launch, no bytes
    assert r["launches"]["lut_int8"] == 0 and r["lut_bytes"] == 0
    assert read({**r, "trace": rec["trace"]}) is None
