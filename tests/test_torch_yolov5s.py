"""The published YOLOv5s v7.0 detector in the port (`core/cnn.py::yolov5s`)
and what it brought: the int8 SiLU table (`core/quantize.py::silu_table`,
`kernels/lut_int8.py`), the nearest upsample and the Detect pack, in the
oracle, both compiled backends, the partitioner, the megakernel planner
and the counters. CPU tests at a small size (width 0.25, 8 classes); the
`cuda`-marked test holds lut_int8 to its plain version on the card."""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import trace
from repro_torch.core import (cnn, execute_schedule, init_params,
                              reference_forward)
from repro_torch.core import compiled as C
from repro_torch.core import megakernel as MK
from repro_torch.core.graph import Graph, pack_rows, upsample
from repro_torch.core.mapping import map_reverse_affinity
from repro_torch.core.partition import Partitioner
from repro_torch.core.quantize import silu_table
from repro_torch.core.schedule import compute_schedule
from repro_torch.hw import scaled_paper_machine
from repro_torch.kernels import _lib, lut_int8, lut_int8_plain
from repro_torch.kernels.lut_int8 import lut_bytes
from repro_torch.serve import Server

SMALL = dict(num_classes=8, width=0.25)
SIZES = [64, 96]


def _frames(n, hw, seed=0):
    return np.random.default_rng(seed).integers(-128, 128, (n, hw, hw, 3),
                                                dtype=np.int8)


def test_the_published_graph_at_640():
    """60 convs (57 Conv blocks and the three Detect convs), 16.43 GOP and
    7,215,616 weights, as counted from yolov5s.yaml; one (25200, 85) int32
    output."""
    g = cnn.yolov5s()
    kinds = collections.Counter(op.kind for op in g.ops)
    assert kinds == {"conv2d": 60, "requant": 57, "silu": 57, "concat": 13,
                     "add": 7, "maxpool": 3, "upsample": 2, "pack": 1}
    assert sum(op.flops(g) for op in g.ops if op.kind == "conv2d") \
        == 16_433_561_600
    assert g.total_weight_bytes() == 7_215_616
    out = g.tensors[g.outputs[0]]
    assert out.shape == (25200, 85) and out.dtype == "int32"
    # the Detect convs carry no requant: their int32 maps feed the pack
    for i, hw in enumerate((80, 40, 20)):
        t = g.tensors[f"m24.m{i}.out"]
        assert t.shape == (hw, hw, 255) and t.dtype == "int32"
        assert [o.kind for o in g.consumers_of(t.name)] == ["pack"]
    # the backbone's C3s add their shortcut; the neck's do not
    adds = {op.name.split(".")[0] for op in g.ops if op.kind == "add"}
    assert adds == {"m2", "m4", "m6", "m8"}
    assert g.op("m0").attrs["padding"] == 2 and g.op("m0").attrs["kh"] == 6
    assert g.op("m9.cv1").attrs["C_out"] == 256
    assert g.tensors["m9.cat.out"].shape == (20, 20, 1024)


def test_silu_table_is_x_sigmoid_x_on_every_input():
    q = np.arange(-128, 128)
    for s_in, s_out in [(1 / 16, 1 / 16), (1 / 8, 1 / 32), (0.05, 0.1)]:
        x = torch.tensor(q * s_in, dtype=torch.float64)
        want = torch.clamp(torch.round(x * torch.sigmoid(x) / s_out),
                           -128, 127).numpy()
        t = silu_table(s_in, s_out)
        assert t.dtype == np.int8 and t.shape == (256,)
        assert np.array_equal(t, want)
    t = silu_table(1 / 16, 1 / 16)
    assert t[128] == 0 and t.min() == -4 and t.max() == 127


def test_upsample_and_pack_equal_plain_torch():
    rng = np.random.default_rng(1)
    g = Graph("t")
    g.add_tensor("a", (3, 5, 4), "int8", is_input=True)
    g.add_tensor("b", (2, 2, 6), "int32", is_input=True)
    g.add_tensor("c", (1, 3, 6), "int32", is_input=True)
    g.mark_output(upsample(g, "up", "a"))
    g.mark_output(pack_rows(g, "pk", ["b", "c"], 3))
    g.validate()
    ins = {"a": rng.integers(-128, 128, (3, 5, 4), dtype=np.int8),
           "b": rng.integers(-9999, 9999, (2, 2, 6), dtype=np.int32),
           "c": rng.integers(-9999, 9999, (1, 3, 6), dtype=np.int32)}
    a = torch.from_numpy(ins["a"]).permute(2, 0, 1)[None].float()
    up = torch.nn.functional.interpolate(a, scale_factor=2, mode="nearest")
    want_up = up[0].permute(1, 2, 0).to(torch.int8).numpy()
    # Ultralytics' Detect view: (bs, na, no, ny, nx) -> rows (y, x, anchor)
    want_pk = np.concatenate([
        torch.from_numpy(ins[k]).permute(2, 0, 1).reshape(2, 3, *ins[k]
                                                          .shape[:2])
        .permute(2, 3, 0, 1).reshape(-1, 3).numpy() for k in ("b", "c")])
    got = reference_forward(g, {}, ins)
    assert np.array_equal(got["up.out"], want_up)
    assert np.array_equal(got["pk.out"], want_pk)
    prog = C.compile_graph(g, {}, scaled_paper_machine(4))
    for run in (lambda: C.run_numpy(prog, ins),
                lambda: C.run_torch(prog, ins, batched=False, device="cpu")):
        out = run()
        assert np.array_equal(out["up.out"], want_up)
        assert np.array_equal(out["pk.out"], want_pk)


def test_lut_int8_plain_version_and_counters():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-128, 128, (3, 7, 5), dtype=np.int8))
    tab = torch.from_numpy(rng.integers(-128, 128, 256, dtype=np.int8))
    want = tab.numpy()[x.numpy().astype(np.int16) + 128]
    _lib.reset_launch_counts()
    assert np.array_equal(lut_int8(x, tab).numpy(), want)
    assert np.array_equal(lut_int8_plain(x, tab).numpy(), want)
    # the plain version counts no launch and no byte
    assert _lib.launch_counts()["lut_int8"] == 0
    assert _lib.byte_counts() == {"lut_int8": 0}
    assert lut_bytes(x.numel()) == 2 * 105 + 256
    with pytest.raises(TypeError):
        lut_int8(x.to(torch.int32), tab)
    with pytest.raises(ValueError):
        lut_int8(x, tab[:255])


@pytest.mark.parametrize("hw", SIZES)
def test_every_backend_equals_the_oracle(hw):
    """The oracle, the schedule's tile-by-tile replay, run_numpy, the
    torch backend, the per-op kernel path and the megakernel program (the
    kernels' plain versions on the CPU) agree bit for bit."""
    g = cnn.yolov5s(hw, hw, **SMALL)
    params = init_params(g, 0)
    x = _frames(2, hw)
    want = [reference_forward(g, params, {"input": f})[g.outputs[0]]
            for f in x]
    hwm = scaled_paper_machine(64)
    subtasks = Partitioner(hwm).partition(g)
    mapping = map_reverse_affinity(subtasks, hwm)
    sched = compute_schedule(subtasks, mapping, hwm)
    assert np.array_equal(execute_schedule(
        g, params, {"input": x[0]}, subtasks, mapping,
        sched)[g.outputs[0]], want[0])
    prog = C.compile_graph(g, params, hwm)
    assert np.array_equal(C.run_numpy(prog, {"input": x[1]})[g.outputs[0]],
                          want[1])
    for run in (C.run_torch, C.run_kernels, MK.run_megakernel):
        got = run(prog, {"input": x}, batched=True, device="cpu")
        assert np.array_equal(got[g.outputs[0]], np.stack(want)), run


def test_row_bands_of_upsample_and_pack_load_the_rows_they_read():
    """An upsample band loads its input rows halved; a pack band loads, of
    each Detect map, only the map rows whose pixels fill its output rows,
    so the schedule waits on those producers alone."""
    g = cnn.yolov5s(640, 640)
    part = Partitioner(scaled_paper_machine(64))
    for op in (g.op("m11"), g.op("m24.pack")):
        for st in part._tile_rows(g, op, 0):
            r0, r1 = st.tile["r0"], st.tile["r1"]
            if op.kind == "upsample":
                (ld,) = st.loads
                assert ld.region == ("rows", r0 // 2, (r1 - 1) // 2 + 1)
                continue
            off = 0
            want = []
            for t in op.inputs:
                H, W, Cc = g.tensors[t].shape
                n = H * W * 3
                a, b = max(r0, off), min(r1, off + n)
                if a < b:
                    want.append((t, ("rows", (a - off) // (W * 3),
                                     (b - 1 - off) // (W * 3) + 1)))
                off += n
            assert [(ld.tensor, ld.region) for ld in st.loads] == want
            assert st.working_set <= part.budget


def test_silu_and_k3less_kinds_stay_out_of_fused_segments():
    """The planner keeps every SiLU (lut_int8) and every upsample and pack
    (plain torch) outside the K3 segments, and the K1-K3 launches within
    the core count."""
    g = cnn.yolov5s(96, 96, **SMALL)
    prog = C.compile_graph(g, init_params(g, 0), scaled_paper_machine(64))
    segs = MK.plan_segments(prog)
    fused = [s.batch.kind for seg in segs if seg.kind == "fused"
             for s in seg.steps]
    assert not {"silu", "upsample", "pack"} & set(fused)
    lut = [seg for seg in segs if seg.kind == "outside"
           and seg.steps[0].mode == "lut"]
    assert len(lut) == 57
    assert sum(seg.emits_call for seg in segs) <= 64


def test_a_replayed_jobs_counts_carry_bytes_and_plain_kinds():
    """What a captured body counts (launches, lut_int8 bytes, plain steps
    by kind) comes off the counters at capture, and a replay adds it to
    the counters and the open serve.job."""
    trace.reset()
    _lib.reset_launch_counts()
    with trace.Tally() as t:
        _lib.count_launch("lut_int8")
        _lib.count_bytes("lut_int8", 1000)
        trace.plain_step("upsample")
        trace.plain_step("pack")
        trace.plain_step("upsample")
    assert t.launches == {"lut_int8": 1} and t.bytes == {"lut_int8": 1000}
    assert t.plain_steps == 3 and t.plain_kinds == {"upsample": 2, "pack": 1}
    assert _lib.launch_counts()["lut_int8"] == 0
    assert _lib.byte_counts()["lut_int8"] == 0
    trace.enable()
    try:
        with trace.span("serve.job", job=1, net="yolo") as job:
            _lib.add_launches(t.launches)
            _lib.add_bytes(t.bytes)
            trace.replayed(1, t.plain_steps, t.plain_kinds)
    finally:
        trace.disable()
    assert job.plain_kinds == {"upsample": 2, "pack": 1}
    assert job.asdict()["plain_kinds"] == {"upsample": 2, "pack": 1}
    assert job.launches == 1 and job.replayed == 1
    assert trace.plain_kinds() == {"upsample": 2, "pack": 1}
    assert _lib.byte_counts()["lut_int8"] == 1000
    _lib.reset_launch_counts()
    trace.reset()
    assert _lib.byte_counts()["lut_int8"] == 0 and trace.plain_kinds() == {}


def test_served_jobs_count_plain_steps_by_kind():
    """A job of the megakernel program on the CPU counts each upsample,
    pack, concat, add and max pool as a plain step of its kind."""
    g = cnn.yolov5s(64, 64, **SMALL)
    srv = Server(scaled_paper_machine(64), backend="cuda", device="cpu")
    srv.register("det", g, period_s=0.1, slots=2)
    trace.reset()
    trace.enable()
    try:
        ts = [srv.submit("det", f) for f in _frames(2, 64)]
        while not all(t.terminal for t in ts):
            srv.step()
    finally:
        trace.disable()
    (job,) = [r for r in trace.records() if r.name == "serve.job"]
    assert job.plain_kinds == {"upsample": 2, "pack": 1, "concat": 13,
                               "add": 7, "maxpool": 3}
    assert job.plain_steps == 26
    trace.reset()


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_server_serves_the_detector_bit_exact(backend):
    g = cnn.yolov5s(96, 96, **SMALL)
    params = init_params(g, 3)
    srv = Server(scaled_paper_machine(64), backend=backend, device="cpu")
    verdict = srv.register("det", g, period_s=0.1, deadline_s=0.1, slots=4,
                           params=params)
    assert verdict.schedulable
    x = _frames(5, 96, seed=4)
    ts = [srv.submit("det", f) for f in x]
    while not all(t.terminal for t in ts):
        srv.step()
    for t, f in zip(ts, x):
        want = reference_forward(g, params, {"input": f})[g.outputs[0]]
        assert np.array_equal(t.result().output[g.outputs[0]], want)


def test_deployment_round_trip_keeps_the_tables(tmp_path):
    g = cnn.yolov5s(64, 64, **SMALL)
    params = init_params(g, 5)
    dep = repro_torch.compile(g, scaled_paper_machine(64), backend="cuda",
                              params=params, device="cpu")
    path = tmp_path / "yolo.rtdep"
    dep.save(path)
    back = repro_torch.compiler.Deployment.load(path, device="cpu")
    x = _frames(1, 64, seed=6)[0]
    want = reference_forward(g, params, {"input": x})[g.outputs[0]]
    assert np.array_equal(back.run({"input": x})[g.outputs[0]], want)


@pytest.mark.cuda
def test_lut_int8_kernel_equals_its_plain_version():
    """On a GPU: lut_int8 at a YOLOv5s 640 SiLU's size and at odd sizes
    and offsets (the one-byte loop) equals its plain version, and counts
    one launch and `lut_bytes` bytes a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    g = torch.Generator("cuda").manual_seed(0)
    for n in (1, 17, 4101, 8 * 160 * 160 * 64):
        x = torch.randint(-128, 128, (n + 1,), generator=g, device="cuda",
                          dtype=torch.int8)
        tab = torch.randint(-128, 128, (256,), generator=g, device="cuda",
                            dtype=torch.int8)
        for xs in (x[:n], x[1:]):
            _lib.reset_launch_counts()
            y = lut_int8(xs, tab)
            torch.cuda.synchronize()
            assert torch.equal(y.cpu(), lut_int8_plain(xs.cpu(), tab.cpu()))
            assert _lib.launch_counts()["lut_int8"] == 1
            assert _lib.byte_counts()["lut_int8"] == lut_bytes(n)
