"""The port's compiled-program backends against the JAX package's.

`numpy`, `torch` and `cuda` (on the CPU: the kernels' plain versions, with
the megakernel on and off) must be bit-exact (`np.array_equal`: integer
arithmetic throughout, and the same float32 round-half-even requant)
against the reference's `jax` backend and `reference_forward` on the three
CNN presets at batch 1 and 8. Lowering structure and the kernel plan
(epilogue fusion, fallback kinds, block metadata) are the reference's.
"""

import numpy as np
import pytest
import torch

import repro
import repro.core as R
import repro.hw as RH
import repro_torch
import repro_torch.core as T
import repro_torch.hw as TH
from repro.core import compiled as RC
from repro_torch.compiler import BackendOptions
from repro_torch.core import compiled as TC

PRESETS = {
    "small_cnn": (lambda m: m.cnn.small_cnn(), (32, 32, 3)),
    "resnet50": (lambda m: m.cnn.resnet50(h=32, w=32, width=0.25,
                                          blocks=(1, 1, 1, 1),
                                          num_classes=16), (32, 32, 3)),
    "yolov5s": (lambda m: m.cnn.yolov5s_backbone(h=64, w=64, width=0.25),
                (64, 64, 3)),
}
BACKENDS = {
    "numpy": ("numpy", None),
    "torch": ("torch", None),
    "cuda-megakernel": ("cuda", BackendOptions()),
    "cuda-per-op": ("cuda", BackendOptions(megakernel=False)),
}


@pytest.fixture(scope="module")
def reference():
    """Per preset: graph, params, a batch of 8 inputs, and the JAX
    package's `jax`-backend outputs for it (batched)."""
    cache = {}

    def get(preset):
        if preset not in cache:
            g = PRESETS[preset][0](R)
            params = R.init_params(g, seed=1)
            xb = np.random.default_rng(2).integers(
                -64, 64, size=(8,) + PRESETS[preset][1]).astype(np.int8)
            dep = repro.compile(g, RH.scaled_paper_machine(4), backend="jax",
                                params=params, num_cores=4)
            cache[preset] = (params, xb,
                             dep.run({"input": xb}, batched=True))
        return cache[preset]
    return get


def _deploy(preset, backend, opts, params):
    g = PRESETS[preset][0](T)
    return g, repro_torch.compile(
        g, TH.scaled_paper_machine(4), backend=backend, num_cores=4,
        params=T.params_from_reference(g, params), backend_options=opts,
        device="cpu")


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_backend_bit_exact_vs_jax(preset, backend, batch, reference):
    params, xb, want = reference(preset)
    g, dep = _deploy(preset, *BACKENDS[backend], params)
    if batch == 1:
        got = {k: v[None] for k, v in dep.run({"input": xb[0]}).items()}
    else:
        got = dep.run({"input": xb}, batched=True)
    for t in g.outputs:
        assert got[t].dtype == want[t].dtype
        assert np.array_equal(got[t], want[t][:batch])
    # and the port's own oracle agrees sample by sample
    ref0 = T.reference_forward(g, params, {"input": xb[0]})
    for t in g.outputs:
        assert np.array_equal(ref0[t], got[t][0])


def test_matches_schedule_interpreter():
    g = T.cnn.small_cnn()
    hw = TH.scaled_paper_machine(4)
    rep, sched, subtasks, mapping = T.analyze(g, hw, num_cores=4)
    params = T.init_params(g, seed=3)
    prog = T.lower_program(g, params, subtasks, mapping, sched, hw=hw)
    x = np.random.default_rng(3).integers(-64, 64, (32, 32, 3)).astype(
        np.int8)
    interp = T.execute_schedule(g, params, {"input": x}, subtasks, mapping,
                                sched)
    single = TC.torch_single(prog, "cpu")({"input": torch.as_tensor(x)})
    outs = [T.run_numpy(prog, {"input": x}),
            {k: v.numpy() for k, v in single.items()},
            T.run_torch(prog, {"input": x}, batched=False, device="cpu"),
            T.run_kernels(prog, {"input": x}, device="cpu"),
            T.run_megakernel(prog, {"input": x}, device="cpu")]
    for out in outs:
        for t in g.outputs:
            assert np.array_equal(interp[t], out[t])


def _programs(preset_or_graphs, cores=4):
    out = []
    for core, hw in ((R, RH), (T, TH)):
        g = (PRESETS[preset_or_graphs][0](core)
             if isinstance(preset_or_graphs, str)
             else preset_or_graphs(core))
        m = hw.scaled_paper_machine(cores)
        rep, sched, subtasks, mapping = core.analyze(g, m, num_cores=cores)
        params = core.init_params(g, seed=7)
        out.append(core.lower_program(g, params, subtasks, mapping, sched,
                                      hw=m))
    return out


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_lowering_and_kernel_plan_identical(preset):
    rprog, tprog = _programs(preset)
    assert rprog.signature == tprog.signature
    assert rprog.buffers == tprog.buffers
    assert repr(rprog.core_streams) == repr(tprog.core_streams)
    assert [b.name for b in tprog.batches] == [op.name for op in
                                               tprog.graph.ops]
    for rb, tb in zip(rprog.batches, tprog.batches):
        assert (rb.name, rb.kind, rb.in_idx, rb.w_idx, rb.out_idx) == \
            (tb.name, tb.kind, tb.in_idx, tb.w_idx, tb.out_idx)
        assert np.array_equal(rb.tiles, tb.tiles)
        assert np.array_equal(np.asarray(rb.mult), np.asarray(tb.mult))
    mode = {"jax": "torch"}
    rplan, tplan = RC._pallas_plan(rprog), TC._kernel_plan(tprog)
    assert [(mode.get(s.mode, s.mode), s.out_idx, s.blocks) for s in rplan] \
        == [(s.mode, s.out_idx, s.blocks) for s in tplan]


def test_kernel_plan_fuses_requant_chains():
    _, tprog = _programs("small_cnn")
    modes = {s.batch.name: s.mode for s in TC._kernel_plan(tprog)}
    assert modes["conv1"] == "conv2d" and modes["conv1.rq"] == "skip"
    assert modes["conv2"] == "conv2d" and modes["conv2.rq"] == "skip"
    assert modes["pool1"] == "torch" and modes["gap"] == "torch"
    assert modes["fc"] == "gemm"


def test_no_fusion_when_acc_is_graph_output():
    def build(core):
        gm = __import__(core.__name__ + ".graph", fromlist=["Graph"])
        g = gm.Graph("acc_out")
        g.add_tensor("input", (12, 12, 3), "int8", is_input=True)
        y = gm.conv2d(g, "c1", "input", 8, 3)
        yq = gm.requant(g, "c1.rq", y)
        g.mark_output(y)
        g.mark_output(yq)
        g.validate()
        return g
    rprog, tprog = _programs(build, cores=2)
    modes = {s.batch.name: s.mode for s in TC._kernel_plan(tprog)}
    assert modes["c1"] == "conv2d" and modes["c1.rq"] == "torch"
    assert all(s.mult is None for s in TC._kernel_plan(tprog))
    x = np.random.default_rng(8).integers(-64, 64, (12, 12, 3)).astype(
        np.int8)
    want = RC.run_pallas(rprog, {"input": x}, interpret=True)
    for out in (T.run_kernels(tprog, {"input": x}, device="cpu"),
                T.run_megakernel(tprog, {"input": x}, device="cpu")):
        for t in tprog.graph.outputs:
            assert np.array_equal(out[t], np.asarray(want[t]))


def test_per_channel_requant_bit_exact():
    g = T.cnn.small_cnn()
    hw = TH.scaled_paper_machine(4)
    rep, sched, subtasks, mapping = T.analyze(g, hw, num_cores=4)
    params = T.init_params(g, seed=9)
    for op in g.ops:
        if op.kind == "requant":
            n = g.tensors[op.outputs[0]].shape[-1]
            base = float(params[f"{op.name}.mult"])
            params[f"{op.name}.mult"] = (
                base * (1 + 0.01 * np.arange(n))).astype(np.float32)
    prog = T.lower_program(g, params, subtasks, mapping, sched, hw=hw)
    x = np.random.default_rng(10).integers(-64, 64, (32, 32, 3)).astype(
        np.int8)
    ref = T.reference_forward(g, params, {"input": x})
    for out in (T.run_torch(prog, {"input": x}, batched=False, device="cpu"),
                T.run_kernels(prog, {"input": x}, device="cpu"),
                T.run_megakernel(prog, {"input": x}, device="cpu")):
        for t in g.outputs:
            assert np.array_equal(ref[t], out[t])


def test_program_pickles_without_device_state():
    import pickle
    _, tprog = _programs("small_cnn")
    TC.torch_batched(tprog, "cpu")
    assert tprog._device_cache
    clone = pickle.loads(pickle.dumps(tprog))
    assert clone._device_cache == {}
    x = np.zeros((32, 32, 3), np.int8)
    assert np.array_equal(
        T.run_torch(clone, {"input": x}, batched=False,
                    device="cpu")["fc.out"],
        T.run_torch(tprog, {"input": x}, batched=False,
                    device="cpu")["fc.out"])


def test_engine_serves_cuda_backend_on_cpu():
    from repro_torch.serve import BatchedInferenceEngine
    g = T.cnn.small_cnn()
    params = T.init_params(g, seed=12)
    eng = BatchedInferenceEngine(g, params, TH.scaled_paper_machine(4), 4,
                                 backend="cuda", device="cpu")
    xb = np.random.default_rng(13).integers(-64, 64, (2, 32, 32, 3)).astype(
        np.int8)
    out = eng.infer(xb)
    for b in range(2):
        ref = T.reference_forward(g, params, {"input": xb[b]})
        for t in g.outputs:
            assert np.array_equal(ref[t], out[t][b])
    assert eng.metrics == {"batches": 1, "samples": 2}
