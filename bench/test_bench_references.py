"""CPU tests of the benchmark's plain reference and of its check: at a
reduced size the reference agrees with the port run on the CPU, it
imports nothing of the port, the control (the reference in the precision
below) reads far from the program, and a run whose timed path is broken
underneath comes out not correct."""

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
from harness import weights  # noqa: E402

CNN_SMALL = {"h": 32, "w": 32, "width": 0.25, "blocks": [1, 1, 1, 1],
             "num_classes": 16}
SEED = 2 ** 31 + 4242


def ref(name):
    return R.load_file(BENCH / "configs" / f"{name}.py", f"bench_ref_{name}")


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse((BENCH / "configs" / "ref_resnet50_int8.py")
                     .read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods <= {"__future__", "math", "numpy"}


def test_cnn_reference_equals_the_ports():
    from repro_torch.core import cnn
    from repro_torch.core.executor import reference_forward
    r = ref("ref_resnet50_int8")
    net = r.layers(**CNN_SMALL)
    params = weights.cnn_params(r.weight_specs(net), SEED, "cpu")
    g = cnn.resnet50(**CNN_SMALL)
    x = np.random.default_rng(0).integers(-128, 128, (3, 32, 32, 3),
                                          dtype=np.int8)
    got = r.forward(net, params, x)
    for b in range(3):
        want = reference_forward(g, params, {"input": x[b]})[g.outputs[0]]
        assert np.array_equal(got[b], want.reshape(-1))
    # at full size: the conv and classifier operations the graph counts,
    # and its weights
    full, gf = r.layers(), cnn.resnet50()
    assert sum(2 * s["M"] * s["K"] * s["N"] for s in r.conv_shapes(full)) \
        == sum(op.flops(gf) for op in gf.ops if op.kind in ("conv2d",
                                                            "gemm"))
    assert sum(np.prod(s[0]) for s in r.weight_specs(full).values()
               if s[1] == "w") == gf.total_weight_bytes()


def _spec(cell, **mix):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = R.cell_spec(bench, cell)
    spec["config"]["graph"]["args"] = dict(CNN_SMALL)
    spec["mix"].update(mix)
    return spec


def test_control_reads_far_from_the_program():
    """The control at a test's size: the reference with int4 weights, on
    the program's own sample, is off where the program is exact."""
    spec = _spec("resnet50-224-int8.rig8-b8")
    out = R.run_cell(spec, seed=SEED, seconds=0.5, trace=False,
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


@pytest.mark.parametrize("cell,fault", [
    ("resnet50-224-int8.cam30-b1", _alter_one_answer),
    ("resnet50-224-int8.rig8-b8", _alter_one_answer),
    ("resnet50-224-int8.rig8-b8", _drop_half_the_batch),
    ("resnet50-224-int8.cam30-b1", _repeat_the_first_answer),
    ("resnet50-224-int8.rig8-b8", _repeat_the_first_answer)])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    spec = _spec(cell, check=64)
    out = R.run_cell(spec, seed=SEED, seconds=2.0, trace=False,
                     device="cpu", fault=fault)
    assert out["correct"] is False
    out = R.run_cell(spec, seed=SEED, seconds=2.0, trace=False,
                     device="cpu", fault=None)
    assert out["correct"] is True, out["checks"]


def test_k2_shapes_come_from_the_programs_plan():
    """The K2 launches of a ResNet50-224 job: the plan's 50 tiled convs,
    whose bound at batch 1 is the smoke run's 0.01308 ms (bytes)."""
    import repro_torch
    from repro_torch.core import cnn
    from repro_torch.hw import scaled_paper_machine
    from harness import bounds
    from harness import cnn as hc
    dep = repro_torch.compile(cnn.resnet50(), scaled_paper_machine(64),
                              backend="cuda", device="cpu")
    k2 = hc.k2_shapes(dep)
    assert len(k2) == 50 and all(s["requant"] for s in k2)
    bd = bounds.Bound()
    for s in k2:
        bounds.k2_launch(bd, 1, s["H"], s["W"], s["C_in"], s["M"], s["K"],
                         s["N"], s["requant"])
    assert bd.s * 1e3 == pytest.approx(0.01308, abs=5e-6) and bd.by == "bytes"
