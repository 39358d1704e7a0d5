"""`repro_torch.compile` and its artifacts against the JAX package's.

The pipeline is a copy, so the stage list, the WCET bound and the schedule
sanitizer's diagnostics must be IDENTICAL to the reference's — zero on the
presets, the same rules and messages on mutated artifacts (compared
exactly: they are strings and Python floats). `Deployment.save`/`load`
round-trips and refuses a wrong machine, a wrong graph and a corrupt file;
the Pallas-only `interpret` option does not exist on the port's backends,
and the default device is the GPU: without one, the entry points raise.
"""

import dataclasses
import zipfile

import numpy as np
import pytest
import torch

import repro
import repro.core as R
import repro.hw as RH
import repro_torch
import repro_torch.core as T
import repro_torch.hw as TH
from repro.analysis import analyze_program as r_analyze_program
from repro.analysis import analyze_schedule as r_analyze_schedule
from repro.core import megakernel as RMK
from repro_torch.analysis import analyze_deployment
from repro_torch.analysis import analyze_program as t_analyze_program
from repro_torch.analysis import analyze_schedule as t_analyze_schedule
from repro_torch.compiler import (ArtifactError, BackendError,
                                  BackendOptions, DeadlineError, Deployment,
                                  get_backend, list_backends)
from repro_torch.core import megakernel as TMK

HW_T, HW_R = TH.scaled_paper_machine(4), RH.scaled_paper_machine(4)


def _pair(build=lambda m: m.cnn.small_cnn(), **kw):
    r = repro.compile(build(R), HW_R, backend="numpy", num_cores=4,
                      use_cache=False, **kw)
    t = repro_torch.compile(build(T), HW_T, backend="numpy", num_cores=4,
                            use_cache=False, device="cpu", **kw)
    return r, t


def _rows(diags):
    return sorted(d.row() for d in diags)


@pytest.mark.parametrize("preset", ["small_cnn", "resnet50", "yolov5s"])
def test_pipeline_and_sanitizer_identical_on_presets(preset):
    build = {"small_cnn": lambda m: m.cnn.small_cnn(),
             "resnet50": lambda m: m.cnn.resnet50(
                 h=32, w=32, width=0.25, blocks=(1, 1, 1, 1),
                 num_classes=16),
             "yolov5s": lambda m: m.cnn.yolov5s_backbone(h=64, w=64,
                                                         width=0.25)}[preset]
    r, t = _pair(build)
    assert [s.name for s in r.stages] == [s.name for s in t.stages] == [
        "quantize", "partition", "map", "schedule", "wcet", "lower",
        "verify"]
    assert [s.summary for s in r.stages[:-1]] == \
        [s.summary for s in t.stages[:-1]]
    assert r.wcet_bound_s == t.wcet_bound_s
    assert repr(r.report) == repr(t.report)
    assert t.artifacts["verify"].clean and r.artifacts["verify"].clean
    assert analyze_deployment(t).clean


def test_mutation_race001_same_diagnostics():
    r, t = _pair()
    out = []
    for dep, analyze in ((r, r_analyze_schedule), (t, t_analyze_schedule)):
        dma = sorted(dep.schedule.dma, key=lambda s: s.start)
        a, b = dma[0], dma[1]
        dma[1] = dataclasses.replace(b, start=a.start,
                                     end=a.start + (b.end - b.start))
        bad = dataclasses.replace(dep.schedule, dma=dma)
        out.append(_rows(analyze(bad, dep.artifacts["partition"],
                                 dep.artifacts["map"], hw=dep.machine)))
    assert out[0] == out[1] and any("RACE001" in row for row in out[1])


def test_mutation_spm002_spm003_same_diagnostics():
    r, t = _pair()
    out = []
    for dep, mk, analyze, hw in ((r, RMK, r_analyze_program, HW_R),
                                 (t, TMK, t_analyze_program, HW_T)):
        segs = mk.plan_segments(dep.program)
        fused = [s for s in segs if s.kind == "fused"]
        floor = min(mk.segment_footprint(dep.program, s, hw.dual_ported)
                    for s in fused)
        tiny = dataclasses.replace(hw, scratchpad_bytes=max(1, floor // 2))
        rows = _rows(analyze(dep.program, tiny, segments=segs))
        i, seg = next((i, s) for i, s in enumerate(segs)
                      if s.kind == "fused" and len(s.steps) >= 2)
        steps = list(seg.steps)
        steps[0], steps[1] = steps[1], steps[0]
        mutated = list(segs)
        mutated[i] = dataclasses.replace(seg, steps=steps)
        rows += _rows(analyze(dep.program, hw, segments=mutated))
        out.append(rows)
    assert out[0] == out[1]
    assert any("SPM002" in row for row in out[1])
    assert any("SPM003" in row for row in out[1])


def test_deadline_enforced():
    with pytest.raises(DeadlineError):
        repro_torch.compile(T.cnn.small_cnn(), HW_T, deadline=1e-9,
                            device="cpu", use_cache=False)


def test_save_load_round_trip(tmp_path):
    g = T.cnn.small_cnn()
    params = T.init_params(g, seed=7)
    dep = repro_torch.compile(g, HW_T, backend="cuda", params=params,
                              backend_options=BackendOptions(max_kernels=2),
                              device="cpu", use_cache=False)
    x = np.random.default_rng(0).integers(-64, 64, (32, 32, 3)).astype(
        np.int8)
    out0 = dep.run(x)
    path = str(tmp_path / "net.rtdep")
    assert dep.save(path) == path
    loaded = Deployment.load(path, machine=HW_T, graph=g, device="cpu")
    assert loaded.backend == "cuda"
    assert loaded.options == BackendOptions(max_kernels=2)
    assert loaded.wcet_bound_s == dep.wcet_bound_s
    assert loaded.schedule.makespan == dep.schedule.makespan
    assert [s.name for s in loaded.stages] == [s.name for s in dep.stages]
    for view in (loaded, loaded.with_backend("numpy", BackendOptions()),
                 loaded.with_backend("torch", BackendOptions())):
        out = view.run(x)
        for t in g.outputs:
            assert np.array_equal(out0[t], out[t])


def test_load_refuses_wrong_machine_graph_and_corrupt_files(tmp_path):
    g = T.cnn.small_cnn()
    dep = repro_torch.compile(g, HW_T, device="cpu", use_cache=False)
    path = str(tmp_path / "net.rtdep")
    dep.save(path)
    other = dataclasses.replace(HW_T,
                                scratchpad_bytes=HW_T.scratchpad_bytes * 2)
    with pytest.raises(ArtifactError, match="refusing to deploy"):
        Deployment.load(path, machine=other, device="cpu")
    with pytest.raises(ArtifactError, match="refusing to deploy graph"):
        Deployment.load(path, graph=T.cnn.small_cnn(h=24, w=24),
                        device="cpu")
    junk = tmp_path / "junk.rtdep"
    junk.write_bytes(b"not a deployment")
    with pytest.raises(ArtifactError):
        Deployment.load(str(junk), device="cpu")
    corrupt = str(tmp_path / "corrupt.rtdep")
    with zipfile.ZipFile(path) as zin, \
            zipfile.ZipFile(corrupt, "w") as zout:
        zout.writestr("manifest.json", zin.read("manifest.json"))
        zout.writestr("payload.pkl",
                      zin.read("payload.pkl")[:-10] + b"x" * 10)
    with pytest.raises(ArtifactError, match="payload hash mismatch"):
        Deployment.load(corrupt, device="cpu")


def test_options_and_capabilities():
    assert list_backends() == ["cuda", "mesh", "numpy", "torch"]
    assert get_backend("mesh").capabilities.mesh
    caps = get_backend("cuda").capabilities
    assert caps.requires_device == "cuda"
    assert caps.supported_options == frozenset(
        {"megakernel", "scratchpad_budget", "max_kernels"})
    assert get_backend("torch").capabilities.supports_batched_native
    assert get_backend("numpy").capabilities.supported_options == frozenset()
    # the Pallas-only `interpret` knob is gone: refused as an argument,
    # ignored (like any unknown key) in an old artifact's manifest
    with pytest.raises(TypeError):
        BackendOptions(interpret=True)
    assert BackendOptions.from_manifest(
        {"interpret": True, "max_kernels": 2}) == BackendOptions(
            max_kernels=2)
    with pytest.raises(BackendError, match="does not support"):
        repro_torch.compile(T.cnn.small_cnn(), HW_T, backend="torch",
                            backend_options=BackendOptions(megakernel=True),
                            device="cpu")
    with pytest.raises(BackendError):
        get_backend("pallas")


def test_default_device_is_the_gpu():
    """Without a GPU the default device raises: nothing silently runs on
    the CPU. With one, the same call compiles for it."""
    g = T.cnn.small_cnn()
    if torch.cuda.is_available():
        assert repro_torch.compile(g, HW_T, use_cache=False).device == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.compile(g, HW_T, backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.Server(HW_T, backend="cuda")
    dep = repro_torch.compile(g, HW_T, backend="cuda", device="cpu")
    x = np.zeros((32, 32, 3), np.int8)
    with pytest.raises(BackendError, match="requires a CUDA device"):
        dep.run(x, device="cuda")
    with pytest.raises(BackendError, match="requires a CUDA device"):
        dataclasses.replace(dep, device="cuda").runner()
    assert np.array_equal(dep.run(x, device="cpu")["fc.out"],
                          dep.run(x)["fc.out"])
