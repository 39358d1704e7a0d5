"""CPU tests of the benchmark's own arithmetic: traffic from the seed,
percentiles and rates over all samples, the roofline counts against the
port's smoke run, the open loop's wait, the JAX check, the device
trace's reduction, and the shape of BENCHMARK.json."""

from __future__ import annotations

import json
import re
import sys
from collections import Counter
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness import bounds, cnn, common, trace, traffic  # noqa: E402

BIG_SEED = 2 ** 31 + 987_654_321


def test_traffic_is_the_same_from_the_same_seed():
    mix = json.loads((BENCH / "traffic" / "rig8-b8.json").read_text())
    a, b = (traffic.Stream(mix, BIG_SEED) for _ in range(2))
    ra = [a.next() for _ in range(200)]
    assert ra == [b.next() for _ in range(200)]
    c = traffic.Stream(mix, BIG_SEED + 1)
    assert [c.next() for _ in range(200)] != ra
    assert all(0 <= r["frame"] < mix["frames"] for r in ra)
    cam = json.loads((BENCH / "traffic" / "cam30-b1.json").read_text())
    f1 = traffic.frames(cam, BIG_SEED, (8, 8, 3))
    assert (f1 == traffic.frames(cam, BIG_SEED, (8, 8, 3))).all()
    assert not (f1 == traffic.frames(cam, BIG_SEED + 1, (8, 8, 3))).all()
    assert f1.dtype.name == "int8" and f1.shape == (64, 8, 8, 3)
    assert f1.min() == -128 and f1.max() == 127
    assert traffic.Stream(cam, 0).due_s(45) == pytest.approx(1.5)


@pytest.mark.parametrize("mix", ["cam30-b1", "rig8-b8"])
def test_every_seed_sends_the_same_frames(mix):
    m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    n = m["frames"]
    for seed in (1, BIG_SEED):
        s = traffic.Stream(m, seed)
        sent = Counter(s.next()["frame"] for _ in range(3 * n))
        assert sent == Counter({k: 3 for k in range(n)})


def test_percentiles_and_rates_take_every_sample():
    v = list(range(1, 101))                      # 1..100
    assert common.percentile(v, 95) == pytest.approx(95.05)
    assert common.percentile(v[::-1], 95) == pytest.approx(95.05)
    assert common.median([3, 1, 2, 10]) == 2.5
    assert common.percentile([7.0], 95) == 7.0
    # one slow sample among many moves the tail, none is dropped
    assert common.percentile([1.0] * 99 + [1000.0], 100) == 1000.0
    assert common.rate(300, 20.0) == 15.0
    with pytest.raises(ValueError):
        common.rate(1, 0.0)
    with pytest.raises(ValueError):
        common.percentile([], 50)


@pytest.mark.parametrize("H,C,N,k,stride,pad", [
    (55, 64, 64, 3, 1, 1),      # a first-stage bottleneck's 3x3 conv
    (55, 256, 512, 1, 2, 0),    # the second stage's downsampling projection
    (224, 3, 64, 7, 2, 3)])     # the stem
def test_roofline_counts_equal_the_smoke_runs(H, C, N, k, stride, pad):
    """K2 at a ResNet50-224 conv, requantized, as the smoke run's path
    table counts it at batch 1."""
    import chip_smoke as cs
    W = H
    oh = ow = (H + 2 * pad - k) // stride + 1
    K = k * k * C
    want = cs.Bound()
    want.add(H * W * C + K * N + oh * ow * N * 1, 2 * oh * ow * N * K)
    bd = bounds.Bound()
    bounds.k2_launch(bd, 1, H, W, C, oh * ow, K, N, True)
    assert bd.s * 1e3 == pytest.approx(want.ms, rel=1e-12)
    assert bd.by == want.by


class FakeClock:
    """A clock that moves only when read or slept on: each reading
    advances it by `tick`, each sleep by the time asked plus an
    overshoot drawn from `over`."""

    def __init__(self, tick, over):
        self.t, self.tick, self.over = 100.0, tick, over
        self.sleeps = []

    def clock(self):
        self.t += self.tick
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s + self.over()


@pytest.mark.parametrize("tick,over", [
    (1e-7, lambda: 0.0), (2e-6, lambda: 0.9e-3), (1e-7, lambda: 5e-3),
    (3e-4, lambda: 0.2e-3)])
def test_open_loop_wait_never_returns_before_due(tick, over):
    import random
    rnd = random.Random(4)
    fc = FakeClock(tick, lambda: over() * rnd.random())
    for k in range(200):
        due = 100.0 + k / 30.0 + 1e-3 * rnd.random()
        now = cnn.wait_until(due, fc.clock, fc.sleep)
        assert now >= due and fc.t >= due
    # it sleeps only up to SPIN_S before the due time
    assert all(s > 0 for s in fc.sleeps)
    fc = FakeClock(1e-7, lambda: 0.0)
    cnn.wait_until(fc.t + 0.5, fc.clock, fc.sleep)
    assert fc.sleeps and fc.sleeps[0] <= 0.5 - cnn.SPIN_S + 1e-6


def test_jax_check_compares_whole_top_level_names():
    names = ["repro_torch", "repro_torch.core.cnn", "reproduce", "jax",
             "jaxlib.xla_client", "flax.linen", "repro", "repro.core",
             "jaxtyping", "numpy"]
    assert common.forbidden_modules(names) == [
        "flax.linen", "jax", "jaxlib.xla_client", "repro", "repro.core"]


def test_trace_reduction():
    # stretch 0-1000 us; a step span 150-880 with the kernels inside it
    host = [("bench.stretch", 0.0, 1000.0), ("Server.step", 150.0, 880.0),
            ("aten::item", 500.0, 600.0), ("Server.submit", 920.0, 950.0)]
    dev = [("conv2d_int8_kernel(params)", 200.0, 400.0),
           ("conv2d_int8_kernel(params)", 350.0, 450.0),
           ("Memcpy DtoH", 700.0, 800.0),
           ("outside", 2000.0, 3000.0)]
    r = trace.reduce(host, dev, {"Server.step", "Server.submit",
                                 trace.STRETCH})
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(350e-6)       # 200-450, 700-800
    assert r["kernels"]["conv2d_int8_kernel"] == [2, pytest.approx(300e-6)]
    gaps = dict((k, v) for k, v in r["idle_gaps"])
    assert gaps == {"harness": pytest.approx(400e-6),
                    "Server.step / aten::item": pytest.approx(250e-6)}
    assert r["spans"]["Server.step"] == [[pytest.approx(730e-6),
                                          pytest.approx(350e-6)]]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert b["paths"] == ["bench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"] == ["python3", "bench/run.py"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/") and len(c["reduced"]) <= 16
        conf = json.loads((ROOT / c["file"]).read_text())
        assert (BENCH / "configs" / f"{conf['reference']}.py").is_file()
        assert (BENCH / "harness" / f"{conf['system']}.py").is_file()
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "readers" / f"{m['name'].split('.')[0]}.py").is_file()
        for w in m["workloads"]:          # each cell reports what it moves
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].split(".")[0].endswith("roofline"):
            assert m["unit"] == "%"
    for w in cells:                        # setup_s, another, a per-layer
        mine = [m for m in b["end_to_end"] if w in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])
