#!/usr/bin/env python3
"""One run of one cell of the benchmark of the PyTorch/CUDA port
(`src/repro_torch`), on the NVIDIA GPU of the machine it starts on:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. `BENCHMARK.json` at the root names the cells;
a cell is a configuration (`bench/configs/<file>.json`, its plain
reference `bench/configs/<reference>.py` beside it) under a traffic mix
(`bench/traffic/<traffic>.json`). The configuration's `system` names the
driver (`bench/harness/<system>.py`) that builds the program, serves the
mix for `--seconds` after its set-up and checks a sample of the answers
against the reference. `--trace 0` reports the cell's end-to-end metrics;
`--trace 1` also profiles a steady stretch of the window and reports the
cell's per-layer metrics, each read by `bench/readers/<name>.py` (the
part of the metric's name before its first dot).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), and last the
numbers compared with their limits, which are also the last lines of
standard error. A run exits non-zero, printing no result, without a CUDA
device (or fewer than the cell asks for), without the port's sources
beside the benchmark, or when a JAX module (or the JAX package the port
is held against) is loaded once the window has closed.

Kernel builds and caches stay inside the checkout (`build/`)."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.common import (forbidden_modules, print_checks,  # noqa: E402
                            result_line)


class RunError(RuntimeError):
    """A run that cannot report: the reason goes to standard error."""


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise RunError(f"{path} not found")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration entry and file, its mix, its
    reference module, and the metrics that apply to it."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no cell {workload!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                     .read_text())

    def applies(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m)
                 and ("workloads" in m or m["moves"] in names)]
    return {"cell": cell, "config": config, "mix": mix, "e2e": e2e,
            "per_layer": per_layer}


def reader(name: str):
    base = name.split(".", 1)[0]
    return load_file(BENCH / "readers" / f"{base}.py",
                     f"bench_reader_{base}")


def run_cell(spec: dict, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault=None) -> dict:
    """Set up, serve and check one cell; returns the driver's result with
    the metrics that apply to the cell (the end-to-end ones, or with
    `trace` the per-layer ones) under "metrics"."""
    config = spec["config"]
    ref = load_file(BENCH / "configs" / f"{config['reference']}.py",
                    f"bench_ref_{config['reference']}")
    driver = importlib.import_module(f"harness.{config['system']}")
    ctx = {"config": config, "mix": spec["mix"], "seed": int(seed),
           "seconds": float(seconds), "trace": bool(trace),
           "device": device, "reference": ref, "fault": fault,
           "t_start": T_START}
    out = driver.run(ctx)
    out["ctx"] = ctx
    if not trace:
        out["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
                          for m in spec["e2e"]}
        return out
    metrics = {}
    for m in spec["per_layer"]:
        v = reader(m["name"]).read(out["rec"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        spec = cell_spec(bench, a.workload)
        if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
            raise RunError(f"the port's sources are not under {ROOT / 'src'}")
        os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                                 / "torch_extensions")
        os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        chips = spec["cell"]["chips"]
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} CUDA device(s); torch "
                           f"sees {torch.cuda.device_count()}")
        out = run_cell(spec, seed=a.seed, seconds=a.seconds,
                       trace=bool(a.trace))
    except (RunError, OSError, KeyError, ValueError) as e:
        print(f"bench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"bench: JAX modules were loaded: {bad}", file=sys.stderr)
        return 3
    ctx = out["ctx"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": spec["cell"]["chips"],
              "memory_peak_bytes": ctx["memory_peak_bytes"]}
    breakdown = None
    if a.trace:
        tr = out["rec"]["trace"]
        if tr is None:
            print("bench: the window held no traced stretch",
                  file=sys.stderr)
            return 2
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": tr["idle_gaps"]}
    print(json.dumps({"context": ctx.get("context"),
                      "check_s": ctx.get("check_s")}), file=sys.stderr)
    print_checks(out["checks"])
    print(result_line(correct=out["correct"], attempted=out["attempted"],
                      failed=out["failed"], metrics=out["metrics"],
                      device=device, checks=out["checks"],
                      breakdown=breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
