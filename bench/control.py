#!/usr/bin/env python3
"""The readings that a cell's correctness limit is set from, on the card:

    python3 bench/control.py --workload <cell> --seconds <s> SEED [SEED ...]

For each seed, in one process: a run of the cell (its set-up, a window of
`--seconds` at the cell's own load, the check), then on the same sample of
answers the control, the plain reference computed in the precision below
the configuration's and put in the program's place (int4 weights for
int8), its logits against the exact ones. One JSON line per seed: the
program's reading and the control's. The benchmark's own runs
do not run the control."""

from __future__ import annotations

import argparse
import json
import sys

import run as R


def control_reading(out: dict) -> int:
    """The widest gap between the control's logits and the exact ones over
    the run's sample."""
    import numpy as np
    ref, s = out["ctx"]["reference"], out["sample"]
    exact = ref.forward(s["net"], s["params"], s["frames"])
    low = ref.forward(s["net"], s["params"], s["frames"], weight_bits=4)
    return int(np.abs(low.astype(np.int64) - exact).max())


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("seeds", type=int, nargs="+")
    a = p.parse_args()
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    spec = R.cell_spec(bench, a.workload)
    sys.path.insert(0, str(R.ROOT / "src"))
    for seed in a.seeds:
        out = R.run_cell(spec, seed=seed, seconds=a.seconds, trace=False,
                         device=a.device)
        row = {"seed": seed, "correct": out["correct"],
               "program": {n: v for n, v, _ in out["checks"]},
               "control": control_reading(out),
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "context": out["ctx"].get("context")}
        print(json.dumps(row), flush=True)
        del out
        if a.device != "cpu":
            import gc

            import torch
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
