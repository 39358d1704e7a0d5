"""Serving launcher (predictable mode by default).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --requests 8 --max-new 16 [--device cpu]

Builds the model on `--device` ("cuda" by default: the CUDA kernels on the
card), runs batched prefill+decode over synthetic prompts, and prints the
paper-pipeline WCET report for the decode step (a bound on the modeled
machine `--hw`, not a measurement of the device).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..models import init_params
from ..serve.engine import Request
from ..serve.predictable import PredictableEngine, analyze_decode
from ..hw import TPU_V5E, PAPER_RISCV


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--hw", default="tpu", choices=["tpu", "paper"])
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--analyze-only", action="store_true",
                    help="print the WCET analysis without running")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    hw = TPU_V5E if args.hw == "tpu" else PAPER_RISCV

    if args.analyze_only:
        rep = analyze_decode(cfg, args.batch, args.max_len, hw)
        print(rep.summary())
        return

    params = init_params(cfg, torch.Generator(args.device).manual_seed(0),
                         device=args.device)
    eng = PredictableEngine(cfg, params, batch_size=args.batch,
                            max_len=args.max_len, hw=hw)
    print(eng.report.summary())
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=list(rng.integers(1, cfg.vocab_size,
                                             rng.integers(4, 12))),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    done = []
    for i in range(0, len(reqs), args.batch):
        done += eng.generate(reqs[i:i + args.batch])
    for r in done[:4]:
        print(f"req {r.rid}: {len(r.out)} tokens -> {r.out[:8]}...")
    print(f"metrics: {eng.metrics}; deadline misses "
          f"{eng.deadline_misses}/{eng.deadline_checks}")


if __name__ == "__main__":
    main()
