"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --steps 50 --batch 8 --seq 256 --ckpt /tmp/ckpt \\
        --device cpu

Runs on the GPU by default (`--device cuda`; without one it raises). One
process drives the 1 x 1 mesh with no process group. For several ranks
run one process per rank with `--coordinator host:port --rank R --world
W` (NCCL on CUDA, gloo on the CPU); each rank uses card R % the card
count. `--model-axis M` cuts the model over M ranks (tensor parallelism,
`param_shardings`' specs) and the rest of the world is the data axis:

    for r in 0 1 2; do PYTHONPATH=src python -m repro_torch.launch.train \
        --arch smollm-135m --reduced --device cpu --steps 5 --seq 64 \
        --model-axis 3 --coordinator localhost:29511 --rank $r \
        --world 3 & done; wait
"""

from __future__ import annotations

import argparse
import json
import os

from ..configs import ARCH_IDS, get_config
from ..train.loop import TrainConfig, train
from ..train.optimizer import OptConfig
from .mesh import _world_size, make_host_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "const"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--data-axis", type=int, default=0,
                    help="0 = all ranks on the data axis")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 for torch.distributed")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="write metrics json here")
    args = ap.parse_args(argv)

    device = args.device
    if args.coordinator:
        import torch
        import torch.distributed as dist
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("--device cuda but torch sees no CUDA "
                                   "device; pass --device cpu")
            card = args.rank % torch.cuda.device_count()
            torch.cuda.set_device(card)
            device = f"cuda:{card}"
        dist.init_process_group(
            "nccl" if args.device == "cuda" else "gloo",
            init_method=f"tcp://{args.coordinator}", rank=args.rank,
            world_size=args.world)

    cfg = get_config(args.arch, reduced=args.reduced)
    # minicpm's distinguishing schedule is WSD; honor it by default
    if args.arch == "minicpm-2b" and args.schedule == "cosine":
        args.schedule = "wsd"
    n_dev = _world_size()
    data_ax = args.data_axis or max(1, n_dev // args.model_axis)
    mesh = make_host_mesh(data=data_ax, model=args.model_axis)

    opt = OptConfig(lr=args.lr, schedule=args.schedule,
                    total_steps=args.steps,
                    warmup_steps=max(1, args.steps // 20))
    tc = TrainConfig(num_steps=args.steps, microbatches=args.microbatches,
                     ckpt_dir=args.ckpt)
    try:
        state, metrics = train(cfg, mesh, opt_cfg=opt, tc=tc,
                               seq_len=args.seq, global_batch=args.batch,
                               device=device)
    finally:
        if args.coordinator:
            import torch.distributed as dist
            dist.destroy_process_group()
    first = metrics["losses"][0]
    last = metrics["losses"][-1]
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"({metrics['history']})")
    if args.out and mesh.rank == 0:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"arch": args.arch, "losses": metrics["losses"],
                       "history": metrics["history"]}, f)
    return state, metrics


if __name__ == "__main__":
    main()
