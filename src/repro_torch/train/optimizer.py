"""AdamW with warmup + {cosine | WSD | constant} schedules.

WSD (warmup-stable-decay) is MiniCPM's schedule [arXiv:2404.06395] — the
assigned minicpm-2b arch's distinguishing training feature: linear warmup,
long stable plateau at peak lr, then a short (default 10%) exponential-ish
decay tail.

Plain functions on trees of tensors (no `torch.optim`), as the JAX package
has no optax: moments in f32, params updated in f32 and cast back to their
storage dtype. The step counter, the learning rate and the gradient norm
stay on the params' device, so an update never waits for the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | wsd | const
    wsd_decay_frac: float = 0.1
    min_lr_ratio: float = 0.1


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or an integer tensor), as a
    float32 tensor on the step's device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((s + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    if cfg.schedule == "cosine":
        mult = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        decay_start = 1.0 - cfg.wsd_decay_frac
        frac = torch.clamp((t - decay_start) / cfg.wsd_decay_frac, 0.0, 1.0)
        mult = torch.where(t < decay_start, torch.ones_like(t),
                           torch.pow(cfg.min_lr_ratio, frac))
    else:
        mult = torch.ones_like(t)
    return cfg.lr * warm * mult


def init_opt_state(params: Any) -> dict:
    """f32 zero moments shaped like `params` and an int32 step of 0, on
    the params' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = leaves(params)[0].device
    return {"mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in flattening order) of each leaf's
    f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def adamw_update(cfg: OptConfig, grads: Any, opt_state: dict, params: Any,
                 grad_norm: torch.Tensor | None = None
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step -> (new params, new opt_state, {"lr", "grad_norm"}).
    Gradients are clipped by their global norm. `grad_norm` overrides the
    norm of `grads`: a ZeRO-1 rank updates its slices of the leaves, but
    clips by the norm of the whole gradient."""
    step = opt_state["step"]
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).to(torch.float32)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(p, g, mu, nu):
        g = g.float() * clip
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        mhat = mu / bc1
        nhat = nu / bc2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        pf = p.float()
        # decoupled weight decay (skip 1-d / scalar leaves: norms, biases)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), mu, nu

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        leaves(params), leaves(grads), leaves(opt_state["mu"]),
        leaves(opt_state["nu"]))]
    new_p = unflatten(params, [o[0] for o in out])
    new_state = {"mu": unflatten(params, [o[1] for o in out]),
                 "nu": unflatten(params, [o[2] for o in out]),
                 "step": step + 1}
    return new_p, new_state, {"lr": lr, "grad_norm": gnorm}
