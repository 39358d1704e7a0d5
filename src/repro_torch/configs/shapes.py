"""Assigned input-shape cells and their stand-in inputs.

LM transformer shapes are (seq_len, global_batch). decode_*/long_* run
`decode_step` (decode: one new token against a seq_len KV cache); prefill
runs the cache-filling prefill step; train_4k runs `train_step`.
long_500k needs sub-quadratic attention: only archs with
cfg.subquadratic=True run it.

Where the JAX package builds `jax.ShapeDtypeStruct`s, `input_specs` builds
tensors on the `meta` device: the same shapes and dtypes, leaf for leaf,
and no storage.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from ..models.serve import cache_spec


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: long_500k needs sub-quadratic "
                       "attention (skip per task spec; see DESIGN.md)")
    return True, ""


def _sds(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def enc_len_for(cfg: ModelConfig, cell: ShapeCell) -> int:
    """Encoder length for enc-dec archs (half the cell budget, min 128)."""
    return max(128, cell.seq_len // 4) if cfg.family == "encdec" else 0


def _cache(cfg: ModelConfig, B: int, S: int, enc_len: int) -> dict:
    return {k: _sds(shape, dt) for k, (shape, dt) in
            cache_spec(cfg, B, S, enc_len).items()}


def input_specs(cfg: ModelConfig, shape: str,
                scale_batch: float = 1.0) -> dict:
    """Meta-tensor stand-ins for every model input of a cell.

    Returns {"batch": ..., "cache": ...} as applicable; weight and
    optimizer stand-ins come from the init functions. scale_batch shrinks
    global_batch for reduced-scale experiments.
    """
    cell = SHAPES[shape]
    B = max(1, int(cell.global_batch * scale_batch))
    S = cell.seq_len
    dt = cfg.torch_dtype

    if cell.kind == "train":
        if cfg.family == "encdec":
            s_enc = S // 2
            s_dec = S - s_enc
            batch = {"tokens": _sds((B, s_dec)),
                     "labels": _sds((B, s_dec)),
                     "src_tokens": _sds((B, s_enc)),
                     "frontend_embeds": _sds((B, s_enc, cfg.d_model), dt)}
            if cfg.frontend is None:
                batch.pop("frontend_embeds")
            return {"batch": batch}
        batch = {"tokens": _sds((B, S)), "labels": _sds((B, S))}
        if cfg.frontend is not None and cfg.frontend_tokens:
            batch["frontend_embeds"] = _sds(
                (B, cfg.frontend_tokens, cfg.d_model), dt)
        return {"batch": batch}

    if cell.kind == "prefill":
        enc_len = enc_len_for(cfg, cell)
        if cfg.family == "encdec":
            batch = {"tokens": _sds((B, S)),
                     "src_tokens": _sds((B, enc_len)),
                     "frontend_embeds": _sds((B, enc_len, cfg.d_model), dt)}
            if cfg.frontend is None:
                batch.pop("frontend_embeds")
        else:
            batch = {"tokens": _sds((B, S))}
            if cfg.frontend is not None and cfg.frontend_tokens:
                batch["frontend_embeds"] = _sds(
                    (B, cfg.frontend_tokens, cfg.d_model), dt)
        return {"batch": batch, "cache": _cache(cfg, B, S, enc_len)}

    # decode: one new token against a seq_len cache
    enc_len = enc_len_for(cfg, cell)
    return {"tokens": _sds((B, 1)),
            "cache": _cache(cfg, B, S, enc_len)}
