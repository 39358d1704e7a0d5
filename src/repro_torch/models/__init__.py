"""LM model zoo of the port: the dense, moe, hybrid, RWKV (`ssm`) and
encdec families, in torch.

`params_from_numpy` carries the JAX package's parameters across (each leaf
converted with `np.asarray` on that side), keeping dtypes: the moe router,
the RWKV decay bias and bonus `u` and the Mamba2 scalars stay float32 in a
bf16 model, as `init_params` makes them on both sides."""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .serve import cache_spec, decode_step, init_cache, prefill_step
from .transformer import (chunked_xent, decode_trunk, encode, forward_hidden,
                          init_params, train_loss)


def _leaf_from_numpy(arr, device) -> torch.Tensor:
    arr = np.array(arr, order="C")       # an owned, writable copy
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy: carry
        # the bits across as int16 and view them as bfloat16
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The port's params from the JAX package's params `tree` (a nested
    dict whose leaves are numpy arrays, e.g. the JAX params mapped through
    `np.asarray`), on `device`, dtypes kept. The layouts are the same, so
    this is a tree map."""
    return _tree_from_numpy(tree, device)


def _tree_from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device)


def opt_state_from_numpy(tree, device="cuda"):
    """The port's AdamW state from the JAX package's (`{"mu", "nu",
    "step"}`, leaves as numpy arrays), on `device`: f32 moments and the
    int32 step counter, as `train.init_opt_state` makes them."""
    return _tree_from_numpy(tree, device)


def params_to(params, device):
    """`params` with every leaf on `device` (leaves already there are
    kept, not copied)."""
    return {k: (params_to(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in params.items()}


__all__ = ["ModelConfig", "init_params", "forward_hidden", "encode",
           "decode_trunk", "prefill_step", "decode_step", "init_cache",
           "cache_spec", "train_loss", "chunked_xent", "params_from_numpy",
           "opt_state_from_numpy", "params_to"]
