"""Sharding rules: DP / TP / EP / SP (+ pod-level DP) as PartitionSpecs.

The JAX package's path-based rules over plain-dict param trees, with the
same conventions, results and fallbacks:

  * mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
    multi-pod; `pod` is pure data parallelism.
  * TP (model axis): attention QKV/O and MLP in/out projections Megatron
    style; embedding/vocab sharded on the vocab dim.
  * EP: expert dim sharded over `model` when divisible (arctic 128/16),
    otherwise TP inside experts (mixtral 8 experts -> shard d_ff).
  * ZeRO-1: optimizer moments additionally sharded over `data` on the first
    dim that is not already sharded.
  * KV caches: batch over (pod, data) when divisible, else sequence over
    (pod, data) (long_500k, global_batch=1); kv-head dim over `model` when
    divisible, else head_dim.

A spec is the port's `PartitionSpec`, a tuple of axis names, tuples of
names or None (one entry per leading dim; missing trailing dims are
unsharded), equal as a tuple to the JAX package's. The mesh is the port's
`HostMesh` (`launch/mesh.py`): `tp` and `n_data` come from its shape. A
`NamedSharding` pairs the two and cuts a whole tensor into this rank's
slice (`shard`) or gathers the slices back (`gather`); `placements` turns
a spec into `torch.distributed.tensor` placements on a `DeviceMesh` of the
same axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.config import ModelConfig
from ..tree import map_with_path
from .collectives import all_gather_cat, all_to_all


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`'s counterpart: P("data", None) is the
    tuple ("data", None). As in jax, an entry naming one axis in a tuple
    is that axis: P(("data",), None) == P("data", None)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axes_of(entry) -> tuple:
    """The mesh axes one spec entry names: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh. `shard` and `gather` move between the whole
    tensor and this rank's slice of it; a dim sharded over an axis of size
    1 stays whole. An entry naming several axes cuts its dim over their
    product, the first axis major, as JAX flattens them."""

    mesh: Any
    spec: PartitionSpec

    def cuts(self) -> list[tuple[int, tuple]]:
        """(dim, axes) of every dim cut over axes of size > 1, the axes in
        mesh order."""
        order = list(self.mesh.shape)
        out = []
        for dim, entry in enumerate(self.spec):
            axes = tuple(a for a in _axes_of(entry)
                         if self.mesh.shape[a] > 1)
            if list(axes) != sorted(axes, key=order.index):
                raise ValueError(f"{self.spec}: axes of one entry must be "
                                 f"in mesh order {tuple(order)}")
            if axes:
                out.append((dim, axes))
        return out

    def axes_size(self, axes) -> int:
        """Ranks along `axes` (their product)."""
        return math.prod(self.mesh.shape[a] for a in axes)

    def axes_index(self, axes) -> int:
        """This rank's index along `axes`, the first axis major."""
        i = 0
        for a in axes:
            i = i * self.mesh.shape[a] + self.mesh.index(a)
        return i

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor `x`."""
        for dim, axes in self.cuts():
            n = self.axes_size(axes)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"divide over {axes}={n}")
            k = x.shape[dim] // n
            x = x.narrow(dim, self.axes_index(axes) * k, k)
        return x.contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice `x` (a collective over
        the cut axes' groups: every rank calls it)."""
        for dim, axes in reversed(self.cuts()):
            x = all_gather_cat(x, dim, self.mesh.group(axes))
        return x

    def local_shape(self, full_shape) -> tuple:
        shape = list(full_shape)
        for dim, axes in self.cuts():
            shape[dim] //= self.axes_size(axes)
        return tuple(shape)

    def names(self, dim: int) -> tuple:
        """The axes (of size > 1) that cut `dim`."""
        return dict(self.cuts()).get(dim, ())

    def data_cuts(self) -> list[tuple[int, tuple]]:
        """The cuts over data axes (not `model`): the param cuts that a
        layer gathers where it uses the leaf."""
        return [(d, a) for d, a in self.cuts() if "model" not in a]


def relayout(x: torch.Tensor, src: NamedSharding,
             dst: NamedSharding) -> torch.Tensor:
    """This rank's slice under `dst` from its slice `x` under `src` (same
    mesh), without holding more than a slice: a dim that `dst` cuts over
    the axes another dim is gathered over takes one all-to-all over them;
    a dim only `dst` cuts is cut as soon as no pending gather runs over
    its axes; the rest are gathered."""
    a, b = dict(src.cuts()), dict(dst.cuts())
    gath = {d: ax for d, ax in a.items() if b.get(d) != ax}
    cuts = {d: ax for d, ax in b.items() if a.get(d) != ax}
    while gath or cuts:
        pair = next(((g, n) for g, ax in gath.items()
                     for n, bx in cuts.items()
                     if bx == ax and n != g and n not in gath), None)
        if pair is not None:
            g, n = pair
            x = all_to_all(x, n, g, src.mesh.group(gath.pop(g)))
            del cuts[n]
            continue
        ready = [n for n, bx in cuts.items() if n not in gath and not any(
            set(bx) & set(ax) for ax in gath.values())]
        for n in ready:
            axes = cuts.pop(n)
            k = x.shape[n] // dst.axes_size(axes)
            x = x.narrow(n, dst.axes_index(axes) * k, k)
        if not ready and gath:
            g = max(gath)
            x = all_gather_cat(x, g, src.mesh.group(gath.pop(g)))
    return x.contiguous()


def placements(spec: PartitionSpec, axis_names) -> tuple:
    """`torch.distributed.tensor` placements of `spec` on a `DeviceMesh`
    whose dims are `axis_names` (e.g. `device_mesh(mesh).mesh_dim_names`):
    Shard(d) on each axis that cuts dim d, Replicate() on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in axis_names:
        dims = [d for d, e in enumerate(spec) if ax in _axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def device_mesh(mesh, device_type: str = "cuda"):
    """A `DeviceMesh` of the HostMesh's axes over the whole world (every
    rank calls it)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(mesh.shape.values()),
                            mesh_dim_names=tuple(mesh.shape))


def _dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _tp(mesh) -> int:
    return mesh.shape["model"]


def _dp(mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.shape:
        n *= mesh.shape["pod"]
    return n


def _div(n: int, d: int) -> bool:
    return n % d == 0


def param_pspec(path_s: str, shape: tuple, cfg: ModelConfig,
                tp: int, n_data: int = 0) -> P:
    """PartitionSpec for one parameter leaf (layer-stacked leaves have a
    leading L dim which is never sharded)."""
    nd = len(shape)

    def dim_spec(dim: int):
        spec = [None] * nd
        spec[dim] = "model"
        return P(*spec) if _div(shape[dim], tp) else P()

    # embeddings
    if path_s.endswith("embed/table"):
        return dim_spec(0)                       # vocab sharded
    if path_s.endswith("lm_head/w"):
        return dim_spec(nd - 1)                  # vocab sharded
    # norms, biases, scalars, token-shift mixes: replicate
    if any(k in path_s for k in ("ln", "norm", "scale", "bias", "mix_",
                                 "cmix", "d_skip", "a_log", "/u")):
        return P()
    # MoE
    if "moe/router" in path_s:
        return P()
    if "/moe/" in path_s:                        # (L, E, D, F) or (L, E, F, D)
        f_dim = 3 if path_s.endswith(("wi", "wg")) else 2
        if n_data and _div(shape[1], n_data) and _div(shape[f_dim], tp):
            # 2-D expert sharding: EP over data + TP over model
            spec = [None] * nd
            spec[1] = "data"
            spec[f_dim] = "model"
            return P(*spec)
        if _div(shape[1], tp):
            return P(None, "model")              # EP over model
        # TP inside experts: shard the F dim (wi/wg: last; wo: dim 2)
        return dim_spec(f_dim)
    # column-parallel (output dim sharded)
    if path_s.endswith(("wq", "wk", "wv", "wi", "wg", "in_proj", "bc_proj",
                        "dt_proj", "wr", "ck", "cr", "w_proj", "conv_w")):
        return dim_spec(nd - 1)
    # row-parallel (input dim sharded)
    if path_s.endswith(("wo", "out_proj", "cv")):
        return dim_spec(nd - 2)
    return P()


def _flat_axes(spec) -> list:
    return [a for e in spec for a in _axes_of(e)]


def _add_data(spec, shape, n_data: int) -> P:
    """`spec` with `data` on the first free dim that divides over it."""
    specs = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, specs)):
        if cur is None and dim % n_data == 0 and dim >= n_data:
            specs[i] = "data"
            break
    return P(*specs)


def param_shardings(cfg: ModelConfig, mesh, params_tree: Any):
    """Tree of NamedShardings matching `params_tree` (tensors, or anything
    with a `.shape`). cfg.fsdp=True additionally shards every large leaf
    over `data` on its first free dim (ZeRO-3)."""
    tp = _tp(mesh)
    n_data = mesh.shape["data"]

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        base = param_pspec(path, shape, cfg, tp, n_data=n_data)
        numel = 1
        for d in shape:
            numel *= d
        if cfg.fsdp and numel >= 1 << 20 and "data" not in _flat_axes(base):
            base = _add_data(base, shape, n_data)
        return NamedSharding(mesh, base)

    return map_with_path(spec, params_tree)


def batch_shardings(cfg: ModelConfig, mesh, batch_tree: Any):
    """Batch dims over (pod, data); everything else replicated."""
    dp = _dp_axes(mesh)
    n_dp = _dp(mesh)

    def spec(path, leaf):
        s = tuple(leaf.shape)
        b = s[0] if s else 0
        if b and _div(b, n_dp):
            return NamedSharding(mesh, P(dp, *([None] * (len(s) - 1))))
        return NamedSharding(mesh, P())

    return map_with_path(spec, batch_tree)


def _kv_axes(B, H, S, dp, n_dp, tp):
    batch_ax = dp if _div(B, n_dp) else None
    head_ax = "model" if _div(H, tp) else None
    # heads not TP-divisible: shard the sequence over model instead
    seq_ax = None
    if head_ax is None:
        if batch_ax is None and _div(S, n_dp * tp):
            seq_ax = dp + ("model",)
        elif _div(S, tp):
            seq_ax = "model"
    return batch_ax, head_ax, seq_ax


def cache_shardings(cfg: ModelConfig, mesh, cache_tree: Any):
    """KV/state caches: (L, B, H, S, hd) and friends."""
    dp = _dp_axes(mesh)
    n_dp = _dp(mesh)
    tp = _tp(mesh)

    def spec(p, leaf):
        s = tuple(leaf.shape)
        if not s:                                 # pos scalar
            return NamedSharding(mesh, P())
        if p.endswith(("k", "v", "xk", "xv")) and len(s) == 5:
            L, B, H, S, hd = s
            b, h, q = _kv_axes(B, H, S, dp, n_dp, tp)
            return NamedSharding(mesh, P(None, b, h, q, None))
        if p.endswith(("k_scale", "v_scale")) and len(s) == 4:
            # (L, B, H, S) int8-KV scales: mirror the 5-D cache sharding
            L, B, H, S = s
            b, h, q = _kv_axes(B, H, S, dp, n_dp, tp)
            return NamedSharding(mesh, P(None, b, h, q))
        if p.endswith("wkv") and len(s) == 5:     # (L, B, H, dk, dv)
            L, B, H, dk, dv = s
            batch_ax = dp if _div(B, n_dp) else None
            head_ax = "model" if _div(H, tp) else None
            return NamedSharding(mesh, P(None, batch_ax, head_ax, None,
                                         None))
        if p.endswith("ssm_state") and len(s) == 4:  # (L, B, Din, N)
            L, B, Din, N = s
            batch_ax = dp if _div(B, n_dp) else None
            ch_ax = "model" if _div(Din, tp) else None
            return NamedSharding(mesh, P(None, batch_ax, ch_ax, None))
        if len(s) >= 2:                           # conv / last_* caches
            B = s[1]
            batch_ax = dp if _div(B, n_dp) else None
            return NamedSharding(mesh, P(None, batch_ax,
                                         *([None] * (len(s) - 2))))
        return NamedSharding(mesh, P())

    return map_with_path(spec, cache_tree)


def zero1_shardings(cfg: ModelConfig, mesh, params_tree: Any):
    """Optimizer-moment shardings: param spec + `data` on the first free dim.

    ZeRO-1: states sharded over the data-parallel ranks; each rank updates
    its slice of every leaf, and the new params are all-gathered."""
    tp = _tp(mesh)
    n_data = mesh.shape["data"]
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, _add_data(
            param_pspec(path, tuple(leaf.shape), cfg, tp),
            tuple(leaf.shape), n_data)), params_tree)


def replicated(mesh, tree: Any):
    return map_with_path(lambda _, __: NamedSharding(mesh, P()), tree)
