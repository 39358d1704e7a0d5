"""Tensor parallelism inside the layers, on this rank's slices.

The JAX package lets GSPMD derive the collectives of a step from the
shardings of its inputs. The port runs each rank on its slices
(`NamedSharding.shard`) with explicit collectives, Megatron style, through
`collectives`' autograd operators:

  * a column-parallel weight (output dim cut over `model`) multiplies the
    replicated input into this rank's slice of the output; when the slice
    is whole heads (or channels of whole heads) the layer goes on with
    its local heads, otherwise it gathers the output whole first;
  * a row-parallel weight (input dim cut) multiplies this rank's slice of
    the input and the partial products are summed over `model`;
  * a replicated param or value used on this rank's slice only (a bias of
    a cut projection, a per-head scale) is taken through `split` or
    `enter`, so that its gradient is whole on every rank;
  * a param cut over `data` (cfg.fsdp's ZeRO-3, moe experts over data) is
    gathered whole over the data group where its layer uses it
    (`layer_whole`, inside the layer's remat, so that only this rank's
    slice stays saved and the recomputation gathers it again), and its
    gradient is reduce-scattered back to the slice there. A leaf outside
    the stacked layers, or a stacked leaf cut on its layer dim (whose
    layers lie on different ranks), is gathered when the step starts
    (`materialize`).

Whether a weight is cut is read from its shape against the whole size
the caller names (`cut`: a leaf that does not divide over the axis stays
whole, as `param_pspec` rules); whether its slice holds whole heads,
from `Axis.divides`. With no mesh in the context, or a model axis of 1,
every helper is the plain computation.
"""

from __future__ import annotations

import dataclasses

import torch

from . import collectives as C
from .context import current_layout, current_mesh


@dataclasses.dataclass(frozen=True)
class Axis:
    """This rank's place on one mesh axis (or a product of axes): its
    size, index and process group."""

    n: int = 1
    index: int = 0
    group: object = None

    def enter(self, x):
        return C.enter(x, self.group) if self.n > 1 else x

    def reduce(self, x):
        return C.reduce(x, self.group) if self.n > 1 else x

    def gather(self, x, dim):
        return C.gather(x, dim, self.group) if self.n > 1 else x

    def split(self, x, dim):
        return C.split(x, dim, self.group) if self.n > 1 else x

    def all_reduce(self, x, op="sum"):
        return C.all_reduce(x, self.group, op) if self.n > 1 else x

    def all_gather(self, x, dim):
        """`gather` without autograd (serving caches)."""
        return C.all_gather_cat(x, dim, self.group) if self.n > 1 else x

    def divides(self, n: int) -> bool:
        """True when `n` parts (heads, channels) split whole over this
        axis of more than one rank."""
        return self.n > 1 and n % self.n == 0

    def local(self, x, dim):
        """This rank's slice of a whole tensor on `dim`, without
        autograd."""
        if self.n == 1:
            return x
        k = x.shape[dim] // self.n
        return x.narrow(dim, self.index * k, k)


def model_axis() -> Axis:
    """The model axis of the mesh in the context (size 1 without one)."""
    mesh = current_mesh()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return Axis()
    if not mesh.distributed:
        raise RuntimeError("a model axis above 1 needs a process group")
    return Axis(mesh.shape["model"], mesh.model_index, mesh.group("model"))


def cache_seq_axis(name: str) -> Axis:
    """The axes that cut the position dim (dim 3) of cache leaf `name`
    under the context's cache layout (`cache_shardings` cuts it when the
    kv heads do not divide over `model`)."""
    layout = current_layout("cache")
    if layout is None or name not in layout:
        return Axis()
    s = layout[name]
    axes = s.names(3)
    if not axes:
        return Axis()
    return Axis(s.axes_size(axes), s.axes_index(axes), s.mesh.group(axes))


def cut(w: torch.Tensor, dim: int, full: int) -> bool:
    """True when `w` holds a slice of its `dim` (of whole size `full`)."""
    return w.shape[dim] != full


def col(x, w, full: int, ax: Axis, bias=None):
    """x @ w (+ bias) for a column-parallel `w` of `full` outputs: this
    rank's slice of the output when w is cut, else the whole output."""
    if not cut(w, -1, full):
        y = x @ w
        return y if bias is None else y + bias
    y = ax.enter(x) @ w
    return y if bias is None else y + ax.split(bias, -1)


def col_whole(x, w, full: int, ax: Axis, bias=None):
    """`col`, gathered whole when w is cut."""
    y = col(x, w, full, ax, bias)
    return ax.gather(y, -1) if y.shape[-1] != full else y


def col_heads(x, w, heads: int, hd: int, ax: Axis, bias=None):
    """A column-parallel projection into `heads` heads of `hd`: this
    rank's heads when w is cut on whole heads, else all of them."""
    y = col(x, w, heads * hd, ax, bias)
    if y.shape[-1] != heads * hd and not ax.divides(heads):
        y = ax.gather(y, -1)
    return y


def row(h, w, full: int, ax: Axis):
    """h @ w for a row-parallel `w` of `full` inputs: with w cut, this
    rank's slice of h times w, summed over `model`."""
    if not cut(w, -2, full):
        return h @ w
    if h.shape[-1] == full:
        h = ax.split(h, -1)
    return ax.reduce(h @ w)


# the stacked trees of params, whose leaves carry a leading layer dim
STACKED = ("layers", "enc_layers", "dec_layers")


def _on_layers(s) -> bool:
    """True when sharding `s` of a stacked leaf cuts its layer dim over
    data (`_add_data` may: then each layer lies on one rank)."""
    return any(dim == 0 for dim, _ in s.data_cuts())


def _gather_data(s, x, shift: int = 0):
    """`x` (this rank's slice under `s`, less its first `shift` dims)
    gathered whole over the data axes that cut it (autograd: the gradient
    is reduce-scattered back to the slice)."""
    for dim, axes in reversed(s.data_cuts()):
        x = C.gather_rs(x, dim - shift, s.mesh.group(axes))
    return x


def materialize(params):
    """`params` with the leaves cut over a data axis gathered whole over
    that axis, by the context's `params` layout: every leaf outside the
    stacked layers, and the stacked leaves cut on their layer dim. The
    other stacked leaves are gathered per layer (`layer_whole`)."""
    layout = current_layout("params")
    if layout is None:
        return params
    from ..tree import tree_map
    return {k: tree_map(lambda s, x: _gather_data(s, x)
                        if k not in STACKED or _on_layers(s) else x,
                        layout[k], v)
            for k, v in params.items()}


def layer_whole(pl_, key: str):
    """One layer `pl_` of the stacked tree `params[key]`, with each leaf
    that is cut over a data axis gathered whole (autograd: its gradient
    reduce-scattered back to the slice), by the context's layout. Called
    inside the layer (under remat, in its recomputation too)."""
    layout = current_layout("params")
    if layout is None:
        return pl_
    from ..tree import tree_map
    return tree_map(lambda s, x: x if _on_layers(s) else _gather_data(s, x, 1),
                    layout[key], pl_)
