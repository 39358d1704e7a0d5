"""Per-device cost counter over torch's own op stream.

The JAX package walks the optimized HLO text of a compiled step
(`launch/hlo_count.py` there) because `cost_analysis()` counts each
`while` body once. Torch has no HLO: an eager step runs every op it does,
one at a time, so `OpCounter`, a `TorchDispatchMode`, sees each executed
op once (Python loops over layers, microbatches and loss chunks need no
trip counts) and counts on this rank's local tensors, which makes every
number per device. It runs under `FakeTensorMode` (the dry run: shapes
only, nothing allocated) or on real tensors (the same counter on a step on
the card).

Counting conventions, the JAX package's:
  * dots and the kernels' custom ops: the formula that
    `torch.utils.flop_counter` registers for the op (2*B*M*K*N for a
    matrix product; K4 and K5 register their own, see their modules);
  * sort: n*log2(n) per result of n elements;
  * elementwise, reductions and the rest: 1 op per result element;
  * data movement (views, copies, casts, concatenation, indexing, fills,
    and the writes into a region below): no op;
  * bytes: operands plus results of each op. A view moves nothing; a copy
    into a slice, an index_put_ and an index_copy_ are charged by the
    region they touch (read and write), as the JAX package charges a
    dynamic-update-slice;
  * collectives (the `c10d` ops that `torch.distributed` issues): result
    bytes per kind (all-reduce, all-gather, reduce-scatter, all-to-all,
    and collective-permute for a receive) and a count, one per op however
    many tensors it carries.

`adjusted_bytes` is `bytes`: the JAX package subtracts there the copies
that its CPU lowering adds and a TPU lowering elides; an eager step on the
card makes every copy it counts.

The counter also follows the storages the step allocates (`live_bytes`,
`peak_bytes`): each new storage is live until the last tensor on it dies.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# c10d op name (without a trailing "_") -> collective kind; None: not one
_C10D = {
    "allreduce": "all-reduce", "allreduce_coalesced": "all-reduce",
    "allgather": "all-gather", "_allgather_base": "all-gather",
    "allgather_coalesced": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall": "all-to-all", "alltoall_base": "all-to-all",
    "recv": "collective-permute", "recv_any_source": "collective-permute",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that move or make data without arithmetic (views are found from
# their schema)
_MOVEMENT = frozenset((
    "_to_copy", "clone", "copy", "copy_", "cat", "stack", "index",
    "index_select", "gather", "constant_pad_nd", "zeros", "zeros_like",
    "ones", "ones_like", "empty", "empty_like", "empty_strided", "full",
    "full_like", "new_zeros", "new_ones", "new_empty", "new_full",
    "new_empty_strided", "fill", "fill_", "zero_", "arange", "scalar_tensor",
    "lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "repeat",
    "repeat_interleave", "flip", "roll", "tril", "triu", "one_hot",
    "_unsafe_view", "contiguous", "expand_copy", "select_backward",
    "slice_backward", "index_put_", "index_put", "index_copy_",
    "index_copy", "masked_fill", "masked_fill_", "detach", "alias",
    "_pin_memory", "set_", "resize_", "copy_from", "split_with_sizes_copy",
    "unbind_copy", "view_copy", "t_copy", "transpose_copy",
    "permute_copy", "embedding", "embedding_dense_backward",
    "_reshape_alias", "as_strided_scatter",
    "slice_scatter", "select_scatter"))

_SORTS = frozenset(("sort", "argsort", "topk", "msort"))
_REGION = frozenset(("copy_", "index_put_", "index_put", "index_copy_",
                     "index_copy", "slice_scatter", "select_scatter"))
_SKIP = frozenset(("device", "barrier", "monitored_barrier_", "wait",
                   "wait_tensor", "size", "stride", "numel", "dim",
                   "is_contiguous", "sym_size", "sym_stride", "sym_numel",
                   "sym_storage_offset"))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    coll_count: float = 0.0

    @property
    def adjusted_bytes(self) -> float:
        return self.bytes

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll.values())


def _is_view(func) -> bool:
    """The op returns an alias of an input and writes nothing."""
    schema = func._schema
    if schema.is_mutable:
        return False
    return any(r.alias_info is not None for r in schema.returns)


def _is_inplace(func) -> bool:
    return func._schema.is_mutable


class OpCounter(TorchDispatchMode):
    """`with OpCounter() as c:` counts every op dispatched inside into
    `c.cost` (a `Cost`), the ops by name into `c.by_op`, and follows the
    storages made inside (`c.live_bytes`, `c.peak_bytes`)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.by_op: dict[str, float] = {}
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._refs: dict[int, list] = {}

    # -- storages -------------------------------------------------------------
    def _release(self, key):
        ent = self._refs.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live_bytes -= ent[0]
            del self._refs[key]

    def _track(self, out):
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
                key, n = st._cdata, st.nbytes()
            except (RuntimeError, NotImplementedError):
                continue
            ent = self._refs.get(key)
            if ent is None:
                ent = self._refs[key] = [n, 0]
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            ent[1] += 1
            weakref.finalize(t, self._release, key)

    # -- ops ------------------------------------------------------------------
    def _charge(self, func, args, kwargs, out):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        c = self.cost
        if ns in ("c10d", "_c10d_functional"):
            kind = _C10D.get(name.rstrip("_"))
            if kind is None:
                return
            res = _tensors(out)
            if name.startswith(("allgather", "_allgather")):
                res = _tensors(args[0])            # the gathered outputs
            elif name.startswith(("_reduce_scatter", "reduce_scatter_")) \
                    and ns == "c10d":
                res = _tensors(args[0])
            elif ns == "c10d" and name.startswith(("allreduce", "recv",
                                                   "alltoall")):
                res = _tensors(args[0])
            n = sum(_nbytes(t) for t in res)
            c.coll[kind] += n
            c.coll_count += 1
            c.bytes += 2 * n
            return
        if name in _SKIP or not _tensors(out):
            return
        self.n_ops += 1
        base = name
        if _is_view(func) and name not in _REGION:
            return
        packet = func.overloadpacket
        if base in _REGION:
            # index_put_(self, indices, values), index_copy_(self, dim,
            # index, source), copy_(self, src), *_scatter(self, src, ...)
            if base.startswith("index_put"):
                src, idx = args[2], _tensors(args[1])
            elif base.startswith("index_copy"):
                src, idx = args[3], [args[2]]
            else:
                src, idx = args[1], []
            c.bytes += 2 * _nbytes(src) + sum(_nbytes(t) for t in idx)
            return
        c.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
            sum(_nbytes(t) for t in _tensors(out))
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
        elif name.rstrip("_") in _SORTS:
            n = sum(t.numel() for t in _tensors(out)[:1])
            f = n * max(1.0, math.log2(max(n, 2)))
        elif name in _MOVEMENT or name.rstrip("_") in _MOVEMENT:
            f = 0.0
        else:
            f = float(sum(t.numel() for t in _tensors(out)[:1]))
        c.flops += f
        if f:
            key = str(packet)
            self.by_op[key] = self.by_op.get(key, 0.0) + f

    def ignore(self, *trees):
        """Leave the storages of `trees` (the step's arguments) out of the
        live bytes, views of them included."""
        for t in _tensors(trees):
            self._refs[t.untyped_storage()._cdata] = [0, math.inf]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._charge(func, args, kwargs, out)
        if func.namespace not in ("c10d", "_c10d_functional") \
                and not _is_inplace(func):
            self._track(out)
        return out


def count(fn, *args, **kwargs) -> tuple[Cost, OpCounter]:
    """Run `fn(*args, **kwargs)` under a fresh `OpCounter`: (its cost, the
    counter)."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.cost, c
