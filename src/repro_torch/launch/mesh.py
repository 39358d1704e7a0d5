"""Host meshes over `torch.distributed`.

The JAX package builds a `jax.sharding.Mesh` over the devices one
controller sees. Torch runs one process per rank (every rank runs the same
program, JAX's multi-controller model), so a mesh here is this rank's place
in the (pod, data, model) grid and the process groups of its data and model
axes. Nothing touches `torch.distributed` at import time.

The device count is the world size of the default process group, or 1 when
no group is initialized (the counterpart of `len(jax.devices())`). A mesh
smaller than the world is repeated: rank r belongs to mesh copy
r // (pod * data * model), and every copy computes the same values.
`make_production_mesh` builds the 16 x 16 or 2 x 16 x 16 mesh on a world of
exactly that size.
"""

from __future__ import annotations

import dataclasses
import math
import threading

_LOCK = threading.Lock()
_MESHES: dict[tuple, tuple] = {}


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """This rank's coordinates in a (pod,) data x model grid, and the
    process groups of its data and model axes (None when no process group
    is initialized: a one-rank mesh, whose collectives are skipped; with a
    group, they run even on axes of size 1)."""

    shape: dict                    # {"pod": p,} "data": d, "model": m
    rank: int
    world: int
    data_index: int
    model_index: int
    data_group: object = None
    model_group: object = None
    dp_group: object = None        # pod x data, when the mesh has pods
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def group(self, axes):
        """The process group of this rank's copy along `axes` (a name or a
        tuple of names in mesh order), or None without a process group."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not self.distributed:
            return None
        return self.groups[axes]

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return {"pod": self.pod_index, "data": self.data_index,
                "model": self.model_index}[axis]

    @property
    def size(self) -> int:
        """Ranks in one copy of the mesh (the product of the axes)."""
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def pod_index(self) -> int:
        return (self.rank % self.size) // (self.shape["data"]
                                           * self.shape["model"])

    @property
    def dp_index(self) -> int:
        """This rank's place among the data-parallel ranks (pod x data)."""
        return self.pod_index * self.shape["data"] + self.data_index

    @property
    def dp_size(self) -> int:
        return self.shape.get("pod", 1) * self.shape["data"]

    @property
    def data_parallel_group(self):
        """The group of the data-parallel ranks (pod x data) that share
        this rank's model index."""
        return self.dp_group if "pod" in self.shape else self.data_group

    @property
    def distributed(self) -> bool:
        """True when a process group is initialized: the collectives run
        (through its backend) even on axes of size 1."""
        return self.model_group is not None


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _world_size() -> int:
    """World size of the default process group, or 1 without one."""
    if _initialized():
        import torch.distributed as dist
        return dist.get_world_size()
    return 1


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0) -> HostMesh:
    """Small mesh over however many ranks the default process group has.

    The axis product must divide the rank count: a 3-rank mesh on an
    8-rank world would strand ranks, which downstream code then mistakes
    for full sharding. Raises `ValueError` naming the axis sizes and the
    rank count when `data * model * pod` does not divide it.

    Every rank of the world must call this with the same axes, in the same
    order as its other group creations (`dist.new_group` is collective).
    Meshes are cached per (axes, world), so later calls create no group.
    """
    if data < 1 or model < 1 or pod < 0:
        raise ValueError(
            f"mesh axis sizes must be positive (pod >= 0), got "
            f"data={data} model={model} pod={pod}")
    n_devices = _world_size()
    product = data * model * (pod or 1)
    if n_devices % product != 0:
        axes_s = (f"pod={pod} data={data} model={model}" if pod
                  else f"data={data} model={model}")
        raise ValueError(
            f"mesh shape {axes_s} (= {product} devices) does not divide "
            f"the {n_devices} available device(s); pick axis sizes whose "
            f"product divides the device count")
    shape = ({"pod": pod} if pod else {}) | {"data": data, "model": model}
    if not _initialized():
        return HostMesh(shape=shape, rank=0, world=1, data_index=0,
                        model_index=0)
    import torch.distributed as dist
    world = dist.group.WORLD
    key = (pod, data, model, id(world))
    with _LOCK:
        hit = _MESHES.get(key)
        # the entry keeps its default group alive, so its id() is not
        # recycled by a later `init_process_group`
        if hit is None or hit[0] is not world:
            hit = _MESHES[key] = (world, _build(
                shape, data, model, product, n_devices, dist.get_rank()))
    return hit[1]


def _build(shape: dict, data: int, model: int, product: int, world: int,
           rank: int) -> HostMesh:
    """Create the groups of every set of the mesh's axes, for every mesh
    copy (all ranks, same order), and keep this rank's. Layout per copy:
    model fastest, then data, then pod, as `jax.make_mesh` orders the
    devices; a group lists its ranks in that order, so its rank order is
    the order in which JAX flattens the axes of a multi-axis spec entry."""
    import itertools

    import torch.distributed as dist
    names = tuple(shape)
    sizes = [shape[a] for a in names]
    strides = [math.prod(sizes[i + 1:]) for i in range(len(names))]
    mine = {}
    for n_axes in range(1, len(names) + 1):
        for axes in itertools.combinations(range(len(names)), n_axes):
            rest = [i for i in range(len(names)) if i not in axes]
            for base in range(0, world, product):
                for fixed in itertools.product(*(range(sizes[i])
                                                 for i in rest)):
                    off = base + sum(c * strides[i]
                                     for c, i in zip(fixed, rest))
                    ranks = sorted(
                        off + sum(c * strides[i] for c, i in zip(cs, axes))
                        for cs in itertools.product(*(range(sizes[i])
                                                      for i in axes)))
                    grp = dist.new_group(ranks)
                    if rank in ranks:
                        mine[tuple(names[i] for i in axes)] = grp
    local = rank % (data * model)
    return HostMesh(shape=shape, rank=rank, world=world,
                    data_index=local // model, model_index=local % model,
                    data_group=mine[("data",)], model_group=mine[("model",)],
                    dp_group=mine.get(("pod", "data")), groups=mine)


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """The 16 x 16 single pod (256 ranks) or the 2 x 16 x 16 two-pod
    (512 ranks) mesh. The world (the default process group's size, or 1)
    must be exactly that many ranks: `ValueError` names it otherwise.
    (The JAX package's `axis_types_kw` shim, which papers over jax
    versions' mesh keywords, has no torch counterpart.)"""
    pod, data, model = (2, 16, 16) if multi_pod else (0, 16, 16)
    need = data * model * (pod or 1)
    world = _world_size()
    if world != need:
        raise ValueError(
            f"the production mesh {'2x16x16' if multi_pod else '16x16'} "
            f"needs {need} ranks; the world has {world}")
    return make_host_mesh(data=data, model=model, pod=pod)
