"""Roofline terms of one step on one device, from the op counter.

Sources (the JAX package reads a compiled XLA program; torch has none):
  * `hlo_count.OpCounter` over the step run on this rank's tensors ->
    per-device FLOPs, bytes and collective bytes by kind.

Terms (seconds, per device = per step wall-clock lower bounds), for one
NVIDIA H100 SXM (80 GB HBM3) at its full 700 W power limit, from NVIDIA's
data sheet:
  compute    = FLOPs / 989e12 FLOP/s     (dense bf16/fp16 tensor cores)
  memory     = bytes / 3.35e12 B/s       (HBM3)
  collective = collective bytes / 450e9 B/s (NVLink 4, per direction)

An HGX H100 node holds 8 cards on one NVLink switch. The production
meshes' 16-wide model axis spans two nodes, so its collectives also cross
the network between nodes (400 Gb/s InfiniBand NDR, 50e9 B/s per card, is
the common fabric), which this one-rate model does not separate: the
collective term is a lower bound there. A card set below 700 W runs slower
under load.
"""

from __future__ import annotations

import dataclasses

from .hlo_count import Cost

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(cost: Cost) -> dict[str, float]:
    """Result bytes per collective kind, and the count of collective ops,
    from a counted run."""
    out = {k: cost.coll[k] for k in _COLLECTIVES}
    out["count"] = cost.coll_count
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    device_flops: float
    device_bytes: float
    device_collective_bytes: float
    collective_breakdown: dict
    model_flops: float                 # analytic 6ND (or decode 2ND) global
    chips: int
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    raw_xla_flops: float = 0.0         # no compiled program: the counter's
    raw_xla_bytes: float = 0.0
    device_bytes_raw: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.device_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.device_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.device_collective_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (device FLOPs x chips): remat/redundancy waste."""
        hw = self.device_flops * self.chips
        return self.model_flops / hw if hw else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline bound."""
        denom = self.bound_s * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.device_flops,
            "hlo_bytes_per_dev": self.device_bytes,
            "coll_bytes_per_dev": self.device_collective_bytes,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_mfu": self.mfu,
            "raw_xla_flops": self.raw_xla_flops,
            "raw_xla_bytes": self.raw_xla_bytes,
            "hlo_bytes_per_dev_raw": self.device_bytes_raw,
        }


def analyze_counted(arch: str, shape: str, mesh_name: str, cost: Cost,
                    model_flops: float, chips: int) -> Roofline:
    """The JAX package's `analyze_compiled` on a counted run: the
    counter's numbers are per device already (each executed op once), so
    the raw fields repeat them."""
    return Roofline(arch=arch, shape=shape, mesh=mesh_name,
                    device_flops=cost.flops,
                    device_bytes=cost.adjusted_bytes,
                    device_collective_bytes=float(cost.collective_bytes),
                    collective_breakdown=collective_bytes(cost),
                    model_flops=model_flops, chips=chips,
                    raw_xla_flops=cost.flops, raw_xla_bytes=cost.bytes,
                    device_bytes_raw=cost.bytes)


def model_flops_for(cfg, cell, n_active: int) -> float:
    """Analytic MODEL_FLOPS for a cell: train 6ND, prefill 2ND,
    decode 2N per token x batch."""
    if cell.kind == "train":
        tokens = cell.seq_len * cell.global_batch
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.seq_len * cell.global_batch
        return 2.0 * n_active * tokens
    return 2.0 * n_active * cell.global_batch   # decode: one token/request
