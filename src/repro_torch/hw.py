"""Deterministic hardware model.

Two instantiations of the same abstract machine:

* ``TPU_V5E`` — the deployment target for the framework (roofline constants
  given by the task spec).
* ``PAPER_RISCV`` — the paper's FPGA configuration (16 Ibex+Vicuna worker
  cores, 512-bit vector registers, 1 MiB scratchpads, shared DDR4), used by
  the paper-faithful benchmarks so the reproduction is runnable at the
  paper's own scale.

The WCET model (upper bounds) and the roofline model (lower bounds) both read
these constants; they are the *same three terms* seen from opposite sides
(see DESIGN.md §6).
"""

from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Deterministic per-worker machine model.

    All rates are peak; WCET derates them with ``wcet_margin`` while the
    roofline uses them as-is.
    """

    name: str
    num_workers: int                 # worker cores (paper) / chips (TPU)
    # -- compute --
    peak_flops_bf16: float           # FLOP/s per worker (fp path)
    peak_ops_int8: float             # OP/s per worker (int8 MAC path)
    vector_lanes_int8: int           # SIMD width in int8 elements
    core_clock_hz: float
    # -- local memory (scratchpad / VMEM) --
    scratchpad_bytes: int
    scratchpad_bw: float             # bytes/s core<->scratchpad
    dual_ported: bool                # DMA may fill while core computes
    # -- shared memory (DRAM / HBM) --
    dram_bw: float                   # bytes/s on the single DMA channel
    dram_latency_s: float            # fixed per-transaction setup cost
    # -- interconnect (crossbar / ICI) --
    link_bw: float                   # bytes/s per link
    dma_channels: int = 1            # paper: exactly one transaction at a time
    # -- analysis --
    wcet_margin: float = 1.25        # multiplicative safety margin on bounds
    # -- scale-out (repro_torch.cluster) --
    # (data, model) jax device-mesh shape the compiled program is sharded
    # over, or None for single-device execution. Part of the dataclass, so
    # `fingerprint()` folds it in: an artifact compiled for one mesh shape
    # refuses to load against any other (Deployment.load).
    mesh_shape: tuple | None = None

    # Derived helpers -------------------------------------------------------
    def fingerprint(self) -> str:
        """Stable hash over every model constant.

        Two HardwareModel instances with identical constants fingerprint
        identically (the machine half of the compiled-artifact cache key);
        any constant change — even the WCET margin — changes the
        fingerprint, so a `Deployment` compiled for one machine refuses to
        load against another (repro_torch.compiler.Deployment.load).
        """
        h = hashlib.sha256()
        for f in dataclasses.fields(self):
            h.update(f"{f.name}={getattr(self, f.name)!r}\n".encode())
        return h.hexdigest()[:16]

    def compute_time_s(self, flops: float, int8: bool = False) -> float:
        """Lower-bound execution time of `flops` on one worker."""
        peak = self.peak_ops_int8 if int8 else self.peak_flops_bf16
        return flops / peak

    def dma_time_s(self, nbytes: float) -> float:
        """Lower-bound time of one DMA transaction of `nbytes`."""
        return self.dram_latency_s + nbytes / self.dram_bw

    def wcet_compute_s(self, flops: float, int8: bool = False) -> float:
        return self.compute_time_s(flops, int8) * self.wcet_margin

    def wcet_dma_s(self, nbytes: float) -> float:
        return self.dma_time_s(nbytes) * self.wcet_margin

    def with_mesh(self, data: int = 1, model: int = 1) -> "HardwareModel":
        """The same machine targeted at a (data, model) jax device mesh.

        The mesh-sharded executor (`repro_torch.cluster.mesh`, backend "mesh")
        maps the machine's worker cores in contiguous blocks onto the
        `model` axis and the serving batch onto the `data` axis. The new
        machine's name and fingerprint both carry the mesh shape, so mesh
        artifacts and single-device artifacts never interchange silently.
        """
        if data < 1 or model < 1:
            raise ValueError(
                f"mesh axes must be >= 1, got data={data} model={model}")
        return dataclasses.replace(
            self, name=f"{self.name}+mesh{data}x{model}",
            mesh_shape=(data, model))


# TPU v5e: constants fixed by the task spec.
TPU_V5E = HardwareModel(
    name="tpu_v5e",
    num_workers=256,                       # one pod slice (16x16 mesh)
    peak_flops_bf16=197e12,
    peak_ops_int8=394e12,                  # MXU int8 path = 2x bf16
    vector_lanes_int8=8 * 128 * 4,         # VPU 8x128 lanes, 4B granules
    core_clock_hz=940e6,
    scratchpad_bytes=128 * 1024 * 1024,    # VMEM
    scratchpad_bw=22e12,                   # VMEM bw (approx, structural only)
    dual_ported=True,                      # Pallas double-buffering
    dram_bw=819e9,                         # HBM per chip
    dram_latency_s=1e-6,
    link_bw=50e9,                          # ICI per link
    dma_channels=1,
    wcet_margin=1.25,
)

# The paper's implementation: 16 worker cores, Vicuna VLEN=512 (64 int8 lanes),
# 1 MiB scratchpad each, DDR4 on an UltraScale+ board. Rates are derived from
# the paper's cited components: Ibex+Vicuna at ~100 MHz FPGA clock; Vicuna
# sustains ~1 MAC/lane/cycle on int8 (Platzer & Puschner, ECRTS'21); a single
# 64-bit DDR4-2400 channel ~19.2 GB/s peak, derated to 12.8 GB/s usable.
PAPER_RISCV = HardwareModel(
    name="paper_riscv16",
    num_workers=16,
    peak_flops_bf16=0.1e9 * 64 * 2 / 4,    # no fp vector path; placeholder
    peak_ops_int8=0.1e9 * 64 * 2,          # 100MHz * 64 lanes * 2 (MAC=2 ops)
    vector_lanes_int8=64,                  # VLEN=512 / 8
    core_clock_hz=100e6,
    scratchpad_bytes=1 * 1024 * 1024,
    scratchpad_bw=0.1e9 * 64,              # one 512b port/cycle
    dual_ported=True,
    dram_bw=12.8e9,
    dram_latency_s=200e-9,
    link_bw=6.4e9,                         # TL-UL crossbar port
    dma_channels=1,
    wcet_margin=1.25,
)


# -- scratchpad-derived kernel tiling -----------------------------------------
#
# The paper's partitioner sizes GEMM tiles so that x-tile + w-tile + int32
# accumulator fit in one core's scratchpad; the Pallas backend of the
# compiled executor (repro_torch.core.compiled.run_pallas) derives its BlockSpec
# shapes from the same constraint so the kernel grid mirrors the SPM
# streaming the schedule models. Streamed tiles (activations + weights)
# are double-buffered on a dual-ported scratchpad — they count twice —
# while the accumulator and output tile are resident once.

_GEMM_BLOCK_CANDIDATES = (1024, 512, 256, 128, 64, 32, 16, 8)
_CONV_ROWS_CANDIDATES = (16, 8, 4, 2, 1)
_CONV_BN_CANDIDATES = (256, 128, 64, 32, 16, 8)


def _gemm_tile_bytes(hw: HardwareModel, bm: int, bn: int, bk: int,
                     out_bytes: int) -> int:
    stream = bm * bk + bk * bn               # int8 x-tile + w-tile
    if hw.dual_ported:
        stream *= 2                          # double-buffered prefetch
    return stream + bm * bn * 4 + bm * bn * out_bytes


def derive_gemm_blocks(hw: HardwareModel, M: int, K: int, N: int,
                       out_bytes: int = 4) -> tuple[int, int, int]:
    """(bm, bn, bk) for a tiled int8 GEMM such that the working set fits in
    one worker's scratchpad (`hw.scratchpad_bytes`).

    Returns the largest square block from a lane-friendly candidate list
    whose footprint — double-buffered x/w tiles + int32 accumulator + output
    tile — fits; the kernel wrapper clamps each block to the actual problem
    dims. `out_bytes` is 1 when requantization is fused into the epilogue
    (int8 output tile), 4 for a raw int32 output.
    """
    for b in _GEMM_BLOCK_CANDIDATES:
        if _gemm_tile_bytes(hw, b, b, b, out_bytes) <= hw.scratchpad_bytes:
            return b, b, b
    return (8, 8, 8)                         # model floor; always correct


def derive_conv_blocks(hw: HardwareModel, attrs: dict,
                       out_bytes: int = 4) -> tuple[int, int]:
    """(rows_t, bn) for the implicit-im2col conv kernel such that one raw
    input band (with halo) + weight tile + int32 accumulator fit in SPM.

    `attrs` is a graph conv2d attr dict (H, W, C_in, C_out, kh, kw, stride,
    padding). Picks the candidate pair with the largest output-tile area
    that fits; falls back to the smallest candidate (correct regardless —
    block shapes only affect the streaming decomposition, never numerics).
    """
    kh, kw, s = attrs["kh"], attrs["kw"], attrs["stride"]
    p, c_in = attrs.get("padding", 0), attrs["C_in"]
    ow = (attrs["W"] + 2 * p - kw) // s + 1
    wp = (ow - 1) * s + kw                   # padded band width actually read
    best = None
    for rows_t in _CONV_ROWS_CANDIDATES:
        in_rows = (rows_t - 1) * s + kh
        for bn in _CONV_BN_CANDIDATES:
            stream = in_rows * wp * c_in + kh * kw * c_in * bn
            if hw.dual_ported:
                stream *= 2
            total = stream + rows_t * ow * bn * (4 + out_bytes)
            if total <= hw.scratchpad_bytes:
                # candidates descend: first fit is the largest bn for this
                # rows_t; the outer loop still compares across rows_t values
                if best is None or rows_t * ow * bn > best[0]:
                    best = (rows_t * ow * bn, rows_t, bn)
                break
    if best is None:
        return _CONV_ROWS_CANDIDATES[-1], _CONV_BN_CANDIDATES[-1]
    return best[1], best[2]


def scaled_paper_machine(num_workers: int,
                         scratchpad_bytes: int | None = None,
                         vector_lanes: int | None = None) -> HardwareModel:
    """The paper's §V outlook: sweep cores / VLEN / scratchpad size."""
    base = PAPER_RISCV
    lanes = vector_lanes or base.vector_lanes_int8
    return dataclasses.replace(
        base,
        name=f"paper_riscv{num_workers}_v{lanes * 8}",
        num_workers=num_workers,
        vector_lanes_int8=lanes,
        peak_ops_int8=base.core_clock_hz * lanes * 2,
        peak_flops_bf16=base.core_clock_hz * lanes * 2 / 4,
        scratchpad_bw=base.core_clock_hz * lanes,
        scratchpad_bytes=scratchpad_bytes or base.scratchpad_bytes,
    )
