"""Subtask partitioning (paper §III.B step 2).

Splits every operator into *subtasks* — GEMM tiles for gemm/conv ops, row
bands for everything else — sized so a subtask's resident working set fits
the worker-core scratchpad (with room for double buffering when the
scratchpad is dual-ported, as in the paper's hardware). Large reduction dims
are *streamed*: a subtask may issue several chunked DMA loads that reuse the
same scratchpad region while accumulating into an int32 tile.

Faithfulness notes:
  * conv2d subtasks transfer the *raw* input band from DRAM and only expand
    it (im2col) inside the scratchpad — the paper's "duplication is only
    carried out in the scratchpad" rule. DRAM bytes (``Transfer.nbytes``) and
    scratchpad bytes (``Transfer.sp_bytes``) are tracked separately.
  * tile N dims are aligned to the vector-lane count (Vicuna VLEN lanes /
    TPU MXU 128-alignment) so per-core programs vectorize fully.
"""

from __future__ import annotations

import dataclasses

from .graph import Graph, OpNode, DTYPE_BYTES, conv_out_hw
from ..hw import HardwareModel


@dataclasses.dataclass
class Transfer:
    """One DMA transaction (DRAM <-> scratchpad)."""
    tensor: str
    kind: str                    # "act" | "weight" | "out"
    nbytes: int                  # bytes moved over the DMA channel
    sp_bytes: int                # bytes occupied in the scratchpad
    region: tuple = ("full",)    # ("rows", r0, r1) | ("cols", c0, c1) | ...

    def key(self) -> tuple:
        return (self.tensor, self.region)


@dataclasses.dataclass
class Subtask:
    sid: int
    op_name: str
    kind: str
    flops: float
    int8: bool
    loads: list[Transfer]
    store: Transfer | None
    sp_resident: int             # max simultaneously-resident scratchpad bytes
    deps: list[int] = dataclasses.field(default_factory=list)
    tile: dict = dataclasses.field(default_factory=dict)

    @property
    def working_set(self) -> int:
        return self.sp_resident

    def load_bytes(self) -> int:
        return sum(t.nbytes for t in self.loads)


class PartitionError(ValueError):
    pass


def _align_down(x: int, a: int) -> int:
    return max(a, (x // a) * a) if x >= a else max(1, x)


class Partitioner:
    """Graph -> list[Subtask] under a scratchpad budget."""

    def __init__(self, hw: HardwareModel, data_fraction: float = 0.5,
                 min_tiles: int | None = None):
        # Paper: 1 MiB scratchpad split into I-mem and D-mem -> data_fraction.
        self.hw = hw
        self.budget = int(hw.scratchpad_bytes * data_fraction)
        self.lanes = hw.vector_lanes_int8
        # expose at least ~2 tiles per worker per GEMM op so the layer-depth
        # critical path is divided across cores (paper §III.B: subtask size
        # depends on "the size of the local memories AND the number of cores")
        self.min_tiles = (2 * hw.num_workers if min_tiles is None
                          else min_tiles)

    # -- public --------------------------------------------------------------
    def partition(self, g: Graph) -> list[Subtask]:
        g.validate()
        subtasks: list[Subtask] = []
        producers: dict[str, list[tuple[int, tuple]]] = {}

        for op in g.ops:
            if op.kind == "gemm":
                new = self._tile_gemm(g, op, len(subtasks))
            elif op.kind == "conv2d":
                new = self._tile_conv(g, op, len(subtasks))
            else:
                new = self._tile_rows(g, op, len(subtasks))
            for st in new:
                st.deps = self._deps_for(st, producers)
                if st.store is not None:
                    producers.setdefault(st.store.tensor, []).append(
                        (st.sid, st.store.region))
                if st.working_set > self.budget:
                    raise PartitionError(
                        f"{op.name}/{st.sid}: working set {st.working_set} "
                        f"exceeds scratchpad budget {self.budget}")
            subtasks.extend(new)
        return subtasks

    # -- dependency wiring ----------------------------------------------------
    @staticmethod
    def _deps_for(st: Subtask, producers: dict) -> list[int]:
        deps: list[int] = []
        for ld in st.loads:
            if ld.kind == "weight":
                continue
            for sid, region in producers.get(ld.tensor, ()):
                if _regions_overlap(ld.region, region):
                    deps.append(sid)
        return sorted(set(deps))

    # -- unified streaming GEMM tiler ----------------------------------------
    def _gemm_geometry(self, M: int, K: int, N: int,
                       ab: int, wb: int, ob: int):
        """Pick (m_t, n_t, k_c).

        Resident set = int32 accumulator (m_t*n_t*4) + double-buffered
        streaming chunk (m_t*k_c*ab + k_c*n_t*wb) * 2.
        """
        lane = min(self.lanes, N)
        half = self.budget // 2
        n_t = _align_down(min(N, max(lane, 512)), lane)
        # prefer MXU-sized m tiles, shrink until the accumulator fits
        m_t = min(M, 512)
        while m_t * n_t * 4 > half and (m_t > 1 or n_t > lane):
            if m_t > 1:
                m_t = max(1, m_t // 2)
            else:
                n_t = _align_down(n_t - lane, lane)
        rem = self.budget - m_t * n_t * 4
        k_c = rem // (2 * (m_t * ab + n_t * wb))
        k_c = max(1, min(K, k_c))
        if k_c < 1:
            raise PartitionError(f"GEMM {M}x{K}x{N} cannot fit scratchpad")
        # grow m_t while there is head-room and k >= a full lane-chunk
        while (m_t * 2 <= M and k_c >= min(K, 4 * lane)
               and (2 * m_t) * n_t * 4
               + 2 * k_c * ((2 * m_t) * ab + n_t * wb) <= self.budget):
            m_t *= 2

        # shrink tiles until the op yields enough cross-core parallelism
        def tiles(mt, nt):
            return -(-M // mt) * -(-N // nt)

        while tiles(m_t, n_t) < self.min_tiles:
            if m_t > 32 and (M // max(1, m_t // 2)) * (N // n_t) >= \
                    tiles(m_t, n_t):
                m_t = max(32, m_t // 2)
            elif n_t > lane:
                n_t = _align_down(n_t - lane, lane)
            else:
                break
        rem = self.budget - m_t * n_t * 4
        k_c = max(1, min(K, rem // (2 * (m_t * ab + n_t * wb))))
        return int(m_t), int(n_t), int(k_c)

    def _emit_gemm_tiles(self, g, op, next_id, M, K, N, x, w, y,
                         kind, raw_act_bytes=None, row_map=None):
        """Shared tile emission for gemm and conv-as-gemm.

        raw_act_bytes(m0, m1) -> (dram_bytes, region) lets conv override the
        activation transfer with the raw (un-duplicated) input band.
        """
        ab = DTYPE_BYTES[g.tensors[x].dtype]
        wb = DTYPE_BYTES[g.tensors[w].dtype]
        ob = DTYPE_BYTES[g.tensors[y].dtype]
        int8 = g.tensors[x].dtype in ("int8", "uint8")
        m_t, n_t, k_c = self._gemm_geometry(M, K, N, ab, wb, ob)
        n_chunks = -(-K // k_c)

        out: list[Subtask] = []
        for m0 in range(0, M, m_t):
            m1 = min(M, m0 + m_t)
            for n0 in range(0, N, n_t):
                n1 = min(N, n0 + n_t)
                loads: list[Transfer] = []
                for ci in range(n_chunks):
                    k0, k1 = ci * k_c, min(K, (ci + 1) * k_c)
                    if raw_act_bytes is None:
                        loads.append(Transfer(
                            x, "act", (m1 - m0) * (k1 - k0) * ab,
                            (m1 - m0) * (k1 - k0) * ab,
                            ("rows", m0, m1)))
                    else:
                        nb, reg = raw_act_bytes(m0, m1)
                        loads.append(Transfer(
                            x, "act", max(1, nb // n_chunks),
                            (m1 - m0) * (k1 - k0) * ab, reg))
                    loads.append(Transfer(
                        w, "weight", (k1 - k0) * (n1 - n0) * wb,
                        (k1 - k0) * (n1 - n0) * wb,
                        ("cols", n0, n1, k0, k1)))
                if row_map is not None:
                    r0, r1 = row_map(m0, m1)
                    store_reg = ("rows", r0, r1)
                else:
                    store_reg = ("rows", m0, m1)
                store = Transfer(y, "out", (m1 - m0) * (n1 - n0) * ob,
                                 (m1 - m0) * (n1 - n0) * ob, store_reg)
                resident = (m1 - m0) * (n1 - n0) * 4 + 2 * min(K, k_c) * (
                    (m1 - m0) * ab + (n1 - n0) * wb)
                out.append(Subtask(
                    sid=next_id + len(out), op_name=op.name, kind=kind,
                    flops=2.0 * (m1 - m0) * K * (n1 - n0), int8=int8,
                    loads=loads, store=store, sp_resident=resident,
                    tile={"m0": m0, "m1": m1, "n0": n0, "n1": n1, "K": K,
                          "k_c": k_c}))
        return out

    def _tile_gemm(self, g: Graph, op: OpNode, next_id: int) -> list[Subtask]:
        a = op.attrs
        return self._emit_gemm_tiles(
            g, op, next_id, a["M"], a["K"], a["N"],
            op.inputs[0], op.weights[0], op.outputs[0], "gemm")

    # -- conv (GEMM-based, implicit im2col) -----------------------------------
    def _tile_conv(self, g: Graph, op: OpNode, next_id: int) -> list[Subtask]:
        a = op.attrs
        oh, ow = conv_out_hw(a)
        K = a["kh"] * a["kw"] * a["C_in"]
        N = a["C_out"]
        s, p, kh = a["stride"], a["padding"], a["kh"]
        x = op.inputs[0]
        ab = DTYPE_BYTES[g.tensors[x].dtype]
        H_in, W_in, C_in = g.tensors[x].shape

        def raw_act_bytes(m0, m1):
            # output rows covered by flat positions [m0, m1)
            r0, r1 = m0 // ow, (m1 - 1) // ow + 1
            i0 = max(0, r0 * s - p)
            i1 = min(H_in, (r1 - 1) * s - p + kh)
            return (i1 - i0) * W_in * C_in * ab, ("rows", i0, i1)

        def row_map(m0, m1):
            return m0 // ow, (m1 - 1) // ow + 1

        return self._emit_gemm_tiles(
            g, op, next_id, oh * ow, K, N,
            x, op.weights[0], op.outputs[0], "conv2d",
            raw_act_bytes=raw_act_bytes, row_map=row_map)

    # -- everything else: row bands -------------------------------------------
    def _tile_rows(self, g: Graph, op: OpNode, next_id: int) -> list[Subtask]:
        y = g.tensors[op.outputs[0]]
        ins = [g.tensors[t] for t in op.inputs]
        rows = y.shape[0]
        per_row = (sum(t.nbytes // max(1, t.shape[0]) for t in ins)
                   + y.nbytes // max(1, rows))
        rows_t = max(1, min(rows, (self.budget // 2) // max(1, per_row)))
        out: list[Subtask] = []
        total_flops = op.flops(g)
        for r0 in range(0, rows, rows_t):
            r1 = min(rows, r0 + rows_t)
            frac = (r1 - r0) / rows
            loads = []
            for t in ins:
                nb = int(t.nbytes * frac) if t.shape[0] == rows else t.nbytes
                reg = (("rows", r0, r1) if t.shape[0] == rows else ("full",))
                if op.kind in ("maxpool", "avgpool", "gap"):
                    k = op.attrs.get("k", t.shape[0])
                    st_ = op.attrs.get("stride", 1)
                    i0 = r0 * st_
                    i1 = min(t.shape[0], (r1 - 1) * st_ + k)
                    nb = max(1, int(t.nbytes * (i1 - i0) / t.shape[0]))
                    reg = ("rows", i0, i1)
                loads.append(Transfer(t.name, "act", nb, nb, reg))
            st_bytes = max(1, int(y.nbytes * frac))
            store = Transfer(y.name, "out", st_bytes, st_bytes,
                             ("rows", r0, r1))
            resident = sum(t.sp_bytes for t in loads) + st_bytes
            out.append(Subtask(
                sid=next_id + len(out), op_name=op.name, kind=op.kind,
                flops=total_flops * frac, int8=False, loads=loads,
                store=store, sp_resident=resident,
                tile={"r0": r0, "r1": r1}))
        return out


def _regions_overlap(a: tuple, b: tuple) -> bool:
    if a[0] == "full" or b[0] == "full":
        return True
    if a[0] == "rows" and b[0] == "rows":
        return a[1] < b[2] and b[1] < a[2]
    if a[0] == "cols" and b[0] == "cols":
        return a[1] < b[2] and b[1] < a[2]
    return True
