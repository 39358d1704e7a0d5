"""Operations and bytes of the served work, computed from shapes.

A kernel's bound is the larger of its bytes over the card's bandwidth and
its operations over the peak rate of their type, each input byte read once
and each output byte written once (the method of the port's smoke run,
whose `Bound` and K2 count these are copies of). A
roofline share is the bound over the measured device time."""

from __future__ import annotations

from .common import PEAK_BYTES, PEAKS


class Bound:
    """Sums of the two halves of the bound over a kernel's shapes, in
    seconds."""

    def __init__(self):
        self.bytes_s = self.ops_s = self.s = 0.0

    def add(self, nbytes: float, ops: float, peak_ops: float) -> float:
        b, o = nbytes / PEAK_BYTES, ops / peak_ops
        self.bytes_s += b
        self.ops_s += o
        self.s += max(b, o)
        return max(b, o)

    @property
    def by(self) -> str:
        return "bytes" if self.bytes_s >= self.ops_s else "operations"


def k2_launch(bd: Bound, B: int, H: int, W: int, C_in: int, M: int, K: int,
              N: int, requant: bool) -> float:
    """One launch of K2 (the int8 implicit-im2col conv) over B frames: the
    input, the (K, N) weights and the output once (int8 after a fused
    requant, int32 without), against 2 M N K operations per frame."""
    return bd.add(B * H * W * C_in + K * N + B * M * N * (1 if requant
                                                          else 4),
                  2.0 * B * M * N * K, PEAKS["int8"])


# -- model work ----------------------------------------------------------------

def cnn_ops_per_frame(shapes: list[dict]) -> float:
    """The int8 operations of one frame: 2 M K N over every conv and the
    classifier."""
    return sum(2.0 * s["M"] * s["K"] * s["N"] for s in shapes)
