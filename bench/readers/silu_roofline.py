"""Kernel layer: lut_int8's (the int8 SiLU's table kernel) share of its
roofline over the traced stretch: the bound of the launches the profiler
recorded over their device time, in %. A launch's bound is its bytes over
the card's 3.35 TB/s, taken at the mean bytes a launch moved in the
window: the record's `lut_bytes` (the port's byte counter,
`repro_torch.kernels.byte_counts()`: each value read and written once and
the table once) over its lut_int8 launches, both read at the window's
close. Nothing where the program has no such kernel or counter."""

from harness.common import PEAK_BYTES


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "cnn" or tr is None:
        return None
    nbytes = rec.get("lut_bytes")
    launches = rec["launches"].get("lut_int8")
    n, s = 0, 0.0
    for name, (cnt, sec) in tr["kernels"].items():
        if "lut_int8_kernel" in name:
            n, s = n + cnt, s + sec
    if not nbytes or not launches or n == 0 or s <= 0:
        return None
    return 100.0 * nbytes / launches / PEAK_BYTES * n / s
