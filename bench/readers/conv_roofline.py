"""Kernel layer: K2's (the int8 implicit-im2col conv) share of its
roofline over the traced stretch: the least time of the launches the
profiler recorded (each job launches K2 once per tiled conv of the
program's plan, whose bounds `harness.bounds.k2_launch` counts from
shapes; the launches recorded are taken at the mean bound of a job's)
over their device time, in %."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "cnn" or tr is None or not rec["k2_per_job"]:
        return None
    n, s = 0, 0.0
    for name, (cnt, sec) in tr["kernels"].items():
        if "conv2d_int8_kernel" in name:
            n, s = n + cnt, s + sec
    if n == 0 or s <= 0:
        return None
    return 100.0 * rec["k2_bound_s"] / rec["k2_per_job"] * n / s
