"""What every cell of the benchmark shares: the published peaks of the
card, percentiles, the host spans of a run, the check that no JAX module
was loaded, and the result line."""

from __future__ import annotations

import json
import math
import sys
import time

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W:
# int8 tensor cores, bf16 tensor cores, float32 outside the tensor cores,
# and the HBM3 bandwidth.
PEAKS = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# the top-level module names a run may not have loaded when it reports:
# JAX, its libraries, and the JAX package that the port is held against
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is forbidden: `repro_torch` passes, `repro.core`
    does not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all `values`, interpolated linearly
    between the two nearest ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    x = (len(v) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def median(values) -> float:
    return percentile(values, 50.0)


def rate(work: float, seconds: float) -> float:
    """Work over the seconds it took: every unit done in the window over
    the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


class Spans:
    """Host spans of one run: (name, start, end) on `time.perf_counter`,
    kept in memory. With `profile` on, each span is also a
    `torch.profiler.record_function` range, so the device trace can say
    what the host was doing."""

    def __init__(self, profile: bool = False):
        self.items: list[tuple[str, float, float]] = []
        self.profile = profile

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name, self.rf = owner, name, None

    def __enter__(self):
        if self.owner.profile:
            import torch
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.owner.items.append((self.name, self.t0, self.t1))
        return False


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: list,
                breakdown: dict | None = None) -> str:
    """The run's last line of standard output. `checks` are (name, value,
    limit) triples, printed last under their own key."""
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return json.dumps(out)


def print_checks(checks: list) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for name, v, lim in checks:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr,
              flush=True)
