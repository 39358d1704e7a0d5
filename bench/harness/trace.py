"""The device trace of a traced run: `torch.profiler` over a stated steady
stretch of the window, reduced to busy time, time by kernel, the host's
activity in the device's idle gaps, and each host span's device time.

The profiler loses the records of a window's first kernel launches (a
block of 14-20, late in a long run), so the stretch opens with LEAD_IN
tiny spin kernels that take the loss and are left out."""

from __future__ import annotations

LEAD_IN = 128
STRETCH = "bench.stretch"


def _short(name: str) -> str:
    s = name.replace("(anonymous namespace)::", "")
    return s.split("(")[0].split("<")[0][-60:] or name[:60]


class Stretch:
    """Profile from `start()` to `stop()`; `stop()` returns the reduced
    trace (see `reduce`). The drivers start it `min(2 s, a quarter of the
    window)` before the window closes and stop it once it has closed, so
    the profiler's own processing stays out of the window."""

    def __init__(self, torch, span_names):
        self.torch = torch
        self.span_names = set(span_names) | {STRETCH}

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        (CUPTI's) takes about a second, which the stretch must not."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            self.torch.cuda._sleep(100)
            self.torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(LEAD_IN):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        self.rf = torch.profiler.record_function(STRETCH)
        self.rf.__enter__()

    def stop(self) -> dict:
        self.torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        host, dev = [], []
        for ev in self.prof.events():
            t0, t1 = ev.time_range.start, ev.time_range.end
            if str(ev.device_type).endswith("CUDA"):
                if "spin_kernel" in ev.name or ev.name in self.span_names:
                    continue
                dev.append((ev.name, t0, t1))
            else:
                host.append((ev.name, t0, t1))
        return reduce(host, dev, self.span_names)


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(merged, a, b) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


def _innermost(events, points) -> list:
    """For each of the sorted `points`, the name of the innermost of the
    start-sorted (start, end, name) `events` that contains it, or None: a
    sweep with a stack of the open events (host events of one thread
    nest)."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(events) and events[i][0] <= p:
            while stack and stack[-1][1] < events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(next((n for a, b, n in reversed(stack) if a <= p <= b),
                        None))
    return out


def reduce(host, dev, span_names) -> dict:
    """host: (name, start_us, end_us) of CPU events (the benchmark's spans
    among them); dev: the same of device operations. Returns, over the
    stretch (the STRETCH span):

      window_s, busy_s      its length and the time some device operation
                            ran (the union of their intervals);
      kernels               {short name: [launches, seconds]};
      device_ops            the 10 names with the most device seconds;
      idle_gaps             the device's idle seconds inside the stretch by
                            what the host was doing at each gap's midpoint
                            (the innermost benchmark span, and the innermost
                            other host event inside it), the 10 largest;
      spans                 {span name: [[wall_s, busy_s], ...]} in order,
                            each span's own length and the device time
                            inside it."""
    st = [(a, b) for n, a, b in host if n == STRETCH]
    if not st:
        raise RuntimeError("the trace holds no stretch span")
    s0, s1 = st[0]
    dev = [(n, max(a, s0), min(b, s1)) for n, a, b in dev
           if b > s0 and a < s1]
    merged = _merge([(a, b) for _, a, b in dev])
    busy = sum(b - a for a, b in merged)
    kernels: dict = {}
    for n, a, b in dev:
        k = kernels.setdefault(_short(n), [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    mine = sorted((a, b, n) for n, a, b in host
                  if n in span_names and n != STRETCH and b > s0 and a < s1)
    other = sorted((a, b, n) for n, a, b in host
                   if n not in span_names and b > s0 and a < s1)
    holes, prev = [], s0
    for a, b in merged + [[s1, s1]]:
        if a > prev:
            holes.append((prev, a))
        prev = max(prev, b)
    mids = [(x + y) / 2 for x, y in holes]
    outer, inner = _innermost(mine, mids), _innermost(other, mids)
    gaps: dict = {}
    for (x, y), o, i in zip(holes, outer, inner):
        label = o if o is not None else "harness"
        if i is not None:
            label += " / " + _short(i)
        gaps[label] = gaps.get(label, 0.0) + (y - x) / 1e6
    spans: dict = {}
    for a, b, n in mine:
        spans.setdefault(n, []).append([(b - a) / 1e6,
                                        _covered(merged, a, b) / 1e6])
    return {"window_s": (s1 - s0) / 1e6, "busy_s": busy / 1e6,
            "kernels": kernels,
            "device_ops": [[n, v[1]] for n, v in ops],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:10],
            "spans": spans}
