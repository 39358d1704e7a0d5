"""Program layer: the median over the window's frames of the job's own
host time, `Ticket.result().latency_s` (the runner's call, which ends with
the output copied to the host), in ms."""

from harness.common import median


def read(rec):
    if rec["kind"] != "cnn" or not rec["frames"]:
        return None
    return median([f["latency_ms"] for f in rec["frames"]])
