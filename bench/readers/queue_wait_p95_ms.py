"""Server layer: the 95th percentile over the window's frames of the time
each waited before its job started (answer on the host less due time less
the job's own `Ticket.result().latency_s`), in ms."""

from harness.common import percentile


def read(rec):
    if rec["kind"] != "cnn" or not rec["frames"]:
        return None
    return percentile([f["total_ms"] - f["latency_ms"]
                       for f in rec["frames"]], 95)
