"""Device layer: the share of the time inside the traced stretch's
`Server.step` calls in which no operation ran on the device, in %."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not tr["spans"].get("Server.step"):
        return None
    wall = sum(w for w, _ in tr["spans"]["Server.step"])
    busy = sum(b for _, b in tr["spans"]["Server.step"])
    return 100.0 * (1.0 - busy / wall) if wall > 0 else None
