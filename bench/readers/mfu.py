"""Whole step: the conv and classifier operations of the frames that the
window's `Server.step` calls served, over those calls' summed host time,
as a share of the card's published int8 peak (1,979 TOP/s), in %."""


def read(rec):
    if rec["kind"] != "cnn":
        return None
    wall = sum(b - a for a, b, _ in rec["steps"])
    work = rec["frames_served"] * rec["ops_per_frame"]
    if wall <= 0 or work <= 0:
        return None
    return 100.0 * work / wall / rec["peak"]
