"""The one traffic generator: a mix file's parameters and a seed give the
requests and their arrivals.

A mix (`bench/traffic/<name>.json`) says how requests arrive and how large
they are:

  * `"loop": "open"` with `rate_hz`: request k is due k / rate_hz seconds
    after the window opens, whether or not earlier ones were answered;
  * `"loop": "closed"` with `clients`: each client sends its next request
    when its last one is answered;
  * `"frames"`: a pool of that many distinct int8 frames, each sent once
    per round, in an order drawn from the seed, so every seed sends the
    same work.

The seed gives the same requests in the same order every time; the
program is given only the requests."""

from __future__ import annotations

import numpy as np


class Lengths:
    """Every integer in [lo, hi] once per round, each round in an order
    drawn from `rng`."""

    def __init__(self, lo: int, hi: int, rng: np.random.Generator):
        self.lo, self.hi, self.rng = int(lo), int(hi), rng
        self.buf: list[int] = []

    def next(self) -> int:
        if not self.buf:
            self.buf = (self.rng.permutation(self.hi - self.lo + 1)
                        + self.lo).tolist()
        return self.buf.pop()


class Stream:
    """The requests of one run, in order: `next()` gives the next one,
    {"frame": index into `frames`}."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.rng = np.random.default_rng([int(seed), 1])
        self.order = Lengths(0, mix["frames"] - 1, self.rng)

    def next(self) -> dict:
        return {"frame": self.order.next()}

    def due_s(self, k: int) -> float:
        """When request k (from 0) of an open loop is due, in seconds after
        the window opens."""
        return k / float(self.mix["rate_hz"])


def frames(mix: dict, seed: int, shape: tuple) -> np.ndarray:
    """The mix's pool of distinct int8 frames of `shape` (H, W, C), drawn
    from the seed over the whole int8 range."""
    rng = np.random.default_rng([int(seed), 2])
    return rng.integers(-128, 128, size=(mix["frames"], *shape),
                        dtype=np.int8)
