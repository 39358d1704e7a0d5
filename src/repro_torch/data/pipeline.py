"""Deterministic, seekable synthetic token pipeline.

Production shape: stateless index -> batch mapping, so (a) restarts resume
mid-epoch by seeking to `step` with no iterator state to checkpoint, and
(b) every data-parallel shard derives its slice from (step, shard_id)
without host coordination — the multi-host-safe pattern.

Synthetic text: a Zipfian unigram stream with short-range Markov structure
(so models actually learn something during the e2e example run), generated
chunk-wise from counter-based RNG (step/shard → seed) — O(1) memory, no
files, fully reproducible.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_strength: float = 0.7   # P(next = f(prev)) vs fresh zipf draw


class SyntheticTokens:
    """Map-style deterministic dataset: batch(step, shard, n_shards)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed random permutation as the Markov successor function
        self._succ = rng.permutation(cfg.vocab_size)
        # precompute zipf cdf over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(p / p.sum())

    def _zipf(self, rng, shape):
        u = rng.random(shape)
        return np.searchsorted(self._cdf, u).astype(np.int32)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1):
        """-> {"tokens": (B_shard, S), "labels": (B_shard, S)} int32."""
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        b = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4_096 + shard)
        fresh = self._zipf(rng, (b, cfg.seq_len + 1))
        seq = fresh.copy()
        use_markov = rng.random((b, cfg.seq_len)) < cfg.markov_strength
        for t in range(1, cfg.seq_len + 1):
            succ = self._succ[seq[:, t - 1]]
            seq[:, t] = np.where(use_markov[:, t - 1], succ, fresh[:, t])
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
