"""Synthetic packed-token data pipeline.

Deterministic PRNG "documents" with a Zipf-like unigram distribution and a
weak Markov structure (so the loss actually decreases during the example
runs), packed into fixed ``[B, S]`` batches with EOS separators. Sharding:
each data-parallel rank slices its batch rows by ``(rank, world)`` — the
global batch is identical regardless of world size, so elastic re-runs are
bitwise reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 512


class PackedSyntheticData:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1)
        self._unigram = (1.0 / ranks ** 1.1)
        self._unigram /= self._unigram.sum()
        # weak bigram structure: token t prefers a band around f(t)
        self._shift = rng.integers(1, max(v - 1, 2))

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        n = max(8, int(rng.exponential(cfg.mean_doc_len)))
        first = rng.choice(cfg.vocab_size, p=self._unigram)
        toks = [first]
        for _ in range(n - 1):
            if rng.random() < 0.5:  # markov step: predictable half the time
                toks.append((toks[-1] * 7 + self._shift) % self.cfg.vocab_size)
            else:
                toks.append(rng.choice(cfg.vocab_size, p=self._unigram))
        return np.asarray(toks, np.int32)

    def batch(self, step: int, rank: int = 0, world: int = 1) -> np.ndarray:
        """Deterministic [global_batch // world, seq_len] batch slice."""
        cfg = self.cfg
        assert cfg.global_batch % world == 0
        rows_per = cfg.global_batch // world
        out = np.empty((rows_per, cfg.seq_len), np.int32)
        for i in range(rows_per):
            row_global = rank * rows_per + i
            rng = np.random.default_rng(
                (cfg.seed, step, row_global))
            buf = []
            while len(buf) < cfg.seq_len:
                buf.extend(self._doc(rng).tolist())
                buf.append(cfg.eos_id)
            out[i] = np.asarray(buf[: cfg.seq_len], np.int32)
        return out

    def batches(self, steps: int, rank: int = 0, world: int = 1) -> Iterator[np.ndarray]:
        for s in range(steps):
            yield self.batch(s, rank, world)
