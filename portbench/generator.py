"""The general generator of the benchmark's traffic: training batches of
token ids and next-token labels, drawn from the seed and a traffic mix
(``portbench/traffic/<name>.json``).

A mix names the batch (rows), the sequence length, and ``zipf_exponent``:
rank r (0-based) is drawn with probability ∝ (r + 1)^-exponent, as word
frequencies in text fall (0: uniform), and ranks map to ids by a
permutation of the vocabulary drawn from the seed: each seed makes other
ids frequent and the same amount of work. Batch ``step`` is drawn from ``(seed, step)``
alone, so the same seed gives the same batches in any order and every row
differs from every other.
"""
from __future__ import annotations

import numpy as np

def _seed_words(seed: int) -> list[int]:
    """A seed of any sign as non-negative words for numpy's SeedSequence."""
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, 1 if seed < 0 else 0]


class TokenBatches:
    """Batches of ``traffic["batch"]`` rows of ``traffic["seq"]`` tokens over
    a vocabulary of ``vocab`` ids, from ``seed``."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        exponent = float(traffic["zipf_exponent"])
        if not exponent >= 0:
            raise ValueError(f"zipf_exponent {exponent} is not a number >= 0")
        self.rows, self.seq, self.vocab, self.seed = traffic["batch"], traffic["seq"], vocab, seed
        w = np.arange(1, vocab + 1, dtype=np.float64) ** -exponent
        self.cdf = np.cumsum(w / w.sum())
        self.ids = np.random.default_rng(_seed_words(seed) + [0]).permutation(vocab)

    @property
    def tokens_per_batch(self) -> int:
        return self.rows * self.seq

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Batch ``step`` (0, 1, …): ``tokens`` and ``labels``, int64 (rows,
        seq), the labels the tokens shifted left by one."""
        rng = np.random.default_rng(_seed_words(self.seed) + [1, step])
        ranks = np.minimum(np.searchsorted(self.cdf, rng.random((self.rows, self.seq + 1))), self.vocab - 1)
        seq = self.ids[ranks].astype(np.int64)
        return {"tokens": np.ascontiguousarray(seq[:, :-1]), "labels": np.ascontiguousarray(seq[:, 1:])}
