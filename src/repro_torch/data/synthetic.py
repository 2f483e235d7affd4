"""Deterministic synthetic token data. Counterpart of
``repro.data.synthetic`` (``TokenStream``): a Zipf-distributed Markov
token source with injected n-gram structure, so a language model has
signal to fit. Pure numpy: the same seed gives the reference's batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int             # per-host
    seed: int = 0
    ngram: int = 3
    zipf_a: float = 1.2


class TokenStream:
    """Markov chain over a Zipf marginal: next ~ mix(bigram(cur), zipf)."""

    def __init__(self, cfg: TokenStreamConfig, host_id: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, host_id]))
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.marginal = ranks ** -cfg.zipf_a
        self.marginal /= self.marginal.sum()
        # deterministic "grammar": token t prefers (t*7+3)%v next
        self.next_pref = (np.arange(v) * 7 + 3) % v

    def _sample_seq(self, n: int) -> np.ndarray:
        v = self.cfg.vocab_size
        out = np.empty(n, np.int32)
        cur = int(self.rng.choice(v, p=self.marginal))
        for i in range(n):
            out[i] = cur
            if self.rng.random() < 0.7:          # structured transition
                cur = int(self.next_pref[cur])
            else:
                cur = int(self.rng.choice(v, p=self.marginal))
        return out

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        b, s = self.cfg.batch_size, self.cfg.seq_len
        while True:
            seq = self._sample_seq(b * (s + 1)).reshape(b, s + 1)
            yield {"tokens": seq[:, :-1].astype(np.int32),
                   "labels": seq[:, 1:].astype(np.int32)}
