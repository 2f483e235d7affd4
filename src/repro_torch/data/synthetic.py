"""Deterministic synthetic data. Counterpart of ``repro.data.synthetic``:
``TokenStream``, a Zipf-distributed Markov token source with injected
n-gram structure, so a language model has signal to fit; and
``classification_dataset``, Gaussian-cluster images for the paper's CNN
family. Pure numpy: the same seed gives the reference's data bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

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


def classification_dataset(num_classes: int = 10, dim: Tuple[int, ...] =
                           (8, 8, 3), n_train: int = 2048, n_test: int = 512,
                           seed: int = 0, noise: float = 0.35):
    """Gaussian class prototypes + structured masks (images NHWC): linearly
    nontrivial, learnable by a small CNN in a few hundred steps. Returns
    ((x_train, y_train), (x_test, y_test)), float32 and int32."""
    rng = np.random.default_rng(seed)
    d = int(np.prod(dim))
    protos = rng.normal(0, 1.0, (num_classes, d)).astype(np.float32)
    # second-order structure: class-specific feature crosses
    mix = rng.normal(0, 0.5, (num_classes, d, 8)).astype(np.float32)

    def draw(n):
        y = rng.integers(0, num_classes, n).astype(np.int32)
        z = rng.normal(0, 1.0, (n, 8)).astype(np.float32)
        x = protos[y] + np.einsum("ndk,nk->nd", mix[y], z) * 0.3
        x += rng.normal(0, noise, (n, d)).astype(np.float32)
        x = np.tanh(x)
        return x.reshape((n,) + dim), y

    xtr, ytr = draw(n_train)
    xte, yte = draw(n_test)
    return (xtr, ytr), (xte, yte)
