"""Token data pipeline of the port: a numpy copy of the reference's
``repro.training.data`` (the port imports nothing of the JAX package).
Every generator draws from ``np.random.RandomState`` in the reference's
order, so the same seeds give the same tokens, byte for byte.

Two sources:

* ``MarkovTaskCorpus`` — synthetic corpora with *controllable regularity*.
  A random Markov chain whose transition rows are sharpened by a
  ``peakedness`` parameter.  High peakedness => highly predictable streams
  (the paper's "code-like" HumanEval regime, where aggressive speculation
  wins); low peakedness => high-entropy streams (the "dialogue-like"
  ShareGPT regime).  This is how the heterogeneous-workload experiments
  (paper Table 1 / Fig. 7) are reproduced without shipping datasets.
* ``lm_batches`` — shuffled fixed-length LM batches with next-token labels
  from any token stream (used by the training examples / train_step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MarkovTaskCorpus:
    """Order-1 Markov chain over ``vocab`` symbols with tunable entropy."""
    vocab_size: int
    peakedness: float          # >1 sharpens rows; ~0 flattens to uniform
    seed: int = 0
    branching: int = 8         # support size of each transition row

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v, k = self.vocab_size, min(self.branching, self.vocab_size)
        self.support = np.stack(
            [rng.choice(v, size=k, replace=False) for _ in range(v)])
        logits = rng.randn(v, k) * self.peakedness
        e = np.exp(logits - logits.max(-1, keepdims=True))
        self.probs = e / e.sum(-1, keepdims=True)

    def entropy(self) -> float:
        p = self.probs
        return float(-(p * np.log(np.maximum(p, 1e-12))).sum(-1).mean())

    def sample(self, length: int, rng: np.random.RandomState,
               start: Optional[int] = None) -> np.ndarray:
        v = self.vocab_size
        tok = rng.randint(v) if start is None else start
        out = np.empty(length, np.int32)
        for i in range(length):
            row = self.probs[tok]
            nxt = self.support[tok][rng.choice(len(row), p=row)]
            out[i] = nxt
            tok = nxt
        return out

    def stream(self, total: int, seed: int = 0) -> np.ndarray:
        return self.sample(total, np.random.RandomState(seed))

    def prompts(self, n: int, length: int, seed: int = 0) -> List[List[int]]:
        rng = np.random.RandomState(seed)
        return [self.sample(length, rng).tolist() for _ in range(n)]


def task_mixture(vocab_size: int, seed: int = 0
                 ) -> Dict[str, MarkovTaskCorpus]:
    """The two-regime workload of paper Table 1."""
    return {
        "code": MarkovTaskCorpus(vocab_size, peakedness=3.0, seed=seed),
        "dialogue": MarkovTaskCorpus(vocab_size, peakedness=0.35,
                                     seed=seed + 1),
    }


def lm_batches(stream: np.ndarray, batch_size: int, seq_len: int,
               seed: int = 0, epochs: int = 1000
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (tokens [B,S], labels [B,S]) — labels are next tokens."""
    n = (len(stream) - 1) // seq_len
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            toks = np.stack([stream[j * seq_len:(j + 1) * seq_len]
                             for j in idx])
            labs = np.stack([stream[j * seq_len + 1:(j + 1) * seq_len + 1]
                             for j in idx])
            yield toks.astype(np.int32), labs.astype(np.int32)


def synthetic_batch(key_seed: int, batch: int, seq: int, vocab: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform-random batch (shape-only uses: smoke tests, dry runs)."""
    rng = np.random.RandomState(key_seed)
    toks = rng.randint(0, vocab, size=(batch, seq), dtype=np.int64)
    labs = np.roll(toks, -1, axis=1)
    return toks.astype(np.int32), labs.astype(np.int32)
