"""Deterministic synthetic token stream with C4-like marginal statistics
(a copy of ``repro/data/synthetic.py``, which is numpy only: the port's
batches are the JAX package's batches, byte for byte).

No C4 download is assumed, so the C4 pipeline is replaced by a seeded
generator producing Zipf-distributed tokens with short-range Markov structure
(so a language model actually has something learnable: local bigram structure
+ skip dependencies). The interface is the one a real tokenized-C4 loader
would have — ``batches(step)`` is a pure function of (seed, step), which is
what makes checkpoint/restart and elastic rescaling exactly replayable.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # C4-ish unigram tail
    markov_strength: float = 0.7  # P(next token depends on prev)


class SyntheticC4:
    """Deterministic, stateless-per-step token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        # fixed random bigram successor table: each token has 8 likely successors
        self._succ = rng.randint(0, v, size=(v, 8)).astype(np.int32)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = (probs / probs.sum()).astype(np.float64)

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> dict:
        """Batch for ``step``; hosts carve disjoint slices of the global batch."""
        cfg = self.cfg
        assert cfg.global_batch % num_hosts == 0
        per_host = cfg.global_batch // num_hosts
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step) % (2**31) + host_id
        )
        b, t = per_host, cfg.seq_len
        base = rng.choice(cfg.vocab_size, size=(b, t + 1), p=self._probs).astype(np.int32)
        toks = base.copy()
        use_markov = rng.random_sample((b, t)) < cfg.markov_strength
        pick = rng.randint(0, 8, size=(b, t))
        succ = self._succ[toks[:, :-1], pick]
        toks[:, 1:] = np.where(use_markov, succ, base[:, 1:])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
