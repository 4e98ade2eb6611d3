"""Deterministic, resumable synthetic data pipeline (a copy of the JAX
package's ``data/pipeline.py``, which is numpy only: for every (seed,
step, shard) the batches are the reference's, bit for bit).

Batches are a pure function of (seed, step, host_shard), so

  * resume-after-restart is exact: the checkpoint stores only the step,
  * elastic re-sharding is trivial: a host's slice is recomputed from its
    new shard index — no data server to rebalance,
  * every host draws only its own shard (no redundant generation).

The synthetic "corpus" is a Zipf-distributed token stream with short-range
Markov structure, so cross-entropy actually decreases during the example
training runs (unlike uniform noise).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d):
        return DataState(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticLM:
    """Zipf-Markov synthetic LM stream."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, num_shards: int = 1, shard: int = 0,
                 zipf_a: float = 1.3, markov_k: int = 16):
        assert global_batch % num_shards == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // num_shards
        self.shard = shard
        self.num_shards = num_shards
        self.state = DataState(seed=seed, step=0)
        self.zipf_a = zipf_a
        # fixed per-corpus Markov successor table (derived from seed only)
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, vocab_size,
                                  size=(min(4096, vocab_size), markov_k))

    def _batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + step) * self.num_shards
            + self.shard)
        B, S = self.local_batch, self.seq + 1
        # zipf draw, clipped to vocab
        base = rng.zipf(self.zipf_a, size=(B, S)).astype(np.int64)
        toks = (base - 1) % self.vocab
        # inject Markov continuity: with p=0.5 follow the successor table
        follow = rng.random((B, S)) < 0.5
        for s in range(1, S):
            prev = toks[:, s - 1] % self._succ.shape[0]
            choice = self._succ[prev, rng.integers(
                0, self._succ.shape[1], size=B)]
            toks[:, s] = np.where(follow[:, s], choice, toks[:, s])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def __next__(self) -> dict[str, np.ndarray]:
        batch = self._batch_at(self.state.step)
        self.state.step += 1
        return batch

    def restore(self, state: DataState) -> None:
        self.state = state


def make_pipeline(cfg, seq_len: int, global_batch: int, seed: int = 0,
                  num_shards: int = 1, shard: int = 0) -> SyntheticLM:
    return SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed,
                       num_shards=num_shards, shard=shard)
