"""Deterministic, resumable, host-sharded data pipeline — twin of
`repro.train.data`, numpy only, so its batches are the reference's, array
for array.

`ShardedStream`:

  * derives every batch from (seed, step) — no hidden iterator state, so
    resuming = constructing with `start_step`,
  * yields only this host's shard: rows [host_id·B/h, (host_id+1)·B/h),
  * takes synthetic token streams (LM) and hashed click streams (recsys)
    through a ``batch_fn``.

`epoch_permutation` gives a deterministic full-epoch permutation for map-
style datasets (same (seed, epoch) on every host → consistent shards).
Batches are numpy; the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np

__all__ = ["ShardedStream", "epoch_permutation", "token_batch_fn", "click_batch_fn"]


@dataclasses.dataclass
class ShardedStream:
    batch_fn: Callable[[np.random.Generator, int], Any]  # (rng, global_batch) -> batch
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    start_step: int = 0

    def __post_init__(self):
        assert 0 <= self.host_id < self.n_hosts
        assert self.global_batch % self.n_hosts == 0, "global batch must split across hosts"
        self._step = self.start_step

    @property
    def step(self) -> int:
        return self._step

    def batch_at(self, step: int) -> Any:
        """The host's shard of the batch for an arbitrary step (pure)."""
        rng = np.random.default_rng((self.seed, step))
        full = self.batch_fn(rng, self.global_batch)
        per = self.global_batch // self.n_hosts
        lo = self.host_id * per

        def shard(x):
            if isinstance(x, np.ndarray) and x.ndim >= 1 and x.shape[0] == self.global_batch:
                return x[lo : lo + per]
            return x

        if isinstance(full, dict):
            return {k: shard(v) for k, v in full.items()}
        return shard(full)

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        b = self.batch_at(self._step)
        self._step += 1
        return b


def epoch_permutation(n: int, epoch: int, seed: int = 0) -> np.ndarray:
    """Same permutation on every host for (seed, epoch) — shard by slicing."""
    return np.random.default_rng((seed, epoch)).permutation(n)


def token_batch_fn(vocab: int, seq_len: int) -> Callable:
    def fn(rng: np.random.Generator, batch: int):
        return rng.integers(0, vocab, (batch, seq_len + 1)).astype(np.int32)

    return fn


def click_batch_fn(n_fields: int, rows_per_field: int) -> Callable:
    def fn(rng: np.random.Generator, batch: int):
        return {
            "ids": rng.integers(0, rows_per_field, (batch, n_fields)).astype(np.int32),
            "labels": (rng.random(batch) > 0.5).astype(np.float32),
        }

    return fn
