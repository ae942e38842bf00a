"""Deterministic, checkpointable minibatch iterator. A numpy-only copy
of the reference's `repro/data/loader.py`: the same seed gives the same
batch order.

Production posture: the iterator's full state is (epoch, position,
permutation seed), so it round-trips through checkpoints and a restarted
job resumes mid-epoch on the exact batch it would have seen — required
for bitwise-reproducible fault recovery. Per-host sharding for multi-host
data parallelism is a pure function of (host_id, num_hosts).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LoaderState:
    epoch: int = 0
    position: int = 0  # batches consumed within the epoch
    seed: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "LoaderState":
        return LoaderState(**d)


class BatchLoader:
    """Shuffled, droppped-remainder batch iterator over array pytrees."""

    def __init__(
        self,
        arrays: dict[str, np.ndarray],
        batch_size: int,
        *,
        host_id: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        drop_remainder: bool = True,
    ):
        n = {len(v) for v in arrays.values()}
        assert len(n) == 1, "all arrays must share the leading dim"
        self.arrays = arrays
        self.n = n.pop()
        self.batch_size = batch_size
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.state = LoaderState(seed=seed)
        self.drop_remainder = drop_remainder

    @property
    def batches_per_epoch(self) -> int:
        per_host = self.n // self.num_hosts
        return per_host // self.batch_size

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.state.seed, epoch))
        perm = rng.permutation(self.n)
        per_host = self.n // self.num_hosts
        lo = self.host_id * per_host
        return perm[lo : lo + per_host]

    def next_batch(self) -> dict[str, np.ndarray]:
        if self.state.position >= self.batches_per_epoch:
            self.state = LoaderState(
                epoch=self.state.epoch + 1, position=0, seed=self.state.seed
            )
        perm = self._perm(self.state.epoch)
        lo = self.state.position * self.batch_size
        idx = perm[lo : lo + self.batch_size]
        self.state = dataclasses.replace(self.state, position=self.state.position + 1)
        return {k: v[idx] for k, v in self.arrays.items()}

    def epoch_batches(self):
        for _ in range(self.batches_per_epoch - self.state.position):
            yield self.next_batch()
