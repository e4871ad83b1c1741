"""Epoch-reshuffled sharded index sampler (the JAX package's
``parallel/sampler.py``; torch's ``DistributedSampler(shuffle=True)`` +
``set_epoch``): a permutation seeded per epoch, padded to a multiple of the
number of shards, each shard taking a strided slice.  The shards default to
the ``torch.distributed`` world when one is initialised, else one."""

from __future__ import annotations

import numpy as np


def _world() -> tuple:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ShardedEpochSampler:
    def __init__(self, n_samples: int, num_shards: int | None = None,
                 shard_id: int | None = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        world, rank = _world()
        self.n = n_samples
        self.num_shards = num_shards if num_shards is not None else world
        self.shard_id = shard_id if shard_id is not None else rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.num_shards
        return -(-self.n // self.num_shards)

    def indices(self) -> np.ndarray:
        order = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        if self.drop_last:
            total = (self.n // self.num_shards) * self.num_shards
            order = order[:total]
        else:
            total = len(self) * self.num_shards
            pad = total - self.n
            if pad:
                order = np.concatenate([order, order[:pad]])
        return order[self.shard_id::self.num_shards]

    def __iter__(self):
        return iter(self.indices())
