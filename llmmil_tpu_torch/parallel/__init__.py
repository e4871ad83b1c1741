"""Data-parallel helpers of the port: the epoch sampler and the
host-to-device prefetch.  The mesh, DDP and the sharded modes of the JAX
package's ``parallel/`` are ROADMAP.md Queue 1 item 10."""

from .prefetch import place_batch, prefetch_to_device
from .sampler import ShardedEpochSampler

__all__ = ["ShardedEpochSampler", "place_batch", "prefetch_to_device"]
