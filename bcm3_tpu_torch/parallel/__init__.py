"""Multi-device execution of the PT sampler over torch.distributed ranks
(counterpart of bcm3_tpu/parallel/)."""

from bcm3_tpu_torch.parallel.mesh import (
    CHAIN_AXIS,
    ChainBlock,
    chain_partition,
    shard_leading_axis,
)

__all__ = [
    "CHAIN_AXIS",
    "ChainBlock",
    "chain_partition",
    "shard_leading_axis",
]
