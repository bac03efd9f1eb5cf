"""Process groups: one process per device, joined by torch.distributed.

Counterpart of bcm3_tpu/parallel/distributed.py. The JAX package wires
hosts into one `jax.distributed` runtime and shards the chain population
over the global device mesh; here every process drives one device, the
processes form one torch.distributed group (NCCL between cards, gloo on
the CPU), and `SamplerPT(PTConfig(shard_over_devices=True))` splits the
population over the group's ranks (parallel/mesh.py).

Typical launch, one process per card:

    torchrun --nproc-per-node=N -m bcm3_tpu_torch.parallel.run_distributed

where each process calls `initialize()` with no arguments (torchrun sets
the environment), or with explicit arguments on the CPU
(`parallel/launch.py` does so for a local group).

Output: every rank runs the same sampler. Sample handlers and the progress
line run on the primary rank only (`is_primary()`), and the handlers
receive the whole population; where every ladder of a rank's block is
whole, each rank's run() returns its own ensembles ("ensemble_shard"),
written per rank and merged with `python -m bcm3_tpu_torch.merge_shards`.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger("bcm3_tpu_torch")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> torch.device:
    """Join this process to the group and bind it to its device.

    With no address, size and rank, the environment is read as torchrun
    sets it (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); otherwise pass
    coordinator_address ("host:port" or "tcp://host:port" of rank 0),
    num_processes and process_id. The backend is NCCL when `device` is a
    CUDA device and gloo when it is the CPU, unless `backend` names one.
    A CUDA rank is bound to cuda:LOCAL_RANK (LOCAL_RANK from the
    environment, else the rank): under NCCL one card a rank, under gloo
    ranks may share a card. A second call warns and does nothing; any
    other failure raises. Returns the rank's device."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"initialize(device={device!r}): no CUDA device is available")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if dist.is_initialized():
        logger.warning("torch.distributed is already initialized; initialize() does nothing")
        return rank_device(kind)
    if coordinator_address is None:
        init_method, kw = "env://", {}
    else:
        init_method = coordinator_address
        if "://" not in init_method:
            init_method = f"tcp://{init_method}"
        kw = dict(world_size=num_processes, rank=process_id)
    local = int(os.environ.get("LOCAL_RANK", process_id if process_id is not None else 0))
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and local >= cards:
            raise RuntimeError(
                f"local rank {local} has no card of its own ({cards} visible): NCCL "
                "needs one card a rank"
            )
        torch.cuda.set_device(local % cards)
    dist.init_process_group(backend, init_method=init_method, **kw)
    logger.info(
        "Process group: rank %d/%d, backend %s, device %s",
        dist.get_rank(), dist.get_world_size(), backend, rank_device(kind),
    )
    return rank_device(kind)


def rank_device(kind: str = "cuda") -> torch.device:
    """This rank's device of `kind`: the current card, or the CPU."""
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if initialized() else 0


def world() -> int:
    """The group's size; 1 without a group."""
    return dist.get_world_size() if initialized() else 1


def is_primary() -> bool:
    """True on the process that owns output files and the progress line."""
    return rank() == 0


def global_chain_mesh(num_chains: int) -> List[Tuple[int, int]]:
    """The chain partition over every rank of the group."""
    from bcm3_tpu_torch.parallel.mesh import chain_partition

    return chain_partition(num_chains, world())


def destroy():
    """Leave the group, if there is one."""
    if initialized():
        dist.destroy_process_group()
