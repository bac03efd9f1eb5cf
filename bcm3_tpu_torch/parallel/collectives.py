"""The collectives of the sharded sampler.

In the JAX package XLA inserts them into a sharded `jit`: the all-gathers
of the adaptation boundary and of the statistics (`process_allgather`),
the collective-permute of a replica exchange across devices. Here they
are explicit calls on the default torch.distributed group:

- `all_gather_rows`: every rank's rows, concatenated in rank order;
- `all_reduce_sum`: a sum over the ranks;
- `exchange_boundary_rows`: point to point, the ghost rows of the ladders
  that a rank boundary splits (`ChainBlock.halo_plan`);
- `broadcast_object`: a picklable value from one rank to every rank;
- `barrier`.

Under NCCL tensors stay on their card; a CPU tensor is refused. Gloo has
no CUDA all-gather or send/recv, so under gloo a CUDA tensor is copied to
the host and its result back to the card (two processes can share one
card that way). Each function counts its calls in its `calls` attribute,
so a test can show that a segment with whole ladders issues none. No
collective's failure is caught here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor that the group's backend can take: the tensor itself
    (contiguous), or under gloo its host copy."""
    backend = dist.get_backend()
    if backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"NCCL collective on a {t.device} tensor: NCCL takes CUDA tensors")
        return t.contiguous()
    if backend == "gloo":
        return t.detach().to("cpu").contiguous()
    raise ValueError(f"unsupported torch.distributed backend {backend!r}")


def all_gather_rows(t: torch.Tensor, counts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's rows of `t` (axis 0) concatenated in rank order, on
    t's device. `counts` gives each rank's row count where they differ
    (every rank must pass the same counts); by default all are t's."""
    all_gather_rows.calls += 1
    world = dist.get_world_size()
    if counts is None:
        counts = [t.shape[0]] * world
    if counts[dist.get_rank()] != t.shape[0]:
        raise ValueError(f"this rank holds {t.shape[0]} rows, its count says {counts}")
    w = _wire(t)
    n = max(counts)
    if t.shape[0] < n:
        w = torch.cat([w, w.new_zeros((n - t.shape[0],) + tuple(t.shape[1:]))])
    parts = [torch.empty_like(w) for _ in range(world)]
    dist.all_gather(parts, w)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(t.device)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, as a new tensor on t's device."""
    all_reduce_sum.calls += 1
    w = _wire(t).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM)
    return w.to(t.device)


def exchange_boundary_rows(
    tensors: Sequence[torch.Tensor], plan: Sequence[Tuple[int, List[int], List[int]]]
) -> List[torch.Tensor]:
    """Send and receive rows point to point: for each (peer, send, recv)
    of `plan`, the rows `send` of every tensor go to `peer`, and the rows
    `recv` are replaced by what `peer` sends (in that order). The tensors
    share axis 0 and one dtype; returns new tensors."""
    exchange_boundary_rows.calls += 1
    dev = tensors[0].device
    flat = torch.cat([t.reshape(t.shape[0], -1) for t in tensors], dim=1)
    width = flat.shape[1]
    ops, recvs = [], []
    for peer, send, recv in plan:
        if send:
            rows = _wire(flat[torch.as_tensor(send, device=dev)])
            ops.append(dist.P2POp(dist.isend, rows, peer))
        if recv:
            buf = _wire(flat.new_empty((len(recv), width)))
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            recvs.append((recv, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for recv, buf in recvs:
        flat = flat.index_copy(0, torch.as_tensor(recv, device=dev), buf.to(dev))
    out, col = [], 0
    for t in tensors:
        k = t.numel() // t.shape[0]
        out.append(flat[:, col : col + k].reshape(t.shape))
        col += k
    return out


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src` on every rank (pickled; only this program's own
    values pass through it)."""
    broadcast_object.calls += 1
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier():
    barrier.calls += 1
    dist.barrier()


def reset_counts():
    for fn in (all_gather_rows, all_reduce_sum, exchange_boundary_rows, broadcast_object, barrier):
        fn.calls = 0


reset_counts()
