"""The chain partition: which rows of the chain population each rank holds.

Counterpart of bcm3_tpu/parallel/mesh.py. The JAX package shards the
stacked chain population over a `jax.sharding.Mesh` axis ("chain"); here
one process drives one device, and rank r of a world of W holds the
contiguous block [r C / W, (r + 1) C / W) of the C chains, the block that
`NamedSharding(mesh, P("chain"))` gives device r there. Replication is the
default: a tensor whose axis 0 is not the chain axis stays whole on every
rank.

A rank's block need not start or end on a ladder boundary (C divisible by
W, the ensemble count E not). `ChainBlock` then also names the covering
ladders, the whole ladders that the block touches: the sampler keeps
those rows, computes its proposals on them in the (ensemble, ladder)
layout and evaluates only its own rows; the rows of the covering ladders
that other ranks own ("ghost" rows) are filled from their owners before
each replica exchange (`halo_plan`, parallel/collectives.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import List, Tuple

import numpy as np
import torch

CHAIN_AXIS = "chain"


def chain_partition(num_chains: int, world: int) -> List[Tuple[int, int]]:
    """Each rank's contiguous block [start, stop) of the chain axis."""
    if world < 1 or num_chains % world != 0:
        raise ValueError(
            f"Chain population {num_chains} must be divisible by the device count "
            f"{world} for sharded execution"
        )
    n = num_chains // world
    return [(r * n, (r + 1) * n) for r in range(world)]


def shard_leading_axis(tree, rank: int, world: int, chain_count: int):
    """Rank `rank`'s rows of every leaf (tensor or array) whose axis 0 is
    the chain count; every other leaf stays whole. Leaves of dataclasses,
    dicts, lists and tuples are mapped."""
    start, stop = chain_partition(chain_count, world)[rank]

    def keep(leaf):
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            if leaf.ndim >= 1 and leaf.shape[0] == chain_count:
                return leaf[start:stop]
            return leaf
        if dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            return dataclasses.replace(
                leaf, **{f.name: keep(getattr(leaf, f.name)) for f in dataclasses.fields(leaf)}
            )
        if isinstance(leaf, dict):
            return {k: keep(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(keep(v) for v in leaf)
        return leaf

    return keep(tree)


@dataclass(frozen=True)
class ChainBlock:
    """Rank `rank`'s share of a population of `num_chains` chains in
    ladders of `ladder_size`: it owns rows [c0, c1) and keeps the covering
    ladders' rows [a0, a1)."""

    num_chains: int
    ladder_size: int
    rank: int
    world: int

    def __post_init__(self):
        chain_partition(self.num_chains, self.world)  # raises unless divisible

    @cached_property
    def c0(self) -> int:
        return chain_partition(self.num_chains, self.world)[self.rank][0]

    @cached_property
    def c1(self) -> int:
        return chain_partition(self.num_chains, self.world)[self.rank][1]

    @cached_property
    def a0(self) -> int:
        return self.c0 - self.c0 % self.ladder_size

    @cached_property
    def a1(self) -> int:
        return self.c1 + (-self.c1) % self.ladder_size

    @cached_property
    def whole(self) -> bool:
        """Every ladder of the block lies whole on this rank."""
        return (self.a0, self.a1) == (self.c0, self.c1)

    @cached_property
    def rows(self) -> int:
        return self.a1 - self.a0

    @cached_property
    def own(self) -> slice:
        """This rank's own rows within the covering rows."""
        return slice(self.c0 - self.a0, self.c1 - self.a0)

    @cached_property
    def ensembles(self) -> Tuple[int, int]:
        """(first ensemble, count) of the covering ladders."""
        L = self.ladder_size
        return self.a0 // L, self.rows // L

    def cover(self, t):
        """The covering rows of a tensor over the whole population."""
        return t[self.a0 : self.a1]

    def _needed(self, rank: int) -> List[int]:
        """Rows that rank `rank` reads in an exchange and does not own: each
        own row's two ladder neighbours (partner and leader, the wrap pair
        included)."""
        L = self.ladder_size
        c0, c1 = chain_partition(self.num_chains, self.world)[rank]
        # only rows in the block's first and last ladders have neighbours
        # outside it
        first_end, last_start = c0 - c0 % L + L, c1 + (-c1) % L - L
        rows = set()
        for c in set(range(c0, min(c1, first_end))) | set(range(max(c0, last_start), c1)):
            base = c - c % L
            rows.update(base + (c % L + s) % L for s in (1, -1))
        return sorted(r for r in rows if not c0 <= r < c1)

    def halo_plan(self) -> List[Tuple[int, List[int], List[int]]]:
        """Point-to-point plan of the ghost rows, one entry per peer rank:
        (peer, covering-row indices sent to it, covering-row indices
        received from it). Empty when the block is whole."""
        if self.whole:
            return []
        parts = chain_partition(self.num_chains, self.world)
        mine = self._needed(self.rank)
        plan = []
        for peer in range(self.world):
            if peer == self.rank:
                continue
            p0, p1 = parts[peer]
            recv = [r - self.a0 for r in mine if p0 <= r < p1]
            send = [r - self.a0 for r in self._needed(peer) if self.c0 <= r < self.c1]
            if send or recv:
                plan.append((peer, send, recv))
        return plan
