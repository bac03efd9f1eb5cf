"""Run a function on every rank of a local process group.

`spawn(fn, world, device, *args)` starts `world` processes
(`torch.multiprocessing.spawn`), joins them into one group on a free
local port (parallel/distributed.py: NCCL for "cuda", gloo for "cpu",
unless `backend` says otherwise), runs `fn(rank, world, *args)` in each
and returns their results in rank order. `fn` and its arguments and
results must pickle (`fn` by import path). A rank that raises makes
spawn raise with that rank's traceback, and the other ranks are ended.

Each rank's math libraries get an equal share of the host's cores (the
thread variables that the caller has not set): every rank fits the same
adaptation on the host, and ranks that each start a thread per core
oversubscribe it (a two-rank banana run's host EM took 20 s that way,
0.2 s alone).
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
from typing import Callable, List, Optional

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, device, backend, port, outdir, args):
    from bcm3_tpu_torch.parallel import distributed

    os.environ["LOCAL_RANK"] = str(rank)
    distributed.initialize(f"tcp://localhost:{port}", world, rank, backend=backend, device=device)
    try:
        out = fn(rank, world, *args)
    finally:
        distributed.destroy()
    # a file per rank: a queue's pipe could fill before the parent joins
    path = os.path.join(outdir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


_THREAD_VARIABLES = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def spawn(
    fn: Callable, world: int, device: str, *args, backend: Optional[str] = None
) -> List:
    """fn(rank, world, *args) on `world` ranks of a new local group on
    `device` ("cuda" or "cpu"); their results in rank order."""
    share = str(max(1, (os.cpu_count() or 1) // world))
    unset = [k for k in _THREAD_VARIABLES if k not in os.environ]
    with tempfile.TemporaryDirectory(prefix="bcm3_spawn_") as outdir:
        # the ranks inherit the environment when they start
        os.environ.update({k: share for k in unset})
        try:
            mp.spawn(
                _rank_main,
                args=(fn, world, device, backend, free_port(), outdir, args),
                nprocs=world,
                join=True,
            )
        finally:
            for k in unset:
                del os.environ[k]
        results = []
        for rank in range(world):
            # written by the ranks above, not read from elsewhere
            with open(os.path.join(outdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
