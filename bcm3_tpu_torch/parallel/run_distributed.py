"""Distributed PT inference over torch.distributed ranks, on the banana
fixture of tests/fixtures/examples (counterpart of
examples/run_distributed.py).

Every rank runs this module. On cards, one process a card, started by
torchrun (which sets the environment that `initialize()` reads):

    torchrun --nproc-per-node=N -m bcm3_tpu_torch.parallel.run_distributed

Or one command a rank, with its rank and the world size; these run on
cuda:<rank> as well unless `--device cpu` asks for the CPU (gloo):

    python -m bcm3_tpu_torch.parallel.run_distributed 0 2 --device cpu   # terminal 1
    python -m bcm3_tpu_torch.parallel.run_distributed 1 2 --device cpu   # terminal 2

Each rank writes its own ensembles to `samples_shard<rank>.npz` in
--out (the layout that io/output.py's `load_shard_npz` reads); merge them
into an R-loadable output.nc with

    python -m bcm3_tpu_torch.merge_shards samples_shard*.npz -o output.nc
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def run(out_dir: str, device: str) -> str:
    """The sharded banana run of this rank (the process group is up);
    returns the path of its shard."""
    from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
    from bcm3_tpu_torch.entry import BANANA
    from bcm3_tpu_torch.parallel import distributed
    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    prior_xml = os.path.join(BANANA, "prior.xml")
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(os.path.join(BANANA, "likelihood.xml"), varset)
    cfg = PTConfig(
        num_samples=500,
        use_every_nth=2,
        num_chains=4,
        num_ensembles=2 * distributed.world(),
        adapt_proposal_samples=250,
        adapt_proposal_times=1,
        shard_over_devices=True,
        seed=7,
        device=device,
    )
    res = SamplerPT(prior, lik, cfg).run()
    e0, e_local = res["ensemble_shard"]  # whole ladders: two a rank
    path = os.path.join(out_dir, f"samples_shard{distributed.rank()}.npz")
    np.savez(
        path,
        samples=res["samples"],
        log_prior=res["log_prior"],
        log_likelihood=res["log_likelihood"],
        e0=e0,
        e_local=e_local,
        num_ensembles=res["num_ensembles"],
        temperatures=np.asarray(res["temperatures"]),
        variables=np.array(varset.names),
        variable_transform=np.asarray(varset.transforms, dtype=np.uint32),
    )
    if distributed.is_primary():
        print(
            f"{distributed.world()} ranks on {device}: {res['evaluations']} evaluations at "
            f"{res['evals_per_second']:.0f} evals/s; merge the shards into an R-loadable "
            "output.nc with:\n  python -m bcm3_tpu_torch.merge_shards "
            f"{os.path.join(out_dir, 'samples_shard*.npz')} -o output.nc"
        )
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", nargs="?", type=int, help="this rank (omit under torchrun)")
    ap.add_argument("world", nargs="?", type=int, help="the number of ranks")
    ap.add_argument("--port", type=int, default=12421, help="rank 0's port on localhost")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card a rank) or cpu (gloo); default cuda")
    ap.add_argument("--out", default=".", help="directory of the shards")
    args = ap.parse_args(argv)

    from bcm3_tpu_torch.parallel import distributed

    if args.rank is not None:
        if args.world is None:
            ap.error("give the world size after the rank")
        distributed.initialize(f"localhost:{args.port}", args.world, args.rank, device=args.device)
    else:
        distributed.initialize(device=args.device)
    try:
        run(args.out, args.device)
    finally:
        distributed.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
