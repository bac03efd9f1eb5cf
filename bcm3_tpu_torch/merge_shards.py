"""Merge per-process distributed emission shards into an R-loadable output.nc.

Copied from the JAX package's bcm3_tpu/merge_shards.py. A multi-process
run emits one ``shard_<p>.npz`` per process (per-host sharded emission,
SURVEY §2.12/§5); the JAX package writes them today, the port once it
runs over several devices (ROADMAP A13). This tool
interleaves the shards back into the exact row order a single-process
run produces and writes the result through the reference-schema HDF5
handler (reference: src/sampler/SampleHandlerNetCDF.cpp:45-111), so the
distributed path ends at the same ``output.nc`` the R analysis layer
(R/load.r:4-61) consumes.

Usage:
    python -m bcm3_tpu_torch.merge_shards shard_0.npz shard_1.npz -o output.nc
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shards", nargs="+", help="per-process .npz emission shards")
    ap.add_argument("-o", "--output", default="output.nc")
    ap.add_argument(
        "--variables",
        nargs="*",
        default=None,
        help="variable names (default: read from the shard files)",
    )
    args = ap.parse_args(argv)

    from bcm3_tpu_torch.io.output import (
        load_shard_npz,
        merge_sharded_results,
        write_results_netcdf,
    )

    shards = [load_shard_npz(fn) for fn in args.shards]
    merged = merge_sharded_results(shards)
    names = args.variables or merged.get("variables")
    if not names:
        print(
            "error: shards carry no variable names; pass --variables",
            file=sys.stderr,
        )
        return 1
    if merged.get("temperatures") is None:
        print("error: shards carry no temperature ladder", file=sys.stderr)
        return 1
    write_results_netcdf(
        merged, args.output, names, merged.get("variable_transform")
    )
    n = merged["samples"].shape[0]
    print(
        f"merged {len(shards)} shards -> {args.output} "
        f"({n} samples x {len(merged['temperatures'])} temperatures x "
        f"{len(names)} variables)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
