"""HDF5 sample store, layout-compatible with the reference output files.

The reference writes NetCDF-4 (= HDF5) files consumed by the R analysis
layer through hdf5r (reference: src/sampler/SampleHandlerNetCDF.cpp,
R/load.r:4-61). This writer produces the same group/dataset layout with
h5py so `bcm3.load.results` keeps working:

    samples/sample_ix          uint32 (S,)
    samples/variable           str    (D,)
    samples/temperature        f8     (C,)
    samples/variable_transform uint32 (D,)
    samples/variable_values    f8     (S, C, D)   fill = NC_FILL_DOUBLE
    samples/log_prior          f8     (S, C)
    samples/log_likelihood     f8     (S, C)
    samples/weights            f8     (S, C)

(hdf5r presents C-order (S, C, D) to R as [var, temp, sample], which is
exactly what R/load.r indexes.)

Copied from the JAX package's bcm3_tpu/io/output.py, with `h5py` imported
only where a file is opened, so that machines without h5py can import the
sampler, and with a resume mode: a run resumed from its checkpoint writes
on into the file of the run it continues (the JAX package rewrites it).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# NetCDF default fill value for double (NC_FILL_DOUBLE); R replaces it by NA
NC_FILL_DOUBLE = 9.9692099683868690e36


class SampleHandlerHDF5:
    """Streaming sample sink (reference: SampleHandlerNetCDF.cpp)."""

    def __init__(
        self,
        filename: str,
        sample_count: int,
        variable_names: Sequence[str],
        variable_transforms: Sequence[int],
        temperatures: np.ndarray,
        sync_every: int = 10,
        resume: bool = False,
    ):
        """`resume`: reopen the existing file of an interrupted run (mode
        "r+") to write on into it, after checking that it holds the
        variables and the `variable_values` shape this run writes; a file
        that differs is refused by name."""
        self.filename = filename
        self.sample_count = sample_count
        self.sample_ix = 0
        self.sync_every = sync_every

        import h5py

        D = len(variable_names)
        C = len(temperatures)
        if resume:
            self._file = h5py.File(filename, "r+")
            self._g = self._file["samples"]
            shape = self._g["variable_values"].shape
            names = [v.decode() if isinstance(v, bytes) else str(v)
                     for v in self._g["variable"][()]]
            if shape != (sample_count, C, D) or names != list(variable_names):
                self._file.close()
                raise ValueError(
                    f"cannot resume into {filename}: it holds variables {names} and "
                    f"variable_values of shape {shape}, this run writes "
                    f"{list(variable_names)} and {(sample_count, C, D)}"
                )
            return
        f = h5py.File(filename, "w")
        g = f.create_group("samples")
        g.create_dataset(
            "sample_ix", data=np.arange(1, sample_count + 1, dtype=np.uint32)
        )
        g.create_dataset(
            "variable",
            data=np.array(list(variable_names), dtype=h5py.string_dtype()),
        )
        g.create_dataset("temperature", data=np.asarray(temperatures, dtype=np.float64))
        g.create_dataset(
            "variable_transform", data=np.asarray(variable_transforms, dtype=np.uint32)
        )
        g.create_dataset(
            "variable_values",
            shape=(sample_count, C, D),
            dtype=np.float64,
            fillvalue=NC_FILL_DOUBLE,
        )
        g.create_dataset(
            "log_prior", shape=(sample_count, C), dtype=np.float64,
            fillvalue=NC_FILL_DOUBLE,
        )
        g.create_dataset(
            "log_likelihood", shape=(sample_count, C), dtype=np.float64,
            fillvalue=NC_FILL_DOUBLE,
        )
        g.create_dataset(
            "weights", shape=(sample_count, C), dtype=np.float64,
            fillvalue=NC_FILL_DOUBLE,
        )
        self._file = f
        self._g = g

    def receive_samples(self, xs, lprior, llh, temperatures, weights=None):
        """Append a batch: xs (S, C, D), lprior/llh (S, C)."""
        S = xs.shape[0]
        i0, i1 = self.sample_ix, self.sample_ix + S
        # cast via numpy: the store is float64 and h5py has no internal
        # conversion path from reduced emission dtypes (ml_dtypes bfloat16)
        self._g["variable_values"][i0:i1] = np.asarray(xs, np.float64)
        self._g["log_prior"][i0:i1] = np.asarray(lprior, np.float64)
        self._g["log_likelihood"][i0:i1] = np.asarray(llh, np.float64)
        self._g["weights"][i0:i1] = (
            np.ones_like(lprior, dtype=np.float64)
            if weights is None
            else np.asarray(weights, np.float64)
        )
        self.sample_ix = i1
        if (i1 // self.sync_every) != (i0 // self.sync_every):
            self._file.flush()

    def set_position(self, ix: int):
        """Continue writing at an absolute row (checkpoint resume)."""
        self.sample_ix = int(ix)

    def close(self):
        self._file.flush()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SampleHandlerTSV:
    """Tab-separated sink for the fixed-temperature chain
    (reference: src/sampler/SampleHandlerTSV.cpp — T=1 only)."""

    def __init__(self, filename: str, variable_names: Sequence[str]):
        self.filename = filename
        self._f = open(filename, "w")
        self._f.write(
            "\t".join(["log_prior", "log_likelihood"] + list(variable_names))
            + "\n"
        )

    def receive_samples(self, xs, lprior, llh, temperatures, weights=None):
        xs = np.asarray(xs, np.float64)  # reduced emission dtypes don't
        lprior = np.asarray(lprior, np.float64)  # support format specs
        llh = np.asarray(llh, np.float64)
        for s in range(xs.shape[0]):
            row = [f"{lprior[s, -1]:.10g}", f"{llh[s, -1]:.10g}"] + [
                f"{v:.10g}" for v in xs[s, -1, :]
            ]
            self._f.write("\t".join(row) + "\n")

    def close(self):
        self._f.close()


class SampleHandlerMAP:
    """Running maximum-a-posteriori tracker
    (reference: src/sampler/SampleHandlerStoreMaxAPosteriori.cpp)."""

    def __init__(self):
        self.map_lposterior = -np.inf
        self.map_llikelihood = np.nan
        self.map_sample = None

    def receive_samples(self, xs, lprior, llh, temperatures, weights=None):
        lpost = lprior[:, -1] + llh[:, -1]
        ix = int(np.nanargmax(lpost)) if len(lpost) else 0
        if len(lpost) and lpost[ix] > self.map_lposterior:
            self.map_lposterior = float(lpost[ix])
            self.map_llikelihood = float(llh[ix, -1])
            self.map_sample = np.array(xs[ix, -1, :])

    def reset(self):
        self.__init__()

    def close(self):
        pass


def load_results(filename: str):
    """Read an output file back (python-side equivalent of R/load.r)."""
    import h5py

    with h5py.File(filename, "r") as f:
        g = f["samples"]
        out = {
            "samples": g["variable_values"][:],
            "log_prior": g["log_prior"][:],
            "log_likelihood": g["log_likelihood"][:],
            "weights": g["weights"][:],
            "temperatures": g["temperature"][:],
            "variables": [
                v.decode() if isinstance(v, bytes) else str(v) for v in g["variable"][:]
            ],
            "variable_transform": g["variable_transform"][:],
        }
    for k in ("samples", "log_prior", "log_likelihood", "weights"):
        arr = out[k]
        arr[arr == NC_FILL_DOUBLE] = np.nan
    return out


def write_results_netcdf(
    result,
    filename: str,
    variable_names: Sequence[str],
    variable_transforms: Sequence[int] | None = None,
    chunk_rows: int = 4096,
):
    """Write a ``SamplerPT.run()`` result dict (or the output of
    :func:`merge_sharded_results`) to an R-loadable ``output.nc`` with the
    reference schema (reference: src/sampler/SampleHandlerNetCDF.cpp:45-111)
    so a distributed run ends at the same artifact a single-process run
    produces and ``R/load.r`` keeps working."""
    xs = np.asarray(result["samples"], dtype=np.float64)
    lp = np.asarray(result["log_prior"], dtype=np.float64)
    ll = np.asarray(result["log_likelihood"], dtype=np.float64)
    temps = np.asarray(result["temperatures"], dtype=np.float64)
    N = xs.shape[0]
    transforms = (
        list(variable_transforms)
        if variable_transforms is not None
        else [0] * len(variable_names)
    )
    with SampleHandlerHDF5(
        filename, N, variable_names, transforms, temps
    ) as handler:
        for i0 in range(0, N, chunk_rows):
            i1 = min(N, i0 + chunk_rows)
            handler.receive_samples(xs[i0:i1], lp[i0:i1], ll[i0:i1], temps)


def load_shard_npz(filename: str):
    """Read one per-process emission shard (written by
    examples/run_distributed.py / the distributed worker) back into the
    dict form :func:`merge_sharded_results` consumes."""
    z = np.load(filename, allow_pickle=False)
    shard = None
    if "e0" in z and int(z["e0"]) >= 0:
        shard = (int(z["e0"]), int(z["e_local"]))
    out = {
        "samples": z["samples"],
        "log_prior": z["log_prior"],
        "log_likelihood": z["log_likelihood"],
        "ensemble_shard": shard,
        "num_ensembles": int(z["num_ensembles"]),
        "temperatures": z["temperatures"] if "temperatures" in z else None,
    }
    if "variables" in z:
        out["variables"] = [str(v) for v in z["variables"]]
    if "variable_transform" in z:
        out["variable_transform"] = [int(t) for t in z["variable_transform"]]
    return out


def merge_sharded_results(results):
    """Merge per-process ``SamplerPT.run()`` results from a multi-process
    (jax.distributed) run with per-host sharded emission into the exact
    row ordering a single-process run produces.

    Each process's result carries ``ensemble_shard = (e0, e_local)``: its
    rows are the pool of its own ensembles, sample-major. The merged store
    interleaves them back to row index ``s * E + e`` (see
    SamplerPT._pool_ensembles). The reference has no distributed output at
    all (SURVEY §2.12); this is the merge step of the mandated per-host
    sharded sample store (SURVEY §5).
    """
    E = int(results[0]["num_ensembles"])
    keys = ("samples", "log_prior", "log_likelihood")
    merged = {}
    for key in keys:
        shards = []
        for r in results:
            shard = r["ensemble_shard"]
            if shard is None:
                raise ValueError(
                    "result has no ensemble_shard info (not a sharded-"
                    "emission run); nothing to merge"
                )
            e0, el = shard
            arr = np.asarray(r[key])
            S = arr.shape[0] // el
            shards.append((e0, el, arr.reshape(S, el, *arr.shape[1:])))
        S = shards[0][2].shape[0]
        rest = shards[0][2].shape[2:]
        out = np.zeros((S, E) + rest, dtype=shards[0][2].dtype)
        seen = np.zeros(E, dtype=bool)
        for e0, el, arr in shards:
            out[:, e0 : e0 + el] = arr
            seen[e0 : e0 + el] = True
        if not seen.all():
            raise ValueError("ensemble shards do not cover the population")
        merged[key] = out.reshape((S * E,) + rest)
    merged["temperatures"] = next(
        (r["temperatures"] for r in results if r.get("temperatures") is not None),
        None,
    )
    merged["num_ensembles"] = E
    for key in ("variables", "variable_transform"):
        for r in results:
            if r.get(key) is not None:
                merged[key] = r[key]
                break
    return merged
