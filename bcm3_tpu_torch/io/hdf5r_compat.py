"""Executable model of the R-side loading contract (hdf5r semantics).

Copied from the JAX package's bcm3_tpu/io/hdf5r_compat.py, with `h5py`
imported only where a file is opened, so that a machine without h5py can
import the port.

The migration promise is that the reference's R analysis layer —
`R/load.r` (bcm3.load.results), `R/stats.r` (variable_summary,
marginal_likelihood) — reads this framework's `output.nc` and
`sampler_adaptation.nc` unchanged. R is not installable in the build
image, so this module vendors a line-faithful Python port of those
scripts *including hdf5r's view of HDF5 files*, and the test suite runs
it against freshly generated outputs. If a schema drift (dimension
order, fill-value handling, missing dataset) would break the real R
scripts, it breaks these ports the same way.

The one semantic that matters and is easy to get wrong: HDF5 stores
C-order (row-major); R is column-major, so hdf5r presents every dataset
with the dimension order REVERSED relative to h5py. A dataset h5py sees
as shape (sample_ix, temperature, variable) has hdf5r `$dims`
(variable, temperature, sample_ix), which is exactly why
`R/load.r:14` yields `posterior$samples[var, temp, sample]`. The
`H5DatasetR` wrapper reproduces that view by transposing.

Ported entry points and their R sources:
- `bcm3_load(...)`            <- R/load.r:63-135  (bcm3.load)
- `bcm3_load_results(...)`    <- R/load.r:4-61    (bcm3.load.results)
- `load_netcdf_bundler_data`  <- R/load.r:137-168
- `variable_summary(...)`     <- R/stats.r:100-115
- `marginal_likelihood(...)`  <- R/stats.r:232-240
- `variable_statistic(...)`   <- R/stats.r:242-278 (incl. R acf/quantile
  conventions: acf normalizes by n and includes lag 0; quantile is R
  type 7, numpy's default "linear")
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np


class H5DatasetR:
    """hdf5r's column-major view of an HDF5 dataset."""

    def __init__(self, ds):
        self._ds = ds

    @property
    def dims(self) -> tuple:
        # hdf5r $dims: reversed relative to the C-order h5py shape
        return tuple(reversed(self._ds.shape))

    def read(self) -> np.ndarray:
        """`dataset[...]` in hdf5r: data with axes reversed."""
        return np.asarray(self._ds[...]).transpose(
            tuple(reversed(range(self._ds.ndim)))
        )

    def get_fill_value(self):
        return self._ds.fillvalue


def _r_dataset(f, path: str) -> H5DatasetR:
    return H5DatasetR(f[path])


def bcm3_load(base_folder: str, prior_file: str = "prior.xml",
              likelihood_file: str = "likelihood.xml") -> Dict:
    """Port of bcm3.load (R/load.r:63-135): prior.xml variable list with
    `repeat` expansion, likelihood type/experiments."""
    model: Dict = {"base_folder": base_folder}
    prior: Dict = {"file_name": prior_file, "variable_attrs": []}
    root = ET.parse(os.path.join(base_folder, prior_file)).getroot()
    variables: List[str] = []
    for el in root.findall("variable"):
        attrs = dict(el.attrib)
        if "repeat" in attrs:
            n = int(float(attrs["repeat"]))
            for k in range(1, n + 1):
                prior["variable_attrs"].append(attrs)
                variables.append(f"{attrs['name']}_{k}")
        else:
            prior["variable_attrs"].append(attrs)
            variables.append(attrs["name"])
    model["prior"] = prior
    model["variables"] = variables
    model["nvar"] = len(variables)

    lik_root = ET.parse(os.path.join(base_folder, likelihood_file)).getroot()
    model["likelihood"] = {
        "file_name": likelihood_file,
        "type": lik_root.attrib.get("type"),
    }
    return model


def bcm3_load_results(
    base_folder: str,
    output_folder: str,
    prior_file: str = "prior.xml",
    likelihood_file: str = "likelihood.xml",
    output_filename: str = "output.nc",
    load_sampler_adaptation: bool = True,
) -> Dict:
    """Port of bcm3.load.results (R/load.r:4-61)."""
    import h5py

    model = bcm3_load(base_folder, prior_file, likelihood_file)
    model["output_folder"] = os.path.join(base_folder, output_folder)

    posterior: Dict = {}
    with h5py.File(os.path.join(model["output_folder"], output_filename),
                   "r") as f:
        posterior["temperatures"] = _r_dataset(f, "samples/temperature").read()
        # [var, temp, sample] after the hdf5r transpose (R/load.r:14)
        vv = _r_dataset(f, "samples/variable_values")
        posterior["samples"] = vv.read()
        if "weights" in f["samples"]:
            posterior["weights"] = _r_dataset(f, "samples/weights").read()
        else:
            posterior["weights"] = np.ones(
                (posterior["samples"].shape[1], posterior["samples"].shape[2])
            )
        lp = _r_dataset(f, "samples/log_prior")
        if len(lp.dims) == 1:
            # single stored temperature: pad to [ntemps, nsamples] with the
            # values in the last (fixed-temperature) row (R/load.r:20-26)
            ntemps = posterior["samples"].shape[1]
            nsamples = posterior["samples"].shape[2]
            posterior["lprior"] = np.full((ntemps, nsamples), np.nan)
            posterior["llikelihood"] = np.full((ntemps, nsamples), np.nan)
            posterior["lprior"][ntemps - 1] = lp.read()
            posterior["llikelihood"][ntemps - 1] = _r_dataset(
                f, "samples/log_likelihood"
            ).read()
        else:
            posterior["lprior"] = lp.read()
            posterior["llikelihood"] = _r_dataset(
                f, "samples/log_likelihood"
            ).read()

        fill_value = vv.get_fill_value()
        for k in ("samples", "weights", "lprior", "llikelihood"):
            arr = posterior[k].astype(np.float64)
            arr[arr == fill_value] = np.nan
            posterior[k] = arr

    posterior["lposterior"] = posterior["lprior"] + posterior["llikelihood"]
    temps = posterior["temperatures"]
    posterior["lfracposterior"] = (
        posterior["lprior"] + temps[:, None] * posterior["llikelihood"]
    )
    model["posterior"] = posterior

    model["sampler_adaptation"] = None
    if load_sampler_adaptation:
        fn = os.path.join(model["output_folder"], "sampler_adaptation.nc")
        if os.path.exists(fn):
            model["sampler_adaptation"] = load_netcdf_bundler_data(fn)

    model["AIC"] = 2 * model["nvar"] - 2 * np.nanmax(posterior["llikelihood"])
    return model


def load_netcdf_bundler_data(filename: str) -> Dict:
    """Port of load.netcdf.bundler.data (R/load.r:137-168): recursive
    group walk, skipping *dim1/*dim2 bookkeeping datasets, 1-D vectors
    kept, 2-D matrices with hdf5r's transposed dims."""
    import h5py

    def walk(group) -> Dict:
        result: Dict = {}
        for name, item in group.items():
            if isinstance(item, h5py.Group):
                result[name] = walk(item)
            else:
                if name.endswith("dim1") or name.endswith("dim2"):
                    continue
                r = H5DatasetR(item)
                if len(r.dims) == 1:
                    result[name] = r.read()
                elif len(r.dims) == 2:
                    result[name] = r.read()
                else:
                    raise ValueError(
                        f"bundler dataset {name} has >2 dims"  # R: stop()
                    )
        return result

    with h5py.File(filename, "r") as f:
        return {name: walk(f[name]) for name in f}


# ----------------------------------------------------------------------
# stats.r ports


def _r_acf(x: np.ndarray, lag_max: int) -> np.ndarray:
    """R stats::acf: c_k = (1/n) sum (x_t - xbar)(x_{t+k} - xbar),
    acf[k] = c_k / c_0, returned for lags 0..lag_max."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    xc = x - x.mean()
    c0 = np.dot(xc, xc) / n
    lags = np.arange(min(lag_max, n - 1) + 1)
    out = np.empty(len(lags))
    for k in lags:
        out[k] = np.dot(xc[: n - k], xc[k:]) / n / c0
    return out


def variable_statistic(samples: np.ndarray, statistic: str, **kw):
    """Port of variable_statistic (R/stats.r:242-278)."""
    x = np.asarray(samples, dtype=np.float64)
    if statistic == "mean":
        return float(np.mean(x))
    if statistic == "median":
        return float(np.median(x))
    if statistic == "sd":
        return float(np.std(x, ddof=1))
    if statistic == "quantile":
        # R default quantile type 7 == numpy "linear"
        return float(np.quantile(x, kw["q"]))
    if statistic == "autocorrelation":
        lag = kw["lag"]
        return float(_r_acf(x, lag)[lag])
    if statistic == "decorr_lag":
        ac = _r_acf(x, len(x) // 2)
        threshold = 2.0 / np.sqrt(len(x))
        below = np.nonzero(ac < threshold)[0]
        # R match(T, sign) is 1-based over lags 0..lag_max
        return int(below[0]) + 1 if len(below) else None
    if statistic == "ess":
        ac = _r_acf(x, len(x) // 2)
        neg = np.nonzero(ac < 0)[0]
        first_neg = int(neg[0]) + 1 if len(neg) else None  # 1-based
        if first_neg is not None and first_neg > 2:
            # R: acf[2:(first_neg-1)] -> 0-based lags 1..first_neg-2
            return float(len(x) / (1 + 2 * np.sum(ac[1 : first_neg - 1])))
        return float(len(x))
    raise ValueError(f"unknown statistic {statistic}")


def variable_summary(model: Dict, temperature_ix: Optional[int] = None,
                     sample_ix: Optional[np.ndarray] = None) -> Dict:
    """Port of variable_summary (R/stats.r:100-115): per-variable
    mean/sd/median/q025/q975/acf-lag1/decorrelation lag/ESS over the
    second half of the fixed-temperature chain by default."""
    samples = model["posterior"]["samples"]
    ntemp, nsamp = samples.shape[1], samples.shape[2]
    if temperature_ix is None:
        temperature_ix = ntemp - 1  # R default: dim[2] (1-based last)
    if sample_ix is None:
        sample_ix = np.arange(nsamp // 2, nsamp)  # R: (n/2+1):n
    out: Dict[str, List] = {
        k: []
        for k in ("mean", "sd", "median", "q025", "q975",
                  "autocorrelation_lag1", "decorrelation_lag", "ess")
    }
    for vi in range(model["nvar"]):
        x = samples[vi, temperature_ix, sample_ix]
        out["mean"].append(variable_statistic(x, "mean"))
        out["sd"].append(variable_statistic(x, "sd"))
        out["median"].append(variable_statistic(x, "median"))
        out["q025"].append(variable_statistic(x, "quantile", q=0.025))
        out["q975"].append(variable_statistic(x, "quantile", q=0.975))
        out["autocorrelation_lag1"].append(
            variable_statistic(x, "autocorrelation", lag=1)
        )
        out["decorrelation_lag"].append(
            variable_statistic(x, "decorr_lag")
        )
        out["ess"].append(variable_statistic(x, "ess"))
    out["row_names"] = list(model["variables"])
    return out


def marginal_likelihood(model: Dict,
                        sample_ix: Optional[np.ndarray] = None) -> float:
    """Port of marginal_likelihood (R/stats.r:232-240): thermodynamic
    integration (trapezoid over the temperature ladder), dropping the
    T=0 point when its mean log-likelihood is infinite."""
    llh = model["posterior"]["llikelihood"]
    nsamp = llh.shape[1]
    if sample_ix is None:
        sample_ix = np.arange(nsamp // 2, nsamp)
    mean_ll = llh[:, sample_ix].mean(axis=1)
    temps = model["posterior"]["temperatures"]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    if np.isinf(mean_ll[0]):
        return float(trapezoid(mean_ll[1:], temps[1:]))
    return float(trapezoid(mean_ll, temps))
