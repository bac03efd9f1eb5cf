"""Grouped HDF5 bundler for adaptation dumps.

Copied from the JAX package's bcm3_tpu/io/bundler.py, with `h5py` imported
only where a file is opened, so that machines without h5py can import the
package. Equivalent of the reference NetCDFBundler
(reference: src/utils/NetCDFBundler.{h,cpp}) used for the
``sampler_adaptation.nc`` files consumed by R
(R/load.r load.netcdf.bundler.data, examples/banana/plots.r:20-36).
Layout: one HDF5 group per name (e.g. ``adapt1/block1``) holding named
vector/matrix datasets.
"""

from __future__ import annotations

import os

import numpy as np


class HDF5Bundler:
    def __init__(self, filename: str, overwrite: bool = False):
        import h5py

        if overwrite and os.path.exists(filename):
            os.remove(filename)
        self._file = h5py.File(filename, "a")

    def add_vector(self, group: str, name: str, values):
        g = self._file.require_group(group)
        if name in g:
            del g[name]
        g.create_dataset(name, data=np.asarray(values))

    def add_matrix(self, group: str, name: str, values):
        self.add_vector(group, name, np.atleast_2d(np.asarray(values)))

    def close(self):
        self._file.flush()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_adaptation_dump(
    filename: str,
    adaptation_iteration: int,
    blocks_and_gmms,
    history: np.ndarray | None = None,
):
    """Write one adaptation's proposal state (reference:
    SamplerPTChain.cpp:149-166, ProposalGaussianMixture::WriteToFile).

    ``blocks_and_gmms``: list of (variable_indices, GMM-of-the-fixed-
    temperature-chain) per block. ``history`` is the full-variable history
    matrix of the fixed-temperature chain (written for iterations >= 1).
    """
    with HDF5Bundler(filename) as b:
        for bi, (block, gmm) in enumerate(blocks_and_gmms):
            group = f"adapt{adaptation_iteration}/block{bi + 1}"
            b.add_vector(group, "variable_indices", np.asarray(block, dtype=np.int32))
            b.add_vector(group, "gmm_weights", gmm.weights)
            for k in range(gmm.num_components):
                b.add_vector(group, f"cluster{k}_mean", gmm.means[k])
                b.add_matrix(group, f"cluster{k}_covariance", gmm.covariances[k])
            if history is not None and adaptation_iteration >= 1:
                b.add_matrix(group, "history", history[:, np.asarray(block)])


def load_bundle(filename: str) -> dict:
    """Read a bundler file back as nested dicts of numpy arrays
    (python-side equivalent of R/load.r's load.netcdf.bundler.data)."""
    import h5py

    def walk(g):
        out = {}
        for k, v in g.items():
            out[k] = walk(v) if isinstance(v, h5py.Group) else np.asarray(v)
        return out

    with h5py.File(filename, "r") as f:
        return walk(f)
