"""Generic NetCDF data-value resolver.

Copied from the JAX package's bcm3_tpu/io/data_reference.py, with `h5py`
imported only where a file is opened. Equivalent of the reference's `DataReference`
(reference: src/sampler/DataReference.{h,cpp}) — note that class has
ZERO call sites in the reference tree (orphaned utility); it is provided
here for interface completeness. Semantics preserved:

- the caller names each dimension and an index LABEL per dimension;
- labels are resolved against the dimension's coordinate values (string
  dimensions match by value; numeric dimensions match by parsed number);
- named dimensions may be given in any order — they are mapped onto the
  variable's actual dimension order (DataReference.cpp:58-72);
- mismatched dimension sets/counts are errors.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _decode(v):
    return v.decode() if isinstance(v, bytes) else v


def _match_index(coord_values: np.ndarray, label: str) -> int:
    vals = [_decode(v) for v in coord_values]
    if len(vals) and isinstance(vals[0], str):
        if label in vals:
            return vals.index(label)
        raise KeyError(f"index label '{label}' not found in dimension values")
    num = float(label)
    arr = np.asarray(vals, dtype=np.float64)
    hits = np.where(np.isclose(arr, num))[0]
    if len(hits) == 0:
        raise KeyError(f"index value {label} not found in dimension values")
    return int(hits[0])


def data_reference(
    filename: str,
    group: str,
    variable_name: str,
    dimensions: Sequence[str],
    indices: Sequence[str],
) -> float:
    """Resolve one scalar value from a grouped NetCDF/HDF5 data file."""
    if len(dimensions) != len(indices):
        raise ValueError(
            f"Inconsistent dimensions/indices for data reference to "
            f"{group}/{variable_name}: {len(dimensions)}/{len(indices)}"
        )
    import h5py

    with h5py.File(filename, "r") as f:
        g = f[group] if group else f
        var = g[variable_name]
        # dimension names attached via DIMENSION_LIST / dimension scales
        # (the layout NetCDFDataFile produces), else fall back to the
        # per-variable 'dimensions' attribute
        dim_names = []
        dim_values = []
        if var.dims and all(len(d) for d in var.dims):
            for d in var.dims:
                scale = d[0]
                dim_names.append(scale.name.rsplit("/", 1)[-1])
                dim_values.append(scale[:])
        else:
            attr = var.attrs.get("dimensions")
            if attr is None:
                raise ValueError(
                    f"{group}/{variable_name} carries no dimension metadata"
                )
            for name in _decode(attr).split(","):
                dim_names.append(name)
                dim_values.append(g[name][:])
        if len(dim_names) != len(dimensions):
            raise ValueError(
                f"NetCDF variable {group}/{variable_name} has "
                f"{len(dim_names)} dimensions, but the data reference "
                f"specifies {len(dimensions)}"
            )
        ix = []
        by_name: Dict[str, str] = dict(zip(dimensions, indices))
        for name, values in zip(dim_names, dim_values):
            if name not in by_name:
                raise ValueError(
                    f"variable dimension '{name}' is not specified in the "
                    f"data reference dimensions {list(dimensions)}"
                )
            ix.append(_match_index(values, by_name[name]))
        return float(var[tuple(ix)])
