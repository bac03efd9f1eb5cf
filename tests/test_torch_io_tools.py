"""The port's copies of the JAX package's HDF5 tools, on the same files:
the data-value resolver (io/data_reference.py) and the shard merger
(merge_shards.py)."""

import h5py
import numpy as np
import pytest

from bcm3_tpu import merge_shards as jax_merge
from bcm3_tpu.io.data_reference import data_reference as jax_data_reference
from bcm3_tpu_torch import merge_shards
from bcm3_tpu_torch.io.data_reference import data_reference


@pytest.fixture
def ref_file(tmp_path):
    """tests/test_cli_io.py:173-203's file: a (patient, time) variable with
    dimension scales."""
    fn = str(tmp_path / "ref.nc")
    with h5py.File(fn, "w") as f:
        g = f.create_group("grp")
        pat = g.create_dataset("patient", data=np.array([b"p1", b"p2", b"p3"]))
        tm = g.create_dataset("time", data=np.array([0.0, 1.5, 3.0, 4.5]))
        v = g.create_dataset("conc", data=np.arange(12.0).reshape(3, 4))
        pat.make_scale("patient")
        tm.make_scale("time")
        v.dims[0].attach_scale(pat)
        v.dims[1].attach_scale(tm)
    return fn


_QUERIES = [
    (["patient", "time"], ["p2", "3.0"]),
    (["time", "patient"], ["1.5", "p3"]),
    (["patient"], ["p2"]),  # too few dimensions: ValueError
    (["patient", "time"], ["p9", "0.0"]),  # unknown label: KeyError
    (["patient", "dose"], ["p1", "0.0"]),  # unknown dimension: ValueError
]


@pytest.mark.parametrize("dims,labels", _QUERIES, ids=[str(i) for i in range(len(_QUERIES))])
def test_data_reference_matches_jax(ref_file, dims, labels):
    outcomes = []
    for fn in (jax_data_reference, data_reference):
        try:
            outcomes.append(fn(ref_file, "grp", "conc", dims, labels))
        except (KeyError, ValueError) as err:
            outcomes.append(type(err))
    assert outcomes[0] == outcomes[1]


def test_merge_shards_matches_jax(tmp_path):
    """Two per-process shards of 3 ensembles each, merged by both tools,
    give the same output.nc."""
    rng = np.random.default_rng(0)
    S, L, D = 5, 2, 3
    shards = []
    for p, e0 in enumerate((0, 3)):
        fn = str(tmp_path / f"shard_{p}.npz")
        np.savez(
            fn, samples=rng.normal(size=(S * 3, L, D)), log_prior=rng.normal(size=(S * 3, L)),
            log_likelihood=rng.normal(size=(S * 3, L)), e0=e0, e_local=3, num_ensembles=6,
            temperatures=np.array([0.5, 1.0]), variables=np.array(["a", "b", "c"]),
            variable_transform=np.array([0, 1, 0]),
        )
        shards.append(fn)
    out = {}
    for name, main in (("jax", jax_merge.main), ("port", merge_shards.main)):
        path = str(tmp_path / f"{name}.nc")
        assert main([*shards, "-o", path]) == 0
        with h5py.File(path, "r") as f:
            out[name] = {k: f["samples"][k][:] for k in f["samples"]}
    assert out["port"].keys() == out["jax"].keys()
    for k, v in out["jax"].items():
        np.testing.assert_array_equal(out["port"][k], v, err_msg=k)
    assert out["port"]["variable_values"].shape == (S * 6, L, D)
