"""The port imports neither JAX nor the JAX package, and needs no h5py,
no nvcc and no card to import.

Checked in a fresh interpreter, because this test process has JAX loaded
already (tests/conftest.py)."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import bcm3_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bcm3_tpu_torch.__path__, "bcm3_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
for mod in {mods!r}:
    if mod in sys.modules:
        raise SystemExit(f"{{mod}} was imported")
for mod in {walked!r}:
    if mod not in names:
        raise SystemExit(f"{{mod}} was not among the modules imported")
"""

# the multi-device path's modules, imported with the rest
WALKED = (
    "bcm3_tpu_torch.entry",
    "bcm3_tpu_torch.parallel.collectives",
    "bcm3_tpu_torch.parallel.distributed",
    "bcm3_tpu_torch.parallel.launch",
    "bcm3_tpu_torch.parallel.mesh",
    "bcm3_tpu_torch.parallel.run_distributed",
)


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )


@pytest.mark.parametrize(
    "forbidden",
    [
        ("jax", "jaxlib", "bcm3_tpu"),
        # the card's machine has no h5py: only the HDF5 readers/writers may
        # import it, and only when called
        ("h5py",),
        # nor matplotlib: only plots.py's drawing functions import it
        ("matplotlib",),
    ],
)
def test_port_imports_without(forbidden):
    proc = _run(_IMPORT_ALL.format(mods=forbidden, walked=WALKED))
    assert proc.returncode == 0, proc.stderr + proc.stdout
    # every module of the package was imported (not an empty walk)
    assert int(proc.stdout.split()[0]) >= 15


def test_import_builds_nothing():
    """Importing the kernel wrappers, the native matching and its users
    neither compiles nor loads a library: no compiler process is started."""
    proc = _run(
        "import subprocess\n"
        "def refuse(*a, **k): raise AssertionError('a process was started at import')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "import bcm3_tpu_torch.ops.poppk_kernels, bcm3_tpu_torch.ops.transit_kernels\n"
        "import bcm3_tpu_torch.likelihoods.cellmisc, bcm3_tpu_torch.cellpop.data_likelihood\n"
        "from bcm3_tpu_torch import native\n"
        "from bcm3_tpu_torch.ops import build\n"
        "assert build._loaded is None and build.last_build_seconds is None\n"
        "assert native._lap_lib is None\n"
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("wrapper", ["b1", "b2"])
def test_wrappers_never_fall_back_off_cpu(wrapper):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device (here 'meta') is refused, not run through the plain
    version."""
    from bcm3_tpu_torch.ops.poppk_kernels import propagate_intervals_one_compartment
    from bcm3_tpu_torch.ops.transit_kernels import PARAM_NAMES, transit_solve

    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "b1":
            x = torch.empty((2, 3), **meta)
            propagate_intervals_one_compartment(
                x, x, x, torch.empty(3, **meta), torch.empty(3, **meta),
                torch.empty((3, 4), **meta),
            )
        else:
            params = {k: torch.empty(5, **meta) for k in PARAM_NAMES}
            grid = torch.empty((5, 7), **meta)
            transit_solve(params, grid, grid)


def test_registry_builds_cell_population_and_refuses_fisa(tmp_path):
    """cell_population and, since fISA was ported, fISA too: the registry
    builds both from their likelihood.xml with the data in memory (the
    name is the test's from before fISA was ported)."""
    import chip_smoke
    from bcm3_tpu_torch.cellpop.likelihood import CellPopulationLikelihood
    from bcm3_tpu_torch.fisa import FISALikelihood

    prior, lik = chip_smoke.cellpop_model(str(tmp_path), "cellpop", 4, 2)
    assert lik.name == "cell_population" and isinstance(lik.model, CellPopulationLikelihood)
    assert lik.model.experiments[0].sparse_solver is not None
    lik, values = chip_smoke.fisa_model(str(tmp_path / "fisa"), "bistable")
    assert lik.name == "fISA" and isinstance(lik.model, FISALikelihood)
    assert lik.model.experiments[0].network.multiroot_solves == 10
    lp = lik.log_prob_batched(torch.as_tensor(values)[None])
    assert lp.shape == (1,) and torch.isfinite(lp).all()
