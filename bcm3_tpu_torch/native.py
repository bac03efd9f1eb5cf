"""The host's Hungarian matching: native/lap.cpp, built and loaded here.

Counterpart of bcm3_tpu/native.py. The shared source native/lap.cpp (a
rectangular Jonker-Volgenant assignment, and a batched masked
matched-logp with C++ threads inside) is compiled with g++ at first use
into bcm3_tpu_torch/_kernels_build/, named by a hash of the source and
flags, and loaded with ctypes. Nothing is built at import. A failed build
or load raises with the compiler's message: the port's matching never
gives way to scipy. scipy's `linear_sum_assignment` is the plain version
(`lap_solve_plain`, `lap_match_logp_batch_plain`), against which the tests
and `chip_smoke.py` hold the native solver.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
LAP_SOURCE = _PKG.parent / "native" / "lap.cpp"
BUILD_DIR = _PKG / "_kernels_build"
CXX_FLAGS = ("-O3", "-std=c++14", "-fPIC", "-shared")

_lap_lib: ctypes.CDLL | None = None

_DP = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(LAP_SOURCE.read_bytes())
    return BUILD_DIR / f"libbcm3lap_{h.hexdigest()[:16]}.so"


def build_lap_library() -> Path:
    """Compile native/lap.cpp unless this exact source is built already;
    raises RuntimeError with the compiler's output if it fails."""
    out = _library_path()
    if out.exists():
        return out
    name = os.environ.get("CXX") or "g++"
    cxx = shutil.which(name)
    if not cxx:
        raise RuntimeError(f"C++ compiler {name!r} not found: the Hungarian matching needs one")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(LAP_SOURCE), "-lpthread"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {LAP_SOURCE.name} failed:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def get_lap_library() -> ctypes.CDLL:
    """The native LAP library, built on first use."""
    global _lap_lib
    if _lap_lib is None:
        lib = ctypes.CDLL(str(build_lap_library()))
        lib.bcm3_lap_solve.restype = ctypes.c_double
        lib.bcm3_lap_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, _DP, ctypes.POINTER(ctypes.c_int),
        ]
        lib.bcm3_lap_match_logp_batch.restype = None
        lib.bcm3_lap_match_logp_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _DP, _U8P, _U8P, ctypes.c_int, _DP,
        ]
        _lap_lib = lib
    return _lap_lib


def match_threads() -> int:
    """The matching's C++ threads: BCM3_MATCH_THREADS, else the host's
    cores up to 16."""
    n = int(os.environ.get("BCM3_MATCH_THREADS", "0"))
    return n if n > 0 else min(os.cpu_count() or 1, 16)


def lap_solve(cost: np.ndarray):
    """Min-cost assignment of the rows of a (n_rows, n_cols) cost matrix
    to distinct columns, n_rows <= n_cols. Returns (row_to_col, total)."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n_rows, n_cols = cost.shape
    if n_rows > n_cols:
        raise ValueError(f"lap_solve needs n_rows <= n_cols, got {cost.shape}")
    out = np.empty(n_rows, dtype=np.int32)
    total = get_lap_library().bcm3_lap_solve(
        n_rows, n_cols, cost.ctypes.data_as(_DP),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out.astype(np.int64), float(total)


def lap_solve_plain(cost: np.ndarray):
    """`lap_solve` by scipy.optimize.linear_sum_assignment."""
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost, dtype=np.float64)
    rows, cols = linear_sum_assignment(cost)
    out = np.full(cost.shape[0], -1, dtype=np.int64)
    out[rows] = cols
    return out, float(cost[rows, cols].sum())


def _batch_args(cost_logp, obs_valid, sim_valid):
    cost = np.ascontiguousarray(cost_logp, dtype=np.float64)
    B, n_obs, n_sim = cost.shape
    ov = np.ascontiguousarray(np.broadcast_to(obs_valid, (B, n_obs)), dtype=np.uint8)
    sv = np.ascontiguousarray(np.broadcast_to(sim_valid, (B, n_sim)), dtype=np.uint8)
    return cost, ov, sv


def lap_match_logp_batch(cost_logp: np.ndarray, obs_valid: np.ndarray,
                         sim_valid: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """For each of B (n_obs, n_sim) log-likelihood matrices, match the
    valid observed rows to valid simulated columns to maximize the total
    logp (reference: DataLikelihoodTimePoints.cpp:200-289): no valid
    observation gives 0, fewer valid simulations than observations -inf,
    non-finite entries count as -1e100 and a total at or below -1e90 is
    -inf. One native call for the whole batch, C++ threads inside
    (n_threads <= 0: `match_threads()`)."""
    cost, ov, sv = _batch_args(cost_logp, obs_valid, sim_valid)
    B, n_obs, n_sim = cost.shape
    totals = np.empty(B, dtype=np.float64)
    if B == 0:
        return totals
    get_lap_library().bcm3_lap_match_logp_batch(
        B, n_obs, n_sim, cost.ctypes.data_as(_DP), ov.ctypes.data_as(_U8P),
        sv.ctypes.data_as(_U8P), n_threads if n_threads > 0 else match_threads(),
        totals.ctypes.data_as(_DP),
    )
    return totals


def lap_match_logp_batch_plain(cost_logp: np.ndarray, obs_valid: np.ndarray,
                               sim_valid: np.ndarray) -> np.ndarray:
    """`lap_match_logp_batch` row by row with scipy."""
    cost, ov, sv = _batch_args(cost_logp, obs_valid, sim_valid)
    totals = np.empty(cost.shape[0], dtype=np.float64)
    for b in range(cost.shape[0]):
        oi, si = np.flatnonzero(ov[b]), np.flatnonzero(sv[b])
        if len(oi) == 0:
            totals[b] = 0.0
            continue
        if len(si) < len(oi):
            totals[b] = -np.inf
            continue
        sub = cost[b][np.ix_(oi, si)]
        sub = np.where(np.isfinite(sub), sub, -1e100)
        t = -lap_solve_plain(-sub)[1]
        totals[b] = t if (np.isfinite(t) and t > -1e90) else -np.inf
    return totals
