"""Build and load the port's CUDA kernels.

The sources in bcm3_tpu_torch/csrc/*.cu expose a plain C interface. At
first use each is compiled with nvcc for Hopper (sm_90a), all at once in
parallel, and the objects are linked into one shared library under
bcm3_tpu_torch/_kernels_build/, named by a hash of the sources and flags,
and loaded with ctypes. A second process finds the library already built
and only loads it.

Nothing here runs at import time: the CPU tests import every module of
the package on machines that have no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"

# --fmad=false: no contraction of a*b+c into a fused multiply-add, so the
# kernels round operation by operation like their plain PyTorch versions
# (one elementwise op per kernel there). The adaptive DP5 step sequence of
# B2 in float32 is sensitive to last-bit differences; with contraction on,
# a small share of lanes took another step sequence than the plain version.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)
# B2J is compiled with contraction on, as torch's own kernels are: under
# --fmad=false libdevice's float64 pow rounds otherwise than torch's pow on
# a few inputs in a million. Its own products are written so that they are
# never fused (transit_dp5_tangent.cu `mul`).
CONTRACTED = ("transit_dp5_tangent.cu",)


def source_flags(src: Path) -> tuple[str, ...]:
    """nvcc's flags for one source: NVCC_FLAGS, with --fmad=true for the
    sources in CONTRACTED."""
    if src.name not in CONTRACTED:
        return NVCC_FLAGS
    return tuple("--fmad=true" if f == "--fmad=false" else f for f in NVCC_FLAGS)


_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
_F64 = ctypes.c_double

# C entry points: name -> argument types (every pointer and the stream
# are c_void_p; every entry returns the cudaGetLastError() code)
_SIGNATURES = {
    # ka, ke, kel, initial_dose, interval, dose, out_gut, out_cen,
    # lanes, patients, intervals, stream
    "bcm3_poppk_propagate_f32": [_P] * 8 + [_I64, _I32, _I32, _P],
    "bcm3_poppk_propagate_f64": [_P] * 8 + [_I64, _I32, _I32, _P],
    # ka, ke, kel, initial_dose, interval, dose, grad_gut, grad_cen,
    # d_rates (3 x lanes: d/dka, d/dke, d/dkel), lanes, patients,
    # intervals, stream
    "bcm3_poppk_propagate_adjoint_f32": [_P] * 9 + [_I64, _I32, _I32, _P],
    "bcm3_poppk_propagate_adjoint_f64": [_P] * 9 + [_I64, _I32, _I32, _P],
    # ka, ke, kel, k_transit, n_transit, dose0, grid, amt, central, ok,
    # next_lane, lane_trips, warp_slots, lanes, patients, stops, trips,
    # rtol, atol, min_dt, first_dt, stream
    "bcm3_transit_dp5_f32": [_P] * 13
    + [_I32, _I32, _I32, _I32, _F32, _F32, _F32, _F32, _P],
    # ka, ke, kel, k_transit, n_transit, kpf, kpb, dose0, grid, amt,
    # obs_slot, central, jac, ok, next_lane, lane_trips, warp_slots, lanes,
    # patients, stops, observations, states, trips, lanes a producer warp,
    # ring slots, blocks, rtol, atol, min_dt, first_dt, stream
    "bcm3_transit_dp5_tangent_f32": [_P] * 17 + [_I32] * 9 + [_F64] * 4 + [_P],
    "bcm3_transit_dp5_tangent_f64": [_P] * 17 + [_I32] * 9 + [_F64] * 4 + [_P],
    # itemsize, states, patients, stops, ring slots, out (5 int32)
    "bcm3_transit_dp5_tangent_occupancy": [_I32] * 5 + [_P],
}

_loaded: ctypes.CDLL | None = None
last_build_seconds: float | None = None


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(" ".join(source_flags(src)).encode())
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbcm3_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this exact source set is not built yet.

    Returns the library path. The compiler's output (register and spill
    counts from -Xptxas=-v) is kept beside the library as a .log file."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    cmds = [
        [nvcc, *source_flags(src), "-c", "-o", str(obj), str(src)]
        for src, obj in zip(sources(), objs)
    ]
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    failed = [(c, log) for c, p, log in zip(cmds, procs, logs) if p.returncode != 0]
    if not failed:
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(proc.stdout)
        if proc.returncode != 0:
            failed.append((link, proc.stdout))
    last_build_seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        cmd, log = failed[0]
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _loaded
    if _loaded is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded = lib
    return _loaded


def check_launch(name: str, code: int) -> None:
    """Raise if a launch reported a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {code}")


def refuse_grad(name: str, tensors) -> None:
    """Raise if autograd would record through a kernel's outputs: the
    kernels write them through raw pointers, so autograd would take them
    for constants and return wrong gradients."""
    import torch

    if torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in tensors
    ):
        raise RuntimeError(
            f"{name}: an input requires grad, and the CUDA kernel's outputs carry no "
            "autograd history"
        )
