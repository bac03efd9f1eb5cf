"""User-plugin likelihood: load a log-density from external code.

Counterpart of bcm3_tpu/likelihoods/plugin.py (reference:
src/likelihoods/LikelihoodDLL.cpp:34-116, example at
examples/dll_likelihood/code.cpp), which dlopens a user shared library
exporting ``initialize_likelihood`` + ``evaluate_log_probability``.
Every plugin becomes ``log_prob_batched(xs (B, D)) -> (B,)``.

- **Python module**: a ``.py`` file exporting either
  ``make_log_prob(variable_names)`` or a plain
  ``evaluate_log_probability(values (D,) numpy) -> float``. The latter
  runs row by row on the host, from one device-to-host copy of the batch,
  so one file serves both packages. The former differs from the JAX
  package's: there it returns a per-row jnp function, which cannot run
  under torch; here it must return a batched torch function
  ``(B, D) -> (B,)`` on the rows' device and dtype.
- **C shared library**: a ``.so`` exporting the reference's exact C ABI
  ``bool evaluate_log_probability(ptrdiff_t n, const double* values,
  const char** names, double* log_p)`` (and optional
  ``bool initialize_likelihood(size_t n, const char* const* names)``),
  loaded with ctypes and called one row at a time on the host in float64,
  from one device-to-host copy of the batch: the JAX package's
  ``pure_callback`` semantics. A false return or a NaN gives -inf.
  This is host time by nature; `chip_smoke.py` logs it per row.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
from typing import Callable, List

import numpy as np
import torch


def _host_rows(host_eval):
    """A batched log-density that copies the rows to the host once and
    calls host_eval on each."""

    def log_prob_batched(xs: torch.Tensor) -> torch.Tensor:
        rows = xs.detach().cpu().numpy()
        out = np.array([host_eval(row) for row in rows], dtype=np.float64)
        return torch.as_tensor(out).to(xs.device, xs.dtype)

    return log_prob_batched


def _load_python_plugin(path: str, variable_names: List[str]) -> Callable:
    spec = importlib.util.spec_from_file_location("bcm3_user_likelihood", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    if hasattr(mod, "initialize_likelihood"):
        if not mod.initialize_likelihood(len(variable_names), variable_names):
            raise RuntimeError("Plugin initialize_likelihood returned False")

    if hasattr(mod, "make_log_prob"):
        return mod.make_log_prob(variable_names)
    if hasattr(mod, "evaluate_log_probability"):
        host_fn = mod.evaluate_log_probability
        return _host_rows(lambda row: float(host_fn(row)))
    raise ValueError(
        f"Python plugin {path} must export make_log_prob or evaluate_log_probability"
    )


def _load_c_plugin(path: str, variable_names: List[str]) -> Callable:
    lib = ctypes.CDLL(path)
    n = len(variable_names)
    name_array = (ctypes.c_char_p * n)(*[name.encode() for name in variable_names])

    init = getattr(lib, "initialize_likelihood", None)
    if init is not None:
        init.restype = ctypes.c_bool
        init.argtypes = [ctypes.c_size_t, ctypes.POINTER(ctypes.c_char_p)]
        if not init(n, name_array):
            raise RuntimeError("Plugin initialize_likelihood returned false")

    eval_fn = lib.evaluate_log_probability
    eval_fn.restype = ctypes.c_bool
    eval_fn.argtypes = [
        ctypes.c_ssize_t,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_double),
    ]

    def host_eval(values: np.ndarray) -> float:
        v = np.ascontiguousarray(values, dtype=np.float64)
        out = ctypes.c_double(np.nan)
        ok = eval_fn(n, v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), name_array,
                     ctypes.byref(out))
        # a false return / NaN means evaluation failure -> -inf (reject),
        # the framework-wide soft-fail convention (the reference,
        # LikelihoodDLL.cpp:103-116, treats it as a hard error)
        if not ok or np.isnan(out.value):
            return -np.inf
        return out.value

    return _host_rows(host_eval)


def load_plugin_log_prob(
    filename_base: str, variable_names: List[str], base_dir: str = "."
) -> Callable:
    """Resolve and load a plugin likelihood.

    ``filename_base`` follows the reference convention (no extension,
    ``.so`` appended; reference: LikelihoodDLL.cpp:68-72). A ``.py`` file
    of the same base name is preferred when present.
    """
    candidates = [
        filename_base,
        filename_base + ".py",
        filename_base + ".so",
        os.path.join(base_dir, filename_base),
        os.path.join(base_dir, filename_base + ".py"),
        os.path.join(base_dir, filename_base + ".so"),
        os.path.join(base_dir, "build", filename_base + ".so"),
    ]
    for cand in candidates:
        if os.path.isfile(cand):
            if cand.endswith(".py"):
                return _load_python_plugin(cand, variable_names)
            return _load_c_plugin(cand, variable_names)
    raise FileNotFoundError(
        f"Cannot find plugin likelihood '{filename_base}' (tried {candidates})"
    )
