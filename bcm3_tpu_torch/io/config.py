"""Layered configuration: command line + INI config file.

Counterpart of bcm3_tpu/io/config.py (reference: src/bcminf/main.cpp:288-343,
Sampler.cpp:142-149, SamplerPT.cpp:147-172): the same dotted option names,
the same ``[section]`` / ``key=value`` config.txt and the same defaults.
Two options are the port's own, ``device`` (default ``cuda``) and
``dtype`` (default ``float32``): a torch program names its device and
precision where the JAX package takes them from JAX's global
configuration (``JAX_PLATFORMS``, x64).
"""

from __future__ import annotations

import argparse
import configparser
import os
from typing import Dict, Optional

import torch

from bcm3_tpu_torch.sampler.pt import PTConfig

# full option table with reference defaults
_DEFAULTS = {
    "sampling_threads": "0",
    "evaluation_threads": "1",
    "prior": "prior.xml",
    "likelihood": "likelihood.xml",
    "learning_rate": "1.0",
    "output.folder": "output",
    "predict.input": "output.nc",
    "predict.output": "prediction.nc",
    "predict.skip_n": "0",
    "predict.specific_temperature": "",
    "bcmopt.input": "output.nc",
    "bcmopt.num_samples": "10",
    "progress_update_time": "0.5",
    "sampler.type": "ptmh",
    "sampler.num_samples": "2500",
    "sampler.use_every_nth": "1",
    "sampler.rngseed": "0",
    "ptmhsampler.num_chains": "6",
    "ptmhsampler.blocking_strategy": "one_block",
    "ptmhsampler.proposal_type": "gaussian_mixture",
    "ptmhsampler.proposal_transform_to_unbounded": "false",
    "ptmhsampler.adapt_proposal_samples": "2000",
    "ptmhsampler.adapt_proposal_times": "2",
    "ptmhsampler.max_history_size": "2000",
    "ptmhsampler.adapt_proposal_max_history_samples": "2000",
    "ptmhsampler.adapt_proposal_max_clustering_samples": "1000",
    "ptmhsampler.stop_proposal_scaling": "6000",
    "ptmhsampler.sample_clustering_kernel_nn": "3",
    "ptmhsampler.sample_clustering_kernel_nn2": "7",
    "ptmhsampler.sample_clustering_num_clusters": "4",
    "ptmhsampler.swapping_scheme": "deterministic_even_odd",
    "ptmhsampler.exchange_probability": "0.5",
    "ptmhsampler.num_exploration_steps": "1",
    "ptmhsampler.temperature_schedule_power": "3.0",
    "ptmhsampler.temperature_schedule_max": "1.0",
    "ptmhsampler.output_proposal_adaptation": "false",
    # dump spectral-clustering intermediates per adaptation to
    # sample_history_clustering.nc (reference: SampleHistoryClustering.h:32)
    "ptmhsampler.output_sample_clustering": "false",
    "ptmhsampler.proposal_t_dof": "0.0",
    "ptmhsampler.initial_position_tries": "100",
    # independent PT replicas batched on the device
    "ptmhsampler.num_ensembles": "1",
    # device batch size for the importance sampler
    "issampler.batch_size": "1024",
    # mid-run checkpoint/resume
    "ptmhsampler.checkpoint_file": "",
    # emit only the fixed-temperature chains, like the reference's
    # EmitSample (SamplerPT.cpp:321-330)
    "ptmhsampler.emit_fixed_only": "false",
    # precision of the emitted copies: "" keeps the sampler dtype
    "ptmhsampler.emit_dtype": "",
    # the port's own: the torch device and floating dtype of the samplers
    # and of the likelihood evaluations
    "device": "cuda",
    "dtype": "float32",
}

_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def _parse_bool(v: str) -> bool:
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def _parse_dtype(v: str):
    v = (v or "").strip()
    if not v:
        return None
    # emission stores are floating-point sample copies; anything else
    # (typos, integer dtypes that would silently truncate samples) is a
    # config error worth naming
    allowed = tuple(_DTYPES)
    if v not in allowed:
        raise ValueError(f"ptmhsampler.emit_dtype must be one of {allowed}, got '{v}'")
    return _DTYPES[v]


def device_and_dtype(opts: Dict[str, str]):
    """The torch device name and the sampler dtype of an option map."""
    name = opts.get("dtype", _DEFAULTS["dtype"])
    if name not in ("float64", "float32"):
        raise ValueError(f"dtype must be float64 or float32, got '{name}'")
    return opts.get("device", _DEFAULTS["device"]), _DTYPES[name]


def load_options(
    config_file: Optional[str] = None, overrides: Optional[Dict[str, str]] = None
) -> Dict[str, str]:
    """Merged option map: defaults < config file < explicit overrides."""
    opts = dict(_DEFAULTS)
    if config_file == "config.txt" and not os.path.exists(config_file):
        config_file = None  # tolerate a missing default config file
    if config_file:
        cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        with open(config_file) as f:
            cp.read_string(f.read())
        for section in cp.sections():
            for key, value in cp.items(section):
                opts[f"{section}.{key}"] = value
    for k, v in (overrides or {}).items():
        if v is not None:
            opts[k] = str(v)
    return opts


def pt_config_from_options(opts: Dict[str, str]) -> PTConfig:
    g = opts.get
    device, dtype = device_and_dtype(opts)
    return PTConfig(
        num_samples=int(g("sampler.num_samples")),
        use_every_nth=int(g("sampler.use_every_nth")),
        seed=int(g("sampler.rngseed")),
        num_chains=int(g("ptmhsampler.num_chains")),
        blocking_strategy=g("ptmhsampler.blocking_strategy"),
        proposal_type=g("ptmhsampler.proposal_type"),
        adapt_proposal_samples=int(g("ptmhsampler.adapt_proposal_samples")),
        adapt_proposal_times=int(g("ptmhsampler.adapt_proposal_times")),
        max_history_size=int(g("ptmhsampler.max_history_size")),
        adapt_proposal_max_history_samples=int(
            g("ptmhsampler.adapt_proposal_max_history_samples")
        ),
        adapt_proposal_max_clustering_samples=int(
            g("ptmhsampler.adapt_proposal_max_clustering_samples")
        ),
        stop_proposal_scaling=int(g("ptmhsampler.stop_proposal_scaling")),
        sample_clustering_nn=int(g("ptmhsampler.sample_clustering_kernel_nn")),
        sample_clustering_nn2=int(g("ptmhsampler.sample_clustering_kernel_nn2")),
        sample_clustering_num_clusters=int(g("ptmhsampler.sample_clustering_num_clusters")),
        swapping_scheme=g("ptmhsampler.swapping_scheme"),
        exchange_probability=float(g("ptmhsampler.exchange_probability")),
        num_exploration_steps=int(g("ptmhsampler.num_exploration_steps")),
        temperature_schedule_power=float(g("ptmhsampler.temperature_schedule_power")),
        temperature_schedule_max=float(g("ptmhsampler.temperature_schedule_max")),
        output_proposal_adaptation=_parse_bool(g("ptmhsampler.output_proposal_adaptation")),
        output_sample_clustering=_parse_bool(g("ptmhsampler.output_sample_clustering")),
        proposal_t_dof=float(g("ptmhsampler.proposal_t_dof")),
        initial_position_tries=int(g("ptmhsampler.initial_position_tries")),
        num_ensembles=int(g("ptmhsampler.num_ensembles")),
        checkpoint_file=g("ptmhsampler.checkpoint_file") or "",
        emit_fixed_only=_parse_bool(g("ptmhsampler.emit_fixed_only")),
        emit_dtype=_parse_dtype(g("ptmhsampler.emit_dtype")),
        device=device,
        dtype=dtype,
    )


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bcminf",
        description="bcm3 inference tool on PyTorch (equivalent of bcminf)",
    )
    p.add_argument("--config_file", "-c", default="config.txt")
    p.add_argument("--prior", default=None)
    p.add_argument("--likelihood", default=None)
    p.add_argument("--output.folder", dest="output_folder", default=None)
    p.add_argument("--learning_rate", "-e", type=float, default=None)
    p.add_argument("--predict", action="store_true")
    p.add_argument("--bcmopt", action="store_true")
    p.add_argument("--bcmopt.input", dest="bcmopt_input", default=None)
    p.add_argument("--bcmopt.num_samples", dest="bcmopt_num_samples", type=int, default=None)
    p.add_argument("--predict.input", dest="predict_input", default=None)
    p.add_argument("--predict.output", dest="predict_output", default=None)
    p.add_argument("--predict.skip_n", dest="predict_skip_n", type=int, default=None)
    p.add_argument("--sampler.num_samples", dest="num_samples", type=int, default=None)
    p.add_argument("--sampler.use_every_nth", dest="use_every_nth", type=int, default=None)
    p.add_argument("--sampler.rngseed", dest="rngseed", type=int, default=None)
    p.add_argument("--ptmhsampler.num_chains", dest="num_chains", type=int, default=None)
    p.add_argument("--ptmhsampler.proposal_type", dest="proposal_type", default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--dtype", default=None, help="float32 (default) or float64")
    return p


def options_from_args(args) -> Dict[str, str]:
    overrides = {
        "prior": args.prior,
        "likelihood": args.likelihood,
        "output.folder": args.output_folder,
        "learning_rate": args.learning_rate,
        "predict.input": args.predict_input,
        "predict.output": args.predict_output,
        "predict.skip_n": args.predict_skip_n,
        "bcmopt.input": args.bcmopt_input,
        "bcmopt.num_samples": args.bcmopt_num_samples,
        "sampler.num_samples": args.num_samples,
        "sampler.use_every_nth": args.use_every_nth,
        "sampler.rngseed": args.rngseed,
        "ptmhsampler.num_chains": args.num_chains,
        "ptmhsampler.proposal_type": args.proposal_type,
        "device": args.device,
        "dtype": args.dtype,
    }
    return load_options(args.config_file, overrides)
