"""bcminf-equivalent command-line tool on PyTorch.

Counterpart of bcm3_tpu/cli.py (reference: src/bcminf/main.cpp,
src/bcmopt/main.cpp). `run` loads prior.xml / likelihood.xml and
config.txt, runs the sampler and writes output.nc (+ log.txt,
sampler_adaptation.nc, sample_history_clustering.nc); `--predict`
re-evaluates the likelihood over a previous run's stored samples and
writes prediction.nc; `--bcmopt` re-estimates the MAP from stored samples
and writes MAP_estimates.tsv and MAP_estimates_paramvalues.tsv.

Each mode is a core that takes the option map, a prior and a likelihood
and touches no file (`make_sampler`, whose sampler's run() takes the
caller's handlers; `predict_core`; `bcmopt_core`), and the file ends
around it (`run`, `predict`, `bcmopt`), which read the XML and pkdata and
write the HDF5 and TSV files. The files need h5py; the cores do not.

The samplers and the likelihood evaluations run on the device of the
`--device` option (default cuda) in the dtype of `--dtype` (default
float32).

Usage:
    python -m bcm3_tpu_torch.cli -c config.txt
    python -m bcm3_tpu_torch.cli -c config.txt --predict
    python -m bcm3_tpu_torch.cli -c config.txt --bcmopt
    python -m bcm3_tpu_torch.cli -c config.txt --device cpu --dtype float64
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from bcm3_tpu_torch import __version__
from bcm3_tpu_torch.io.config import device_and_dtype
from bcm3_tpu_torch.io.output import NC_FILL_DOUBLE, SampleHandlerMAP
from bcm3_tpu_torch.io.progress import ProgressIndicatorConsole
from bcm3_tpu_torch.likelihoods import fixed_parameter_likelihood
from bcm3_tpu_torch.sampler.factory import create_sampler

# rows per likelihood call of --predict
PREDICT_BATCH = 65536


def _setup_logging(output_path: str):
    os.makedirs(output_path, exist_ok=True)
    handlers = [
        logging.StreamHandler(),
        logging.FileHandler(os.path.join(output_path, "log.txt"), mode="w"),
    ]
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=handlers,
        force=True,
    )


def _load_model(opts):
    from bcm3_tpu_torch.likelihoods import create_likelihood
    from bcm3_tpu_torch.model.prior import Prior
    from bcm3_tpu_torch.model.variables import VariableSet

    varset = VariableSet.from_xml(opts["prior"])
    prior = Prior.from_xml(opts["prior"], varset)
    likelihood = create_likelihood(opts["likelihood"], varset)
    likelihood.learning_rate = float(opts.get("learning_rate", "1.0"))
    return varset, prior, likelihood


# ---------------------------------------------------------------------------
# run


def make_sampler(opts: Dict[str, str], prior, likelihood, progress_stream=None):
    """The sampler of `run`: the factory's, with the console progress
    indicator (on `progress_stream`, default stderr) where it takes one.
    Its run() samples into its `sample_handlers`."""
    sampler = create_sampler(prior, likelihood, opts)
    if hasattr(sampler, "progress"):
        sampler.progress = ProgressIndicatorConsole(
            update_time=float(opts.get("progress_update_time", "0.5")),
            stream=progress_stream,
        )
    return sampler


def write_dumps(output_path: str, sampler):
    """sampler_adaptation.nc and sample_history_clustering.nc from the
    sampler's dumps, where it kept any (bcm3_tpu/cli.py:84-120)."""
    from bcm3_tpu_torch.io.bundler import HDF5Bundler, write_adaptation_dump

    log = logging.getLogger("bcminf")
    if getattr(sampler, "adaptation_dumps", None):
        fn = os.path.join(output_path, "sampler_adaptation.nc")
        if os.path.exists(fn):
            os.remove(fn)
        for iteration, record, history in sampler.adaptation_dumps:
            write_adaptation_dump(fn, iteration, record, history)
        log.info("Wrote %s", fn)
    if getattr(sampler, "clustering_dumps", None):
        # per-adaptation spectral-clustering diagnostics, group iterN
        # (reference: SampleHistoryClustering.cpp:40-56)
        fn = os.path.join(output_path, "sample_history_clustering.nc")
        if os.path.exists(fn):
            os.remove(fn)
        with HDF5Bundler(fn) as bundle:
            for iteration, dump in sampler.clustering_dumps:
                grp = f"iter{iteration}"
                for name in ("clustering_input_samples", "K", "Y"):
                    bundle.add_matrix(grp, name, dump[name])
                for name in ("clustering_input_sample_scaling", "assignment", "all_assignment"):
                    bundle.add_vector(grp, name, dump[name])
        log.info("Wrote %s", fn)


def run(opts) -> int:
    import h5py  # noqa: F401  (the output files need it: fail before sampling)

    from bcm3_tpu_torch.io.output import SampleHandlerHDF5

    output_path = opts["output.folder"]
    _setup_logging(output_path)
    log = logging.getLogger("bcminf")
    log.info("bcm3 inference tool on PyTorch - version %s", __version__)
    device, dtype = device_and_dtype(opts)
    log.info("torch device: %s, dtype %s", device, dtype)

    varset, prior, likelihood = _load_model(opts)
    sampler = make_sampler(opts, prior, likelihood)
    # a run that resumes from its checkpoint writes on into the output file
    # of the run it continues, which keeps the rows written before
    checkpoint = getattr(getattr(sampler, "config", None), "checkpoint_file", "")
    resume = bool(checkpoint) and os.path.exists(checkpoint)
    with SampleHandlerHDF5(
        os.path.join(output_path, "output.nc"),
        sampler.expected_emitted_samples,
        varset.names,
        varset.transforms,
        getattr(sampler, "emit_ladder", sampler.ladder),
        resume=resume,
    ) as handler:
        sampler.sample_handlers.append(handler)
        t0 = time.time()
        sampler.run()
    log.info("Total run time: %.2fs", time.time() - t0)
    write_dumps(output_path, sampler)
    return 0


# ---------------------------------------------------------------------------
# predict


def predict_core(opts: Dict[str, str], likelihood, samples: np.ndarray):
    """Re-evaluate the likelihood over stored samples (S, C, D)
    (reference: src/bcminf/main.cpp:142-278): for each temperature (or
    the one of `predict.specific_temperature`), every (skip_n+1)-th
    sample of the second half, in batches of PREDICT_BATCH rows through
    `log_prob_batched`, times the learning rate. Returns the (S, C)
    predictions (NC_FILL_DOUBLE where not evaluated), the evaluation
    count and the seconds."""
    device, dtype = device_and_dtype(opts)
    S, C, D = samples.shape
    skip_n = int(opts.get("predict.skip_n", "0"))
    use_ix = np.arange(S // 2, S, skip_n + 1)
    spec_t = opts.get("predict.specific_temperature", "")
    temp_ix = range(C) if spec_t in ("", None) else [int(spec_t)]

    pred = np.full((S, C), NC_FILL_DOUBLE)
    t0 = time.perf_counter()
    n_eval = 0
    for ti in temp_ix:
        for i0 in range(0, len(use_ix), PREDICT_BATCH):
            rows = use_ix[i0 : i0 + PREDICT_BATCH]
            xs = torch.as_tensor(samples[rows, ti, :], dtype=dtype, device=device)
            vals = likelihood.log_prob_batched(xs).cpu().numpy().astype(np.float64)
            pred[rows, ti] = vals * likelihood.learning_rate
        n_eval += len(use_ix)
    elapsed = time.perf_counter() - t0
    logging.getLogger("bcminf").info(
        "Prediction: %d evaluations in %.3fs (%.1f evals/s)",
        n_eval,
        elapsed,
        n_eval / max(elapsed, 1e-9),
    )
    return pred, n_eval, elapsed


def predict(opts) -> int:
    import h5py

    from bcm3_tpu_torch.io.output import load_results

    output_path = opts["output.folder"]
    _setup_logging(output_path)
    log = logging.getLogger("bcminf")

    _, _, likelihood = _load_model(opts)
    res = load_results(os.path.join(output_path, opts["predict.input"]))
    pred, _, _ = predict_core(opts, likelihood, res["samples"])

    out_fn = os.path.join(output_path, opts["predict.output"])
    with h5py.File(out_fn, "w") as f:
        g = f.create_group("predictions")
        g.create_dataset("log_likelihood", data=pred, fillvalue=NC_FILL_DOUBLE)
        g.create_dataset("temperature", data=res["temperatures"])
    log.info("Wrote %s", out_fn)
    return 0


# ---------------------------------------------------------------------------
# bcmopt


def bcmopt_core(opts: Dict[str, str], prior, full_likelihood, stored) -> dict:
    """MAP re-estimation over stored samples (reference:
    src/bcmopt/main.cpp:15-240): for each stored temperature and each of
    `bcmopt.num_samples` samples of the second half, the stored variables
    that are not in `prior` are held at the sample's values and a short
    sampler (the factory's, from `opts`) with a MAP sink runs over the
    others. `full_likelihood` is over the stored variable layout;
    `stored` holds the stored samples (S, C, D), variable names and
    temperatures (as io.output.load_results gives them).

    Returns the sample indices, the temperatures, the names of the fixed
    and the optimized variables, and per (temperature, sample) one row,
    temperature-major: temperature, sample index, MAP log posterior and
    log likelihood, the fixed values and the MAP sample."""
    stored_names = list(stored["variables"])
    samples = stored["samples"]
    temps = stored["temperatures"]
    S = samples.shape[0]
    names = prior.varset.names

    # non-sampled parameters = stored variables not in the current prior
    # (reference: src/bcmopt/main.cpp:134-149)
    non_sampled_ix = [i for i, name in enumerate(stored_names) if name not in names]
    sampled_pos = [stored_names.index(n) for n in names]

    num_input = int(opts.get("bcmopt.num_samples", "10"))
    start_ix = S // 2
    use_ix = [
        start_ix + i * (S - start_ix) // num_input + ((S - start_ix) // num_input - 1)
        for i in range(num_input)
    ]

    log = logging.getLogger("bcmopt")
    # every inner sampler runs from scratch: with one checkpoint file for
    # all of them, each after the first would resume from the first one's
    # finished run and find no MAP (the JAX CLI does so,
    # bcm3_tpu/cli.py:259; this is a deliberate departure from it)
    if opts.get("ptmhsampler.checkpoint_file"):
        log.warning("bcmopt ignores ptmhsampler.checkpoint_file: each sampler runs from scratch")
        opts = {k: v for k, v in opts.items() if k != "ptmhsampler.checkpoint_file"}
    rows: List[dict] = []
    for ti in range(len(temps)):
        log.info("Temperature %d (%g)...", ti, temps[ti])
        for si in use_ix:
            sub = fixed_parameter_likelihood(full_likelihood, samples[si, ti, :], sampled_pos)
            sampler = create_sampler(prior, sub, opts)
            handler = SampleHandlerMAP()
            sampler.sample_handlers.append(handler)
            sampler.run()
            rows.append({
                "temperature": temps[ti],
                "sample": si,
                "map_lposterior": handler.map_lposterior,
                "map_llikelihood": handler.map_llikelihood,
                "fixed": samples[si, ti, non_sampled_ix],
                "map_sample": handler.map_sample,
            })
    return {
        "use_ix": use_ix,
        "temperatures": temps,
        "fixed_names": [stored_names[i] for i in non_sampled_ix],
        "optimized_names": list(names),
        "rows": rows,
    }


def write_bcmopt_tables(output_path: str, result: dict):
    """MAP_estimates.tsv (per temperature, the MAP log posterior of each
    sample) and MAP_estimates_paramvalues.tsv (per sample, the fixed and
    the optimized values), formatted as bcm3_tpu/cli.py:214-277 does."""
    fn1 = os.path.join(output_path, "MAP_estimates.tsv")
    fn2 = os.path.join(output_path, "MAP_estimates_paramvalues.tsv")
    n = len(result["use_ix"])
    with open(fn1, "w") as f1, open(fn2, "w") as f2:
        f1.write("temperature" + "".join(f"\t{i}" for i in range(n)) + "\n")
        f2.write(
            "temperature_sample\tlog posterior\tlog likelihood"
            + "".join(f"\tfixed_{name}" for name in result["fixed_names"])
            + "".join(f"\toptimized_{name}" for name in result["optimized_names"])
            + "\n"
        )
        for ti, temp in enumerate(result["temperatures"]):
            f1.write(f"{temp:g}")
            for r in result["rows"][ti * n : (ti + 1) * n]:
                f1.write(f"\t{r['map_lposterior']:g}")
                f2.write(
                    f"{r['temperature']:g}_{r['sample']}\t{r['map_lposterior']:g}"
                    f"\t{r['map_llikelihood']:g}"
                )
                for v in r["fixed"]:
                    f2.write(f"\t{v:g}")
                if r["map_sample"] is not None:
                    for v in r["map_sample"]:
                        f2.write(f"\t{v:g}")
                f2.write("\n")
            f1.write("\n")
    return fn1, fn2


def bcmopt(opts) -> int:
    from bcm3_tpu_torch.io.output import load_results
    from bcm3_tpu_torch.likelihoods import create_likelihood
    from bcm3_tpu_torch.model.prior import Prior
    from bcm3_tpu_torch.model.variables import VariableSet

    output_path = opts["output.folder"]
    _setup_logging(output_path)
    log = logging.getLogger("bcmopt")

    varset = VariableSet.from_xml(opts["prior"])
    prior = Prior.from_xml(opts["prior"], varset)
    stored = load_results(os.path.join(output_path, opts["bcmopt.input"]))
    # the likelihood over the full stored variable layout
    full_varset = VariableSet(
        names=list(stored["variables"]),
        transforms=[int(t) for t in stored["variable_transform"]],
    )
    full_likelihood = create_likelihood(opts["likelihood"], full_varset)
    result = bcmopt_core(opts, prior, full_likelihood, stored)
    fn1, fn2 = write_bcmopt_tables(output_path, result)
    log.info("Wrote %s and %s", fn1, fn2)
    return 0


def main(argv=None) -> int:
    from bcm3_tpu_torch.io.config import build_arg_parser, options_from_args

    args = build_arg_parser().parse_args(argv)
    opts = options_from_args(args)
    if args.predict:
        return predict(opts)
    if args.bcmopt:
        return bcmopt(opts)
    return run(opts)


if __name__ == "__main__":
    sys.exit(main())
