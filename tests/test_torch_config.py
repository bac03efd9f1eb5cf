"""The port's option parsing against the JAX package's (io/config.py).

- One config.txt and one command line through both packages'
  build_arg_parser / options_from_args give equal option maps; the port's
  has `device` and `dtype` in addition, and nothing else.
- pt_config_from_options gives equal PTConfig fields, field by field
  (emit_dtype by name: a JAX dtype there, a torch dtype here).
- A bad emit_dtype raises the same ValueError in both.
- A run with emit_dtype bfloat16 emits the bfloat16-rounded values.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bcm3_tpu.io import config as jconfig
from bcm3_tpu_torch.io import config as pconfig

CONFIG = """[sampler]
num_samples=60
use_every_nth=3
rngseed=77

[ptmhsampler]
num_chains=5
num_ensembles=16
blocking_strategy=Turek
proposal_type=clustered_covariance
adapt_proposal_samples=20
adapt_proposal_times=1
swapping_scheme=stochastic_random
exchange_probability=0.4  # inline comment
output_proposal_adaptation=true
output_sample_clustering=yes
emit_fixed_only=true
emit_dtype=float32
checkpoint_file=state.ckpt

[predict]
skip_n=2

[output]
folder=out_dir
"""

ARGV = [
    "--sampler.num_samples", "90", "--ptmhsampler.proposal_type", "global_covariance",
    "-e", "0.5", "--predict.output", "p.nc", "--bcmopt.num_samples", "3",
]


def _maps(tmp_path, port_argv=()):
    """Both packages' maps of CONFIG and ARGV; `port_argv` adds the port's
    own options to the port's command line."""
    cfg = tmp_path / "config.txt"
    cfg.write_text(CONFIG)
    argv = ["-c", str(cfg), *ARGV]
    jmap = jconfig.options_from_args(jconfig.build_arg_parser().parse_args(argv))
    pmap = pconfig.options_from_args(pconfig.build_arg_parser().parse_args([*argv, *port_argv]))
    return jmap, pmap


def test_option_maps_equal(tmp_path):
    jmap, pmap = _maps(tmp_path)
    assert set(pmap) - set(jmap) == {"device", "dtype"}
    assert {k: v for k, v in pmap.items() if k not in ("device", "dtype")} == jmap
    assert (pmap["device"], pmap["dtype"]) == ("cuda", "float32")
    assert jmap["ptmhsampler.exchange_probability"] == "0.4"
    assert jmap["sampler.num_samples"] == "90" and jmap["learning_rate"] == "0.5"


def test_pt_config_fields_equal(tmp_path):
    jmap, pmap = _maps(tmp_path, ["--device", "cpu", "--dtype", "float64"])
    jcfg = jconfig.pt_config_from_options(jmap)
    pcfg = pconfig.pt_config_from_options(pmap)
    common = {f.name for f in dataclasses.fields(jcfg)} & {f.name for f in dataclasses.fields(pcfg)}
    common -= {"dtype", "emit_dtype"}
    # the 27 fields the table sets besides emit_dtype, and gmm_fit_backend,
    # shard_over_devices, mesh_devices, emit_chunk_size and profile_dir,
    # which it leaves at their defaults
    assert len(common) == 32
    for name in sorted(common):
        assert getattr(pcfg, name) == getattr(jcfg, name), name
    assert str(jcfg.emit_dtype) == "float32" and pcfg.emit_dtype == torch.float32
    assert (pcfg.device, pcfg.dtype) == ("cpu", torch.float64)
    # the default device is the card's
    assert pconfig.pt_config_from_options(_maps(tmp_path)[1]).device == "cuda"


@pytest.mark.parametrize("bad", ["int8", "float", "bfloat"])
def test_bad_emit_dtype_raises_in_both(tmp_path, bad):
    jmap, pmap = _maps(tmp_path)
    messages = []
    for mod, opts in ((jconfig, jmap), (pconfig, pmap)):
        with pytest.raises(ValueError, match="emit_dtype must be one of") as err:
            mod.pt_config_from_options(dict(opts, **{"ptmhsampler.emit_dtype": bad}))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_bfloat16_emission(tmp_path):
    """emit_dtype bfloat16 through the factory: the emitted rows are the
    state's values rounded to bfloat16 (numpy carries them as float32)."""
    from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import (
        synthesize_trial,
        write_poppk_likelihood_xml,
        write_poppk_prior_xml,
    )
    from bcm3_tpu_torch.sampler import create_sampler

    trial, _ = synthesize_trial(num_patients=2, num_timepoints=6, seed=5)
    trial.save(str(tmp_path / "pk.nc"), "TRIAL1", "lapatinib")
    write_poppk_prior_xml(str(tmp_path / "prior.xml"), 2, "one")
    write_poppk_likelihood_xml(
        str(tmp_path / "lik.xml"), str(tmp_path / "pk.nc"), "TRIAL1", "lapatinib", "one"
    )
    vs = VariableSet.from_xml(str(tmp_path / "prior.xml"))
    opts = {
        "sampler.num_samples": "3", "ptmhsampler.num_chains": "2",
        "ptmhsampler.adapt_proposal_samples": "0", "ptmhsampler.emit_dtype": "bfloat16",
        "sampler.rngseed": "3", "device": "cpu", "dtype": "float64",
    }
    s = create_sampler(Prior.from_xml(str(tmp_path / "prior.xml"), vs),
                       create_likelihood(str(tmp_path / "lik.xml"), vs), opts)
    res = s.run()
    assert res["samples"].dtype == np.float32
    last = s.state.x.reshape(-1, 2, vs.num_variables)[:, -1]
    np.testing.assert_array_equal(res["samples"][-1:, -1], last.to(torch.bfloat16).float().numpy())
