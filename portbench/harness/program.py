"""The program's model, built as a user of bcm3_tpu_torch builds it, over
the inputs the benchmark made.

The prior is read from the prior.xml the configuration describes; the
likelihood is the program's PopPK likelihood over the trial arrays the
reference generator made, wrapped in the benchmark's `Boundary` and
handed to the sampler as a `Likelihood`.
"""

from __future__ import annotations

import os

from portbench.harness.boundary import Boundary
from portbench.reference import prior as ref_prior


def build(ctx):
    """(program Prior, Likelihood around ctx.boundary). Sets ctx.boundary."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood, PopPKTrial

    cfg = ctx.config
    path = os.path.join(ctx.tmpdir, f"prior_{cfg['name']}.xml")
    ref_prior.write_xml(cfg, path)
    varset = VariableSet.from_xml(path)
    prior = Prior.from_xml(path, varset)
    trial = PopPKTrial(**ctx.trial)
    model = PopPKLikelihood(varset, trial, cfg["pk_type"], cfg["drug"],
                            solver_trips=cfg["solver_trips"])
    ctx.boundary = Boundary(model)
    return prior, Likelihood("pop_pk_trajectory", ctx.boundary, model=model)
