"""Cell-population likelihoods (counterpart of bcm3_tpu/cellpop).

Ported so far: the host Hungarian matching of `data_likelihood`, which
`mitosis_time_estimation` uses; the `cell_population` type itself is
ROADMAP A11.
"""
