"""Cell-population likelihoods (counterpart of bcm3_tpu/cellpop): the
`cell_population` type (`likelihood`, `experiment`) over the population
simulator (`simulate`), its variability and treatments, and the data
likelihoods with the host Hungarian matching (`data_likelihood`), which
`mitosis_time_estimation` uses too.
"""
