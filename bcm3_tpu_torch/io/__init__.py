from bcm3_tpu_torch.io.output import NC_FILL_DOUBLE, SampleHandlerHDF5, load_results

__all__ = ["NC_FILL_DOUBLE", "SampleHandlerHDF5", "load_results"]
