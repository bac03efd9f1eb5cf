from bcm3_tpu_torch.io.bundler import HDF5Bundler, write_adaptation_dump
from bcm3_tpu_torch.io.config import (
    build_arg_parser,
    load_options,
    options_from_args,
    pt_config_from_options,
)
from bcm3_tpu_torch.io.output import NC_FILL_DOUBLE, SampleHandlerHDF5, load_results

__all__ = [
    "NC_FILL_DOUBLE",
    "SampleHandlerHDF5",
    "load_results",
    "HDF5Bundler",
    "write_adaptation_dump",
    "build_arg_parser",
    "load_options",
    "options_from_args",
    "pt_config_from_options",
]
