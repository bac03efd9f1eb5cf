from bcm3_tpu_torch.sbml.model import SBMLModel
from bcm3_tpu_torch.sbml.parser import parse_sbml_file, parse_sbml_string

__all__ = ["SBMLModel", "parse_sbml_file", "parse_sbml_string"]
