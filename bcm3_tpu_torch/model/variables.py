"""Variable sets loaded from the reference `prior.xml` schema.

TPU-native equivalent of the reference VariableSet
(reference: src/sampler/VariableSet.cpp:16-95). Supports the
``<prior>``/``<variableset>`` root elements, the ``repeat`` attribute
(expanding to ``name_0 .. name_{k-1}``) and the output transforms
selected by ``logspace``/``logistic`` attributes.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List

import numpy as np

# Transform codes, matching the reference enum so the integers written to
# the output file are interchangeable (reference: src/sampler/VariableSet.h:8-13)
TRANSFORM_NONE = 0
TRANSFORM_LOG = 1
TRANSFORM_LOG10 = 2
TRANSFORM_LOGIT = 3


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


@dataclass
class VariableSet:
    names: List[str] = field(default_factory=list)
    transforms: List[int] = field(default_factory=list)

    @property
    def num_variables(self) -> int:
        return len(self.names)

    def add_variable(self, name: str, logspace: bool = False, logistic: bool = False):
        self.names.append(name)
        if logspace:
            self.transforms.append(TRANSFORM_LOG10)
        elif logistic:
            self.transforms.append(TRANSFORM_LOGIT)
        else:
            self.transforms.append(TRANSFORM_NONE)

    def index_of(self, name: str) -> int:
        return self.names.index(name)

    def transform_values(self, x: np.ndarray) -> np.ndarray:
        """Apply per-variable output transforms along the last axis."""
        x = np.asarray(x)
        out = np.array(x, dtype=np.float64)
        t = np.asarray(self.transforms)
        out[..., t == TRANSFORM_LOG] = np.exp(x[..., t == TRANSFORM_LOG])
        out[..., t == TRANSFORM_LOG10] = np.power(10.0, x[..., t == TRANSFORM_LOG10])
        sel = t == TRANSFORM_LOGIT
        out[..., sel] = 1.0 / (1.0 + np.exp(-x[..., sel]))
        return out

    @classmethod
    def from_xml(cls, filename: str) -> "VariableSet":
        tree = ET.parse(filename)
        root = tree.getroot()
        if root.tag not in ("prior", "variableset"):
            raise ValueError(
                f"Incorrect prior XML format: root element '{root.tag}' "
                "(expected 'prior' or 'variableset')"
            )
        vs = cls()
        for var in root.findall("variable"):
            name = var.get("name")
            if name is None:
                raise ValueError("variable element without name attribute")
            repeat = int(var.get("repeat", "1"))
            logspace = _parse_bool(var.get("logspace", "false"))
            logistic = _parse_bool(var.get("logistic", "false"))
            if repeat > 1:
                for i in range(repeat):
                    vs.add_variable(f"{name}_{i}", logspace, logistic)
            else:
                vs.add_variable(name, logspace, logistic)
        return vs
