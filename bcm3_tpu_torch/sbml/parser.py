"""SBML document parser (XML + MathML subset + CellDesigner annotations).

A copy of bcm3_tpu/sbml/parser.py (plain Python), the port's replacement
for the reference's libsbml-backed document layer (reference:
src/sbml/SBMLModel.cpp LoadSBML:47-130, SBMLSpecies.cpp, SBMLReaction.cpp,
SBMLAssignmentRule.cpp). libsbml is only used by the reference to read the
XML and hand over MathML ASTs; this module does both with ElementTree and
a small tuple-based AST, which bcm3_tpu_torch.sbml.ratelaws compiles to
torch functions over lanes.

Supported structure: species (with CellDesigner class annotations
including Sink/Gene/RNA/Protein with modification residues, used for
the reference's full-name convention, SBMLSpecies.cpp GetFullName:95-131),
reactions with kinetic laws, global parameters, assignment rules,
initial assignments and function definitions.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MATHML_NS = "http://www.w3.org/1998/Math/MathML"
CELLDESIGNER_NS_HINT = "celldesigner"

# AST node forms (plain tuples so they are hashable and easily walked):
#   ("const", float)
#   ("name", str)
#   ("call", fname, (arg_asts...))
#   ("+", (children...)) / ("*", (children...))
#   ("-", (a, b)) / ("neg", (a,)) / ("/", (a, b)) / ("pow", (a, b))
#   ("exp"|"ln"|"log10"|"sqrt", (a,))


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_mathml(node: ET.Element):
    """MathML element -> AST (reference: libsbml readMathML + the AST
    subset handled in SBMLRatelaws.cpp Generate:86-347)."""
    tag = _local(node.tag)
    if tag == "math":
        children = [c for c in node if not _local(c.tag).startswith("annotation")]
        if len(children) != 1:
            raise ValueError("math element must have exactly one child")
        return parse_mathml(children[0])
    if tag == "ci":
        return ("name", (node.text or "").strip())
    if tag == "cn":
        text = (node.text or "").strip()
        sep = node.find(f"{{{MATHML_NS}}}sep")
        if sep is not None:
            # e-notation: mantissa <sep/> exponent
            mant = text
            expo = (sep.tail or "0").strip()
            return ("const", float(mant) * 10.0 ** float(expo))
        ntype = node.get("type", "real")
        if ntype == "rational":
            raise ValueError("rational cn not supported")
        return ("const", float(text))
    if tag == "csymbol":
        sym = (node.text or "").strip()
        if "time" in (node.get("definitionURL") or "") or sym in ("time", "t"):
            return ("name", "__time__")
        raise ValueError(f"Unsupported csymbol '{sym}'")
    if tag == "pi":
        return ("const", 3.141592653589793)
    if tag == "exponentiale":
        return ("const", 2.718281828459045)
    if tag != "apply":
        raise ValueError(f"Unsupported MathML element <{tag}>")

    children = list(node)
    op = _local(children[0].tag)
    args = tuple(parse_mathml(c) for c in children[1:])
    if op == "plus":
        if len(args) == 0:
            return ("const", 0.0)
        return ("+", args) if len(args) > 1 else args[0]
    if op == "times":
        if len(args) == 0:
            return ("const", 1.0)
        return ("*", args) if len(args) > 1 else args[0]
    if op == "minus":
        if len(args) == 1:
            return ("neg", args)
        if len(args) == 2:
            return ("-", args)
        raise ValueError("minus with more than 2 children")
    if op == "divide":
        if len(args) != 2:
            raise ValueError("divide must have 2 children")
        return ("/", args)
    if op == "power":
        return ("pow", args)
    if op == "exp":
        return ("exp", args)
    if op == "ln":
        return ("ln", args)
    if op == "log":
        # optional logbase child was consumed as args[0] if present
        if len(children) > 1 and _local(children[1].tag) == "logbase":
            base = parse_mathml(list(children[1])[0])
            val = parse_mathml(children[2])
            return ("/", (("ln", (val,)), ("ln", (base,))))
        return ("log10", args)
    if op == "root":
        if len(children) > 1 and _local(children[1].tag) == "degree":
            degree = parse_mathml(list(children[1])[0])
            val = parse_mathml(children[2])
            return ("pow", (val, ("/", (("const", 1.0), degree))))
        return ("sqrt", args)
    if op == "ci":
        # function application: first child names the function
        fname = (children[0].text or "").strip()
        return ("call", fname, args)
    raise ValueError(f"Unsupported MathML operator <{op}>")


@dataclass
class SBMLSpeciesDef:
    """One species (reference: src/sbml/SBMLSpecies.{h,cpp})."""

    id: str
    name: str
    initial_value: float
    sbml_type: str = "Unknown"  # Gene/Transcript/Protein/Complex/Drug/...
    residues: Dict[str, str] = field(default_factory=dict)  # id -> residue name
    residue_modifications: Dict[str, str] = field(default_factory=dict)

    @property
    def full_name(self) -> str:
        """reference: SBMLSpecies.cpp GetFullName:95-131."""
        t = self.sbml_type
        if t == "Gene":
            return self.name + "_gene"
        if t == "Transcript":
            return self.name + "_mrna"
        if t == "Protein":
            full = self.name + "_protein"
            for rid in self.residues:
                state = self.residue_modifications.get(rid)
                full += "_" + self.residues[rid] + "_" + (state or "empty")
            return full
        if t == "Sink":
            return "sink"
        return self.name


@dataclass
class SBMLReactionDef:
    """One reaction (reference: src/sbml/SBMLReaction.{h,cpp})."""

    id: str
    reactants: List[Tuple[str, float]]  # (species id, stoichiometry)
    products: List[Tuple[str, float]]
    rate_ast: Optional[tuple]  # None -> rate 0


@dataclass
class SBMLRuleDef:
    target: str  # species or parameter id
    ast: tuple


@dataclass
class SBMLFunctionDef:
    id: str
    arg_names: List[str]
    body: tuple


@dataclass
class SBMLDocument:
    species: Dict[str, SBMLSpeciesDef]
    species_order: List[str]
    reactions: Dict[str, SBMLReactionDef]
    reaction_order: List[str]
    parameters: Dict[str, float]  # global SBML parameter values
    assignment_rules: List[SBMLRuleDef]
    initial_assignments: Dict[str, tuple]
    functions: Dict[str, SBMLFunctionDef]


def _findall(node: ET.Element, name: str) -> List[ET.Element]:
    return [c for c in node.iter() if _local(c.tag) == name]


def _children_named(node: ET.Element, name: str) -> List[ET.Element]:
    return [c for c in node if _local(c.tag) == name]


def _first(node: Optional[ET.Element], name: str) -> Optional[ET.Element]:
    if node is None:
        return None
    for c in node:
        if _local(c.tag) == name:
            return c
    return None


_CLASS_MAP = {
    "GENE": "Gene",
    "RNA": "Transcript",
    "PROTEIN": "Protein",
    "COMPLEX": "Complex",
    "DEGRADED": "Sink",
    "DRUG": "Drug",
    "PHENOTYPE": "Phenotype",
    "UNKNOWN": "Unknown",
}


def _parse_celldesigner_species(
    sp_el: ET.Element, sp: SBMLSpeciesDef, protein_residues: Dict[str, Dict[str, str]]
):
    """CellDesigner class + modification annotations
    (reference: SBMLSpecies.cpp Initialize:14-93)."""
    annotation = _first(sp_el, "annotation")
    if annotation is None:
        return
    for ext in annotation.iter():
        if _local(ext.tag) != "speciesIdentity":
            continue
        cls = _first(ext, "class")
        if cls is not None and cls.text:
            cname = cls.text.strip()
            if cname not in _CLASS_MAP:
                raise ValueError(
                    f"Unrecognized species type {cname} for species {sp.id}"
                )
            sp.sbml_type = _CLASS_MAP[cname]
            if sp.sbml_type == "Transcript":
                sp.name += "_mRNA"
        if sp.sbml_type == "Protein":
            pref = _first(ext, "proteinReference")
            if pref is not None and pref.text:
                sp.residues = dict(protein_residues.get(pref.text.strip(), {}))
            state = _first(ext, "state")
            mods = _first(state, "listOfModifications") if state is not None else None
            if mods is not None:
                for mod in mods:
                    sp.residue_modifications[mod.get("residue")] = mod.get("state")


def _parse_protein_list(model_el: ET.Element) -> Dict[str, Dict[str, str]]:
    """Model-level CellDesigner protein modification-residue lists
    (reference: SBMLSpecies.cpp:63-78)."""
    out: Dict[str, Dict[str, str]] = {}
    for plist in model_el.iter():
        if _local(plist.tag) != "listOfProteins":
            continue
        for protein in plist:
            pid = protein.get("id")
            residues: Dict[str, str] = {}
            for rlist in protein:
                if _local(rlist.tag) == "listOfModificationResidues":
                    for res in rlist:
                        residues[res.get("id")] = res.get("name")
            if pid:
                out[pid] = residues
    return out


def parse_sbml_string(text: str) -> SBMLDocument:
    root = ET.fromstring(text)
    model_el = _first(root, "model")
    if model_el is None:
        raise ValueError("SBML document has no model element")

    protein_residues = _parse_protein_list(model_el)

    species: Dict[str, SBMLSpeciesDef] = {}
    species_order: List[str] = []
    los = _first(model_el, "listOfSpecies")
    for sp_el in los if los is not None else []:
        amt = sp_el.get("initialAmount")
        conc = sp_el.get("initialConcentration")
        init = float(amt if amt is not None else (conc if conc is not None else "nan"))
        sp = SBMLSpeciesDef(
            id=sp_el.get("id"),
            name=sp_el.get("name", sp_el.get("id")),
            initial_value=init,
        )
        _parse_celldesigner_species(sp_el, sp, protein_residues)
        if sp.id in species:
            raise ValueError(f"Duplicate species id {sp.id}")
        species[sp.id] = sp
        species_order.append(sp.id)

    parameters: Dict[str, float] = {}
    lop = _first(model_el, "listOfParameters")
    for p_el in lop if lop is not None else []:
        v = p_el.get("value")
        parameters[p_el.get("id")] = float(v) if v is not None else float("nan")

    functions: Dict[str, SBMLFunctionDef] = {}
    lof = _first(model_el, "listOfFunctionDefinitions")
    for f_el in lof if lof is not None else []:
        math = _first(f_el, "math")
        lam = _first(math, "lambda") if math is not None else None
        if lam is None:
            continue
        args = []
        body = None
        for c in lam:
            if _local(c.tag) == "bvar":
                args.append((list(c)[0].text or "").strip())
            else:
                body = parse_mathml(c)
        functions[f_el.get("id")] = SBMLFunctionDef(
            id=f_el.get("id"), arg_names=args, body=body
        )

    reactions: Dict[str, SBMLReactionDef] = {}
    reaction_order: List[str] = []
    lor = _first(model_el, "listOfReactions")
    for r_el in lor if lor is not None else []:
        rid = r_el.get("id")

        def refs(list_name):
            lst = _first(r_el, list_name)
            out = []
            for ref in lst if lst is not None else []:
                if _local(ref.tag) != "speciesReference":
                    continue
                out.append(
                    (ref.get("species"), float(ref.get("stoichiometry", "1")))
                )
            return out

        kl = _first(r_el, "kineticLaw")
        math = _first(kl, "math") if kl is not None else None
        ast = parse_mathml(math) if math is not None else None
        if rid in reactions:
            raise ValueError(f"Duplicate reaction id {rid}")
        reactions[rid] = SBMLReactionDef(
            id=rid,
            reactants=refs("listOfReactants"),
            products=refs("listOfProducts"),
            rate_ast=ast,
        )
        reaction_order.append(rid)

    assignment_rules: List[SBMLRuleDef] = []
    lorl = _first(model_el, "listOfRules")
    for rule_el in lorl if lorl is not None else []:
        if _local(rule_el.tag) != "assignmentRule":
            continue
        math = _first(rule_el, "math")
        assignment_rules.append(
            SBMLRuleDef(target=rule_el.get("variable"), ast=parse_mathml(math))
        )

    initial_assignments: Dict[str, tuple] = {}
    loia = _first(model_el, "listOfInitialAssignments")
    for ia_el in loia if loia is not None else []:
        math = _first(ia_el, "math")
        initial_assignments[ia_el.get("symbol")] = parse_mathml(math)

    return SBMLDocument(
        species=species,
        species_order=species_order,
        reactions=reactions,
        reaction_order=reaction_order,
        parameters=parameters,
        assignment_rules=assignment_rules,
        initial_assignments=initial_assignments,
        functions=functions,
    )


def parse_sbml_file(filename: str) -> SBMLDocument:
    with open(filename) as f:
        return parse_sbml_string(f.read())
