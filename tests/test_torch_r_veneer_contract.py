"""Static contract test for the port's R veneer (R/bcm3tpu_torch.r).

No R runtime exists here, so the reticulate veneer cannot run; it adds no
logic (every body is `mod$<name>(...)` calls into
`bcm3_tpu_torch.rbridge`), so what can break silently is the call
contract. Checked, with tests/test_r_veneer_contract.py's parser:

  1. every `mod$<name>(...)` exists in `bcm3_tpu_torch.rbridge` and
     accepts the call site's argument count;
  2. the port's veneer and R/bcm3tpu.r (the JAX package's, unchanged)
     define the same `bcm3.*` functions with the same formals;
  3. the port's veneer imports the port's bridge and takes the device from
     `getOption("bcm3tpu.device", "cuda")`, and its string literals are
     safe for the parser.
"""

import inspect
import re
from pathlib import Path

import pytest

from test_r_veneer_contract import _mod_calls, _r_string_literals, _strip_r_comments

R_DIR = Path(__file__).resolve().parent.parent / "R"
VENEER = R_DIR / "bcm3tpu_torch.r"
JAX_VENEER = R_DIR / "bcm3tpu.r"


def _functions(path):
    """{bcm3.* name: its formals, whitespace removed}."""
    text = _strip_r_comments(path.read_text())
    return {m.group(1): re.sub(r"\s+", "", m.group(2))
            for m in re.finditer(r"(bcm3(?:\.\w+)+)\s*<-\s*function\s*\(([^)]*)\)", text)}


def test_every_veneer_call_resolves_with_valid_arity():
    import bcm3_tpu_torch.rbridge as rbridge

    calls = list(_mod_calls(_strip_r_comments(VENEER.read_text())))
    assert len(calls) >= 30, "too few mod$ calls found: parser or veneer broken"
    problems = []
    for name, n_args in calls:
        fn = getattr(rbridge, name, None)
        if fn is None or not callable(fn):
            problems.append(f"{name}: not a callable in bcm3_tpu_torch.rbridge")
            continue
        try:
            inspect.signature(fn).bind(*range(n_args))
        except TypeError as e:
            problems.append(f"{name}({n_args} args): {e}")
    assert not problems, "\n".join(problems)


def test_same_functions_and_formals_as_the_jax_veneer():
    port, jax = _functions(VENEER), _functions(JAX_VENEER)
    assert len(port) >= 30
    assert port == jax


@pytest.mark.parametrize("path", [VENEER, JAX_VENEER], ids=["port", "jax"])
def test_bridge_module_and_device(path):
    text = _strip_r_comments(path.read_text())
    if path == VENEER:
        assert 'reticulate::import("bcm3_tpu_torch.rbridge"' in text
        assert "bcm3_tpu.rbridge" not in text
        assert text.count("mod$init(") == 2
        assert text.count('device = getOption("bcm3tpu.device", "cuda")') == 2
    else:
        # the JAX package's veneer stays on the JAX bridge
        assert 'reticulate::import("bcm3_tpu.rbridge"' in text
    unsafe = [s for s in _r_string_literals(path.read_text()) if any(ch in s for ch in "#,()")]
    assert not unsafe, unsafe


def test_every_function_calls_the_module():
    text = _strip_r_comments(VENEER.read_text())
    bodies = re.split(r"(?=bcm3(?:\.\w+)+\s*<-\s*function)", text)
    for body in bodies[1:]:
        assert "mod$" in body, f"veneer function without a module call: {body.splitlines()[0]}"
