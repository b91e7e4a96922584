"""The ctypes signatures of the port's CUDA libraries against their C
prototypes.

``ops/_build._SIGNATURES`` declares the argument types of every exported
function of ``vlgp_tpu_torch/csrc/<name>.cu``.  ctypes trusts them: a
pointer declared as an int is cut to 32 bits without a word.  This test
reads each ``extern "C"`` function from the sources (no compiler needed)
and holds its parameters against the declaration in count and kind.
"""
import ctypes
import re

import pytest

from vlgp_tpu_torch.ops import _build

_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float",
         ctypes.c_double: "double"}


def _kind(param: str) -> str:
    param = param.strip()
    if "*" in param:
        return "pointer"
    base = param.split()[-2] if len(param.split()) > 1 else param
    return {"int": "int", "float": "float", "double": "double"}[base]


def _extern_c_functions(text: str) -> dict:
    """{name: (result kind, [parameter kinds])} of every function defined
    in an ``extern "C" { ... }`` block or after ``extern "C"`` on its line."""
    text = re.sub(r"//[^\n]*", "", text)
    bodies = []
    for m in re.finditer(r'extern "C"\s*\{', text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        bodies.append(text[m.end():i - 1])
    bodies += re.findall(r'extern "C"\s+([^{;]+\([^)]*\)\s*\{)', text)
    funcs = {}
    for body in bodies:
        for m in re.finditer(r"(?m)^\s*(?:extern \"C\"\s+)?([\w ]+?\**)\s*\b(\w+)\(([^)]*)\)\s*\{",
                             body):
            result, name, params = m.groups()
            params = [p for p in params.split(",") if p.strip()]
            funcs[name] = (_kind(result + " x"), [_kind(p) for p in params])
    return funcs


@pytest.mark.parametrize("name", _build.SOURCES)
def test_signatures_match_the_c_prototypes(name):
    funcs = _extern_c_functions((_build.CSRC / f"{name}.cu").read_text())
    declared = _build._SIGNATURES[name]
    assert set(funcs) == set(declared), (sorted(funcs), sorted(declared))
    for fn, (argtypes, restype) in declared.items():
        result, params = funcs[fn]
        assert [_KIND[t] for t in argtypes] == params, fn
        assert _KIND[restype] == result, fn


def test_error_string_signature_matches_the_header():
    """ns_error_string (ns_common.cuh, in every library) takes the int that
    an entry point returned; load_library declares it so."""
    funcs = _extern_c_functions((_build.CSRC / "ns_common.cuh").read_text())
    assert funcs == {"ns_error_string": ("pointer", ["int"])}


def test_parser_sees_a_drifted_signature():
    """A pointer parameter added to a prototype changes what the parser
    reads, so the comparison above would fail on it."""
    src = 'extern "C" {\nint f(const float* a, int n, void* stream) {\n  return 0;\n}\n}\n'
    assert _extern_c_functions(src) == {"f": ("int", ["pointer", "int", "pointer"])}
    drifted = src.replace("int n,", "float* r0, int n,")
    assert _extern_c_functions(drifted)["f"][1] == ["pointer", "pointer", "int", "pointer"]
