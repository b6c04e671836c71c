"""The port's two dispatch tables, on the CPU.

* ops/kernels/build.py's ENTRY_POINTS against the `extern "C"` functions
  of csrc/*.cu, parsed from the sources: every function is listed, with
  its library, and with one parameter code per C parameter of the matching
  type (a pointer p, the stream s, int i, unsigned int I, long long q,
  float f).  ctypes passes whatever the table says, so a table that
  disagrees with a signature would pass wrong arguments without an error.
* models/unet.py's UNET_CONV against args.py's --unet_conv: the table's
  names are the flag's choices, and each runs one of the port's four conv
  forms.
"""
import argparse
import os
import re

import pytest

from v2e_tpu_torch.args import v2e_args
from v2e_tpu_torch.models import unet
from v2e_tpu_torch.ops.kernels import build

SIGNATURE = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def c_entry_points():
    """{name: (library, [C parameter declarations])} of csrc/*.cu."""
    out = {}
    for f in sorted(os.listdir(build.CSRC)):
        if f.endswith(".cu"):
            with open(os.path.join(build.CSRC, f)) as src:
                for name, params in SIGNATURE.findall(src.read()):
                    decls = [" ".join(p.split()) for p in params.split(",") if p.strip()]
                    out[name] = (f[:-3], decls)
    return out


C_ENTRY_POINTS = c_entry_points()


def code(decl: str) -> str:
    """The table's code for one C parameter declaration."""
    if "*" in decl:
        return "s" if decl.endswith(" stream") else "p"
    ctype = decl.rsplit(" ", 1)[0]
    return {"int": "i", "unsigned int": "I", "long long": "q", "float": "f"}[ctype]


def test_the_sources_have_the_thirteen_entry_points():
    assert set(C_ENTRY_POINTS) == set(build.ENTRY_POINTS)
    assert len(C_ENTRY_POINTS) == 14


@pytest.mark.parametrize("name", sorted(C_ENTRY_POINTS))
def test_entry_point_table_matches_the_signature(name):
    library, decls = C_ENTRY_POINTS[name]
    table_library, codes = build.ENTRY_POINTS[name]
    assert table_library == library
    assert len(build.parameters(codes)) == len(decls)
    assert build.parameters(codes) == [code(d) for d in decls]


def test_unet_conv_names_are_the_flags_choices():
    parser = v2e_args(argparse.ArgumentParser())
    action = next(a for a in parser._actions if a.dest == "unet_conv")
    assert list(unet.UNET_CONV) == list(action.choices)
    assert action.default in unet.UNET_CONV
    four = {"dense": unet.DENSE, "packedz": unet.PACKEDZ, "fold": unet.FOLD,
            "fold45": unet.FOLD45}
    assert len(set(four.values())) == 4
    for name in unet.UNET_CONV:
        assert unet.unet_form(name) in four.values(), name
    for name, form in four.items():
        assert unet.unet_form(name) is form
    assert unet.FOLD45.fold == {4, 5} and unet.FOLD.fold == {1, 2, 3, 4, 5}
    assert {n for n in unet.UNET_CONV if unet.unet_form(n) == unet.DENSE} == {
        "auto", "dense", "packed", "packedup", "blocked"}
    with pytest.raises(ValueError):
        unet.unet_form("packedfold3")
