"""The ctypes signatures in nfdpm_tpu_torch/ops/kernels/_build.py against the
C interfaces of the CUDA sources they load.

ctypes passes an argument as the type `_SIGNATURES` gives it: a pointer
declared as a C int is cut to 32 bits, and a `long long` passed as an int
loses its high half, silently. So every `extern "C"` function of every
csrc/*.cu is parsed here (no nvcc needed) and held against its entry:
the same names, the same number of arguments, each a pointer, an `int` or
a `long long` as in C, and the same return type. The same sources' kernel
names must fall into their groups of the device-time breakdown
(nfdpm_tpu_torch/profiling.py), which matches them by name.
"""

import ctypes
import re

import pytest

from nfdpm_tpu_torch import profiling
from nfdpm_tpu_torch.ops.kernels import _build

# A definition at the start of a line inside the extern "C" block:
# return type, name, the argument list (may span lines), then "{".
_DEFINITION = re.compile(r"^(int|long long|void)\s+(\w+)\s*\(([^)]*)\)\s*\{",
                         re.MULTILINE)


def _c_type(decl: str):
    """The ctypes type that carries one C parameter declaration."""
    decl = " ".join(decl.split())
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.replace("const ", "").split()[:-1]  # drop the parameter name
    kind = " ".join(words)
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong}[kind]


def extern_c_functions(source: str) -> dict:
    """{name: ([argument ctypes], return ctypes)} of the functions defined
    in the source's extern "C" block."""
    start = source.index('extern "C" {')
    block = source[start:]
    out = {}
    for ret, name, args in _DEFINITION.findall(block):
        argtypes = [_c_type(a) for a in args.split(",") if a.strip() and a.strip() != "void"]
        restype = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "void": None}[ret]
        out[name] = (argtypes, restype)
    return out


def test_parser_reads_pointers_ints_and_long_longs():
    src = ('extern "C" {\nlong long f(const float* a, int b,\n         long long c, void* s) '
           '{ return 0; }\nint g() { return 0; }\n}')
    assert extern_c_functions(src) == {
        "f": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
              ctypes.c_longlong),
        "g": ([], ctypes.c_int)}


def test_every_source_has_a_signature_table():
    assert set(_build.SOURCES) == set(_build._SIGNATURES)


@pytest.mark.parametrize("library", sorted(_build.SOURCES))
def test_signatures_match_the_c_interface(library):
    declared = extern_c_functions(_build.source(library).read_text())
    table = _build._SIGNATURES[library]
    assert sorted(table) == sorted(declared), (
        f"{library}: _SIGNATURES names {sorted(table)}, the source defines {sorted(declared)}")
    for name, (argtypes, restype) in table.items():
        c_args, c_ret = declared[name]
        assert len(argtypes) == len(c_args), f"{name}: {len(argtypes)} args, C has {len(c_args)}"
        for i, (got, want) in enumerate(zip(argtypes, c_args)):
            assert got is want, f"{name} argument {i}: {got.__name__} for C's {want.__name__}"
        assert restype is c_ret, f"{name} returns {c_ret}, _SIGNATURES says {restype}"


# A kernel's definition: __global__ void [__launch_bounds__(...)] name(
_KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
# kernel-name prefix -> its group in profiling.GROUPS
KERNEL_GROUPS = {"channel_mix_": "channel_mix + coupling tails",
                 "coupling_tail_": "channel_mix + coupling tails",
                 "fla_bwd_": "fused_linear_attention backward",
                 "fla_": "fused_linear_attention"}


@pytest.mark.parametrize("library", ["flow_kernels", "attention_kernels"])
def test_kernel_names_fall_into_their_profiling_group(library):
    names = _KERNEL.findall(_build.source(library).read_text())
    assert names, f"no __global__ kernel found in {library}"
    for name in names:
        want = next(g for prefix, g in KERNEL_GROUPS.items() if name.startswith(prefix))
        assert profiling.group_of(name) == want, (name, profiling.group_of(name))
