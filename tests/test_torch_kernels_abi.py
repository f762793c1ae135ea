"""The port's CUDA boundary (`pf3plat_tpu_torch/kernels.py`) on the CPU.

Each library's `extern "C"` exports, read from its source, map onto ctypes;
every launch ends in `void* stream`; every export the wrappers name exists
and each literal launch or query passes as many arguments as its C
declaration takes. `launch` and `call` against a stub library handle:
tensors go as data pointers, the stream is appended, a wrong argument
count or a CUDA error raises, only launches count."""

from __future__ import annotations

import ast
import ctypes
from pathlib import Path

import pytest
import torch

from pf3plat_tpu_torch import kernels
from pf3plat_tpu_torch.ops.rasterizer import streamed

REPO = Path(__file__).resolve().parents[1]
QUERIES = ("_smem", "_occupancy")
# the exports each library's wrappers name, launches and queries
WRAPPED = {
    "adam": ("pf3_adam_norm", "pf3_adam_update"),
    "attention_bwd": ("pf3_attention_bwd", "pf3_attention_bwd_occupancy"),
    "attention_fwd": ("pf3_attention_fwd", "pf3_attention_fwd_occupancy"),
    "compact_pairs": ("pf3_compact_pairs",),
    "composite_bwd": ("pf3_composite_bwd", *(f"pf3_composite_bwd{q}" for q in QUERIES),
                      "pf3_composite_bwd_sub_block"),
    "composite_bwd_blocks": ("pf3_composite_bwd_blocks",
                             *(f"pf3_composite_bwd_blocks{q}" for q in QUERIES)),
    "composite_fwd": ("pf3_composite_fwd", *(f"pf3_composite_fwd{q}" for q in QUERIES)),
    "dup_reduce": ("pf3_dup_reduce",),
    "table_bwd": ("pf3_table_bwd", *(f"pf3_table_bwd{q}" for q in QUERIES)),
    "table_fwd": ("pf3_table_fwd", *(f"pf3_table_fwd{q}" for q in QUERIES)),
}


def _all_exports() -> dict:
    return {s: e for name in kernels.SOURCES for s, e in kernels.exports(name).items()}


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_library_exports_map_onto_ctypes(name):
    """Every parameter and return type of the library's exports has a ctypes
    type, an export taking a pointer is a launch ending in `void* stream`
    (a query takes none), and the exports its wrappers name exist."""
    found = kernels.exports(name)
    assert set(WRAPPED[name]) <= set(found), f"{name} lacks {set(WRAPPED[name]) - set(found)}"
    for symbol, export in found.items():
        assert symbol.startswith(f"pf3_{name}"), symbol
        assert export.restype in kernels.CTYPES, (symbol, export.restype)
        for c_type, param in export.params:
            assert c_type in kernels.CTYPES, (symbol, param, c_type)
        takes_pointer = any(t.endswith("*") for t, _ in export.params)
        assert takes_pointer == (export.params[-1:] == (("void*", "stream"),)), symbol


def test_exports_are_unique_and_headers_export_nothing():
    """No symbol is exported by two libraries (`launch` finds a symbol's
    library by its name), and no header declares an export that no
    library's source would show."""
    names = [s for name in kernels.SOURCES for s in kernels.exports(name)]
    assert len(names) == len(set(names))
    assert len(names) == 24
    for header in kernels.CSRC.glob("*.cuh"):
        assert 'extern "C"' not in header.read_text(), header.name


def _kernel_calls():
    """(file:line, kind, symbol, positional count, starred) of every
    `kernels.launch` / `kernels.call` with a literal symbol in the port."""
    files = sorted((REPO / "pf3plat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("launch", "call")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "kernels"):
                continue
            head = node.args[0]
            if isinstance(head, ast.Constant):
                starred = any(isinstance(a, ast.Starred) for a in node.args[1:])
                yield (f"{path.relative_to(REPO)}:{node.lineno}", node.func.attr, head.value,
                       len(node.args) - 1 - starred, starred)


def test_wrappers_pass_what_the_c_declarations_take():
    """Each literal launch or query names an export and passes its C
    parameters (less the stream a launch appends): a parameter added on one
    side only fails here, without the card."""
    declared = _all_exports()
    calls = list(_kernel_calls())
    assert {c[2] for c in calls} >= {"pf3_compact_pairs", "pf3_dup_reduce", "pf3_table_fwd",
                                     "pf3_attention_fwd", "pf3_adam_update"}
    for where, kind, symbol, n_args, starred in calls:
        assert symbol in declared, f"{where}: {symbol} is no export"
        want = len(declared[symbol].params) - (kind == "launch")
        assert (n_args <= want) if starred else (n_args == want), (where, n_args, want)


class _StubExport:
    """One export of a stub library: records its calls, returns `rc`."""

    def __init__(self):
        self.rc = 0
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _StubLibrary:
    def __init__(self, symbols):
        for symbol in symbols:
            setattr(self, symbol, _StubExport())


@pytest.fixture
def stub(monkeypatch):
    """`bind(name)`: library `name` bound to a stub handle; the stream a
    launch would append is 4242, and the devices asked for it are kept."""
    monkeypatch.setattr(kernels, "_SYMBOLS", {})
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.SOURCES, 0))
    devices = []
    monkeypatch.setattr(kernels, "_stream", lambda device: devices.append(device) or 4242)

    def bind(name):
        return kernels._bind(name, _StubLibrary(kernels.exports(name)))

    bind.devices = devices
    return bind


def test_launch_converts_appends_the_stream_and_counts(stub):
    lib = stub("dup_reduce")
    fn = lib.pf3_dup_reduce
    assert fn.restype is ctypes.c_int
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    grads, ids = torch.zeros(9, 5), torch.zeros(5, dtype=torch.int32)
    out = torch.empty(9, 3)
    kernels.launch("pf3_dup_reduce", grads, 5, ids, 3, 2, out)
    assert fn.calls == [(grads.data_ptr(), 5, ids.data_ptr(), 3, 2, out.data_ptr(), 4242)]
    assert stub.devices == [grads.device]
    assert kernels.LAUNCHES["dup_reduce"] == 1

    # one argument short, one too many: nothing runs, nothing counts
    with pytest.raises(TypeError, match="pf3_dup_reduce"):
        kernels.launch("pf3_dup_reduce", grads, 5, ids, 3, 2)
    with pytest.raises(TypeError, match="pf3_dup_reduce"):
        kernels.launch("pf3_dup_reduce", grads, 5, ids, 3, 2, out, out)
    # a CUDA error is raised with the symbol, and not counted
    fn.rc = 700
    with pytest.raises(RuntimeError, match="pf3_dup_reduce failed: cudaError 700"):
        kernels.launch("pf3_dup_reduce", grads, 5, ids, 3, 2, out)
    assert len(fn.calls) == 2 and kernels.LAUNCHES["dup_reduce"] == 1
    with pytest.raises(KeyError, match="pf3_no_such_kernel"):
        kernels.launch("pf3_no_such_kernel", grads)


def test_call_returns_the_query_value_uncounted(stub):
    lib = stub("composite_bwd")
    lib.pf3_composite_bwd_sub_block.rc = 8
    lib.pf3_composite_bwd_smem.rc = 68096
    assert lib.pf3_composite_bwd_smem.restype is ctypes.c_longlong
    assert lib.pf3_composite_bwd_sub_block.argtypes == []
    assert streamed.bwd_sub_block() == 8
    assert kernels.smem_bytes("composite_bwd", 16, 128) == 68096
    assert lib.pf3_composite_bwd_smem.calls == [(16, 128)]
    with pytest.raises(TypeError, match="pf3_composite_bwd_smem"):
        kernels.call("pf3_composite_bwd_smem", 16)
    # a query is no launch
    with pytest.raises(TypeError, match="pf3_composite_bwd_sub_block"):
        kernels.launch("pf3_composite_bwd_sub_block")
    assert sum(kernels.LAUNCHES.values()) == 0 and stub.devices == []


def test_unknown_c_type_raises_at_load(stub, monkeypatch, tmp_path):
    """An export with a type outside the five raises when its library is
    bound, naming the symbol and the type."""
    (tmp_path / "probe.cu").write_text(
        '// extern "C" int pf3_commented(char c);\n'
        'extern "C" int pf3_probe(const void* x, double y,\n'
        '                         void* stream) { return 0; }\n')
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    monkeypatch.setattr(kernels, "SOURCES", {"probe": "probe.cu"})
    kernels.exports.cache_clear()
    try:
        found = kernels.exports("probe")
        assert list(found) == ["pf3_probe"]
        assert found["pf3_probe"].params == (("const void*", "x"), ("double", "y"),
                                             ("void*", "stream"))
        with pytest.raises(TypeError, match="pf3_probe.*'double'"):
            stub("probe")
    finally:
        kernels.exports.cache_clear()
