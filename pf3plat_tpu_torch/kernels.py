"""Build, load, type, launch and count the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is one library, named after the file's stem,
compiled by `nvcc` with a plain C interface (`-gencode
arch=compute_90a,code=sm_90a`) and loaded with `ctypes`. Builds run at
first use, one `nvcc` per source, all started together, into
`<repo>/build/kernels/<hash of the sources>/`; a finished build is reused
while the sources are unchanged. Nothing is built at import time.

A library's `extern "C"` declarations are the only statement of its ABI:
`load` reads them from the source and types each export once. Parameters
are `int`, `long long`, `float`, `const void*` or `void*`; an export whose
last parameter is `void* stream` is a launch. `launch(symbol, *args)`
passes tensors as their data pointers, appends the current stream, raises
on a non-zero return and counts the call; `call(symbol, *args)` runs a
query and returns its value.

A new kernel is a `.cu` file with such exports and a Python wrapper that
validates its arguments and calls `launch`.

`LAUNCHES` counts, per library, the launches on the card (plain integers;
`reset_launches()` zeroes them).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "kernels"
SOURCES = {src.stem: src.name for src in sorted(CSRC.glob("*.cu"))}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# the C types an export may use, as ctypes takes them
CTYPES = {
    "int": ctypes.c_int,
    "long long": ctypes.c_longlong,
    "float": ctypes.c_float,
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
}

LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES}
_LIBS: dict[str, ctypes.CDLL] = {}
# symbol -> (typed function, library, appends a stream, C parameter count)
_SYMBOLS: dict[str, tuple] = {}


class Export(NamedTuple):
    """One `extern "C"` declaration: return type and (type, name) pairs."""

    symbol: str
    restype: str
    params: tuple[tuple[str, str], ...]


_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_EXTERN = re.compile(r'extern\s+"C"\s+([A-Za-z_][\w\s]*?)\s+(\w+)\s*\(([^)]*)\)', re.S)
_PARAM = re.compile(r"(.+?)\s*\b(\w+)")


def _c_type(text: str) -> str:
    """`text` with single spaces and each `*` against the word before it."""
    return re.sub(r"\s*\*", "*", " ".join(text.split()))


@functools.cache
def exports(name: str) -> dict[str, Export]:
    """The `extern "C"` declarations of library `name`, read from its
    source: {symbol: Export}."""
    text = _COMMENT.sub("", (CSRC / SOURCES[name]).read_text())
    found = {}
    for restype, symbol, params in _EXTERN.findall(text):
        pairs = []
        for param in params.split(","):
            if param.strip() in ("", "void"):
                continue
            m = _PARAM.fullmatch(" ".join(param.split()))
            if m is None:
                raise ValueError(f"{symbol}: cannot read parameter {param.strip()!r}")
            pairs.append((_c_type(m.group(1)), m.group(2)))
        found[symbol] = Export(symbol, _c_type(restype), tuple(pairs))
    return found


def _ctype(symbol: str, c_type: str):
    if c_type not in CTYPES:
        raise TypeError(f"{symbol}: C type {c_type!r} has no ctypes mapping "
                        f"(known: {', '.join(CTYPES)})")
    return CTYPES[c_type]


def _bind(name: str, handle):
    """Type every export of library `name` on `handle` (its ctypes handle)
    and register them for `launch` and `call`."""
    bound = {}
    for export in exports(name).values():
        fn = getattr(handle, export.symbol)
        fn.restype = _ctype(export.symbol, export.restype)
        fn.argtypes = [_ctype(export.symbol, t) for t, _ in export.params]
        stream = export.params[-1:] == (("void*", "stream"),)
        bound[export.symbol] = (fn, name, stream, len(export.params))
    _SYMBOLS.update(bound)
    _LIBS[name] = handle
    return handle


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_dir() -> Path:
    h = hashlib.sha256()
    for name in sorted(SOURCES):
        h.update((CSRC / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every kernel library not yet built (in parallel).

    Returns {"seconds": wall time, "ptxas": {name: compiler report}}; each
    report is kept beside its library, so a later call returns it too."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, src in SOURCES.items():
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            lib,
        )
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    logs = {name: out_dir / f"lib{name}.log" for name in SOURCES}
    reports = {name: log.read_text() for name, log in logs.items() if log.exists()}
    return {"seconds": time.perf_counter() - t0, "ptxas": reports}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, building it if needed,
    its exports typed from its source."""
    if name not in _LIBS:
        lib_path = _build_dir() / f"lib{name}.so"
        if not lib_path.exists():
            build_all()
        _bind(name, ctypes.CDLL(str(lib_path)))
    return _LIBS[name]


def _lookup(symbol: str) -> tuple:
    """`_SYMBOLS[symbol]`, loading the library that exports it."""
    owner = [name for name in SOURCES if symbol in exports(name)]
    if not owner:
        raise KeyError(f"no kernel library exports {symbol}")
    load(owner[0])
    return _SYMBOLS[symbol]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(symbol: str, *args) -> None:
    """Launch export `symbol`: tensors go as their data pointers, the
    current stream of the first tensor's device is appended; raises on a
    non-zero return (a CUDA error), then counts the launch."""
    fn, name, stream, n_params = _SYMBOLS.get(symbol) or _lookup(symbol)
    if not stream or len(args) + 1 != n_params:
        raise TypeError(f"{symbol} is no launch of {n_params - 1} arguments and a stream "
                        f"(got {len(args)} arguments)")
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    c_args.append(_stream(next(a for a in args if isinstance(a, torch.Tensor)).device))
    rc = fn(*c_args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed: cudaError {rc}")
    LAUNCHES[name] += 1


def call(symbol: str, *args):
    """The value query `symbol` returns for `args` (no stream, not
    counted)."""
    fn, _, _, n_params = _SYMBOLS.get(symbol) or _lookup(symbol)
    if len(args) != n_params:
        raise TypeError(f"{symbol} takes {n_params} arguments, got {len(args)}")
    return fn(*args)


SMEM_LIMIT = 232448  # bytes of shared memory one block can use on sm_90


def smem_bytes(name: str, ts: int, chunk: int) -> int:
    """Shared memory of one CTA of compositing kernel `name` (`composite_fwd`,
    `composite_bwd`, `composite_bwd_blocks`, `table_fwd`, `table_bwd`) at
    tile size `ts` and `chunk`, as its library computes it
    (`pf3_<name>_smem`)."""
    return int(call(f"pf3_{name}_smem", ts, chunk))


def occupancy(name: str, ts: int, chunk: int) -> int:
    """CTAs of compositing kernel `name` that fit one SM at tile size `ts`
    and `chunk` (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`, registers
    and shared memory as built). Needs the card."""
    got = int(call(f"pf3_{name}_occupancy", ts, chunk))
    if got < 0:
        raise RuntimeError(f"{name}: occupancy query failed (cudaError {-got})")
    return got


def check_smem(name: str, ts: int, chunk: int) -> None:
    """Raise if kernel `name` needs more shared memory than a block has."""
    need = smem_bytes(name, ts, chunk)
    if need > SMEM_LIMIT:
        raise ValueError(f"{name}: tile size {ts} and chunk {chunk} need {need} bytes of "
                         f"shared memory, more than a block's {SMEM_LIMIT}")
