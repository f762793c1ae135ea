"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` into its own shared library
with a plain C interface (`-gencode arch=compute_90a,code=sm_90a`), loaded
with `ctypes`. Builds run at first use, one `nvcc` per source, all started
together, into `<repo>/build/kernels/<hash of the sources>/`; a finished
build is reused while the sources are unchanged. Nothing here runs at
import time.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it on the
card (plain integers; `reset_launches()` zeroes them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {
    "compact_pairs": "compact_pairs.cu",
    "composite_fwd": "composite_fwd.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES}
_LIBS: dict[str, ctypes.CDLL] = {}


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

    Returns {"seconds": wall time, "ptxas": {name: compiler report}}."""
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
    reports = {}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "ptxas": reports}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, building it if needed."""
    if name not in _LIBS:
        lib_path = _build_dir() / f"lib{name}.so"
        if not lib_path.exists():
            build_all()
        _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(name: str, rc: int) -> None:
    """Raise if the C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
