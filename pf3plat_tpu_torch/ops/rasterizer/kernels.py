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
    "composite_bwd": "composite_bwd.cu",
    "composite_bwd_blocks": "composite_bwd_blocks.cu",
    "dup_reduce": "dup_reduce.cu",
    "table_fwd": "table_fwd.cu",
    "table_bwd": "table_bwd.cu",
    "attention_fwd": "attention_fwd.cu",
    "attention_bwd": "attention_bwd.cu",
    "adam": "adam.cu",
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


def build_variants(name: str, defines: list[dict], reports: dict | None = None
                   ) -> list[ctypes.CDLL]:
    """Measurement builds of kernel library `name`, one per dict of
    preprocessor definitions (all compiled together): the ctypes handles, in
    order; `reports`, if given, receives each build's compiler report by
    library file name. Not counted, not cached in `_LIBS`; the product path
    never calls this."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for defs in defines:
        flags = [f"-D{k}={v}" for k, v in sorted(defs.items())]
        tag = hashlib.sha256(" ".join(flags).encode()).hexdigest()[:8]
        lib = out_dir / f"lib{name}.{tag}.so"
        proc = None
        if not lib.exists():
            cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(lib), str(CSRC / SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        procs.append((proc, lib))
    for proc, lib in procs:
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"kernel build failed: {name} {lib.name}:\n{log}")
            if reports is not None:
                reports[lib.name] = log
    return [ctypes.CDLL(str(lib)) for _, lib in procs]


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, building it if needed."""
    if name not in _LIBS:
        lib_path = _build_dir() / f"lib{name}.so"
        if not lib_path.exists():
            build_all()
        _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]


SMEM_LIMIT = 232448  # bytes of shared memory one block can use on sm_90


def smem_bytes(name: str, ts: int, chunk: int) -> int:
    """Shared memory of one CTA of compositing kernel `name` (`composite_fwd`,
    `composite_bwd`, `composite_bwd_blocks`, `table_fwd`, `table_bwd`) at
    tile size `ts` and `chunk`, as its library computes it
    (`pf3_<name>_smem`)."""
    fn = getattr(load(name), f"pf3_{name}_smem")
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 2
    return int(fn(ts, chunk))


def occupancy(name: str, ts: int, chunk: int) -> int:
    """CTAs of compositing kernel `name` that fit one SM at tile size `ts`
    and `chunk` (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`, registers
    and shared memory as built). Needs the card."""
    fn = getattr(load(name), f"pf3_{name}_occupancy")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2
    got = int(fn(ts, chunk))
    if got < 0:
        raise RuntimeError(f"{name}: occupancy query failed (cudaError {-got})")
    return got


def check_smem(name: str, ts: int, chunk: int) -> None:
    """Raise if kernel `name` needs more shared memory than a block has."""
    need = smem_bytes(name, ts, chunk)
    if need > SMEM_LIMIT:
        raise ValueError(f"{name}: tile size {ts} and chunk {chunk} need {need} bytes of "
                         f"shared memory, more than a block's {SMEM_LIMIT}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(name: str, rc: int) -> None:
    """Raise if the C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
