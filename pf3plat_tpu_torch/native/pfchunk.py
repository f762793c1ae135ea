"""pfchunk: native chunk container — Python writer + ctypes reader binding.

Port of `pf3plat_tpu/native/pfchunk.py` with its own copy of the C++
reader (`pfchunk.cc`, the same file format, version 2). Chunks convert once
from the reference's `.torch` pickles to the mmap-friendly `.pfchunk`
layout, after which ingestion needs no pickle: scene keys, camera rows and
JPEG buffers are served zero-copy out of the file mapping.

The shared library builds at first use (`g++ -O2 -fPIC -shared`, plain C
ABI through ctypes) into `<repo>/build/native/<hash of the source>/`, as
`kernels.py` builds the CUDA libraries. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Iterator

import numpy as np

_MAGIC = 0x48434650
# v2: scene key padded to 8-byte alignment so the camera block (72*n bytes)
# and the image index (u64 pairs) are both 8-aligned — the C++ reader
# reinterpret_casts those addresses and must never do misaligned u64 reads.
_VERSION = 2
_HEADER = struct.Struct("<IIQ")
_SCENE = struct.Struct("<QQQQQ")
_IMAGE = struct.Struct("<QQ")

SOURCE = Path(__file__).resolve().parent / "pfchunk.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_LIB = None


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libpfchunk.so"


def build_library(force: bool = False) -> Path:
    """Compile pfchunk.cc into libpfchunk.so (reused while the source is
    unchanged)."""
    out = _lib_path()
    if out.exists() and not force:
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the pfchunk reader cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libpfchunk.so.tmp{os.getpid()}")
    subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True)
    os.replace(tmp, out)
    return out


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    lib.pfchunk_open.restype = ctypes.c_void_p
    lib.pfchunk_open.argtypes = [ctypes.c_char_p]
    lib.pfchunk_close.argtypes = [ctypes.c_void_p]
    lib.pfchunk_num_scenes.restype = ctypes.c_uint64
    lib.pfchunk_num_scenes.argtypes = [ctypes.c_void_p]
    lib.pfchunk_scene_key.restype = ctypes.c_void_p
    lib.pfchunk_scene_key.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
    ]
    lib.pfchunk_num_frames.restype = ctypes.c_uint64
    lib.pfchunk_num_frames.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.pfchunk_cameras.restype = ctypes.POINTER(ctypes.c_float)
    lib.pfchunk_cameras.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.pfchunk_jpeg.restype = ctypes.c_void_p
    lib.pfchunk_jpeg.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.pfchunk_decode_poses.restype = ctypes.c_int
    lib.pfchunk_decode_poses.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    _LIB = lib
    return lib


def write_pfchunk(path: Path, scenes: list[dict]) -> None:
    """Write scenes [{key: str, cameras: (n,18) f32, images: [bytes]}]."""
    path = Path(path)
    offset = _HEADER.size + _SCENE.size * len(scenes)

    blobs = []
    entries = []
    for scene in scenes:
        key = scene["key"].encode("utf-8")
        cams = np.ascontiguousarray(scene["cameras"], dtype="<f4")
        n = cams.shape[0]
        key_off = offset
        blobs.append(key)
        offset += len(key)
        pad = (-offset) % 8
        blobs.append(b"\0" * pad)
        offset += pad
        cam_off = offset
        blobs.append(cams.tobytes())
        offset += cams.nbytes
        img_index_off = offset
        offset += _IMAGE.size * n
        img_entries = []
        img_blobs = []
        for jpeg in scene["images"]:
            raw = bytes(jpeg)
            img_entries.append((offset, len(raw)))
            img_blobs.append(raw)
            offset += len(raw)
        blobs.append(b"".join(_IMAGE.pack(o, ln) for o, ln in img_entries))
        blobs.extend(img_blobs)
        entries.append((key_off, len(key), cam_off, n, img_index_off))

    with path.open("wb") as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, len(scenes)))
        for e in entries:
            f.write(_SCENE.pack(*e))
        for b in blobs:
            f.write(b)


def convert_torch_chunk(torch_path: Path, out_path: Path) -> int:
    """One-time conversion of a reference `.torch` chunk."""
    from ..data.dataset import load_chunk

    raw = load_chunk(Path(torch_path))
    scenes = [
        {
            "key": ex["key"],
            "cameras": ex["cameras"],
            "images": [np.asarray(img, np.uint8).tobytes() for img in ex["images"]],
        }
        for ex in raw
    ]
    write_pfchunk(Path(out_path), scenes)
    return len(scenes)


class PfChunkReader:
    """Zero-copy reader over one .pfchunk file (C++ mmap underneath)."""

    def __init__(self, path: Path):
        self._lib = _load_lib()
        self._handle = self._lib.pfchunk_open(str(path).encode())
        if not self._handle:
            raise IOError(f"failed to open pfchunk {path}")

    def __len__(self) -> int:
        return int(self._lib.pfchunk_num_scenes(self._handle))

    def key(self, scene: int) -> str:
        ln = ctypes.c_uint64()
        ptr = self._lib.pfchunk_scene_key(self._handle, scene, ctypes.byref(ln))
        return ctypes.string_at(ptr, ln.value).decode("utf-8")

    def num_frames(self, scene: int) -> int:
        return int(self._lib.pfchunk_num_frames(self._handle, scene))

    def cameras(self, scene: int) -> np.ndarray:
        n = self.num_frames(scene)
        ptr = self._lib.pfchunk_cameras(self._handle, scene)
        return np.ctypeslib.as_array(ptr, shape=(n, 18))

    def poses(self, scene: int) -> tuple[np.ndarray, np.ndarray]:
        """Native batched pose decode -> (c2w (n,4,4), intrinsics (n,3,3))."""
        cams = self.cameras(scene)
        n = cams.shape[0]
        c2w = np.empty((n, 4, 4), np.float32)
        intr = np.empty((n, 3, 3), np.float32)
        fptr = ctypes.POINTER(ctypes.c_float)
        rc = self._lib.pfchunk_decode_poses(
            cams.ctypes.data_as(fptr), n,
            c2w.ctypes.data_as(fptr), intr.ctypes.data_as(fptr),
        )
        if rc != 0:
            raise ValueError("pose decode failed")
        return c2w, intr

    def jpeg(self, scene: int, frame: int) -> bytes:
        ln = ctypes.c_uint64()
        ptr = self._lib.pfchunk_jpeg(
            self._handle, scene, frame, ctypes.byref(ln)
        )
        return ctypes.string_at(ptr, ln.value)

    def scenes(self) -> Iterator[dict]:
        for s in range(len(self)):
            c2w, intr = self.poses(s)
            yield {
                "key": self.key(s),
                "c2w": c2w,
                "intrinsics": intr,
                "num_frames": self.num_frames(s),
                "jpeg": lambda f, s=s: self.jpeg(s, f),
            }

    def close(self) -> None:
        if self._handle:
            self._lib.pfchunk_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
