"""The native host decoder: ctypes bindings of native/vcg_host.cc, a
thread-pooled libjpeg decode (counterpart of the JAX package's
data/native_loader.py:1-146).

The library is built from the checkout's native/vcg_host.cc with g++ and
libjpeg on first use (native/build.sh's flags but -march=native, so that
a cached build runs on any x86-64 host), into the port's gitignored
`_build/` directory under a name keyed by a hash of the source and
flags, as ops/_build.py does for the CUDA sources; nothing is written to
native/. `toolchain()` says whether g++ and jpeglib.h are on
the machine, before any build.

`install_native_loader(n)` routes data/frames.load_clip_frames through
the decoder (frames, and the s2d pack the stems read, permuted in the
thread pool). Unlike the JAX package's, which returns False and keeps
PIL without a word when the library is missing (native_loader.py:75-85),
it raises where g++, jpeglib.h or the build is missing or the library
does not load. Nothing installs it by default: PIL stays the decoder
unless a caller installs this one. A frame whose file is missing or
does not decode is zero-filled and counted in `NativeLoader.failures`.
At a file's own size the decode equals PIL's (both libjpeg, the same
default DCT and upsampling); a resize is nearest-neighbour here and
PIL's filter there, so resized frames differ.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from .frames import space_to_depth4

SOURCE = Path(__file__).resolve().parents[2] / "native" / "vcg_host.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-ljpeg", "-lpthread"]

__all__ = ["NativeLoader", "build_library", "install_native_loader",
           "space_to_depth4", "toolchain"]


def toolchain() -> Tuple[bool, str]:
    """(True, g++ path) where g++ is found and preprocesses
    `#include <jpeglib.h>`, else (False, what is missing)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False, "no g++ on PATH"
    probe = subprocess.run([gxx, "-E", "-x", "c++", "-"],
                           input=b"#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True)
    if probe.returncode != 0:
        return False, "no jpeglib.h (libjpeg's development headers)"
    return True, gxx


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"vcg_host-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """The library's path, compiled first when no up-to-date build is
    there; raises RuntimeError naming what is missing or g++'s output."""
    out = _lib_path()
    if out.exists():
        return out
    ok, gxx = toolchain()
    if not ok:
        raise RuntimeError(f"cannot build the native decoder: {gxx}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           *LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees half a file
    return out


_u8p = ctypes.POINTER(ctypes.c_uint8)


class NativeLoader:
    """Thread-pooled JPEG batch decoder (JAX native_loader.py:23-120).
    lib_path: a built library to load instead of this checkout's build."""

    def __init__(self, n_threads: int = 4, lib_path: Optional[str] = None):
        path = lib_path or build_library()
        self.lib = lib = ctypes.CDLL(os.path.abspath(path))
        lib.vcg_pool_create.restype = ctypes.c_void_p
        lib.vcg_pool_create.argtypes = [ctypes.c_int]
        lib.vcg_pool_destroy.argtypes = [ctypes.c_void_p]
        for fn in (lib.vcg_decode_batch, lib.vcg_decode_batch_s2d):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                           ctypes.c_int, _u8p, ctypes.c_int]
        lib.vcg_decode_file.restype = ctypes.c_int
        lib.vcg_decode_file.argtypes = [ctypes.c_char_p, _u8p, ctypes.c_int]
        lib.vcg_normalize_f32.argtypes = [
            _u8p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        self.pool = lib.vcg_pool_create(n_threads)
        self.failures = 0

    def __del__(self):
        pool = getattr(self, "pool", None)
        if pool:
            self.lib.vcg_pool_destroy(pool)
            self.pool = None

    def _batch(self, fn, paths: Sequence[str], hw: int, shape) -> np.ndarray:
        n = len(paths)
        out = np.empty((n, *shape), np.uint8)
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        self.failures += fn(self.pool, arr, n, out.ctypes.data_as(_u8p), hw)
        return out

    def decode_batch(self, paths: Sequence[str], hw: int = 224) -> np.ndarray:
        """paths -> uint8 [N, hw, hw, 3]; unreadable files zero-filled."""
        return self._batch(self.lib.vcg_decode_batch, paths, hw, (hw, hw, 3))

    def decode_batch_s2d(self, paths: Sequence[str],
                         hw: int = 224) -> np.ndarray:
        """paths -> uint8 [N, hw/4, hw/4, 48], the 4x4 space-to-depth
        order of frames.space_to_depth4, permuted in the thread pool."""
        if hw % 4:
            raise ValueError(f"the s2d decode takes hw a multiple of 4, "
                             f"got {hw}")
        return self._batch(self.lib.vcg_decode_batch_s2d, paths, hw,
                           (hw // 4, hw // 4, 48))

    def decode_file(self, path: str, hw: int = 224) -> np.ndarray:
        """One file -> uint8 [hw, hw, 3] on the calling thread."""
        out = np.empty((hw, hw, 3), np.uint8)
        if self.lib.vcg_decode_file(os.fsencode(path),
                                    out.ctypes.data_as(_u8p), hw) != 0:
            self.failures += 1
        return out

    def normalize_f32(self, u8: np.ndarray, mean, std) -> np.ndarray:
        """uint8 [..., 3] -> float32 u8 / 255 / std - mean / std on the
        host (JAX native_loader.py:105-120)."""
        if u8.shape[-1] != 3 or not u8.flags["C_CONTIGUOUS"]:
            raise ValueError("normalize_f32 takes a contiguous [..., 3] "
                             "uint8 array")
        dst = np.empty(u8.shape, np.float32)
        m = np.ascontiguousarray(mean, np.float32)
        s = np.ascontiguousarray(std, np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        self.lib.vcg_normalize_f32(u8.ctypes.data_as(_u8p),
                                   dst.ctypes.data_as(f32p), u8.size // 3,
                                   m.ctypes.data_as(f32p),
                                   s.ctypes.data_as(f32p))
        return dst


def install_native_loader(n_threads: int = 4,
                          lib_path: Optional[str] = None) -> NativeLoader:
    """Route data/frames.load_clip_frames through the native decoder (JAX
    native_loader.py:134-146) and return it; raises where it cannot be
    built or loaded. `frames.set_native_loader(None)` puts PIL back."""
    from . import frames

    loader = NativeLoader(n_threads, lib_path)
    fn = lambda paths, hw: loader.decode_batch(paths, hw)  # noqa: E731
    fn.s2d = lambda paths, hw: loader.decode_batch_s2d(paths, hw)
    frames.set_native_loader(fn)
    return loader
