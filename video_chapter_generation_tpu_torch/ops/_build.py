"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into a shared library with a plain C
interface (no PyTorch headers: seconds per build, not minutes) under
`video_chapter_generation_tpu_torch/_build/`, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one
loads from disk. Nothing here runs at import: the first CUDA call of a
kernel wrapper builds what it needs, and `build_all` builds every source
at once, one nvcc process per source started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernel sources (csrc/<name>.cu)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    h.update((SRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + [f"-D{d}" for d in defines]).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: List[str] = None,
              defines: Tuple[str, ...] = ()) -> Dict[str, Path]:
    """Compile every source that has no up-to-date library yet, one nvcc
    per source, all started together (defines: extra -D macros, for the
    timing builds of a kernel's parts). Returns name -> library path;
    raises with nvcc's output if any compile fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _lib_path(n, defines) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *[f"-D{d}" for d in defines], "-o",
               str(tmp), str(SRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log.decode()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])  # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _loaded[name] = lib
        return lib
