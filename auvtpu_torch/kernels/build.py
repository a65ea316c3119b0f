"""Build the CUDA sources of the port with nvcc at first use.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled into a shared library under ``build/auvtpu_torch/`` at the root of
the checkout, then loaded with ctypes.  The library's file name carries a
hash of the sources and the flags, so an edit rebuilds and a stale library is
never loaded; the library is written under a temporary name and moved into
place, so a concurrent process never loads a partial file.  nvcc's messages
(``-Xptxas -v``: registers, spills, shared memory per kernel) are kept
beside the library in ``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils.profiling import spanned

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "auvtpu_torch"

# No fast-math: IEEE division, sqrtf and expf as the plain versions use.
# -fmad=false keeps a*b+c as two roundings, like the plain torch ops, so the
# kernels follow the plain versions' arithmetic op for op.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of auvtpu_torch are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives for the current
    sources and flags."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@spanned
def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for these sources and
    flags exists.  Raises with nvcc's messages if the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@spanned
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
