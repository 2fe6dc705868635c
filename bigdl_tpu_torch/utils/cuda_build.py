"""Build the port's CUDA kernels from ``bigdl_tpu_torch/csrc/``.

Each ``csrc/<name>.cu`` holds a plain C entry point (no PyTorch
headers), so ``nvcc`` builds it into a shared library in seconds and
the wrapper binds it with ``ctypes``. Libraries land in
``bigdl_tpu_torch/_build/`` (git-ignored) under a name that carries the
content hash of the source and of the shared ``csrc/*.cuh`` headers, so
an edited source or header rebuilds and a stale library is never loaded.
Builds happen at first use; :func:`build_all` starts one ``nvcc`` per
source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names (``csrc/<name>.cu``) the package ships."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source, every shared
    header of ``csrc/`` and the flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as src:
            h.update(src.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start ``nvcc`` for one source (None when already built)."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job: Optional[Tuple[subprocess.Popen, str, str]]
            ) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every listed kernel (default: all of ``csrc/``), one
    ``nvcc`` process per source, all started together. Returns the
    compiler's output per kernel (``-Xptxas -v``: registers, shared
    memory, spills); empty for a library that was already built."""
    names = sources() if names is None else list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        return {n: _finish(n, j) for n, j in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use and cached."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _loaded[name] = ctypes.CDLL(library_path(name))
        return lib
