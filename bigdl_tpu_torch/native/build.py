"""Build the port's native host runtime (``native/src/*.cpp``) with g++.

The library is compiled at first use into ``bigdl_tpu_torch/_build/``
(git-ignored) under a name that carries a hash of every source, header
and flag, so an edited source rebuilds and a stale library is never
loaded. The flags are the JAX package's (``bigdl_tpu/native/build.py``):
``-O3 -std=c++17 -fPIC -shared -pthread`` with no ``-march`` and no fast
math, so the arithmetic (the reciprocal multiply of the augment op) is
the same on every x86-64 host. Builds are serialized by a thread lock and
a file lock, so pytest workers or processes that start together compile
once. There is no fallback: a missing or failing compiler raises
``OSError`` with the compiler's output.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "native", "src")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_LOCK = threading.Lock()


def sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith(".cpp"))


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sorted(os.listdir(SRC_DIR)):
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libbigdl_native-{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compiles (if needed) and returns the path of the native library.
    Raises OSError when g++ is missing or the build fails."""
    out = library_path()
    with _LOCK:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(out):     # built by another process meanwhile
                return out
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = ["g++", *FLAGS, *sources(), "-o", tmp]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise OSError("g++ not found: the native runtime is built "
                              "from source at first use") from e
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise OSError(f"native build failed ({' '.join(cmd)}):\n"
                              f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
    return out
