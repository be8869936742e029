"""The benchmark's plain references: frozen C built by gcc (amv_ref.c,
g729_ref.c) and plain NumPy containers.  Nothing here imports the program.

`library(name)` builds portbench/reference/<name>.c with gcc into
build/portbench/ at the checkout's root (a fixed directory, rebuilt when
the source or a header is newer) and loads it.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "build",
                         "portbench")
_LIBS: dict = {}
_LOCK = threading.Lock()


def library(name: str) -> ctypes.CDLL:
    """portbench/reference/<name>.c built and loaded (once a process)."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = _load(name)
        return _LIBS[name]


def _load(name: str) -> ctypes.CDLL:
    src = os.path.join(HERE, f"{name}.c")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    deps = [src] + glob.glob(os.path.join(HERE, "*.h"))
    if not (os.path.exists(so) and all(os.path.getmtime(d) <=
                                       os.path.getmtime(so) for d in deps)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["gcc", "-O2", "-fPIC", "-shared", "-o", tmp, src]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"gcc failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(so)
