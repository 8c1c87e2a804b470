"""Build a CUDA source into a shared library and load it with ctypes.

Every kernel of the port is CUDA C++ for ``sm_90a`` with a plain C entry
point (no PyTorch headers, so ``nvcc`` takes seconds).  :func:`load`
compiles a source at first use into ``build/repro_torch_kernels/`` at the
repository root and loads the library.  The library's name carries a hash
of the source, the local headers it includes (``csrc/sm90.cuh``) and the
flags, so an edited source or header is rebuilt; a build
writes a temporary file and renames it, so two processes building the
same source do not see half a library.  Nothing is compiled when a module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source with the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_includes(source: Path) -> List[Path]:
    """Every file that ``source`` reaches through ``#include "..."``
    (resolved beside the including file), each once, in the order met."""
    seen: List[Path] = []
    todo = [source]
    while todo:
        cur = todo.pop()
        for name in _LOCAL_INCLUDE.findall(cur.read_bytes()):
            path = (cur.parent / name.decode()).resolve()
            if path.exists() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def library_path(source: Path) -> Path:
    """The library's path: its name hashes the source, every local header
    it includes and the flags, so an edit to any of them rebuilds it."""
    h = hashlib.sha1(source.read_bytes())
    for header in local_includes(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def load(source: Path) -> Tuple[ctypes.CDLL, Optional[float], str]:
    """Compile ``source`` if its library is not built yet, then load it.

    Returns ``(library, seconds nvcc took or None when no build ran,
    what nvcc printed)``; ``-Xptxas -v`` makes that the per-kernel
    register and shared-memory report."""
    path = library_path(source)
    seconds, log = None, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path)), seconds, log
