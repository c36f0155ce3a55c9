"""Build and load the port's CUDA kernels (nvcc + ctypes).

Every CUDA source of a kernel subpackage (``kernels/*/*.cu``: each
``kernel.cu``, and the ``backward.cu`` of ``ssd_scan``, ``rglru_scan`` and
``flash_attention``) is compiled for Hopper
(``sm_90a``) by its own ``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use, from the package's own sources, into
``build/kernels/`` at the repository root (listed in ``.gitignore``); the
library's file name carries a hash of the sources, the headers they share
(``kernels/*.cuh``) and the flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is.

Nothing here runs at import time: the CPU tests import every module of the
port on hosts that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB = None
# what the last build did: {"seconds": float, "cached": bool, "log": str}
BUILD_INFO: Dict[str, object] = {}


def sources() -> List[Path]:
    """The CUDA sources of every kernel subpackage, in a fixed order."""
    return sorted(KERNELS_DIR.glob("*/*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return path


def _library_path(srcs: List[Path]) -> Path:
    h = hashlib.sha256(" ".join(ARCH + CFLAGS).encode())
    for s in srcs + sorted(KERNELS_DIR.glob("*.cuh")):   # and shared headers
        h.update(s.name.encode() + s.parent.name.encode() + s.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def _compile(srcs: List[Path], out: Path) -> str:
    """One nvcc per source, run concurrently, then one link.  Returns the
    compilers' output (ptxas register and shared-memory report)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    procs: List[subprocess.Popen] = []
    try:
        objs = [tmp / f"{s.parent.name}_{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen([nvcc, *ARCH, *CFLAGS, "-c", str(s),
                                   "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = []
        for s, p in zip(srcs, procs):
            text, _ = p.communicate()
            logs.append(f"== {s.parent.name}/{s.name}\n{text}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s}:\n{text}")
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o",
                               str(tmp / out.name), *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp / out.name, out)      # atomic: readers see all or none
        return "\n".join(logs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use in this process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            srcs = sources()
            out = _library_path(srcs)
            t0 = time.perf_counter()
            cached = out.exists()
            log = "" if cached else _compile(srcs, out)
            BUILD_INFO.update(seconds=time.perf_counter() - t0,
                              cached=cached, log=log)
            _LIB = ctypes.CDLL(str(out))
        return _LIB


def entry(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of the library with its signature declared.  Every
    entry returns the launch's ``cudaError_t`` as an int."""
    fn = getattr(load(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
