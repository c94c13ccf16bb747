"""Build and load the hand-written CUDA kernels under csrc/.

Each `csrc/<name>.cu` is compiled by nvcc, at its first use in a process,
into a shared library with a plain C interface that ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so

The library is cached in build/kernels/ (at the repository root) under a
hash of every csrc/ source and the flags, so a changed source rebuilds
and an unchanged one loads at once. The environment variable
PRISIM_KERNEL_DEFINES (comma-separated names, read at the first load)
adds a -D flag for each, and so a library of its own: profile_banded.py
--phase-clocks sets PRISIM_PHASE_CLOCKS. The ptxas report (registers,
shared memory, spills) is kept beside the library. There is no fallback: a
missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from . import tracing

__all__ = ["load_kernel_library", "build_info"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED = {}      # name -> ctypes.CDLL, one load per process
_INFO = {}        # name -> dict(path, seconds, built, report)


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return path


def _flags():
    defines = os.environ.get("PRISIM_KERNEL_DEFINES", "")
    return NVCC_FLAGS + ["-D" + d for d in defines.split(",") if d]


def _source_hash(flags):
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_kernel_library(name):
    """ctypes handle of the library built from csrc/<name>.cu; the first
    load in a process is the span kernels.load, whose attribute `built`
    says whether nvcc compiled it."""
    if name in _LOADED:
        return _LOADED[name]
    with tracing.span("kernels.load", kernel=name) as sp:
        lib = _load(name)
        sp.set(built=_INFO[name]["built"])
    return lib


def _load(name):
    src = CSRC / (name + ".cu")
    if not src.exists():
        raise FileNotFoundError(src)
    flags = _flags()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / ("%s-%s.so" % (name, _source_hash(flags)))
    log_path = lib_path.with_suffix(".log")
    built = False
    t0 = time.time()
    if not lib_path.exists():
        tmp = lib_path.with_name("%s.%d.tmp" % (lib_path.name, os.getpid()))
        cmd = [_nvcc()] + flags + ["-I", str(CSRC), "-o", str(tmp),
                                   str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d) for %s:\n%s%s"
                               % (proc.returncode, src, proc.stdout,
                                  proc.stderr))
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)       # atomic: concurrent builders agree
        built = True
    lib = ctypes.CDLL(str(lib_path))
    _INFO[name] = dict(path=str(lib_path), seconds=time.time() - t0,
                       built=built,
                       report=log_path.read_text() if log_path.exists()
                       else "")
    _LOADED[name] = lib
    return lib


def build_info(name):
    """Path, build seconds, whether this process compiled it, and the
    ptxas report of a loaded library."""
    return dict(_INFO[name])
