"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/`` at the repository root (a
directory ``.gitignore`` lists), then loaded with ``ctypes``.  The sources
share the mask stream and the cell bodies through the headers
``csrc/*.cuh``.  The library name carries a hash of the source, the headers
and the flags, so an edited source or header rebuilds and an unchanged one
loads at once.  Nothing here runs at import time: a
build starts on the first launch, or when a caller asks for it with
:func:`build_all` (which starts one ``nvcc`` per source, all together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build on the machine that has the GPU")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source, of every shared header (``csrc/*.cuh``) and of the flags, so an
    edited header rebuilds every kernel too."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for a build started by :func:`_start`; returns nvcc's output
    ("" when the library was already built)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names) -> dict[str, str]:
    """Compile every named source in parallel; returns the nvcc logs."""
    started = {name: _start(name) for name in names}
    return {name: _finish(name, st) for name, st in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if it is missing
    (callers keep the handle)."""
    _finish(name, _start(name))
    return ctypes.CDLL(str(library_path(name)))
