"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``; none
includes PyTorch's headers, so a build takes seconds.  Libraries go to
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, and are built at first use (or all at once, in
parallel, by :func:`build_all`).  Nothing is built when a module is
imported.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("scan_filter", "grouped_agg", "wire_codec")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under
    $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
            "cannot be built")
    return path


def _target(name: str) -> tuple:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def compile_source(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns the compiler's report (``-Xptxas -v``: registers, shared
    memory and spills per kernel), empty when nothing was built."""
    src, lib = _target(name)
    if lib.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return proc.stderr


def build_all(names=SOURCES) -> dict:
    """Compile every source at once, one ``nvcc`` each, all started
    together; returns name -> compiler report."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(compile_source, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        compile_source(name)
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS[name] = lib
    return lib
