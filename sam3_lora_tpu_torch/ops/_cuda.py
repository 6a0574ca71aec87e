"""Build and load the port's CUDA kernels.

Every source under ``csrc/`` (the attention forward and backward kernels and
the int8 GEMM kernels) is compiled with ``nvcc`` for ``sm_90a``, one process
per source, all started together, then linked into one shared library with a
plain C interface. The library lands in ``_build/<hash>/``, keyed on a hash of
the sources, headers and flags, at first use; it is loaded with ``ctypes``.
Each kernel module (``attention_kernel.py``, ``gemm_int8.py``) declares the
argument types of its own entry points on the loaded library. Nothing here
runs at import: the CPU tests import every module on a host without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("attention_fwd.cu", "attention_bwd.cu", "gemm_int8.cu")
_HEADERS = ("attention_common.cuh",)
# no --use_fast_math: the int8 quantization divides and rounds as IEEE does
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _run(procs) -> None:
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _popen(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@functools.lru_cache(maxsize=1)
def build() -> str:
    """Compile the kernel library if this source hash has no build yet;
    return the path of the shared library."""
    h = hashlib.sha256()
    for name in SOURCES + _HEADERS:
        with open(os.path.join(_CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(_NVCC_FLAGS).encode())
    out_dir = os.path.join(_BUILD_DIR, h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libsam3_kernels.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, name + ".o") for name in SOURCES]
        _run([_popen([nvcc, *_NVCC_FLAGS, "-c", "-o", obj, os.path.join(_CSRC_DIR, name)])
              for name, obj in zip(SOURCES, objs)])
        so = os.path.join(tmp, "lib.so")
        _run([_popen([nvcc, *_NVCC_FLAGS, "-shared", "-o", so, *objs])])
        os.replace(so, lib)  # atomic: a concurrent reader sees all or nothing
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    return ctypes.CDLL(build())
