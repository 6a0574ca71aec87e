"""The native COCO RLE codec: ``csrc/rle.cpp`` (a copy of the JAX package's
``native/rle.cpp``), built with ``g++ -O3 -shared -fPIC -std=c++17`` at
first use into ``_build/<hash>/librle.so``, keyed on a hash of the source
and the flags, and bound with ctypes.

There is no fallback: a failed build raises. The numpy encoder and decoder
of ``ops/rle.py`` (``rle_encode_numpy``, ``rle_decode_numpy``) are the plain
versions the tests hold this codec against; the strings are byte for byte
theirs, and pycocotools'.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Union

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "rle.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
COMPILER = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build() -> str:
    """Compile the codec if this source hash has no build yet; return the
    path of the shared library. Raises when the compiler is missing or
    fails."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_DIR, key)
    lib = os.path.join(out_dir, "librle.so")
    if os.path.exists(lib):
        return lib
    cxx = shutil.which(COMPILER)
    if cxx is None:
        raise RuntimeError(f"the native RLE codec needs {COMPILER!r} on PATH to build {SOURCE}")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        so = os.path.join(tmp, "librle.so")
        proc = subprocess.run([cxx, *FLAGS, SOURCE, "-o", so], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native RLE codec failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(so, lib)  # atomic: a concurrent reader sees all or nothing
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded codec (built first if needed), its argument types declared."""
    lib = ctypes.CDLL(build())
    i64 = ctypes.c_int64
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.rle_encode_counts.argtypes = [u8p, i64, i64p]
    lib.rle_encode_counts.restype = i64
    lib.rle_decode_counts.argtypes = [i64p, i64, u8p, i64]
    lib.rle_decode_counts.restype = None
    lib.rle_counts_to_string.argtypes = [i64p, i64, ctypes.c_char_p]
    lib.rle_counts_to_string.restype = i64
    lib.rle_string_to_counts.argtypes = [ctypes.c_char_p, i64, i64p]
    lib.rle_string_to_counts.restype = i64
    lib.rle_string_decode.argtypes = [ctypes.c_char_p, i64, u8p, i64]
    lib.rle_string_decode.restype = None
    lib.downsample_mask_exact.argtypes = [f32p, i64, i64, i64, f32p]
    lib.downsample_mask_exact.restype = None
    return lib


def _ascii(s: Union[str, bytes]) -> bytes:
    return s.encode("ascii") if isinstance(s, str) else s


def rle_encode_counts(mask: np.ndarray) -> np.ndarray:
    """(H, W) {0, 1} mask -> column-major run lengths, the first run counting zeros."""
    flat = np.ascontiguousarray(np.asarray(mask, np.uint8).flatten(order="F"))
    if not flat.size:
        return np.zeros(0, np.int64)
    counts = np.empty(flat.size + 2, np.int64)
    n = int(library().rle_encode_counts(flat, flat.size, counts))
    return counts[:n].copy()


def rle_counts_to_string(counts: np.ndarray) -> str:
    """Run lengths -> the compressed string (delta coding, 6-bit chars + 48)."""
    c = np.ascontiguousarray(np.asarray(counts, np.int64))
    buf = ctypes.create_string_buffer(8 * max(len(c), 1))
    m = library().rle_counts_to_string(c, len(c), buf)
    return buf.raw[:m].decode("ascii")


def rle_string_to_counts(s: Union[str, bytes]) -> np.ndarray:
    b = _ascii(s)
    counts = np.empty(max(len(b), 1), np.int64)
    n = library().rle_string_to_counts(b, len(b), counts)
    return counts[:n].copy()


def rle_decode_counts(counts: np.ndarray, total: int) -> np.ndarray:
    """Run lengths -> the column-major flat uint8 mask of ``total`` pixels."""
    c = np.ascontiguousarray(np.asarray(counts, np.int64))
    flat = np.zeros(total, np.uint8)
    library().rle_decode_counts(c, len(c), flat, total)
    return flat


def rle_string_decode(s: Union[str, bytes], total: int) -> np.ndarray:
    """The compressed string -> the column-major flat uint8 mask, in one pass."""
    b = _ascii(s)
    flat = np.zeros(total, np.uint8)
    library().rle_string_decode(b, len(b), flat, total)
    return flat


def rle_encode(mask: np.ndarray) -> Dict:
    """(H, W) {0, 1} mask -> COCO compressed RLE dict."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": rle_counts_to_string(rle_encode_counts(mask))}


def rle_decode(rle: Dict) -> np.ndarray:
    """COCO RLE dict (compressed string or uncompressed counts) -> (H, W) uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        flat = rle_string_decode(counts, h * w)
    else:
        flat = rle_decode_counts(counts, h * w)
    return flat.reshape((h, w), order="F")


def downsample_mask_exact(mask: np.ndarray, out: int) -> Optional[np.ndarray]:
    """Area-average downsample of an (H, W) mask to (out, out), thresholded
    at 0.5; None unless H and W are multiples of ``out``."""
    h, w = mask.shape
    if h % out or w % out:
        return None
    src = np.ascontiguousarray(mask, np.float32)
    dst = np.empty((out, out), np.float32)
    library().downsample_mask_exact(src, h, w, out, dst)
    return dst
