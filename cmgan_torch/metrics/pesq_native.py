"""ctypes binding to the port's native wideband-PESQ library.

`native/pesq/pesq.cc` is compiled with g++ at first use into
`cmgan_torch/native/pesq/_build/<hash>/libcmgan_pesq.so`, keyed by a
hash of the source and the flags. It builds or raises: there is no
other scorer to fall back to. Host code, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "pesq"
)
SOURCE = os.path.join(NATIVE_DIR, "pesq.cc")
BUILD_ROOT = os.path.join(NATIVE_DIR, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None


def find_compiler() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: it is needed to build the PESQ scorer")
    return cxx


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, digest, "libcmgan_pesq.so")


def build() -> str:
    """Compile pesq.cc unless a library of the same source exists."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = find_compiler()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # build under a temporary name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed for pesq.cc:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            dptr = ctypes.POINTER(ctypes.c_double)
            lib.cmgan_pesq_wb.restype = ctypes.c_double
            lib.cmgan_pesq_wb.argtypes = [dptr, dptr, ctypes.c_long]
            lib.cmgan_pesq_wb_batch.restype = None
            lib.cmgan_pesq_wb_batch.argtypes = [dptr, dptr, ctypes.c_long, ctypes.c_long, dptr]
            _lib = lib
        return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def pesq(sample_rate: int, ref, deg, mode: str = "wb") -> float:
    """Wideband PESQ MOS-LQO. Signature mirrors the `pesq` wheel."""
    if mode != "wb":
        raise ValueError("only wideband (P.862.2) mode is supported")
    if sample_rate != 16000:
        raise ValueError("wideband PESQ requires 16 kHz input")
    ref = np.ascontiguousarray(ref, np.float64).reshape(-1)
    deg = np.ascontiguousarray(deg, np.float64).reshape(-1)
    n = min(ref.size, deg.size)
    return float(_load_library().cmgan_pesq_wb(_dptr(ref), _dptr(deg), n))


def pesq_batch(ref: np.ndarray, deg: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
    """Score a batch of equal-length pairs: ref, deg [B, N] -> [B]."""
    if sample_rate != 16000:
        raise ValueError("wideband PESQ requires 16 kHz input")
    ref = np.ascontiguousarray(ref, np.float64)
    deg = np.ascontiguousarray(deg, np.float64)
    if ref.shape != deg.shape or ref.ndim != 2:
        raise ValueError(f"expected two [B, N] arrays, got {ref.shape} and {deg.shape}")
    b, n = ref.shape
    out = np.empty(b, np.float64)
    _load_library().cmgan_pesq_wb_batch(_dptr(ref), _dptr(deg), b, n, _dptr(out))
    return out
