"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface. At first use it is
compiled for Hopper (`sm_90a`) into a shared library under
`cmgan_torch/ops/_build/<name>-<hash>/`, keyed by a hash of the source,
of every header under `csrc/` it includes, and of the flags, and loaded
with `ctypes`. Nothing here includes PyTorch's
headers, so a build takes seconds. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
    "--split-compile=0",  # a source's kernels compile side by side (nvcc 12.1 or later)
)


@dataclasses.dataclass(frozen=True)
class Build:
    path: str        # the shared library
    seconds: float   # nvcc wall time, 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register / shared-memory report)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is not None and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return nvcc


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[str]:
    """csrc/<name>.cu and, in the order met, every file under csrc/ that it
    includes with quotes, directly or through another such file."""
    files, todo = [], [f"{name}.cu"]
    while todo:
        rel = todo.pop(0)
        path = os.path.join(CSRC, rel)
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            todo += [os.path.normpath(os.path.join(os.path.dirname(rel), inc.decode()))
                     for inc in _INCLUDE.findall(f.read())]
    return files


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_ROOT, f"{name}-{digest.hexdigest()[:16]}", f"lib{name}.so")


def build(name: str) -> Build:
    """Compile csrc/<name>.cu unless a library of the same source exists."""
    path = library_path(name)
    if os.path.exists(path):
        return Build(path, 0.0, "")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # build under a temporary name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, path)
    return Build(path, seconds, log)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built at first use."""
    return ctypes.CDLL(build(name).path)
