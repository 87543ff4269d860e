"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under the
repository's ``build/`` directory and loaded with ``ctypes``. The library's
file name carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded. The hash also covers the
headers of ``csrc/`` that the source includes (``#include "<name>.cuh"``),
so an edited header rebuilds every library that includes it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def library_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    headers = sorted({h.decode() for h in INCLUDE.findall(text)})
    parts = [text] + [(CSRC / h).read_bytes() for h in headers]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the library's path."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}.cu (nvcc exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name)))


@lru_cache(maxsize=None)
def stream_query():
    """A function from a device index to its current CUDA stream's handle,
    resolved once: the raw query skips building a Stream object on every
    launch; it is private to torch, so the public query stands in where it
    is missing."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        def raw(index: int) -> int:
            return torch.cuda.current_stream(index).cuda_stream
    return raw


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise for a non-zero ``cudaError_t`` returned by one of ``lib``'s entry points."""
    if rc != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} ({lib.cuda_error_string(rc).decode()})")
