"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and is
compiled by ``nvcc`` into ``rpvg_tpu_torch/build/lib<name>.so`` at first
use, then loaded with ``ctypes``.  A library older than its source is
rebuilt.  Nothing here runs at import time: the CPU test host has no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Dict, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills of every kernel, on stderr.
    "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_library(name: str, force: bool = False) -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu`` when the library is missing, stale or
    ``force`` is set.  Returns (library path, nvcc's stderr — the
    ``-Xptxas -v`` report — or "" when nothing was built)."""
    src = source_path(name)
    out = library_path(name)
    if (
        not force
        and os.path.exists(out)
        and os.path.getmtime(out) >= os.path.getmtime(src)
    ):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed for {name} (rc={result.returncode}):\n{result.stderr}"
        )
    os.replace(tmp, out)
    return out, result.stderr


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so``; cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        path, _ = build_library(name)
        lib = ctypes.CDLL(path)
        _LOADED[name] = lib
    return lib
