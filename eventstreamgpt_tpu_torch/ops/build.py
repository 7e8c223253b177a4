"""Building the port's kernels at first use, inside the checkout.

CUDA sources under ``eventstreamgpt_tpu_torch/csrc/`` compile with ``nvcc``
into shared libraries with a plain C interface, loaded with ``ctypes``;
Triton kernels compile at their first launch. Everything built goes under
``<checkout>/build/`` (``.gitignore`` lists it): the libraries in
``build/kernels/``, Triton's cache in ``build/triton/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
KERNEL_DIR = BUILD_DIR / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: named by the source's content hash."""
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return KERNEL_DIR / f"{Path(source).stem}-{digest}.so"


def compile_command(source: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(library_path(source)), str(CSRC_DIR / source)]


def build_all(sources: list[str]) -> dict[str, Path]:
    """Compiles every source not built yet, one ``nvcc`` per source, all at once."""
    KERNEL_DIR.mkdir(parents=True, exist_ok=True)
    procs = {
        s: subprocess.Popen(compile_command(s), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s in sources
        if not library_path(s).exists()
    }
    for s, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{s} (exit {p.returncode}):\n{out}")
    return {s: library_path(s) for s in sources}


def load_library(source: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``csrc/<source>``, built first if needed."""
    if source not in _LIBS:
        path = build_all([source])[source]
        _LIBS[source] = ctypes.CDLL(str(path))
    return _LIBS[source]


def triton_modules():
    """Imports Triton with its cache inside the checkout; returns ``(triton, tl)``."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    return triton, tl
