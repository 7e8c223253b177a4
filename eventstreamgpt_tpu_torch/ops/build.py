"""Building the port's kernels at first use, inside the checkout.

CUDA sources under ``eventstreamgpt_tpu_torch/csrc/`` compile with ``nvcc``
(without fast math) into shared libraries with a plain C interface, loaded
with ``ctypes``. Everything built goes under ``<checkout>/build/kernels/``
(``.gitignore`` lists ``build/``).
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

_LIBS: dict[tuple, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def library_path(source: str, defines: tuple[str, ...] = ()) -> Path:
    """Where ``csrc/<source>`` (or the file at an absolute ``source``) builds
    to with the ``-D`` macros ``defines``: named by content and flags hash."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join((*NVCC_FLAGS, *defines)).encode()).hexdigest()[:16]
    return KERNEL_DIR / f"{src.stem}-{digest}.so"


def compile_command(source: str, defines: tuple[str, ...] = ()) -> list[str]:
    macros = [f"-D{d}" for d in defines]
    return [nvcc_path(), *NVCC_FLAGS, *macros, "-o", str(library_path(source, defines)), str(CSRC_DIR / source)]


def build_all(sources: list) -> dict:
    """Compiles every source not built yet, one ``nvcc`` per source, all at
    once. A source is a name under ``csrc/`` or a ``(source, defines)`` pair;
    returns each one's library path."""
    jobs = {s: (s, ()) if isinstance(s, str) else s for s in sources}
    KERNEL_DIR.mkdir(parents=True, exist_ok=True)
    procs = {
        s: subprocess.Popen(compile_command(*job), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, job in jobs.items()
        if not library_path(*job).exists()
    }
    for s, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {jobs[s][0]} {' '.join(jobs[s][1])} (exit {p.returncode}):\n{out}")
    return {s: library_path(*job) for s, job in jobs.items()}


def load_library(source: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``csrc/<source>`` built with ``defines``, built first if needed."""
    key = (source, tuple(defines))
    if key not in _LIBS:
        _LIBS[key] = ctypes.CDLL(str(build_all([key])[key]))
    return _LIBS[key]

