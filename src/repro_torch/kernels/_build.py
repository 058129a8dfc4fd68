"""Build the hand-written CUDA kernel with nvcc into a shared library.

The kernel is ``csrc/flash_attention.cu`` with a plain C interface, compiled
for ``sm_90a`` at first use into ``build/repro_torch_kernels/`` at the root
of the checkout (listed in ``.gitignore``).  The library's file name carries
a hash of its source and flags, so a stale library is never loaded.  The
wrapper loads the result with ``ctypes``.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "library_path", "build"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    found = cuda_home / "bin" / "nvcc"
    if found.exists():
        return str(found)
    on_path = shutil.which("nvcc")
    if on_path is None:
        raise RuntimeError(f"nvcc not found under {cuda_home} or on PATH")
    return on_path


def library_path() -> Path:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{SOURCE.stem}-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the kernel's library unless one built from the same source
    exists, and return its path.  The compiler's report (registers, shared
    memory, spills) is kept beside it as ``.log``.  Raises with the
    compiler's output if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lib.with_suffix(".log").write_text(res.stdout)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed (nvcc exit {res.returncode}):\n"
                           f"{res.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib
