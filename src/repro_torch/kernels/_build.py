"""Build the hand-written CUDA kernels with nvcc into shared libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled for
``sm_90a`` at first use into its own library under
``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``).  ``baselines/<name>.cu`` holds an earlier design of a
kernel, built the same way only to time the current one against.  A
library's file name carries a hash of its source and flags, so a stale
library is never loaded.  The wrappers load the results
with ``ctypes``.  ``build_all`` starts one nvcc per source at once.
``device_sms`` gives the launch plans of both wrappers the card's SM count.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC", "BASELINES", "BUILD_DIR", "SMS", "names", "source", "library_path",
           "build", "build_all", "ptxas_report", "device_sms"]

CSRC = Path(__file__).resolve().parent / "csrc"
BASELINES = Path(__file__).resolve().parent / "baselines"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: SMs of an H100 SXM, for a launch plan asked for without a device.
SMS = 132

_sms = {}


def device_sms(device) -> int:
    """SMs of a CUDA device (cached): the card a launch plan is made for; an
    H100's ``SMS`` for the meta device (the dry run reckons for the card)."""
    if device.type == "meta":
        return SMS
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device.index]


def _nvcc() -> str:
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    found = cuda_home / "bin" / "nvcc"
    if found.exists():
        return str(found)
    on_path = shutil.which("nvcc")
    if on_path is None:
        raise RuntimeError(f"nvcc not found under {cuda_home} or on PATH")
    return on_path


def names() -> list[str]:
    """Every kernel source under ``csrc/``, by stem."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def source(name: str) -> Path:
    """``csrc/<name>.cu``, else ``baselines/<name>.cu``."""
    path = CSRC / f"{name}.cu"
    return path if path.exists() else BASELINES / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the library built from the current source of ``name`` lives."""
    h = hashlib.sha256(source(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(kernels: list[str] | None = None) -> dict[str, Path]:
    """Build each named kernel (default: every one under ``csrc/``) unless a
    library built from the same source exists, one nvcc per source, all
    started together.  Returns
    ``{name: library path}``.  Each compiler report (registers, shared
    memory, spills) is kept beside its library as ``.log``.  Raises with the
    compiler's output if a build fails."""
    kernels = names() if kernels is None else kernels
    libs = {name: library_path(name) for name in kernels}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp)
    failed = []
    for name, (proc, tmp) in running.items():
        report, _ = proc.communicate()
        lib = libs[name]
        lib.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{report}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return libs


def build(name: str) -> Path:
    """Build one kernel's library (see ``build_all``) and return its path."""
    return build_all([name])[name]


def ptxas_report(text: str) -> list[tuple[str, str]]:
    """[(entry function, 'registers, shared memory, spills')] from the
    ``nvcc -Xptxas -v`` report of one library.  Entry functions are
    demangled to ``name<template arguments>`` where ``c++filt`` exists."""
    out, fn, info = [], None, []
    for ln in text.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            if fn:
                out.append((fn, "; ".join(info)))
            fn, info = ln.split("'")[1], []
        elif fn and ("spill" in ln or "registers" in ln):
            info.append(ln.replace("ptxas info    : ", ""))
    if fn:
        out.append((fn, "; ".join(info)))
    tool = shutil.which("c++filt")
    if tool is None or not out:
        return [(fn[:90], info) for fn, info in out]
    names = subprocess.run([tool], input="\n".join(fn for fn, _ in out), text=True,
                           capture_output=True, check=True).stdout.splitlines()
    short = [n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
             for n in names]
    return [(name, info) for name, (_, info) in zip(short, out)]
