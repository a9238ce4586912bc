"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each kernel keeps its source under ``<kernel>/csrc/`` with a plain C entry
point (pointers and the stream as ``void*``, returning ``cudaGetLastError()``
as an int).  On first use the source is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library under
``kernels/_build/``, named by a hash of every file under the source's
``csrc/`` (the source and any header it includes from there, with ``-I``
that directory) so that an edited source or header is rebuilt, and loaded
with :mod:`ctypes`.  Nothing is built on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

#: kernel name → its CUDA source, relative to this directory
SOURCES: Dict[str, str] = {
    "decode_attention": "decode_attention/csrc/decode_attention.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "ssd_scan": "ssd_scan/csrc/ssd_scan.cu",
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    csrc = (KERNELS_DIR / SOURCES[name]).parent
    h = hashlib.sha1()
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(csrc)).encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _build(name: str) -> Path:
    """Compile ``name``'s source unless its library is built; nvcc's output
    (with ptxas's register and spill report) goes to a ``.log`` beside it."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    src = KERNELS_DIR / SOURCES[name]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(src.parent), "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out.with_suffix(".log").write_text(res.stdout)
    if res.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name} (rc {res.returncode}):\n{res.stdout}")
    os.replace(tmp, out)  # a finished library appears whole
    return out


def build_all() -> None:
    """Compile every source that is not built yet, one nvcc process per
    source, all started together."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        list(pool.map(_build, SOURCES))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _loaded[name] = lib
        return lib
