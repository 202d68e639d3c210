"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source ``asv_subtools_tpu_torch/csrc/<name>.cu`` has a plain C
interface. It is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``asv_subtools_tpu_torch/build/lib<name>.so`` (listed in ``.gitignore``)
and loaded with ``ctypes``. A library is rebuilt when its source, or a
shared header (``csrc/*.cuh``), is newer than it. Every launch function
returns ``cudaGetLastError()``; the wrappers pass it to :func:`check`,
which raises if it is not 0.

The native host front end (``runtime/capi.cc`` over
``runtime/frontend/feature.cc``) is built here too, by :func:`build_capi`:
plain ``c++`` with the flags of ``runtime/CMakeLists.txt``, into
``build/libasvtpu_capi.so``. It is host code and needs no CUDA.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only install has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("fbank", "att_pooling", "res2_chain", "stats_pooling")
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

RUNTIME = _PKG.parent / "runtime"
CAPI_SOURCES = ("capi.cc", "frontend/feature.cc")
CAPI_LIB = BUILD_DIR / "libasvtpu_capi.so"
CXX_FLAGS = ("-std=c++17", "-O3", "-march=native", "-fPIC", "-shared")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """A library is stale when its source, or any shared header, is newer."""
    lib = _lib_path(name)
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return not lib.exists() or lib.stat().st_mtime < max(f.stat().st_mtime for f in sources)


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile the stale libraries, one ``nvcc`` per source, all started
    together. Returns the seconds spent. Raises with the compiler's output
    if a build fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C function to ``(argtypes, restype)``; they are
    bound once, at the first load (pointers and the stream as c_void_p)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.asv_error_string.argtypes = [ctypes.c_int]
        lib.asv_error_string.restype = ctypes.c_char_p
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return lib


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device: the persistent kernels
    size their grids by it."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib.asv_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _capi_stale(lib: Path) -> bool:
    sources = [RUNTIME / f for f in CAPI_SOURCES] + list((RUNTIME / "frontend").glob("*.h"))
    return not lib.exists() or lib.stat().st_mtime < max(f.stat().st_mtime for f in sources)


def build_capi(lib: Optional[Path] = None) -> float:
    """Compile ``libasvtpu_capi.so`` (the native host front end) with
    ``c++`` into ``lib`` (default ``CAPI_LIB``) when it is missing or
    older than a source or a header of ``runtime/frontend/``. The library
    is written under a temporary name and renamed, so concurrent builders
    never load a half-written file (the name holds the process and the
    thread). Returns the seconds spent; raises with
    the compiler's output if the compiler is missing or the build fails."""
    lib = Path(lib) if lib is not None else CAPI_LIB
    if not _capi_stale(lib):
        return 0.0
    cxx = shutil.which(os.environ.get("CXX", "c++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++) on PATH: the native host front end cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-I", str(RUNTIME), "-o", str(tmp), *(str(RUNTIME / f) for f in CAPI_SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native front end failed ({' '.join(cmd)}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0
