"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source ``asv_subtools_tpu_torch/csrc/<name>.cu`` has a plain C
interface. It is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``asv_subtools_tpu_torch/build/lib<name>.so`` (listed in ``.gitignore``)
and loaded with ``ctypes``. A library is rebuilt when its source, or a
shared header (``csrc/*.cuh``), is newer than it. Every launch function
returns ``cudaGetLastError()``; the wrappers pass it to :func:`check`,
which raises if it is not 0.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only install has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("fbank", "att_pooling", "res2_chain", "stats_pooling")
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

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
