"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source ``asv_subtools_tpu_torch/csrc/<name>.cu`` has a plain C
interface. It is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``asv_subtools_tpu_torch/build/lib<name>.so`` (listed in ``.gitignore``)
and loaded with ``ctypes``. A library is rebuilt when its source, or a
shared header (``csrc/*.cuh``, ``csrc/*.h``), is newer than it. Every
launch function returns ``cudaGetLastError()``; the wrappers pass it to
:func:`check`, which raises if it is not 0. K2-K4's launchers plan their
own launches from ``csrc/launch_plan.h``.

Host libraries are built by :func:`build_host`: plain ``c++`` with the
flags of ``runtime/CMakeLists.txt``, no CUDA. It builds the native front
end (``runtime/capi.cc`` over ``runtime/frontend/feature.cc``) into
``build/libasvtpu_capi.so`` (:func:`build_capi`), and the CPU tests' host
library over ``csrc/launch_plan.h``.

The native runtime (``asv_subtools_tpu_torch/runtime``: the bundle loader,
the CudaExecutor, the kernels' op registrations and the two binaries
``bundle_runner`` and ``asv_extractor_main``) is built by
:func:`build_runtime`: plain ``c++`` against the installed torch's
headers and libraries, linked to the ``nvcc``-built kernel libraries, into
``build/runtime/``. Where torch has no CUDA or there is no ``nvcc`` it
builds a CPU-only variant, whose binaries refuse ``--device=cuda``.

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
SOURCES = ("fbank", "att_pooling", "res2_chain", "stats_pooling", "rel_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--expt-relaxed-constexpr",
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


def _older(out: Path, deps) -> bool:
    """Whether ``out`` is missing or older than one of ``deps``."""
    return not out.exists() or out.stat().st_mtime < max(f.stat().st_mtime for f in deps)


def _headers() -> list:
    """The headers every kernel source may include."""
    return [*CSRC.glob("*.cuh"), *CSRC.glob("*.h")]


def _stale(name: str) -> bool:
    """A library is stale when its source, or any shared header, is newer."""
    return _older(_lib_path(name), [CSRC / f"{name}.cu", *_headers()])


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
    jobs = []
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.{threading.get_ident()}.tmp"
        jobs.append(([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")], tmp, _lib_path(name)))
    _run_all(jobs, "nvcc")
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


def planned_launch(lib: ctypes.CDLL, prefix: str, device, pointers: tuple, facts: tuple, what: str,
                   tail: tuple = ()) -> int:
    """One launch of K2, K3 or K4 (``csrc/launch_plan.h``): the workspace
    ``<prefix>_workspace_bytes(*facts)`` asks for (ValueError where no plan
    takes the call), then ``<prefix>_launch(*pointers, workspace, *facts,
    *tail, &route, stream)`` on the device's current stream. Raises on its
    code; returns the route it took."""
    import torch

    need, route = ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(device):
        if getattr(lib, f"{prefix}_workspace_bytes")(*facts, ctypes.byref(need)):
            raise ValueError(f"no plan of the {what} takes this call {facts} (csrc/launch_plan.h)")
        work = torch.empty(need.value, dtype=torch.uint8, device=device)
        code = getattr(lib, f"{prefix}_launch")(*pointers, work.data_ptr(), *facts, *tail, ctypes.byref(route),
                                                 torch.cuda.current_stream(device).cuda_stream)
    check(lib, code, what)
    return route.value


def build_host(lib: Path, sources: Sequence[Path], include: Path, headers: Sequence[Path]) -> float:
    """Compile host C++ ``sources`` (``-I include``) with ``c++`` into the
    shared library ``lib`` when it is missing or older than a source or one
    of ``headers``. The library is written under a temporary name and
    renamed, so concurrent builders never load a half-written file (the
    name holds the process and the thread). Returns the seconds spent;
    raises with the compiler's output if the compiler is missing or the
    build fails."""
    if not _older(lib, [*sources, *headers]):
        return 0.0
    cxx = shutil.which(os.environ.get("CXX", "c++"))
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (c++) on PATH: {lib.name} cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-I", str(include), "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {lib.name} failed ({' '.join(cmd)}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0


def build_capi(lib: Optional[Path] = None) -> float:
    """Build ``libasvtpu_capi.so``, the native host front end, into ``lib``
    (default ``CAPI_LIB``): :func:`build_host` over ``runtime/capi.cc`` and
    ``runtime/frontend/``."""
    return build_host(Path(lib) if lib is not None else CAPI_LIB, [RUNTIME / f for f in CAPI_SOURCES], RUNTIME,
                      list((RUNTIME / "frontend").glob("*.h")))


RUNTIME_SRC = _PKG / "runtime"
RUNTIME_BUILD = BUILD_DIR / "runtime"
RUNTIME_BINARIES = ("bundle_runner", "asv_extractor_main")
# object -> source; cuda_executor and ops include libtorch's headers (20-40 s each)
_RUNTIME_UNITS = {
    "bundle": RUNTIME_SRC / "bundle.cc",
    "cuda_executor": RUNTIME_SRC / "cuda_executor.cc",
    "ops": RUNTIME_SRC / "ops.cc",
    "feature": RUNTIME / "frontend" / "feature.cc",
    "bundle_runner_main": RUNTIME_SRC / "bin" / "bundle_runner_main.cc",
    "asv_extractor_main": RUNTIME_SRC / "bin" / "asv_extractor_main.cc",
}
_RUNTIME_LINK = {
    "bundle_runner": ("bundle_runner_main", "bundle", "cuda_executor"),
    "asv_extractor_main": ("asv_extractor_main", "bundle", "cuda_executor", "feature"),
}
_OP_KERNELS = ("att_pooling", "res2_chain", "stats_pooling")  # the kernels runtime/ops.cc calls


def runtime_has_cuda() -> bool:
    """Whether :func:`build_runtime` builds the CUDA variant here: torch
    built with CUDA and ``nvcc`` present."""
    import torch

    if torch.version.cuda is None:
        return False
    try:
        _nvcc()
    except RuntimeError:
        return False
    return True


def runtime_binary(name: str, out_dir: Optional[Path] = None) -> Path:
    """The path of a runtime binary (``bundle_runner`` or ``asv_extractor_main``)."""
    if name not in RUNTIME_BINARIES:
        raise ValueError(f"no runtime binary {name!r}; expected one of {RUNTIME_BINARIES}")
    return (Path(out_dir) if out_dir is not None else RUNTIME_BUILD) / name


def _cudart() -> Path:
    """The CUDA runtime library torch loads (its pip package's), else the toolkit's."""
    import torch

    dirs = [Path(torch.__file__).resolve().parent.parent / "nvidia" / "cuda_runtime" / "lib",
            Path(_nvcc()).resolve().parent.parent / "lib64"]
    for d in dirs:
        found = sorted(d.glob("libcudart.so*"))
        if found:
            return found[0]
    raise RuntimeError(f"no libcudart.so under {[str(d) for d in dirs]}")


def _run_all(jobs, what: str) -> None:
    """Run (command, temporary output, final output) jobs in parallel;
    rename each output when its command succeeds, raise with the output of
    every command that failed."""
    procs = [(cmd, tmp, dst, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for cmd, tmp, dst in jobs]
    failed = []
    for cmd, tmp, dst, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{what} failed ({' '.join(map(str, cmd))}):\n{out}")
        else:
            os.replace(tmp, dst)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_runtime(out_dir: Optional[Path] = None, ops: bool = True) -> float:
    """Build the native runtime's two binaries into ``out_dir`` (default
    ``build/runtime/``) when they are missing, older than a source or a
    header (``runtime/frontend/``, ``runtime/utils/`` and the kernels'
    headers, ``csrc/launch_plan.h`` among them, included), or were
    built by another torch or variant. Every translation unit compiles at
    once, one ``c++`` each; objects and binaries are written under
    temporary names and renamed. The CUDA variant (:func:`runtime_has_cuda`)
    first builds the kernel libraries ``runtime/ops.cc`` calls and links
    them with an rpath; ``ops=False`` leaves ``ops.cc`` out (a binary that
    cannot run a package holding the kernels' ops). Returns the seconds
    spent; raises with the compiler's output if a step fails."""
    import torch
    from torch.utils import cpp_extension

    out = Path(out_dir) if out_dir is not None else RUNTIME_BUILD
    cuda = runtime_has_cuda()
    stamp = f"torch {torch.__version__} cuda {cuda} ops {ops}\n"
    stamp_file = out / "BUILD_STAMP"
    binaries = [runtime_binary(name, out) for name in RUNTIME_BINARIES]
    sources = list(_RUNTIME_UNITS.values()) + [*RUNTIME_SRC.glob("*.h"), *(RUNTIME / "frontend").glob("*.h"),
                                               *(RUNTIME / "utils").glob("*.h"), *_headers()]
    libs = [_lib_path(name) for name in _OP_KERNELS] if cuda and ops else []
    fresh = (stamp_file.exists() and stamp_file.read_text() == stamp
             and not any(_stale(name) for name in (_OP_KERNELS if libs else ()))
             and not any(_older(b, sources + libs) for b in binaries))
    if fresh:
        return 0.0
    cxx = shutil.which(os.environ.get("CXX", "c++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++) on PATH: the native runtime cannot be built")
    t0 = time.perf_counter()
    if libs:
        build(_OP_KERNELS)
    out.mkdir(parents=True, exist_ok=True)
    stamp_file.unlink(missing_ok=True)
    torch_lib = Path(torch.__file__).resolve().parent / "lib"
    flags = ["-std=c++17", "-O2", "-fPIC", f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             "-I", str(RUNTIME), "-I", str(RUNTIME_SRC), "-I", str(CSRC)]
    for inc in cpp_extension.include_paths():
        flags += ["-isystem", inc]
    if cuda:
        flags += ["-DASV_WITH_CUDA", "-isystem", str(Path(_nvcc()).resolve().parent.parent / "include")]
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    units = [u for u in _RUNTIME_UNITS if ops or u != "ops"]
    _run_all([([cxx, *flags, "-c", str(_RUNTIME_UNITS[u]), "-o", str(out / f"{u}.o.{tag}")],
               out / f"{u}.o.{tag}", out / f"{u}.o") for u in units], "compiling the native runtime")
    link = ["-L", str(torch_lib), f"-Wl,-rpath,{torch_lib}", "-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        cudart = _cudart()
        link += ["-ltorch_cuda", "-lc10_cuda", str(cudart), f"-Wl,-rpath,{cudart.parent}"]
        if ops:
            link += ["-L", str(BUILD_DIR), f"-Wl,-rpath,{BUILD_DIR}", *(f"-l{name}" for name in _OP_KERNELS)]
    link += ["-lpthread"]
    jobs = []
    for name, objs in _RUNTIME_LINK.items():
        dst = runtime_binary(name, out)
        tmp = dst.with_name(f"{dst.name}.{tag}")
        objs = [*objs, "ops"] if ops else list(objs)
        jobs.append(([cxx, *(str(out / f"{o}.o") for o in objs), "-o", str(tmp), *link], tmp, dst))
    _run_all(jobs, "linking the native runtime")
    stamp_file.write_text(stamp)
    return time.perf_counter() - t0
