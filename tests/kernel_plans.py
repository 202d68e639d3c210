"""The launch plans of kernels K2-K4 on the CPU.

asv_subtools_tpu_torch/csrc/launch_plan.h holds each plan once; its
kernels' launchers plan with it on the card. Here the same header runs in
a host library that kernels._build.build_host compiles from
tests/kernel_plans.cc, bound with ctypes, behind the small Python face
the CPU tests use.
"""

import ctypes
import functools
from pathlib import Path

from asv_subtools_tpu_torch.kernels import _build

LIB = _build.BUILD_DIR / "libkernel_plans.so"

_LL = ctypes.c_longlong
_P = ctypes.POINTER(_LL)
_SIGNATURES = {
    "asv_plan_smem_limit": ([], ctypes.c_int),
    "asv_plan_att": ([ctypes.c_int] * 5 + [_P], ctypes.c_int),
    "asv_plan_res2_cuda_core": ([ctypes.c_int] * 4 + [_P], ctypes.c_int),
    "asv_plan_res2_tensor_core": ([ctypes.c_int] * 4 + [_P], ctypes.c_int),
    "asv_plan_res2": ([ctypes.c_int] * 6 + [_P], ctypes.c_int),
    "asv_plan_stats_t_splits": ([ctypes.c_int] * 4, ctypes.c_int),
    "asv_plan_stats_spans": ([ctypes.c_int] * 6 + [_P], None),
    "asv_plan_stats": ([ctypes.c_ulonglong, ctypes.c_int, _LL, _LL] + [ctypes.c_int] * 5 + [_P], ctypes.c_int),
}
RES2_FIELDS = ("tensor", "tt", "tiles", "rp", "sp", "smem", "bytes")
ATT_FIELDS = ("tensor", "tiles", "kp", "wxt_cols", "w2t_rows", "stats", "glob", "part", "wxt", "w2t", "bytes")
STATS_FIELDS = ("ring", "vec", "blocks", "splits", "span_rows", "bytes")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    _build.build_host(LIB, [Path(__file__).with_suffix(".cc")], _build.CSRC, [_build.CSRC / "launch_plan.h"])
    lib = ctypes.CDLL(str(LIB))
    for fn, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _call(fn, fields, *args):
    """(whether the plan exists and fits, its fields by name)."""
    out = (_LL * len(fields))()
    ok = getattr(_lib(), fn)(*args, out)
    return bool(ok), dict(zip(fields, out))


def smem_limit() -> int:
    return _lib().asv_plan_smem_limit()


def att_plan(b, c, t, k, bf16):
    """K2's plan of a call: route, tiles, units, weight layouts, workspace."""
    return _call("asv_plan_att", ATT_FIELDS, b, c, t, k, int(bf16))


def res2_plan(b, t, h, n, d, bf16):
    """K3's plan as its launcher chooses it."""
    return _call("asv_plan_res2", RES2_FIELDS, b, t, h, n, d, int(bf16))


def tile_plan(t, n, d):
    """(TT, tiles, RP) of K3's CUDA-core kernel; ValueError when the halo
    leaves no room for a tile in the block's rows."""
    _, p = _call("asv_plan_res2_cuda_core", RES2_FIELDS, t, 1, n, d)
    if p["tiles"] == 0:
        raise ValueError(f"dilation {d} with {n} stages leaves no room for a tile")
    return p["tt"], p["tiles"], p["rp"]


def tensor_core_plan(t, h, n, d):
    """(TT, tiles, state rows, part row stride SP, shared-memory bytes) of
    K3's tensor-core kernel, whether or not it fits."""
    _, p = _call("asv_plan_res2_tensor_core", RES2_FIELDS, t, h, n, d)
    if p["tiles"] == 0:
        raise ValueError(f"dilation {d} with {n} stages leaves no room for a tile")
    return p["tt"], p["tiles"], p["rp"], p["sp"], p["smem"]


def t_splits(b, t, d, vec):
    """K4's direct kernel: blocks over T for one (row, D tile)."""
    return _lib().asv_plan_stats_t_splits(b, t, d, vec)


def _spans(ring, b, t, d, vec, blocks):
    out = (_LL * 2)()
    _lib().asv_plan_stats_spans(int(ring), b, t, d, vec, blocks, out)
    return tuple(out)


def direct_plan(b, t, d, vec):
    """(splits, span_rows) of K4's direct kernel."""
    return _spans(False, b, t, d, vec, 0)


def ring_plan(b, t, d, vec, blocks):
    """(splits, span_rows) of K4's ring kernel on ``blocks`` persistent blocks."""
    return _spans(True, b, t, d, vec, blocks)


def stats_plan(b, t, d, elem_bytes, route=-1, sms=132, address=0, strides=None):
    """K4's plan as its launcher makes it for x [B, T, D] at ``address``
    (strides default to a contiguous x); route -1 lets it choose."""
    sb, st = strides if strides is not None else (t * d, d)
    return _call("asv_plan_stats", STATS_FIELDS, address, elem_bytes, sb, st, b, t, d, route, sms)
