"""The native (C++) host feature front end through ctypes (counterpart:
asv_subtools_tpu/features/native.py).

``runtime/frontend/feature.cc`` computes Kaldi fbank and MFCC on one host
thread about 2.9x faster than the numpy chain (JAX native.py's
measurement), and agrees with the port's host features at 1e-3 (fbank)
and 2e-3 (MFCC): another FFT and accumulation order, not bit for bit. The
library is built from the checkout at first use (kernels/_build.py
``build_capi``: plain ``c++``, no CUDA) into
``asv_subtools_tpu_torch/build/``.

The C API takes the mel bin count, the sample rate, the cepstra count and
the energy flags; every other option is fixed at Kaldi's defaults. Two
choices differ from JAX's module: an option the C API cannot express
raises ``ValueError`` naming it (JAX returns None and its caller computes
that utterance with numpy), and a missing compiler or a failed build
raises (JAX returns None). :func:`unsupported_option` answers the question
without raising, for the ``"auto"`` backend's choice.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class NativeCallError(RuntimeError):
    """The C function returned an error (-1) for one wave."""


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises when it cannot be).
    The loader's threads may ask at once: one builds and loads."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _build_and_load()
    return _LIB


def _build_and_load() -> ctypes.CDLL:
    from ..kernels._build import CAPI_LIB, build_capi

    build_capi()
    lib = ctypes.CDLL(str(CAPI_LIB))
    f32p, i, f = ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float
    lib.asvtpu_fbank.argtypes = [f32p, i, i, f, i, i, i, f32p, i]
    lib.asvtpu_fbank.restype = i
    lib.asvtpu_mfcc.argtypes = [f32p, i, i, i, f, i, f32p, i]
    lib.asvtpu_mfcc.restype = i
    return lib


def native_available() -> bool:
    """Whether the library could be built and loaded here."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


def _frame_option(fo) -> Optional[str]:
    """The first frame option off the Kaldi default the C API fixes."""
    checks = (
        ("dither", abs(fo.dither) < 1e-12),
        ("preemph_coeff", abs(fo.preemph_coeff - 0.97) < 1e-9),
        ("window_type", fo.window_type == "povey"),
        ("remove_dc_offset", fo.remove_dc_offset),
        ("round_to_power_of_two", fo.round_to_power_of_two),
        ("snip_edges", fo.snip_edges),
        ("frame_shift_ms", abs(fo.frame_shift_ms - 10.0) < 1e-9),
        ("frame_length_ms", abs(fo.frame_length_ms - 25.0) < 1e-9),
    )
    return next((name for name, ok in checks if not ok), None)


def _mel_option(mo) -> Optional[str]:
    """The C API forwards only num_bins; low/high freq must be the C++
    defaults or the output would silently differ."""
    if abs(mo.low_freq - 20.0) >= 1e-9:
        return "low_freq"
    if abs(mo.high_freq - 0.0) >= 1e-9:
        return "high_freq"
    return None


def unsupported_option(opts, kind: str = "fbank") -> Optional[str]:
    """The name of the first option of ``opts`` (FbankOptions for
    ``kind="fbank"``, MfccOptions for ``"mfcc"``) that the C API cannot
    express, or None (the checks of JAX native.py:54-76, 102-111)."""
    if kind == "fbank" and opts.use_energy:
        return "use_energy"
    bad = _frame_option(opts.frame_opts) or _mel_option(opts.mel_opts)
    if bad or kind == "fbank":
        return bad
    if abs(getattr(opts, "cepstral_lifter", 22.0) - 22.0) > 1e-9:
        return "cepstral_lifter"
    if getattr(opts, "energy_floor", 0.0) != 0.0:
        return "energy_floor"
    return None


def _check(opts, kind: str) -> None:
    bad = unsupported_option(opts, kind)
    if bad is not None:
        raise ValueError(f"the native front end cannot express {kind} option {bad!r} (the C API fixes it at "
                         "Kaldi's default); use backend='numpy'")


def _call(fn, wave: np.ndarray, dim: int, frame_shift: int, *args) -> np.ndarray:
    w = np.ascontiguousarray(np.asarray(wave, np.float32))
    out = np.zeros((len(w) // frame_shift + 2) * dim, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    nf = fn(w.ctypes.data_as(f32p), len(w), *args, out.ctypes.data_as(f32p), len(out))
    if nf < 0:
        raise NativeCallError(f"the native front end failed on a wave of {len(w)} samples")
    return out[: nf * dim].reshape(nf, dim).copy()


def native_fbank(wave: np.ndarray, opts) -> np.ndarray:
    """[S] float32 -> [T, num_bins] float32 log-mel fbank by the C++ front
    end. Raises ValueError for an option it cannot express."""
    _check(opts, "fbank")
    nb = int(opts.mel_opts.num_bins)
    fo = opts.frame_opts
    return _call(load().asvtpu_fbank, wave, nb, int(fo.samp_freq * 0.001 * 10), nb, fo.samp_freq, 0,
                 int(opts.use_power), int(opts.use_log_fbank))


def native_mfcc(wave: np.ndarray, opts) -> np.ndarray:
    """[S] float32 -> [T, num_ceps] float32 MFCC by the C++ front end.
    Raises ValueError for an option it cannot express."""
    _check(opts, "mfcc")
    nb, nc = int(opts.mel_opts.num_bins), int(opts.num_ceps)
    fo = opts.frame_opts
    return _call(load().asvtpu_mfcc, wave, nc, int(fo.samp_freq * 0.001 * 10), nb, nc, fo.samp_freq,
                 int(opts.use_energy))
