"""Fused Kaldi log-mel fbank: the wrapper of kernel K1 and its plain version.

Replaces asv_subtools_tpu/features/pallas_fbank.py `fused_fbank` (the
Pallas kernel at :228/:283). The CUDA source is csrc/fbank.cu; its header
note gives the design and the bound on an H100.

Window processing is linear, so DC removal, preemphasis and the window
fold on the host, in float64, into one effective DFT matrix
``eff = (M0 D A diag(win)) @ [C | S]`` of shape [window, 2 * padded/2]
(pallas_fbank.py:103-124). The kernel then does one product, the power,
the mel product and the log. The TPU kernel's 128-lane frame groups and
tile choice are layout devices of that chip and have no counterpart here.

``dft_dtype=torch.bfloat16`` (the serving setting) rounds the raw samples
and the folded matrix to bf16 and sums their products in f32, as the TPU
kernel does; the plain version reproduces the same rounding points.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import _build
from .config import EPSILON, FbankOptions
from .functional import check_extraction_options, dft_matrices, feature_window, mel_banks

_CHUNK = 16  # folded-matrix rows per shared-memory chunk in csrc/fbank.cu
_SIGNATURES = {
    "asv_fbank_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_size_t),
    "asv_fbank_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
                         ctypes.c_int),
}


@functools.lru_cache(maxsize=None)
def folded_dft(opts: FbankOptions) -> np.ndarray:
    """Host precompute: [window_pad, 2*keep] float32 effective DFT matrix,
    rows past the window zero (window_pad = window rounded up to 16)."""
    fo = opts.frame_opts
    w, padded = fo.window_size, fo.padded_window_size
    # E = M0 . D . A . diag(win) acting on row-vector frames (f @ E):
    # M0 zeroes samples past the window, D subtracts the window mean, A
    # applies preemphasis, diag(win) multiplies the window function.
    e = np.zeros((padded, padded), np.float64)
    e[:w, :w] = np.eye(w)
    if fo.remove_dc_offset:
        e[:w, :w] -= 1.0 / w
    if fo.preemph_coeff != 0.0:
        p = float(fo.preemph_coeff)
        a = np.eye(padded)
        a[np.arange(w - 1), np.arange(1, w)] = -p
        a[0, 0] = 1.0 - p
        e = e @ a
    win = np.zeros(padded, np.float64)
    win[:w] = feature_window(fo)
    e = e * win[None, :]
    keep = padded // 2
    c, s = dft_matrices(padded, keep)
    cs = np.concatenate([np.asarray(c, np.float64), np.asarray(s, np.float64)], axis=1)
    window_pad = -(-w // _CHUNK) * _CHUNK
    eff = np.zeros((window_pad, 2 * keep), np.float32)
    eff[:w] = (e @ cs)[:w]
    return eff


@functools.lru_cache(maxsize=None)
def mel_bands(opts: FbankOptions) -> Tuple[np.ndarray, np.ndarray]:
    """Each mel filter's band of non-zero weights: meta [nb, 3] int32 =
    (first bin, count, offset into weights), weights [nnz] float32."""
    mel = mel_banks(opts.mel_opts, opts.frame_opts)  # [keep, nb]
    meta, weights, off = [], [], 0
    for m in range(mel.shape[1]):
        nz = np.nonzero(mel[:, m])[0]
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        meta.append((lo, hi - lo, off))
        weights.append(mel[lo:hi, m])
        off += hi - lo
    return np.asarray(meta, np.int32), np.concatenate(weights).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _constants(opts: FbankOptions, dft_bf16: bool, device: torch.device):
    eff = torch.as_tensor(folded_dft(opts), device=device)
    if dft_bf16:
        eff = eff.to(torch.bfloat16)
    meta, weights = mel_bands(opts)
    mel = torch.as_tensor(mel_banks(opts.mel_opts, opts.frame_opts), device=device)
    return (eff, torch.as_tensor(meta, device=device),
            torch.as_tensor(weights, device=device), mel)


def _num_frames(wave: torch.Tensor, opts: FbankOptions) -> int:
    check_extraction_options(opts.frame_opts)
    if wave.dim() != 2:
        raise ValueError(f"wave must be [B, S], got shape {tuple(wave.shape)}")
    t = opts.frame_opts.num_frames(wave.shape[1])
    if t <= 0:
        raise ValueError("waveform too short")
    return t


def _dft_bf16(dft_dtype: torch.dtype) -> bool:
    if dft_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dft_dtype must be float32 or bfloat16, got {dft_dtype}")
    return dft_dtype == torch.bfloat16


def fused_fbank_plain(
    wave: torch.Tensor,
    opts: FbankOptions = FbankOptions(),
    dft_dtype: torch.dtype = torch.float32,
    with_energy: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: the folded DFT product in f32,
    or with bf16-rounded operands and f32 sums."""
    t = _num_frames(wave, opts)
    bf16 = _dft_bf16(dft_dtype)
    fo = opts.frame_opts
    window, keep = fo.window_size, fo.padded_window_size // 2
    eff, _, _, mel = _constants(opts, bf16, wave.device)
    frames = wave.to(torch.float32).unfold(-1, window, fo.window_shift)[:, :t]
    x = frames.to(torch.bfloat16).float() if bf16 else frames
    reim = x @ eff[:window].float()
    re, im = reim[..., :keep], reim[..., keep:]
    power = re * re + im * im
    if not opts.use_power:
        power = torch.sqrt(power)
    out = power @ mel
    if opts.use_log_fbank:
        out = torch.log(torch.clamp_min(out, EPSILON))
    if not with_energy:
        return out, None
    es = frames.sum(-1)
    es2 = (frames * frames).sum(-1)
    energy = es2 - es * es / float(window) if fo.remove_dc_offset else es2
    return out, torch.log(torch.clamp_min(energy, EPSILON))


def _launch_kernel(wave, opts, bf16, with_energy, t):
    fo = opts.frame_opts
    b, s = wave.shape
    keep = fo.padded_window_size // 2
    if keep != 256:
        raise ValueError(
            f"the fbank kernel takes a padded window of 512 samples, got {fo.padded_window_size}")
    if fo.window_shift % 4:
        raise ValueError(f"the fbank kernel needs a frame shift that is a multiple of 4, got {fo.window_shift}")
    if wave.dtype != torch.float32:
        raise ValueError(f"wave must be float32, got {wave.dtype}")
    wave = wave.contiguous()
    eff, meta, weights, _ = _constants(opts, bf16, wave.device)
    nb = opts.mel_opts.num_bins
    lib = _build.load("fbank", _SIGNATURES)
    smem = lib.asv_fbank_smem_bytes(fo.window_shift, eff.shape[0], nb, weights.numel())
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"frame geometry needs {smem} bytes of shared memory, above {_build.SMEM_LIMIT}")
    out = torch.empty((b, t, nb), dtype=torch.float32, device=wave.device)
    energy = torch.empty((b, t), dtype=torch.float32, device=wave.device) if with_energy else None
    with torch.cuda.device(wave.device):
        code = lib.asv_fbank_launch(
            wave.data_ptr(), eff.data_ptr(), meta.data_ptr(), weights.data_ptr(),
            out.data_ptr(), energy.data_ptr() if with_energy else None,
            b, s, t, fo.window_shift, fo.window_size, eff.shape[0], nb, weights.numel(),
            int(opts.use_power), int(opts.use_log_fbank), int(fo.remove_dc_offset), int(bf16),
            torch.cuda.current_stream(wave.device).cuda_stream,
        )
    _build.check(lib, code, "fbank kernel")
    fused_fbank.launches += 1
    return out, energy


def fused_fbank(
    wave: torch.Tensor,
    opts: FbankOptions = FbankOptions(),
    dft_dtype: torch.dtype = torch.float32,
    with_energy: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """wave [B, S] -> (log-mel [B, T, num_bins] f32, raw log-energy [B, T] or None).

    dither=0, snip_edges=True semantics; raises otherwise. On a CPU tensor
    this is :func:`fused_fbank_plain`; on a CUDA tensor it launches
    csrc/fbank.cu. ``fused_fbank.launches`` counts kernel launches.
    """
    if wave.device.type == "cpu":
        return fused_fbank_plain(wave, opts, dft_dtype, with_energy)
    if wave.device.type != "cuda":
        raise ValueError(f"fused_fbank runs on cpu or cuda tensors, got {wave.device}")
    return _launch_kernel(wave, opts, _dft_bf16(dft_dtype), with_energy, _num_frames(wave, opts))


fused_fbank.launches = 0
