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

Two kernels share the source. The bf16 mode runs on the tensor cores
(``mma.sync``) when the frame shift is a multiple of 8 samples (so that a
frame's row starts on a 16-byte boundary of the bf16 span) and the tile's
shared memory fits; it reads the folded matrix from a second constant,
:func:`mma_matrix_index`'s reordering of the same bf16 values. The f32
mode, and bf16 with another frame shift, run the CUDA-core kernel, which
takes a shift that is a multiple of 4. ``fused_fbank.last_route`` says
which kernel the last launch ran.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import _build
from .config import EPSILON, FbankOptions
from .functional import check_extraction_options, cmvn_utterance, dft_matrices, feature_window, mel_banks

_CHUNK = 16      # folded-matrix rows per shared-memory chunk of the CUDA-core kernel in csrc/fbank.cu
_MMA_CHUNK = 32  # rows per ring stage of the tensor-core kernel (kKC there)
_SIGNATURES = {
    "asv_smem_limit": ([], ctypes.c_int),
    "asv_fbank_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_size_t),
    "asv_fbank_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
                         ctypes.c_int),
    "asv_fbank_mma_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_size_t),
    "asv_fbank_mma_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
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


def interleaved_columns(keep: int) -> np.ndarray:
    """Column order of the tensor-core kernel's matrix: column 2c is cos of
    bin c and column 2c + 1 sin of bin c (columns c and keep + c of
    [cos | sin]), so one accumulator fragment holds re and im of a bin."""
    n = np.arange(2 * keep)
    return np.where(n % 2 == 0, n // 2, keep + n // 2)


def mma_matrix_index(rows: int, keep: int = 256) -> np.ndarray:
    """The folded matrix as the tensor-core kernel reads it: for each
    element of [rows/16 k-steps][8 warps][4 quarters][32 lanes][4 registers]
    [2 halves], the flat index ``k * 2 * keep + column`` into [cos | sin].

    A warp owns 64 interleaved columns, 8 tiles of 8. Lane ``4 g + tg`` of a
    ``mma.sync.m16n8k16`` holds of a B tile the column ``g`` and the rows
    ``2 tg, 2 tg + 1`` (register 0) and ``2 tg + 8, 2 tg + 9`` (register 1);
    quarter ``j4`` packs both registers of the tiles ``2 j4`` and
    ``2 j4 + 1`` into the 16 bytes a lane loads at once. A chunk of 32 rows
    is then 32 KB of contiguous memory."""
    if rows % 16 or 2 * keep != 512:
        raise ValueError(f"the tensor-core layout takes rows in 16s and 512 columns, got {rows} x {2 * keep}")
    kst, w, j4, lane, r, h = np.meshgrid(np.arange(rows // 16), np.arange(8), np.arange(4),
                                         np.arange(32), np.arange(4), np.arange(2), indexing="ij")
    g, tg = lane >> 2, lane & 3
    k = 16 * kst + 2 * tg + h + 8 * (r & 1)
    n = 64 * w + 8 * (2 * j4 + (r >> 1)) + g
    return (k * 2 * keep + interleaved_columns(keep)[n]).ravel()


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


@functools.lru_cache(maxsize=None)
def _mma_matrix(opts: FbankOptions, device: torch.device) -> torch.Tensor:
    """The bf16 folded matrix in the tensor-core kernel's order, rows padded
    with zeros to a multiple of 32."""
    eff = folded_dft(opts)
    rows = -(-opts.frame_opts.window_size // _MMA_CHUNK) * _MMA_CHUNK
    padded = np.zeros((rows, eff.shape[1]), np.float32)
    padded[:eff.shape[0]] = eff  # folded_dft pads to 16 rows, never past 32
    flat = torch.as_tensor(padded, device=device).to(torch.bfloat16).reshape(-1)
    return flat[torch.as_tensor(mma_matrix_index(rows, eff.shape[1] // 2), device=device)].contiguous()


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
    if wave.dtype != torch.float32:
        raise ValueError(f"wave must be float32, got {wave.dtype}")
    wave = wave.contiguous()
    dev = wave.device
    eff, meta, weights, _ = _constants(opts, bf16, dev)
    nb, nnz = opts.mel_opts.num_bins, weights.numel()
    lib = _build.load("fbank", _SIGNATURES)
    out = torch.empty((b, t, nb), dtype=torch.float32, device=dev)
    energy = torch.empty((b, t), dtype=torch.float32, device=dev) if with_energy else None
    tail = (out.data_ptr(), energy.data_ptr() if with_energy else None)
    flags = (int(opts.use_power), int(opts.use_log_fbank), int(fo.remove_dc_offset))
    stream = torch.cuda.current_stream(dev).cuda_stream

    window_pad = -(-fo.window_size // _MMA_CHUNK) * _MMA_CHUNK
    limit = lib.asv_smem_limit()
    if (bf16 and fo.window_shift % 8 == 0
            and lib.asv_fbank_mma_smem_bytes(fo.window_shift, window_pad, nb, nnz) <= limit):
        # rows of the waveform start on 16-byte boundaries: the kernel brings
        # a tile's samples in with one bulk copy
        if s % 4:
            wave = torch.nn.functional.pad(wave, (0, -s % 4))
        elif wave.data_ptr() % 16:
            wave = wave.clone()
        with torch.cuda.device(dev):
            code = lib.asv_fbank_mma_launch(
                wave.data_ptr(), _mma_matrix(opts, dev).data_ptr(), meta.data_ptr(), weights.data_ptr(),
                *tail, b, wave.shape[1], t, fo.window_shift, fo.window_size, window_pad, nb, nnz,
                *flags, _build.sm_count(dev), stream)
        route = "tensor_core"
    else:
        if fo.window_shift % 4:
            raise ValueError(f"the fbank kernel needs a frame shift that is a multiple of 4, got {fo.window_shift}")
        smem = lib.asv_fbank_smem_bytes(fo.window_shift, eff.shape[0], nb, nnz)
        if smem > limit:
            raise ValueError(f"frame geometry needs {smem} bytes of shared memory, above {limit}")
        with torch.cuda.device(dev):
            code = lib.asv_fbank_launch(
                wave.data_ptr(), eff.data_ptr(), meta.data_ptr(), weights.data_ptr(), *tail,
                b, s, t, fo.window_shift, fo.window_size, eff.shape[0], nb, nnz, *flags, int(bf16), stream)
        route = "cuda_core"
    _build.check(lib, code, "fbank kernel")
    fused_fbank.launches += 1
    fused_fbank.last_route = route
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
    csrc/fbank.cu. ``fused_fbank.launches`` counts kernel launches and
    ``fused_fbank.last_route`` names the last one's kernel ("tensor_core"
    or "cuda_core").
    """
    if wave.device.type == "cpu":
        return fused_fbank_plain(wave, opts, dft_dtype, with_energy)
    if wave.device.type != "cuda":
        raise ValueError(f"fused_fbank runs on cpu or cuda tensors, got {wave.device}")
    return _launch_kernel(wave, opts, _dft_bf16(dft_dtype), with_energy, _num_frames(wave, opts))


fused_fbank.launches = 0
fused_fbank.last_route = None


def wave_features(
    wave: torch.Tensor,
    mask: Optional[torch.Tensor],
    opts: FbankOptions,
    dft_dtype: torch.dtype,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The front end of serving and of the wave-input train step: wave
    [B, S] and its sample mask -> (CMVN'd log-mel [B, T, bins] f32, frame
    mask [B, T]).

    Frame b is valid while ``t < max((n_b - window)//shift + 1, 1)`` with
    n_b the valid samples; CMVN runs over the valid frames and the others
    are zeroed (the fbank of padding is log(eps), not zero). Without a
    sample mask every frame counts and nothing is zeroed."""
    feats, _ = fused_fbank(wave, opts, dft_dtype=dft_dtype, with_energy=False)
    if mask is None:
        return cmvn_utterance(feats), None
    shift, win = opts.frame_opts.window_shift, opts.frame_opts.window_size
    n_frames = torch.clamp_min((mask.sum(1) - win) // shift + 1, 1)
    fmask = torch.arange(feats.shape[1], device=feats.device)[None, :] < n_frames[:, None]
    return cmvn_utterance(feats, mask=fmask) * fmask[..., None], fmask
