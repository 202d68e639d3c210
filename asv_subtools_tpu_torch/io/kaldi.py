"""Kaldi ark/scp I/O (the port's own numpy copy).

Counterpart: asv_subtools_tpu/io/kaldi.py, behaviour unchanged (parity:
pytorch/libs/support/kaldi_io.py). The Kaldi binary table format:
  - float/double vectors ("FV ", "DV ") and matrices ("FM ", "DM ")
  - int32 vectors (alignments)
  - compressed matrices ("CM " one-byte-per-element with per-column
    percentile headers, "CM2" 16-bit, "CM3" one-byte whole-matrix)
  - scp indirection "key path:offset" with optional row-range reads
  - pipes ("cmd |" rspecifiers / "| cmd" wspecifiers)
Writers: vectors and matrices, and the paired vector ark/scp writer the
extractor uses.
"""

from __future__ import annotations

import io
import os
import struct
import subprocess
from typing import BinaryIO, Iterator, Optional, Tuple

import numpy as np

def open_or_fd(file_or_fd, mode: str = "rb"):
    """Open a path, pipe ('cmd |' read / '| cmd' write), or pass through fd."""
    if isinstance(file_or_fd, str):
        spec = file_or_fd
        if spec.endswith("|") and "r" in mode:
            proc = subprocess.Popen(spec[:-1], shell=True, stdout=subprocess.PIPE)
            return _PipeWrapper(proc, proc.stdout)
        if spec.startswith("|") and ("w" in mode or "a" in mode):
            proc = subprocess.Popen(spec[1:], shell=True, stdin=subprocess.PIPE)
            return _PipeWrapper(proc, proc.stdin)
        offset = None
        if ":" in spec and not os.path.exists(spec):
            path, _, off = spec.rpartition(":")
            if off.isdigit() and os.path.exists(path):
                offset = int(off)
                spec = path
        f = open(spec, mode)
        if offset is not None:
            f.seek(offset)
        return f
    return file_or_fd


class _PipeWrapper:
    def __init__(self, proc, stream):
        self._proc = proc
        self._stream = stream

    def __getattr__(self, name):
        return getattr(self._stream, name)

    def close(self):
        self._stream.close()
        self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_key(fd: BinaryIO) -> Optional[str]:
    """Read a whitespace-terminated token (the utt key)."""
    chars = []
    while True:
        c = fd.read(1)
        if not c:
            return None
        if c == b" ":
            break
        chars.append(c)
    key = b"".join(chars).decode()
    return key if key else None


def _expect_binary(fd: BinaryIO) -> None:
    binary = fd.read(2)
    if binary != b"\x00B":
        raise ValueError(f"expected binary header \\0B, got {binary!r}")


def _read_int32(fd: BinaryIO) -> int:
    size_byte = fd.read(1)
    if size_byte != b"\x04":
        raise ValueError(f"expected int32 size marker, got {size_byte!r}")
    return struct.unpack("<i", fd.read(4))[0]


def _write_int32(fd: BinaryIO, v: int) -> None:
    fd.write(b"\x04" + struct.pack("<i", v))


def read_vec_flt(fd_or_path) -> np.ndarray:
    fd = open_or_fd(fd_or_path)
    try:
        return _read_vec_flt_binary(fd)
    finally:
        if fd is not fd_or_path:
            fd.close()


def _read_vec_flt_binary(fd: BinaryIO) -> np.ndarray:
    _expect_binary(fd)
    header = fd.read(3)
    if header == b"FV ":
        dtype, size = np.float32, 4
    elif header == b"DV ":
        dtype, size = np.float64, 8
    else:
        raise ValueError(f"unknown vector header {header!r}")
    dim = _read_int32(fd)
    return np.frombuffer(fd.read(dim * size), dtype=dtype).copy()


def read_vec_int(
    fd_or_path, row_range: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """Read a Kaldi int32 vector (alignment format written by
    ali-to-phones): '\\0B' + int32 dim + per-element ('\\x04' + int32)
    pairs (parity: kaldi_io.py:191-229). row_range=(start, end) slices
    elements [start, end) — the reference's inclusive `chunk` arg, except
    we consume exactly this record so ark iteration stays aligned (the
    reference overreads into the next record when chunk[0] > 0,
    kaldi_io.py:214-217)."""
    fd = open_or_fd(fd_or_path)
    try:
        return _read_vec_int_binary(fd, row_range)
    finally:
        if fd is not fd_or_path:
            fd.close()


def _read_vec_int_binary(
    fd: BinaryIO, row_range: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    _expect_binary(fd)
    dim = _read_int32(fd)
    if dim == 0:
        return np.array([], dtype=np.int32)
    raw = fd.read(dim * 5)
    pairs = np.frombuffer(raw, dtype=[("size", "int8"), ("value", "<i4")],
                          count=dim)
    vec = pairs["value"]
    if row_range is not None:
        s, e = row_range
        vec = vec[s:e]
    return np.ascontiguousarray(vec)


def read_vec_int_ark(fd_or_path) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, int32 vector) over an alignment ark
    (parity: kaldi_io.py:175-189 read_vec_int_ark / read_ali_ark)."""
    fd = open_or_fd(fd_or_path)
    try:
        while True:
            key = read_key(fd)
            if key is None:
                return
            yield key, _read_vec_int_binary(fd)
    finally:
        if fd is not fd_or_path:
            fd.close()


def read_vec_int_scp(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    for key, rxfile in read_scp(path):
        yield key, read_vec_int(rxfile)


def read_mat(
    fd_or_path, row_range: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """Read a (possibly compressed) matrix; row_range=(start, end) slices
    rows [start, end) without materializing the rest where possible (the
    reference's `chunk` arg, kaldi_io.py:449)."""
    fd = open_or_fd(fd_or_path)
    try:
        _expect_binary(fd)
        return _read_mat_body(fd, fd.read(3), row_range)
    finally:
        if fd is not fd_or_path:
            fd.close()


def _read_mat_body(
    fd: BinaryIO, header: bytes, row_range: Optional[Tuple[int, int]]
) -> np.ndarray:
    if header in (b"FM ", b"DM "):
        dtype, esize = (np.float32, 4) if header == b"FM " else (np.float64, 8)
        rows = _read_int32(fd)
        cols = _read_int32(fd)
        if row_range is not None:
            s, e = row_range
            s, e = max(0, s), min(rows, e)
            fd.seek(s * cols * esize, io.SEEK_CUR)
            data = np.frombuffer(fd.read((e - s) * cols * esize), dtype=dtype)
            return data.reshape(e - s, cols).copy()
        data = np.frombuffer(fd.read(rows * cols * esize), dtype=dtype)
        return data.reshape(rows, cols).copy()
    if header in (b"CM ", b"CM2", b"CM3"):
        return _read_compressed_mat(fd, header, row_range)
    raise ValueError(f"unknown matrix header {header!r}")


def _uint16_to_float(data: np.ndarray, min_value: float, rng: float) -> np.ndarray:
    return min_value + rng * data.astype(np.float32) / 65535.0


def _read_compressed_mat(fd, header, row_range) -> np.ndarray:
    """Kaldi CompressedMatrix: global header (min, range, rows, cols),
    then per-column uint16 percentiles + uint8 codes (format 1), plain
    uint16 codes (format 2), or uint8 codes (format 3)."""
    min_value, rng = struct.unpack("<ff", fd.read(8))
    rows, cols = struct.unpack("<ii", fd.read(8))
    if header == b"CM ":
        col_headers = np.frombuffer(fd.read(cols * 8), dtype=np.uint16).reshape(cols, 4)
        data = np.frombuffer(fd.read(cols * rows), dtype=np.uint8).reshape(cols, rows)
        p0, p25, p75, p100 = [
            _uint16_to_float(col_headers[:, i], min_value, rng) for i in range(4)
        ]
        mat = np.zeros((cols, rows), np.float32)
        c = data.astype(np.float32)
        lo = c <= 64
        mid = (c > 64) & (c <= 192)
        hi = c > 192
        for j in range(cols):
            cj = c[j]
            mat[j][lo[j]] = p0[j] + (p25[j] - p0[j]) * (cj[lo[j]] / 64.0)
            mat[j][mid[j]] = p25[j] + (p75[j] - p25[j]) * ((cj[mid[j]] - 64) / 128.0)
            mat[j][hi[j]] = p75[j] + (p100[j] - p75[j]) * ((cj[hi[j]] - 192) / 63.0)
        out = mat.T
    elif header == b"CM2":
        data = np.frombuffer(fd.read(rows * cols * 2), dtype=np.uint16).reshape(rows, cols)
        out = _uint16_to_float(data, min_value, rng)
    else:  # CM3
        data = np.frombuffer(fd.read(rows * cols), dtype=np.uint8).reshape(rows, cols)
        out = min_value + rng * data.astype(np.float32) / 255.0
    if row_range is not None:
        s, e = row_range
        out = out[max(0, s) : min(rows, e)]
    return out.copy()


def read_vec_flt_ark(fd_or_path) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(fd_or_path)
    try:
        while True:
            key = read_key(fd)
            if key is None:
                return
            yield key, _read_vec_flt_binary(fd)
    finally:
        if fd is not fd_or_path:
            fd.close()


def read_mat_ark(fd_or_path) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(fd_or_path)
    try:
        while True:
            key = read_key(fd)
            if key is None:
                return
            yield key, read_mat(fd)
    finally:
        if fd is not fd_or_path:
            fd.close()


def read_scp(path: str) -> Iterator[Tuple[str, str]]:
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                yield parts[0], parts[1]


def read_mat_scp(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    for key, rxfile in read_scp(path):
        yield key, read_mat(rxfile)


def read_vec_flt_scp(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    for key, rxfile in read_scp(path):
        yield key, read_vec_flt(rxfile)


def write_vec_flt(fd_or_path, vec: np.ndarray, key: str) -> int:
    """Write 'key \\0B FV <dim> data'. Returns the value byte offset (for scp)."""
    fd = open_or_fd(fd_or_path, "ab")
    try:
        fd.write((key + " ").encode())
        offset = fd.tell() if hasattr(fd, "tell") else -1
        fd.write(b"\x00B")
        v = np.ascontiguousarray(vec)
        if v.dtype == np.float64:
            fd.write(b"DV ")
        else:
            v = v.astype(np.float32)
            fd.write(b"FV ")
        _write_int32(fd, v.shape[0])
        fd.write(v.tobytes())
        return offset
    finally:
        if fd is not fd_or_path:
            fd.close()


def write_mat(fd_or_path, mat: np.ndarray, key: str) -> int:
    fd = open_or_fd(fd_or_path, "ab")
    try:
        fd.write((key + " ").encode())
        offset = fd.tell() if hasattr(fd, "tell") else -1
        fd.write(b"\x00B")
        m = np.ascontiguousarray(mat)
        if m.dtype == np.float64:
            fd.write(b"DM ")
        else:
            m = m.astype(np.float32)
            fd.write(b"FM ")
        _write_int32(fd, m.shape[0])
        _write_int32(fd, m.shape[1])
        fd.write(m.tobytes())
        return offset
    finally:
        if fd is not fd_or_path:
            fd.close()


class ArkScpWriter:
    """Paired vector ark+scp writer (Kaldi 'ark,scp:xvector.ark,xvector.scp')."""

    def __init__(self, ark_path: str, scp_path: Optional[str] = None):
        self.ark_path = os.path.abspath(ark_path)
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w") if scp_path else None

    def write(self, key: str, array: np.ndarray) -> None:
        offset = write_vec_flt(self._ark, array, key)
        if self._scp:
            self._scp.write(f"{key} {self.ark_path}:{offset}\n")

    def close(self) -> None:
        self._ark.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
