"""Kaldi ark/scp I/O (the port's own numpy copy).

Counterpart: asv_subtools_tpu/io/kaldi.py, behaviour unchanged (parity:
pytorch/libs/support/kaldi_io.py). The Kaldi binary table format:
  - float/double vectors ("FV ", "DV ") and matrices ("FM ", "DM ")
  - int32 vectors (alignments)
  - compressed matrices ("CM " one-byte-per-element with per-column
    percentile headers, "CM2" 16-bit, "CM3" one-byte whole-matrix)
  - scp indirection "key path:offset" with optional row-range reads
  - pipes ("cmd |" rspecifiers / "| cmd" wspecifiers)
  - int32 alignments (``read_ali``, ``write_vec_int``)
  - standalone Kaldi object files with no utterance key (mean.vec,
    transform.mat, the PLDA and i-vector models): tokens, vector and
    matrix bodies, binary or text
Writers: vectors, int vectors and matrices, and the paired vector ark/scp
writer the extractor uses.
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


def read_ali(
    fd_or_path, row_range: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """Per-frame integer labels from EITHER a Kaldi int-vector alignment
    entry (what ali-to-phones writes; reference read_ali_ark,
    kaldi_io.py:169-173) or a single-column float matrix — sniffed from
    the byte after '\\0B'."""
    fd = open_or_fd(fd_or_path)
    try:
        _expect_binary(fd)
        first = fd.read(1)
        if first == b"\x04":  # int32 dim marker -> int vector
            dim = struct.unpack("<i", fd.read(4))[0]
            pairs = np.frombuffer(fd.read(dim * 5),
                                  dtype=[("size", "int8"), ("value", "<i4")],
                                  count=dim)
            vec = pairs["value"]
            if row_range is not None:
                vec = vec[row_range[0]:row_range[1]]
            return np.ascontiguousarray(vec)
        mat = _read_mat_body(fd, first + fd.read(2), row_range)
        return mat[:, 0].astype(np.int32)
    finally:
        if fd is not fd_or_path:
            fd.close()



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


def write_vec_int(fd_or_path, vec: np.ndarray, key: str) -> int:
    """Write a Kaldi int32 vector ('\\x04'-prefixed elements, parity:
    kaldi_io.py:236-267). Returns the value byte offset (for scp)."""
    fd = open_or_fd(fd_or_path, "ab")
    try:
        fd.write((key + " ").encode())
        offset = fd.tell() if hasattr(fd, "tell") else -1
        fd.write(b"\x00B")
        v = np.ascontiguousarray(vec, dtype="<i4")
        _write_int32(fd, v.shape[0])
        body = np.empty(v.shape[0], dtype=[("size", "int8"), ("value", "<i4")])
        body["size"] = 4
        body["value"] = v
        fd.write(body.tobytes())
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




# ---------------------------------------------------------------------------
# Standalone Kaldi OBJECT files (rxfilename style, no utterance key):
# what `ivector-mean` (mean.vec), `est-lda`/`transform-vec` (transform.mat)
# and `ivector-compute-plda` (plda) write. Binary layout: "\0B" marker,
# then tokens as "<Token> " and Vector/Matrix bodies as
# "FV "/"DV " '\4'int32 dim data  /  "FM "/"DM " '\4'int32 rows '\4'int32
# cols data. Text files have no \0B and print "[ ... ]" blocks.
# ---------------------------------------------------------------------------


def _read_head(fd: BinaryIO):
    """(is_binary, head_bytes): peeks WITHOUT seeking (pipes from
    open_or_fd('cmd |') can't seek) — text callers prepend head_bytes to
    the rest of the stream."""
    head = fd.read(2)
    return head == b"\x00B", head


def read_token(fd: BinaryIO) -> str:
    """Kaldi ReadToken: whitespace-delimited token."""
    tok = b""
    while True:
        c = fd.read(1)
        if not c or c in b" \t\n\r":
            if tok:
                return tok.decode()
            if not c:
                raise EOFError("EOF while reading token")
            continue
        tok += c


def write_token(fd: BinaryIO, tok: str) -> None:
    fd.write(tok.encode() + b" ")


def expect_token(fd: BinaryIO, want: str) -> None:
    """Read a token and require it (NOT an assert: the read is a format-
    critical side effect that must survive python -O)."""
    got = read_token(fd)
    if got != want:
        raise ValueError(f"expected Kaldi token {want!r}, got {got!r}")


def _read_text_block(text: str):
    """Parse consecutive '[ ... ]' numeric blocks from Kaldi text.

    Every block yields a LIST OF ROWS (rows = lines inside the block,
    Kaldi's text Matrix::Write layout); vector callers flatten, matrix
    callers np.asarray the rows — so a 1xN matrix keeps its 2-D shape."""
    blocks = []
    in_block = False
    rows: list = []
    row: list = []
    for line in text.splitlines():
        for tok in line.replace("[", " [ ").replace("]", " ] ").split():
            if tok == "[":
                in_block, rows, row = True, [], []
            elif tok == "]":
                if row:
                    rows.append(row)
                blocks.append(rows)
                in_block, rows, row = False, [], []
            elif in_block:
                row.append(float(tok))
        if in_block and row:
            rows.append(row)
            row = []
    return blocks


def read_vec(fd_or_path) -> np.ndarray:
    """Standalone Kaldi vector file (e.g. `ivector-mean spk.ark mean.vec`),
    binary or text."""
    fd = open_or_fd(fd_or_path)
    try:
        binary, head = _read_head(fd)
        if binary:
            header = fd.read(3)
            if header == b"FV ":
                dtype, size = np.float32, 4
            elif header == b"DV ":
                dtype, size = np.float64, 8
            else:
                raise ValueError(f"unknown vector header {header!r}")
            dim = _read_int32(fd)
            return np.frombuffer(fd.read(dim * size), dtype=dtype).copy()
        text = (head + fd.read()).decode()
        rows = _read_text_block(text)[0]
        return np.asarray(
            [v for r in rows for v in r], np.float64
        )
    finally:
        if fd is not fd_or_path:
            fd.close()


def write_vec(fd_or_path, vec: np.ndarray, binary: bool = True) -> None:
    """Standalone Kaldi vector file (dtype keeps f64 as DV, else FV)."""
    v = np.ascontiguousarray(vec).ravel()
    if not binary:
        with open(fd_or_path, "w") as f:
            f.write(" [ " + " ".join(repr(float(x)) for x in v) + " ]\n")
        return
    fd = open_or_fd(fd_or_path, "wb")
    try:
        fd.write(b"\x00B")
        _write_vec_body(fd, v)
    finally:
        if fd is not fd_or_path:
            fd.close()


def _write_vec_body(fd: BinaryIO, v: np.ndarray) -> None:
    if v.dtype == np.float64:
        fd.write(b"DV ")
    else:
        v = v.astype(np.float32)
        fd.write(b"FV ")
    _write_int32(fd, v.shape[0])
    fd.write(v.tobytes())


def _write_mat_body(fd: BinaryIO, m: np.ndarray) -> None:
    m = np.ascontiguousarray(m)
    if m.dtype == np.float64:
        fd.write(b"DM ")
    else:
        m = m.astype(np.float32)
        fd.write(b"FM ")
    _write_int32(fd, m.shape[0])
    _write_int32(fd, m.shape[1])
    fd.write(m.tobytes())


def read_mat_file(fd_or_path) -> np.ndarray:
    """Standalone Kaldi matrix file (e.g. an est-lda / transform.mat
    artifact), binary or text."""
    fd = open_or_fd(fd_or_path)
    try:
        binary, head = _read_head(fd)
        if binary:
            return _read_mat_body(fd, fd.read(3), None)
        text = (head + fd.read()).decode()
        rows = _read_text_block(text)[0]
        return np.asarray(rows, np.float64)
    finally:
        if fd is not fd_or_path:
            fd.close()


def write_mat_file(fd_or_path, mat: np.ndarray, binary: bool = True) -> None:
    if not binary:
        with open(fd_or_path, "w") as f:
            f.write(" [")
            for row in np.asarray(mat):
                f.write("\n  " + " ".join(repr(float(x)) for x in row))
            f.write(" ]\n")
        return
    fd = open_or_fd(fd_or_path, "wb")
    try:
        fd.write(b"\x00B")
        _write_mat_body(fd, np.asarray(mat))
    finally:
        if fd is not fd_or_path:
            fd.close()


class ArkScpWriter:
    """Paired ark+scp writer (Kaldi 'ark,scp:xvector.ark,xvector.scp'):
    float vectors, or float matrices with ``matrix=True`` (feature arks)."""

    def __init__(self, ark_path: str, scp_path: Optional[str] = None, matrix: bool = False):
        self.ark_path = os.path.abspath(ark_path)
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w") if scp_path else None
        self._matrix = matrix

    def write(self, key: str, array: np.ndarray) -> None:
        offset = (write_mat if self._matrix else write_vec_flt)(self._ark, array, key)
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
