"""Classic GMM-UBM / i-vector subsystem.

Parity: kaldi/runIvector.sh (UBM + 400-d total-variability i-vector via
sid/train_diag_ubm.sh + train_ivector_extractor.sh + extract_ivectors.sh),
re-designed as batched array programs: Baum-Welch statistics are two
matmuls per utterance batch; the T-matrix EM M-step solves per-component
normal equations with stacked einsums.

The port's own numpy copy of asv_subtools_tpu/backend/ivector.py,
behaviour unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from .classifiers import DiagGmm, train_diag_gmm


def train_ubm(
    frames: np.ndarray, num_components: int = 256, num_iters: int = 20, seed: int = 0
) -> DiagGmm:
    """Diagonal UBM on pooled frame features [N, D] (train_diag_ubm.sh)."""
    return train_diag_gmm(
        frames, num_components=num_components, num_iters=num_iters, seed=seed
    )


@dataclasses.dataclass
class BaumWelchStats:
    """Zeroth/first-order sufficient statistics per utterance."""

    n: np.ndarray  # [U, K] soft counts
    f: np.ndarray  # [U, K, D] first-order stats (already mean-centered)


def collect_stats(
    ubm: DiagGmm, utterances: Sequence[np.ndarray]
) -> BaumWelchStats:
    """Per-utterance Baum-Welch stats, centered by the UBM means."""
    k, d = ubm.means.shape
    n_out = np.zeros((len(utterances), k))
    f_out = np.zeros((len(utterances), k, d))
    for i, x in enumerate(utterances):
        gamma = ubm.responsibilities(np.asarray(x, np.float64))  # [T, K]
        n_out[i] = gamma.sum(axis=0)
        f_out[i] = gamma.T @ x - n_out[i][:, None] * ubm.means
    return BaumWelchStats(n_out, f_out)


@dataclasses.dataclass
class IvectorExtractor:
    """Total-variability model: M = m + T w, diag covariances from the UBM."""

    t: np.ndarray  # [K, D, R]
    ubm: DiagGmm

    @property
    def ivector_dim(self) -> int:
        return self.t.shape[2]

    def _posterior(self, n: np.ndarray, f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior (mean, covariance) of w given one utterance's stats."""
        mean, cov = self._posterior_batch(n[None], f[None])
        return mean[0], cov[0]

    def _posterior_batch(
        self, n: np.ndarray, f: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior (means [U, R], covariances [U, R, R]) for a whole
        utterance batch at once — stacked einsums + one batched inverse,
        no per-utterance python loop."""
        k, d, r = self.t.shape
        sigma_inv = 1.0 / self.ubm.vars  # [K, D]
        # L_i = I + sum_k n_ik T_k' Sigma_k^-1 T_k
        ti = self.t * sigma_inv[:, :, None]  # [K, D, R]
        tt = np.einsum("kdr,kds->krs", ti, self.t)  # [K, R, R] (shared)
        l = np.eye(r)[None] + np.einsum("uk,krs->urs", n, tt)
        b = np.einsum("kdr,ukd->ur", ti, f)
        cov = np.linalg.inv(l)  # batched
        return np.einsum("urs,us->ur", cov, b), cov

    def extract(self, stats: BaumWelchStats) -> np.ndarray:
        """Posterior-mean i-vectors [U, R] (one batched solve)."""
        means, _ = self._posterior_batch(stats.n, stats.f)
        return means

    def extract_from_frames(self, utterances: Sequence[np.ndarray]) -> np.ndarray:
        return self.extract(collect_stats(self.ubm, utterances))


@dataclasses.dataclass
class KaldiIvectorExtractor:
    """A Kaldi-trained total-variability model (`final.ie`,
    src/ivector/ivector-extractor.h): per-component projections M_k
    [D, R], FULL inverse covariances Sigma_inv_k [D, D] (our compact
    trainer assumes diagonal; Kaldi's models are full), component weights
    w_vec [K], and the non-zero ivector prior offset on dim 0.
    """

    m: np.ndarray  # [K, D, R]
    sigma_inv: np.ndarray  # [K, D, D]
    w_vec: np.ndarray  # [K]
    prior_offset: float

    @property
    def ivector_dim(self) -> int:
        return self.m.shape[2]

    def extract(self, stats: BaumWelchStats) -> np.ndarray:
        """Posterior-mean i-vectors [U, R] (GetIvectorDistribution
        semantics: quadratic = I + sum_k n_k M_k' SigmaInv_k M_k, linear
        = sum_k M_k' SigmaInv_k f_k + prior_offset e_0; the reported
        ivector subtracts the prior offset from dim 0)."""
        k, d, r = self.m.shape
        ti = np.einsum("kde,ker->kdr", self.sigma_inv, self.m)  # [K, D, R]
        tt = np.einsum("kdr,kds->krs", ti, self.m)  # [K, R, R]
        l = np.eye(r)[None] + np.einsum("uk,krs->urs", stats.n, tt)
        b = np.einsum("kdr,ukd->ur", ti, stats.f)
        b[:, 0] += self.prior_offset
        means = np.linalg.solve(l, b[..., None])[..., 0]
        means[:, 0] -= self.prior_offset
        return means


def _read_basic(fd, dtype_char, size):
    import struct

    marker = fd.read(1)
    if marker != bytes([size]):
        raise ValueError(f"expected basic-type size {size}, got {marker!r}")
    return struct.unpack(dtype_char, fd.read(size))[0]


def _read_packed_sym(fd) -> np.ndarray:
    """Kaldi SpMatrix (packed lower triangle): 'FP '/'DP ' + dim +
    dim*(dim+1)/2 values."""
    from ..io.kaldi import _read_int32

    header = fd.read(3)
    dtype, esize = {b"FP ": (np.float32, 4), b"DP ": (np.float64, 8)}[header]
    dim = _read_int32(fd)
    vals = np.frombuffer(fd.read(dim * (dim + 1) // 2 * esize), dtype=dtype)
    out = np.zeros((dim, dim), np.float64)
    idx = 0
    for i in range(dim):
        out[i, : i + 1] = vals[idx : idx + i + 1]
        idx += i + 1
    return out + np.tril(out, -1).T  # symmetrize


def read_kaldi_ivector_extractor(path: str) -> KaldiIvectorExtractor:
    """Read Kaldi's binary `final.ie` (IvectorExtractor::Write layout:
    "<IvectorExtractor>" "<w>" Matrix "<w_vec>" Vector "<M>" int32 K +
    K Matrices "<SigmaInv>" K SpMatrices "<IvectorOffset>" double
    "</IvectorExtractor>"), so reference/Kaldi-trained extractors
    (sid/train_ivector_extractor.sh output) load directly."""
    from ..io.kaldi import _read_int32, _read_mat_body, expect_token

    def read_mat(fd):
        return np.asarray(_read_mat_body(fd, fd.read(3), None), np.float64)

    def read_vec(fd):
        header = fd.read(3)
        dtype, esize = {b"FV ": (np.float32, 4),
                        b"DV ": (np.float64, 8)}[header]
        dim = _read_int32(fd)
        return np.frombuffer(fd.read(dim * esize), dtype=dtype).astype(
            np.float64
        )

    with open(path, "rb") as f:
        if f.read(2) != b"\x00B":
            raise ValueError("final.ie must be Kaldi binary")
        expect_token(f, "<IvectorExtractor>")
        expect_token(f, "<w>")
        read_mat(f)  # weight-projection matrix; unused by extraction
        expect_token(f, "<w_vec>")
        w_vec = read_vec(f)
        expect_token(f, "<M>")
        k = _read_int32(f)
        m = np.stack([read_mat(f) for _ in range(k)])
        expect_token(f, "<SigmaInv>")
        sigma_inv = np.stack([_read_packed_sym(f) for _ in range(k)])
        expect_token(f, "<IvectorOffset>")
        prior_offset = _read_basic(f, "<d", 8)
        expect_token(f, "</IvectorExtractor>")
    return KaldiIvectorExtractor(
        m=m, sigma_inv=sigma_inv, w_vec=w_vec,
        prior_offset=float(prior_offset),
    )


def write_kaldi_ivector_extractor(model: KaldiIvectorExtractor,
                                  path: str) -> None:
    """Inverse of read_kaldi_ivector_extractor (round-trip + export)."""
    import struct

    from ..io.kaldi import _write_int32, _write_mat_body, write_token

    with open(path, "wb") as f:
        f.write(b"\x00B")
        write_token(f, "<IvectorExtractor>")
        write_token(f, "<w>")
        _write_mat_body(f, np.zeros((0, 0), np.float64))
        write_token(f, "<w_vec>")
        v = np.asarray(model.w_vec, np.float64)
        f.write(b"DV ")
        _write_int32(f, v.shape[0])
        f.write(v.tobytes())
        write_token(f, "<M>")
        _write_int32(f, model.m.shape[0])
        for mk in model.m:
            _write_mat_body(f, np.asarray(mk, np.float64))
        write_token(f, "<SigmaInv>")
        for sk in model.sigma_inv:
            s = np.asarray(sk, np.float64)
            f.write(b"DP ")
            _write_int32(f, s.shape[0])
            tri = np.concatenate([s[i, : i + 1] for i in range(s.shape[0])])
            f.write(np.ascontiguousarray(tri).tobytes())
        write_token(f, "<IvectorOffset>")
        f.write(bytes([8]) + struct.pack("<d", model.prior_offset))
        write_token(f, "</IvectorExtractor>")


def train_ivector_extractor(
    ubm: DiagGmm,
    stats: BaumWelchStats,
    ivector_dim: int = 100,
    num_iters: int = 10,
    seed: int = 0,
) -> IvectorExtractor:
    """EM for the total-variability matrix T (train_ivector_extractor.sh).

    E-step: posterior mean/cov of w per utterance; M-step: per-component
    T_k <- (sum_i F_ik E[w]') (sum_i n_ik E[ww'])^-1.
    """
    rng = np.random.default_rng(seed)
    k, d = ubm.means.shape
    r = ivector_dim
    t = rng.normal(size=(k, d, r)) * 0.1
    model = IvectorExtractor(t, ubm)
    for _ in range(num_iters):
        # E-step: batched posteriors over ALL utterances at once
        means, covs = model._posterior_batch(stats.n, stats.f)  # [U,R],[U,R,R]
        eww = covs + np.einsum("ur,us->urs", means, means)  # [U, R, R]
        # M-step accumulators as stacked einsums (no python loops)
        acc_a = np.einsum("uk,urs->krs", stats.n, eww)  # sum_i n_ik E[ww']
        acc_b = np.einsum("ukd,ur->kdr", stats.f, means)  # sum_i f_ik E[w]'
        # batched per-component solve: T_k acc_a[k] = acc_b[k]
        model.t = np.linalg.solve(
            acc_a + 1e-6 * np.eye(r)[None],
            np.transpose(acc_b, (0, 2, 1)),
        ).transpose(0, 2, 1)
    return model
