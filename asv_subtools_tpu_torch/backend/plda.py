"""Two-covariance PLDA: EM training + batched LLR scoring.

The port's own numpy copy of asv_subtools_tpu/backend/plda.py, behaviour
unchanged, with the [E, T] LLR matrix in f32 torch on the device
(``llr_matrix_device``). Parity: score/pyplda/plda_base.py
(Kaldi-compatible): PldaStats.add_samples (:49-66), PldaEstimation EM
(:232-300), PLDA.transform_ivector (:93-106), log_likelihood_ratio
(:109-136), get_output diagonalization (:186-214).

The per-class python loops become segment-sum vectorized stats grouped by
class size; scoring is a closed-form batched computation that produces the
whole [enroll x test] LLR matrix with matmul-shaped ops. EM's small DxD
solves stay float64 on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

M_LOG_2PI = 1.8378770664093454835606594728112


@dataclasses.dataclass
class PldaStats:
    """Sufficient statistics for two-covariance PLDA."""

    dim: int
    num_classes: int
    class_weight: float
    example_weight: float
    sum: np.ndarray  # [D] weighted sum of class means
    offset_scatter: np.ndarray  # [D, D]
    class_means: np.ndarray  # [S, D]
    class_counts: np.ndarray  # [S]
    class_weights: np.ndarray  # [S]

    @staticmethod
    def from_vectors(
        vectors: np.ndarray, spk_ids: np.ndarray, weights: Optional[np.ndarray] = None
    ) -> "PldaStats":
        """Vectorized equivalent of looping add_samples per speaker."""
        x = vectors.astype(np.float64)
        ids, inverse = np.unique(spk_ids, return_inverse=True)
        s, d = len(ids), x.shape[1]
        counts = np.bincount(inverse, minlength=s).astype(np.float64)
        sums = np.zeros((s, d))
        np.add.at(sums, inverse, x)
        means = sums / counts[:, None]
        if weights is None:
            w = np.ones(s)
        else:
            w = np.asarray(weights, np.float64)
        # offset scatter: sum_k w_k * (X_k' X_k - n_k m_k m_k')
        per_ex_w = w[inverse]
        scatter = (x * per_ex_w[:, None]).T @ x
        scatter -= (means * (w * counts)[:, None]).T @ means
        return PldaStats(
            dim=d,
            num_classes=s,
            class_weight=float(w.sum()),
            example_weight=float((w * counts).sum()),
            sum=(means * w[:, None]).sum(axis=0),
            offset_scatter=scatter,
            class_means=means,
            class_counts=counts,
            class_weights=w,
        )


@dataclasses.dataclass
class Plda:
    """Trained PLDA model in Kaldi's diagonalized form.

    mean [D]; transform [D, D] (within-class -> unit, between -> diag psi);
    psi [D] between-class variances in the transformed space.
    """

    mean: np.ndarray
    transform: np.ndarray
    psi: np.ndarray

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    # -- projection -------------------------------------------------------
    def transform_vectors(
        self,
        vectors: np.ndarray,
        num_examples: int | np.ndarray = 1,
        normalize_length: bool = True,
        simple_length_norm: bool = False,
    ) -> np.ndarray:
        """Project + length-normalize (batched transform_ivector :93-106)."""
        x = (vectors - self.mean) @ self.transform.T
        if not normalize_length:
            return x
        if simple_length_norm:
            factor = np.sqrt(self.dim) / np.linalg.norm(x, axis=-1, keepdims=True)
        else:
            n = np.asarray(num_examples, np.float64)
            inv_covar = 1.0 / (self.psi + 1.0 / n if np.ndim(n) == 0 else
                               self.psi[None, :] + 1.0 / n[:, None])
            dot = np.sum(inv_covar * x**2, axis=-1, keepdims=True)
            factor = np.sqrt(self.dim / dot)
        return x * factor

    # -- scoring ----------------------------------------------------------
    def llr_matrix(
        self,
        enroll: np.ndarray,
        test: np.ndarray,
        enroll_counts: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Full [E, T] log-likelihood-ratio matrix, vectorized.

        enroll/test are ALREADY transformed (transform_vectors). Parity with
        log_likelihood_ratio (:109-136), generalized to per-row counts.
        """
        e = enroll.astype(np.float64)
        t = test.astype(np.float64)
        n = (
            np.ones(e.shape[0])
            if enroll_counts is None
            else np.asarray(enroll_counts, np.float64)
        )
        psi = self.psi[None, :]  # [1, D]
        n_ = n[:, None]  # [E, 1]
        w = n_ * psi / (n_ * psi + 1.0)  # [E, D] posterior-mean coefficient
        mean = w * e  # [E, D]
        var_given = 1.0 + psi / (n_ * psi + 1.0)  # [E, D]
        logdet_given = np.sum(np.log(var_given), axis=1)  # [E]
        inv_given = 1.0 / var_given

        # loglike_given[i, j] = -0.5 (logdet_i + C + sum_d (t_jd - mean_id)^2 inv_id)
        t2 = t**2  # [T, D]
        cross = (inv_given * mean) @ t.T  # [E, T]
        quad = inv_given @ t2.T - 2.0 * cross + np.sum(inv_given * mean**2, axis=1, keepdims=True)
        loglike_given = -0.5 * (
            logdet_given[:, None] + M_LOG_2PI * self.dim + quad
        )

        var_no = self.psi + 1.0  # [D]
        logdet_no = np.sum(np.log(var_no))
        loglike_no = -0.5 * (
            logdet_no + M_LOG_2PI * self.dim + t2 @ (1.0 / var_no)
        )  # [T]
        return (loglike_given - loglike_no[None, :]).astype(np.float32)

    # -- misc -------------------------------------------------------------
    def smooth_within_class_covariance(self, smoothing_factor: float) -> None:
        """Kaldi plda smoothing (:138-149)."""
        within = 1.0 + smoothing_factor * self.psi
        self.psi = self.psi / within
        self.transform = (within**-0.5)[:, None] * self.transform


def estimate_plda(
    stats: PldaStats, num_em_iters: int = 10
) -> Plda:
    """EM estimation (parity: PldaEstimation :232-300, vectorized over
    classes grouped by example count)."""
    d = stats.dim
    between = np.eye(d)
    within = np.eye(d)
    global_mean = stats.sum / stats.class_weight

    m_all = stats.class_means - global_mean  # [S, D]
    counts = stats.class_counts
    weights = stats.class_weights

    for _ in range(num_em_iters):
        within_stats = stats.offset_scatter.copy()
        within_count = stats.example_weight - stats.class_weight
        between_stats = np.zeros((d, d))
        between_count = 0.0

        within_inv = np.linalg.inv(within)
        between_inv = np.linalg.inv(between)

        # group classes by n (same count -> same mix_var): vectorized loop
        for n in np.unique(counts):
            sel = counts == n
            w = weights[sel]
            m = m_all[sel]  # [K, D]
            mix_var = np.linalg.inv(between_inv + n * within_inv)  # [D, D]
            # w_k = mix_var @ (n * within_inv) @ m_k (reference :286-289);
            # row form: m_row @ (n*within_inv) @ mix_var — both matrices are
            # symmetric but do NOT commute, so the order matters
            wk = m @ (n * within_inv) @ mix_var  # [K, D] posterior means
            mw = m - wk
            between_stats += w.sum() * mix_var + (wk * w[:, None]).T @ wk
            between_count += w.sum()
            within_stats += n * w.sum() * mix_var + n * (mw * w[:, None]).T @ mw
            within_count += w.sum()

        within = within_stats / within_count
        between = between_stats / between_count

    # diagonalize: within -> I, between -> diag(psi)
    c = np.linalg.inv(np.linalg.cholesky(within))
    b_proj = c @ between @ c.T
    s, u = np.linalg.eigh(b_proj)
    order = np.argsort(s)[::-1]
    s = s[order]
    u = u[:, order]
    if s.min() <= 0:
        s = np.maximum(s, 1e-10)
    return Plda(mean=global_mean, transform=u.T @ c, psi=s)


def write_kaldi_plda_text(plda: Plda, path: str) -> None:
    """Reference text format (plda_base.py plda_trans_write :218-228):
    <Plda> [ mean ] [ transform rows ] [ psi ] </Plda>."""
    with open(path, "w") as f:
        f.write("<Plda>  [ " + " ".join(map(str, plda.mean.ravel())) + " ]\n")
        f.write(" [")
        for row in plda.transform:
            f.write("\n  " + " ".join(map(str, row)))
        f.write(" ]")
        f.write("\n [ " + " ".join(map(str, plda.psi.ravel())) + " ]\n")
        f.write("</Plda> ")


def read_kaldi_plda_text(path: str) -> Plda:
    """Inverse of write_kaldi_plda_text."""
    text = open(path).read()
    inner = text.split("<Plda>")[1].split("</Plda>")[0]
    blocks = []
    depth = 0
    cur: list = []
    for tok in inner.replace("[", " [ ").replace("]", " ] ").split():
        if tok == "[":
            depth += 1
            cur = []
        elif tok == "]":
            depth -= 1
            blocks.append(cur)
        else:
            cur.append(float(tok))
    mean = np.asarray(blocks[0])
    dim = len(mean)
    transform = np.asarray(blocks[1]).reshape(dim, dim)
    psi = np.asarray(blocks[2])
    return Plda(mean=mean, transform=transform, psi=psi)


def write_kaldi_plda(plda: Plda, path: str, binary: bool = True) -> None:
    """Kaldi's own `<Plda>` OBJECT format (src/ivector/plda.h Write:
    "<Plda>" mean_ transform_ psi_ "</Plda>"; members are double, so the
    binary bodies are DV/DM/DV) — what `ivector-compute-plda` emits and
    `ivector-plda-scoring` consumes. binary=False writes the text form
    (same as write_kaldi_plda_text)."""
    if not binary:
        write_kaldi_plda_text(plda, path)
        return
    from ..io.kaldi import _write_mat_body, _write_vec_body, write_token

    with open(path, "wb") as f:
        f.write(b"\x00B")
        write_token(f, "<Plda>")
        _write_vec_body(f, np.asarray(plda.mean, np.float64).ravel())
        _write_mat_body(f, np.asarray(plda.transform, np.float64))
        _write_vec_body(f, np.asarray(plda.psi, np.float64).ravel())
        write_token(f, "</Plda>")


def read_kaldi_plda(path: str) -> Plda:
    """Read a Kaldi `plda` artifact in ANY of its shipped forms:

    * Kaldi binary object ("\\0B<Plda> DV.. DM.. DV..</Plda>") — the
      format a reference-stack user's `ivector-compute-plda` model file
      is in (a back-end-only migration);
    * Kaldi/pyplda text object (plda_base.py plda_trans_write :216-225);
    * the pyplda two-covariance ark (mean/within_var/between_var keys,
      plda_base.py plda_write :337-342) — converted to (transform, psi)
      with the same diagonalization as the reference's get_output
      (:179-214).
    """
    from ..io.kaldi import expect_token, read_token, read_vec

    with open(path, "rb") as f:
        head = f.read(2)
        if head == b"\x00B":
            tok = read_token(f)
            if tok == "<Plda>":
                from ..io.kaldi import _read_int32, _read_mat_body

                # bodies follow without per-field \0B markers
                def vec_body():
                    header = f.read(3)
                    dtype, size = {b"FV ": (np.float32, 4),
                                   b"DV ": (np.float64, 8)}[header]
                    dim = _read_int32(f)
                    return np.frombuffer(
                        f.read(dim * size), dtype=dtype
                    ).copy()

                mean = vec_body()
                transform = _read_mat_body(f, f.read(3), None)
                psi = vec_body()
                expect_token(f, "</Plda>")
                return Plda(
                    mean=np.asarray(mean, np.float64),
                    transform=np.asarray(transform, np.float64),
                    psi=np.asarray(psi, np.float64),
                )
            # a keyed ark whose first key happened after \0B? fall through
        text_head = head + f.read(256)
    if b"<Plda>" in text_head:
        return read_kaldi_plda_text(path)
    # two-covariance ark (pyplda plda_write)
    mean, within_var, between_var = read_two_cov_ark(path)
    return plda_from_two_cov(mean, within_var, between_var)


def plda_from_two_cov(mean, within_var, between_var) -> Plda:
    """(mean, within, between) -> diagonalized (transform, psi), exactly
    the reference's PldaEstimation.get_output (plda_base.py:179-214)."""
    c = np.linalg.inv(np.linalg.cholesky(within_var))
    b_proj = c @ between_var @ c.T
    s, u = np.linalg.eigh(b_proj)
    order = np.argsort(s)[::-1]
    s, u = s[order], u[:, order]
    s = np.maximum(s, 1e-10)
    return Plda(mean=np.asarray(mean, np.float64).ravel(),
                transform=u.T @ c, psi=s)


def write_two_cov_ark(mean, within_var, between_var, path: str) -> None:
    """Two-covariance form as Kaldi float-vector ark entries keyed
    mean/within_var/between_var (what pyplda plda_read consumes,
    plda_base.py:167-178)."""
    from ..io.kaldi import write_vec_flt

    write_vec_flt(path, np.asarray(mean).ravel(), "mean")
    write_vec_flt(path, np.asarray(within_var).ravel(), "within_var")
    write_vec_flt(path, np.asarray(between_var).ravel(), "between_var")


def read_two_cov_ark(path: str):
    """Read the two-covariance ark back -> (mean, within, between)."""
    from ..io.kaldi import read_vec_flt_ark

    entries = dict(read_vec_flt_ark(path))
    mean = entries["mean"]
    dim = len(mean)
    return (
        mean,
        entries["within_var"].reshape(dim, dim),
        entries["between_var"].reshape(dim, dim),
    )


def plda_score_trials(
    plda: Plda,
    enroll_vectors: np.ndarray,
    test_vectors: np.ndarray,
    enroll_counts: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Convenience: raw vectors -> transformed -> LLR matrix [E, T]."""
    n = 1 if enroll_counts is None else enroll_counts
    e = plda.transform_vectors(enroll_vectors, num_examples=n)
    t = plda.transform_vectors(test_vectors, num_examples=1)
    return plda.llr_matrix(e, t, enroll_counts)


def llr_matrix_device(
    plda: Plda,
    enroll,
    test,
    enroll_counts: Optional[np.ndarray] = None,
    device=None,
) -> torch.Tensor:
    """[E, T] PLDA LLR matrix in f32 on ``device`` (the card unless
    ``"cpu"``): the arithmetic of Plda.llr_matrix, whose matmul-shaped
    terms are the two products ``(inv_given * mean) @ t.T`` and
    ``inv_given @ t2.T``. enroll/test are already transformed; numpy
    arrays or tensors. Returns a tensor on that device."""
    dev = resolve_device(device)
    e = torch.as_tensor(enroll).to(device=dev, dtype=torch.float32)
    t = torch.as_tensor(test).to(device=dev, dtype=torch.float32)
    n = (
        torch.ones(e.shape[0], device=dev)
        if enroll_counts is None
        else torch.as_tensor(enroll_counts).to(device=dev, dtype=torch.float32)
    )
    psi = torch.as_tensor(plda.psi).to(device=dev, dtype=torch.float32)[None, :]
    n_ = n[:, None]
    w = n_ * psi / (n_ * psi + 1.0)
    mean = w * e
    var_given = 1.0 + psi / (n_ * psi + 1.0)
    logdet_given = torch.sum(torch.log(var_given), dim=1)
    inv_given = 1.0 / var_given
    t2 = t * t
    cross = (inv_given * mean) @ t.T
    quad = inv_given @ t2.T - 2.0 * cross + torch.sum(inv_given * mean * mean, dim=1, keepdim=True)
    loglike_given = -0.5 * (logdet_given[:, None] + M_LOG_2PI * plda.dim + quad)
    var_no = psi[0] + 1.0
    loglike_no = -0.5 * (torch.sum(torch.log(var_no)) + M_LOG_2PI * plda.dim + t2 @ (1.0 / var_no))
    return loglike_given - loglike_no[None, :]
