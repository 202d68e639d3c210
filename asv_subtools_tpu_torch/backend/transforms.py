"""Embedding-space transforms: mean/submean, length-norm, LDA, whitening.

Parity: the reference's transform chain "mean-lda-submean-whiten-norm"
(score/process.sh:60-120) executed by Kaldi binaries `ivector-mean`,
`ivector-compute-lda`, `transform-vec`, `ivector-normalize-length` and
score/whiten/train_ZCA_Whitening.py — here as pure array programs, in
float64 numpy on the host.

The port's own numpy copy of asv_subtools_tpu/backend/transforms.py,
behaviour unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def speaker_means(
    vectors: np.ndarray, spk_ids: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-speaker mean vectors (Kaldi ivector-mean spk2utt mode).

    vectors [N, D]; spk_ids [N] int. Returns (means [S, D], counts [S])
    where S = number of unique ids, rows ordered by id.
    """
    ids, inverse = np.unique(spk_ids, return_inverse=True)
    s = len(ids)
    d = vectors.shape[1]
    sums = np.zeros((s, d), np.float64)
    np.add.at(sums, inverse, vectors)
    counts = np.bincount(inverse, minlength=s).astype(np.float64)
    return (sums / counts[:, None]).astype(vectors.dtype), counts


def global_mean(vectors: np.ndarray) -> np.ndarray:
    """Global mean (the `mean`/`submean` resource, process.sh)."""
    return np.mean(vectors, axis=0)


def length_norm(vectors: np.ndarray, scale_to_sqrt_dim: bool = True) -> np.ndarray:
    """Kaldi ivector-normalize-length: scale each vector to norm sqrt(D)."""
    norms = np.linalg.norm(vectors, axis=-1, keepdims=True)
    norms = np.maximum(norms, 1e-12)
    target = np.sqrt(vectors.shape[-1]) if scale_to_sqrt_dim else 1.0
    return vectors * (target / norms)


def train_lda(
    vectors: np.ndarray,
    spk_ids: np.ndarray,
    lda_dim: int,
    total_covariance_factor: float = 0.0,
    covariance_floor: float = 1.0e-6,
) -> np.ndarray:
    """Kaldi-style LDA estimation (ivector-compute-lda semantics).

    Returns a projection matrix [D, lda_dim] (apply as `x @ T`), computed so
    the within-class (optionally mixed with total) covariance becomes unit
    and between-class directions with the largest eigenvalues are kept.
    """
    x = vectors.astype(np.float64)
    n, d = x.shape
    mean = x.mean(axis=0)
    xc = x - mean
    total_cov = (xc.T @ xc) / n

    means, counts = speaker_means(x, spk_ids)
    mc = means - mean
    between = (mc * counts[:, None]).T @ mc / n
    within = total_cov - between

    # mix within with total (Kaldi total_covariance_factor)
    w = (
        (1.0 - total_covariance_factor) * within
        + total_covariance_factor * total_cov
    )
    # floor eigenvalues for stability
    wvals, wvecs = np.linalg.eigh(w)
    wvals = np.maximum(wvals, covariance_floor * wvals.max())
    w_inv_sqrt = wvecs @ np.diag(wvals**-0.5) @ wvecs.T

    b_proj = w_inv_sqrt @ between @ w_inv_sqrt
    evals, evecs = np.linalg.eigh(b_proj)
    order = np.argsort(evals)[::-1][:lda_dim]
    # rows of (evecs.T @ w_inv_sqrt) are the LDA directions
    t = (evecs[:, order].T @ w_inv_sqrt).T  # [D, lda_dim]
    return t.astype(vectors.dtype)


def apply_lda(vectors: np.ndarray, transform: np.ndarray, mean: Optional[np.ndarray] = None) -> np.ndarray:
    x = vectors - (mean if mean is not None else 0.0)
    return x @ transform


class ZCAWhitening:
    """ZCA whitening (parity: score/whiten/train_ZCA_Whitening.py:29-66).

    The reference does NOT center (its mean-subtraction is commented out
    — "submean" is a separate chain step before "whiten"), uses the
    ddof=1 second moment, and clips the spectrum BEFORE the sqrt:
    W = U diag(1/sqrt(max(s, reg))) U'.
    """

    def __init__(self, regularization: float = 1e-6):
        self.regularization = regularization
        self.whiten: Optional[np.ndarray] = None
        self.dewhiten: Optional[np.ndarray] = None

    def fit(self, vectors: np.ndarray) -> "ZCAWhitening":
        x = vectors.astype(np.float64)
        cov = x.T @ x / (x.shape[0] - 1)
        u, s, _ = np.linalg.svd(cov, hermitian=True)
        root = np.sqrt(np.clip(s, self.regularization, None))
        self.whiten = u @ np.diag(1.0 / root) @ u.T
        self.dewhiten = u @ np.diag(root) @ u.T
        return self

    def transform(self, vectors: np.ndarray) -> np.ndarray:
        if self.whiten is None:
            raise RuntimeError("fit() first")
        return (vectors @ self.whiten.T).astype(vectors.dtype)


class PCAWhitening:
    """PCA transform (parity: score/process.sh:250-260 `trainpcawhiten`,
    which runs Kaldi `est-pca --read-vectors=true` with default options).

    Kaldi est-pca with defaults outputs the mean-centering affine PCA
    ROTATION onto the top `dim` principal components (variance
    normalization is off by default); `normalize_variance=True` adds the
    1/sqrt(eig) scaling for full whitening.
    """

    def __init__(self, dim: Optional[int] = None,
                 normalize_variance: bool = False,
                 regularization: float = 1e-12):
        self.dim = dim
        self.normalize_variance = normalize_variance
        self.regularization = regularization
        self.mean: Optional[np.ndarray] = None
        self.components: Optional[np.ndarray] = None  # [dim, D]

    def fit(self, vectors: np.ndarray) -> "PCAWhitening":
        x = vectors.astype(np.float64)
        self.mean = x.mean(axis=0)
        xc = x - self.mean
        cov = xc.T @ xc / max(x.shape[0] - 1, 1)
        s, u = np.linalg.eigh(cov)  # ascending
        order = np.argsort(s)[::-1]
        s, u = s[order], u[:, order]
        d = self.dim or x.shape[1]
        comp = u[:, :d].T  # [d, D]
        if self.normalize_variance:
            comp = comp / np.sqrt(
                np.clip(s[:d], self.regularization, None)
            )[:, None]
        self.components = comp
        return self

    def transform(self, vectors: np.ndarray) -> np.ndarray:
        if self.components is None:
            raise RuntimeError("fit() first")
        x = vectors.astype(np.float64) - self.mean
        return (x @ self.components.T).astype(vectors.dtype)


class TransformChain:
    """Composable transform chain like the reference's per-set process string
    e.g. "mean-lda-submean-whiten-norm" (score/process.sh:60-72).

    Each step is (name, callable(x) -> x). `apply` runs them in order.
    """

    def __init__(self):
        self.steps = []

    def add(self, name: str, fn) -> "TransformChain":
        self.steps.append((name, fn))
        return self

    def apply(self, vectors: np.ndarray) -> np.ndarray:
        x = vectors
        for _, fn in self.steps:
            x = fn(x)
        return x

    def __repr__(self):
        return "-".join(n for n, _ in self.steps) or "(empty)"
