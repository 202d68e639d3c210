"""Vector-space classifiers for the scoring back-end: SVM, logistic
regression, diagonal GMM.

Parity: score/svm/{prepareSVMdata.sh,svm_ratelimit.py} (SVM scoring),
score.sh "lr" classifier, and score/gmm/{scoreByGMM.sh,
train_diag_gmm_with_vector.sh} (per-class diagonal GMMs over vectors for
LID). GMM EM is a vectorized array program (the Kaldi gmm-global-* binaries
it replaces ran per-utterance loops).

The port's own numpy copy of asv_subtools_tpu/backend/classifiers.py,
behaviour unchanged; ``train_logistic_regression(solver="lbfgs")`` adds a
scipy solve of sklearn's objective for machines without sklearn.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np


def train_svm(
    vectors: np.ndarray, labels: np.ndarray, c: float = 1.0
) -> "LinearClassifier":
    """One-vs-rest linear SVM on (length-normalized) embeddings."""
    from sklearn.svm import LinearSVC

    clf = LinearSVC(C=c)
    clf.fit(vectors, labels)
    return LinearClassifier(clf.coef_, clf.intercept_, np.unique(labels))


def train_logistic_regression(
    vectors: np.ndarray, labels: np.ndarray, c: float = 1.0, solver: str = "sklearn"
) -> "LinearClassifier":
    """Multi-class logistic regression (the reference's "lr" classifier).

    ``solver="sklearn"`` is sklearn's LogisticRegression(C=c). ``"lbfgs"``
    minimises the same objective with scipy's L-BFGS-B in float64, as
    sklearn's lbfgs solver does (at most 1,000 iterations, the objective
    over the sample count) but to a gradient tolerance of 1e-6 against
    its 1e-4: C times the summed cross-entropy plus half the squared norm
    of the weights (the intercept unpenalised), softmax over the classes,
    or one logistic row for two classes.
    """
    if solver == "lbfgs":
        return _lbfgs_logistic_regression(vectors, labels, c)
    if solver != "sklearn":
        raise ValueError(f"unknown solver {solver!r}")
    from sklearn.linear_model import LogisticRegression

    clf = LogisticRegression(C=c, max_iter=1000)
    clf.fit(vectors, labels)
    return LinearClassifier(clf.coef_, clf.intercept_, clf.classes_)


def _lbfgs_logistic_regression(vectors: np.ndarray, labels: np.ndarray, c: float) -> "LinearClassifier":
    from scipy.optimize import minimize
    from scipy.special import log_softmax, softmax

    x = np.asarray(vectors, np.float64)
    classes, y = np.unique(labels, return_inverse=True)
    n, d = x.shape
    k = 1 if len(classes) == 2 else len(classes)
    target = np.eye(len(classes))[y] if k > 1 else y[:, None].astype(np.float64)

    def loss_grad(theta):
        w, b = theta[:k * d].reshape(k, d), theta[k * d:]
        z = x @ w.T + b
        if k > 1:
            loss = -(target * log_softmax(z, axis=1)).sum()
            err = softmax(z, axis=1) - target
        else:  # binary: log(1 + exp(-s z)) with s = +-1
            sgn = 2.0 * target - 1.0
            loss = np.logaddexp(0.0, -sgn * z).sum()
            err = -sgn / (1.0 + np.exp(sgn * z))
        f = c * loss + 0.5 * (w * w).sum()
        grad = np.concatenate([(c * err.T @ x + w).ravel(), c * err.sum(0)])
        return f / n, grad / n

    res = minimize(loss_grad, np.zeros(k * (d + 1)), jac=True, method="L-BFGS-B",
                   options={"maxiter": 1000, "gtol": 1e-6, "ftol": 64 * np.finfo(float).eps})
    return LinearClassifier(res.x[:k * d].reshape(k, d), res.x[k * d:], classes)


@dataclasses.dataclass
class LinearClassifier:
    weight: np.ndarray  # [C, D] (or [1, D] binary)
    bias: np.ndarray  # [C]
    classes: np.ndarray

    def scores(self, vectors: np.ndarray) -> np.ndarray:
        """[N, C] decision scores."""
        s = vectors @ self.weight.T + self.bias
        if s.shape[1] == 1:  # binary: expand to two-class scores
            s = np.concatenate([-s, s], axis=1)
        return s

    def predict(self, vectors: np.ndarray) -> np.ndarray:
        return self.classes[np.argmax(self.scores(vectors), axis=1)]


@dataclasses.dataclass
class DiagGmm:
    """Diagonal-covariance GMM (per-class LID scorer)."""

    weights: np.ndarray  # [K]
    means: np.ndarray  # [K, D]
    vars: np.ndarray  # [K, D]

    def log_likelihood(self, x: np.ndarray) -> np.ndarray:
        """[N] total log-likelihood log sum_k w_k N(x; mu_k, var_k)."""
        return self._component_loglikes(x).max(axis=1) + np.log(
            np.sum(
                np.exp(
                    self._component_loglikes(x)
                    - self._component_loglikes(x).max(axis=1, keepdims=True)
                ),
                axis=1,
            )
        )

    def _component_loglikes(self, x: np.ndarray) -> np.ndarray:
        """[N, K] log w_k + log N(x; mu_k, var_k)."""
        d = x.shape[1]
        const = -0.5 * (d * np.log(2 * np.pi) + np.sum(np.log(self.vars), axis=1))
        # -(x-mu)^2 / 2var expanded to matmul-shaped terms
        x2 = (x**2) @ (0.5 / self.vars).T
        xm = x @ (self.means / self.vars).T
        m2 = 0.5 * np.sum(self.means**2 / self.vars, axis=1)
        return np.log(np.maximum(self.weights, 1e-30)) + const - x2 + xm - m2[None, :]

    def responsibilities(self, x: np.ndarray) -> np.ndarray:
        ll = self._component_loglikes(x)
        ll = ll - ll.max(axis=1, keepdims=True)
        p = np.exp(ll)
        return p / p.sum(axis=1, keepdims=True)


def train_diag_gmm(
    x: np.ndarray,
    num_components: int = 16,
    num_iters: int = 20,
    seed: int = 0,
    var_floor: float = 1e-3,
) -> DiagGmm:
    """EM for a diagonal GMM, kmeans++-style init.

    Parity: train_diag_gmm_with_vector.sh (Kaldi gmm-global-est loop).
    """
    rng = np.random.default_rng(seed)
    n, d = x.shape
    k = min(num_components, n)
    # init means from random distinct points
    idx = rng.choice(n, size=k, replace=False)
    gmm = DiagGmm(
        weights=np.full(k, 1.0 / k),
        means=x[idx].copy(),
        vars=np.tile(np.var(x, axis=0) + var_floor, (k, 1)),
    )
    for _ in range(num_iters):
        r = gmm.responsibilities(x)  # [N, K]
        nk = np.maximum(r.sum(axis=0), 1e-10)
        gmm.weights = nk / n
        gmm.means = (r.T @ x) / nk[:, None]
        e2 = (r.T @ (x**2)) / nk[:, None]
        gmm.vars = np.maximum(e2 - gmm.means**2, var_floor)
    return gmm


def gmm_lid_scores(
    gmms: Dict[str, DiagGmm], vectors: np.ndarray
) -> Tuple[np.ndarray, Sequence[str]]:
    """Score vectors against per-language GMMs -> [N, L] log-likelihoods
    (scoreByGMM.sh semantics)."""
    langs = sorted(gmms)
    scores = np.stack([gmms[l].log_likelihood(vectors) for l in langs], axis=1)
    return scores, langs


def train_diag_gmm_mmi(
    class_gmms: Dict[str, DiagGmm],
    vectors: np.ndarray,
    labels: np.ndarray,
    num_iters: int = 4,
    learning_rate: float = 1.0,
    i_smooth: float = 100.0,
    var_floor: float = 1e-3,
) -> Dict[str, DiagGmm]:
    """Discriminative MMI refinement of per-class GMMs.

    Parity: the reference's patched Kaldi `gmm-global-est-*-mmi` binaries
    (README.md:330-345): numerator stats from a class's own data,
    denominator stats from that class's posterior over ALL data, extended
    Baum-Welch mean/variance update with I-smoothing toward the ML stats.
    """
    classes = sorted(class_gmms)
    out = {c: DiagGmm(g.weights.copy(), g.means.copy(), g.vars.copy())
           for c, g in class_gmms.items()}
    y = np.asarray(labels)
    for _ in range(num_iters):
        # class posteriors over all data (the denominator model)
        ll = np.stack([out[c].log_likelihood(vectors) for c in classes], axis=1)
        ll = ll - ll.max(axis=1, keepdims=True)
        post = np.exp(ll)
        post = post / post.sum(axis=1, keepdims=True)  # [N, C]
        for ci, c in enumerate(classes):
            g = out[c]
            own = vectors[y == ci]
            r_num = g.responsibilities(own)  # [Nc, K]
            n_num = r_num.sum(axis=0)
            f_num = r_num.T @ own
            s_num = r_num.T @ (own**2)
            # denominator: all data weighted by this class's posterior
            w_den = post[:, ci]
            r_den = g.responsibilities(vectors) * w_den[:, None]
            n_den = r_den.sum(axis=0)
            f_den = r_den.T @ vectors
            s_den = r_den.T @ (vectors**2)
            # extended BW with I-smoothing (D-term from i_smooth)
            d = n_den * learning_rate + i_smooth  # [K]
            denom = np.maximum(n_num - n_den + d, 1e-6)[:, None]  # [K, 1]
            new_means = (f_num - f_den + d[:, None] * g.means) / denom
            new_s = (s_num - s_den + d[:, None] * (g.vars + g.means**2)) / denom
            g.means = new_means
            g.vars = np.maximum(new_s - new_means**2, var_floor)
    return out
