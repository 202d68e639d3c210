"""Score-level fusion (parity: fusionByLda.sh, fusionBySvm.py,
greedyFusion.sh, weightScore.sh).

Each fusion takes K systems' score vectors over the SAME trials and learns
combination weights on a dev set with labels.

The port's own numpy copy of asv_subtools_tpu/backend/fusion.py,
behaviour unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .metrics import compute_eer


def weight_fusion(scores: Sequence[np.ndarray], weights: Sequence[float]) -> np.ndarray:
    """Fixed-weight sum (weightScore.sh)."""
    out = np.zeros_like(np.asarray(scores[0], np.float64))
    for s, w in zip(scores, weights):
        out = out + w * np.asarray(s, np.float64)
    return out


def _normalize_scores(s: np.ndarray) -> Tuple[np.ndarray, float, float]:
    m, sd = float(np.mean(s)), float(np.std(s) + 1e-12)
    return (s - m) / sd, m, sd


def lda_fusion(
    dev_scores: Sequence[np.ndarray],
    dev_labels: np.ndarray,
    eval_scores: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fisher-LDA fusion weights (fusionByLda.sh): project the K-dim score
    vector onto the direction separating target/nontarget classes.
    Returns (weights, fused eval scores)."""
    x = np.stack([np.asarray(s, np.float64) for s in dev_scores], axis=1)  # [N, K]
    y = np.asarray(dev_labels)
    mu1 = x[y == 1].mean(axis=0)
    mu0 = x[y == 0].mean(axis=0)
    sw = np.cov(x[y == 1].T) * (y == 1).sum() + np.cov(x[y == 0].T) * (y == 0).sum()
    sw = np.atleast_2d(sw) + 1e-6 * np.eye(x.shape[1])
    w = np.linalg.solve(sw, mu1 - mu0)
    w = w / np.sum(np.abs(w))
    if np.sum(w * (mu1 - mu0)) < 0:
        w = -w
    ev = x if eval_scores is None else np.stack(
        [np.asarray(s, np.float64) for s in eval_scores], axis=1
    )
    return w, ev @ w


def logistic_fusion(
    dev_scores: Sequence[np.ndarray],
    dev_labels: np.ndarray,
    eval_scores: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Logistic-regression calibration+fusion (fusionBySvm.py analogue)."""
    from sklearn.linear_model import LogisticRegression

    x = np.stack([np.asarray(s) for s in dev_scores], axis=1)
    clf = LogisticRegression(max_iter=1000)
    clf.fit(x, dev_labels)
    ev = x if eval_scores is None else np.stack(
        [np.asarray(s) for s in eval_scores], axis=1
    )
    return clf.coef_[0], ev @ clf.coef_[0] + clf.intercept_[0]


def svm_fusion(
    dev_scores: Sequence[np.ndarray],
    dev_labels: np.ndarray,
    eval_scores: Optional[Sequence[np.ndarray]] = None,
    normalize: bool = False,
    c: float = 1.0,
) -> Tuple[np.ndarray, float, np.ndarray]:
    """Linear-SVM fusion, reference-exact (fusionBySvm.py:131-160):
    labels map to +1/-1, `svm.SVC(kernel='linear', C=1, random_state=777)`
    learns (w, b), and the fused score is x @ w + b. With normalize=True
    each system's scores pass through a sigmoid first (:92).
    Returns (weights, bias, fused eval scores).
    """
    from sklearn import svm as _svm

    def _prep(cols):
        x = np.stack([np.asarray(s, np.float64) for s in cols], axis=1)
        return 1.0 / (1.0 + np.exp(-x)) if normalize else x

    x = _prep(dev_scores)
    y = np.where(np.asarray(dev_labels) == 1, 1, -1)
    model = _svm.SVC(kernel="linear", max_iter=-1, C=c, random_state=777)
    model.fit(x, y)
    w = model.coef_[0]
    b = float(model.intercept_[0])
    ev = x if eval_scores is None else _prep(eval_scores)
    return w, b, ev @ w + b


def greedy_fusion(
    dev_scores: Sequence[np.ndarray],
    dev_labels: np.ndarray,
    eval_scores: Optional[Sequence[np.ndarray]] = None,
    weight_grid: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
) -> Tuple[List[float], np.ndarray]:
    """Greedy EER-minimizing fusion (greedyFusion.sh): start from the best
    single system (z-normed), then greedily add each remaining system at
    the grid weight that most lowers dev EER."""
    normed = [_normalize_scores(np.asarray(s, np.float64))[0] for s in dev_scores]
    k = len(normed)
    eers = [compute_eer(s, dev_labels)[0] for s in normed]
    order = list(np.argsort(eers))
    weights = [0.0] * k
    weights[order[0]] = 1.0
    fused = normed[order[0]].copy()
    best_eer = eers[order[0]]
    for idx in order[1:]:
        best_w, best_new = 0.0, best_eer
        for w in weight_grid:
            cand = fused + w * normed[idx]
            e, _ = compute_eer(cand, dev_labels)
            if e < best_new:
                best_new, best_w = e, w
        if best_w > 0:
            fused = fused + best_w * normed[idx]
            weights[idx] = best_w
            best_eer = best_new
    if eval_scores is not None:
        ev = np.zeros_like(np.asarray(eval_scores[0], np.float64))
        for i, (s, w) in enumerate(zip(eval_scores, weights)):
            if w:
                zn = _normalize_scores(np.asarray(dev_scores[i], np.float64))
                ev = ev + w * (np.asarray(s, np.float64) - zn[1]) / zn[2]
        fused = ev
    return weights, fused
