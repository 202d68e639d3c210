"""EER (the port's own numpy copy of asv_subtools_tpu/backend/metrics.py:15-58)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def roc_curve(scores: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(false-alarm rate, miss rate, thresholds) swept over all scores.

    labels: 1 = target, 0 = nontarget. Thresholds descend; at threshold t
    a trial is accepted iff score >= t.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    order = np.argsort(-scores, kind="mergesort")
    s = scores[order]
    l = labels[order]
    n_target = l.sum()
    n_non = len(l) - n_target
    if n_target == 0 or n_non == 0:
        raise ValueError("need both target and nontarget trials")
    tp = np.cumsum(l)
    fp = np.cumsum(1 - l)
    fa = fp / n_non
    miss = 1.0 - tp / n_target
    return fa, miss, s


def compute_eer(scores: np.ndarray, labels: np.ndarray) -> Tuple[float, float]:
    """Equal error rate + its threshold (Kaldi compute-eer semantics, with
    linear interpolation between the bracketing points)."""
    fa, miss, thr = roc_curve(scores, labels)
    idx = np.nanargmin(np.abs(miss - fa))
    if miss[idx] == fa[idx]:
        return float(miss[idx]), float(thr[idx])
    diff = miss - fa
    sign = np.signbit(diff)
    cross = np.where(sign[:-1] != sign[1:])[0]
    if len(cross) == 0:
        return float((miss[idx] + fa[idx]) / 2), float(thr[idx])
    i = cross[0]
    d0, d1 = diff[i], diff[i + 1]
    w = d0 / (d0 - d1) if d0 != d1 else 0.5
    eer = fa[i] + w * (fa[i + 1] - fa[i])
    t = thr[i] + w * (thr[i + 1] - thr[i])
    return float(eer), float(t)
