"""Evaluation metrics: EER, minDCF, Cavg, min t-DCF, retrieval mAP.

The port's own numpy copy of asv_subtools_tpu/backend/metrics.py,
behaviour unchanged. Parity: computeEER.sh/compute-eer (Kaldi),
computeEER-like-Bosaris.py, compute_min_dcf.py, computeCavg.py:83-117,
computeMin-t-DCF.py. All are O(N log N) sort-and-sweep array programs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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

def compute_eer_bosaris(
    scores: np.ndarray, labels: np.ndarray
) -> Tuple[float, float]:
    """EER with the reference's exact Bosaris-like convention
    (computeEER-like-Bosaris.py:50-93): sweep scores ascending, at the
    first point where FAR <= FRR pick that point or the previous one —
    whichever has the smaller |FAR-FRR| — and average its two rates.

    No interpolation: the reported threshold is always one of the scores.
    Ties sort nontargets first, matching python's list sort of
    [score, label] pairs with nontarget=0 < target=1.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.int64)
    n_p = int(labels.sum())
    n_n = len(labels) - n_p
    if n_p == 0 or n_n == 0:
        raise ValueError("need both target and nontarget trials")
    order = np.lexsort((labels, scores))  # ascending score, nontarget first
    l = labels[order]
    s = scores[order]
    frr = np.cumsum(l) / n_p  # rejected targets at each inclusive cut
    far = (n_n - np.cumsum(1 - l)) / n_n  # accepted nontargets above cut
    cross = np.nonzero(far <= frr)[0]
    i = int(cross[0])
    if i == 0:  # the reference would crash here (empty memory); bracket it
        return float((far[0] + frr[0]) / 2), float(s[0])
    if abs(far[i] - frr[i]) <= abs(far[i - 1] - frr[i - 1]):
        return float((far[i] + frr[i]) / 2), float(s[i])
    return float((far[i - 1] + frr[i - 1]) / 2), float(s[i - 1])


def compute_eer_kaldi(
    scores: np.ndarray, labels: np.ndarray
) -> Tuple[float, float]:
    """EER with Kaldi compute-eer semantics (the binary behind
    computeEER.sh:22): walk the sorted target scores; the EER is the
    fraction of targets below the first target score that exceeds its
    quantile-matched nontarget score.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.int64)
    tar = np.sort(scores[labels == 1])
    non = np.sort(scores[labels == 0])
    if len(tar) == 0 or len(non) == 0:
        raise ValueError("need both target and nontarget trials")
    n_t, n_n = len(tar), len(non)
    pos = np.arange(n_t - 1)  # target_position + 1 < target_size
    non_idx = np.maximum(n_n - 1 - (n_n * pos / n_t).astype(np.int64), 0)
    hit = np.nonzero(non[non_idx] < tar[pos])[0]
    target_position = int(hit[0]) if len(hit) else n_t - 1
    return float(target_position / n_t), float(tar[target_position])


def compute_min_dcf(
    scores: np.ndarray,
    labels: np.ndarray,
    p_target: float = 0.01,
    c_miss: float = 1.0,
    c_fa: float = 1.0,
) -> Tuple[float, float]:
    """Normalized minimum detection cost (NIST DCF).

    Parity: kaldi/sid/compute_min_dcf.py:54-106. The sweep covers every
    score cut plus the reject-everything endpoint the reference reaches at
    its last ascending threshold (fnr=1, fpr=0); without it a garbage
    system whose best operating point is "accept nothing" would report a
    higher cost than the reference.
    """
    fa, miss, thr = roc_curve(scores, labels)
    fa = np.concatenate([[0.0], fa])
    miss = np.concatenate([[1.0], miss])
    thr = np.concatenate([[thr[0]], thr])
    dcf = c_miss * miss * p_target + c_fa * fa * (1.0 - p_target)
    dcf_default = min(c_miss * p_target, c_fa * (1.0 - p_target))
    idx = int(np.argmin(dcf))
    return float(dcf[idx] / dcf_default), float(thr[idx])


def compute_cavg(
    pairs: Sequence[Tuple[int, int, float]],
    lang_num: int,
    p_target: float = 0.5,
    bins: int = 20,
    min_score: Optional[float] = None,
    max_score: Optional[float] = None,
    unknown_as_nontarget: bool = False,
) -> Tuple[list, float]:
    """LID Cavg over threshold bins (parity: computeCavg.py:83-117).

    pairs: (claimed_lang_id, true_lang_id or -1, score). With
    unknown_as_nontarget (computeCavg_unknown.py), utterances whose true
    language is unknown (-1) count as an extra nontarget class for every
    claimed language.
    """
    arr = np.asarray([[a, b, c] for a, b, c in pairs], np.float64)
    claimed = arr[:, 0].astype(int)
    true = arr[:, 1].astype(int)
    score = arr[:, 2]
    lo = score.min() if min_score is None else min_score
    hi = score.max() if max_score is None else max_score
    precision = (hi - lo) / bins
    # computeCavg_unknown.py:114: with the unknown pseudo-class the
    # nontarget prior divides by lang_num (lang_num_1 - 1), not lang_num-1
    n_nontarget_classes = lang_num if unknown_as_nontarget else lang_num - 1
    p_nontarget = (1.0 - p_target) / n_nontarget_classes

    cavgs = []
    for section in range(bins + 1):
        threshold = lo + section * precision
        target_cavg = np.zeros(lang_num)
        for lang in range(lang_num):
            sel = claimed == lang
            is_tgt = sel & (true == lang)
            n_tgt = is_tgt.sum()
            p_miss = (score[is_tgt] < threshold).mean() if n_tgt else 0.0
            p_fa_sum = 0.0
            others = list(range(lang_num))
            if unknown_as_nontarget:
                others.append(-1)
            for other in others:
                if other == lang:
                    continue
                is_non = sel & (true == other)
                if is_non.sum():
                    p_fa_sum += (score[is_non] >= threshold).mean()
            target_cavg[lang] = p_target * p_miss + p_nontarget * p_fa_sum
        cavgs.append(float(target_cavg.mean()))
    return cavgs, float(min(cavgs))


def compute_min_tdcf(
    asv_scores: np.ndarray,
    asv_labels: np.ndarray,  # 1 target, 0 nontarget, -1 spoof
    cm_scores: np.ndarray,
    cm_labels: np.ndarray,  # 1 bona fide, 0 spoof
    pi_tar: float = 0.9405,
    pi_non: float = 0.0095,
    pi_spoof: float = 0.05,
    c_miss_asv: float = 1.0,
    c_fa_asv: float = 10.0,
    c_miss_cm: float = 1.0,
    c_fa_cm: float = 10.0,
) -> float:
    """ASVspoof min t-DCF, reference-exact (computeMin-t-DCF.py:94-225).

    The ASV system operates at its Bosaris-convention EER threshold
    (an actual score value, :175); the CM sweep covers every ascending
    score cut INCLUDING the accept-everything (P_miss=0, P_fa=1) and
    reject-everything (P_miss=1, P_fa=0) endpoints (:204-223); and the
    returned cost is min(beta*P_miss_cm + P_fa_cm) with beta = C1/C2 —
    i.e. the reference normalizes by C2, not by min(C1, C2) as the
    official ASVspoof scorer does.
    """
    asv_scores = np.asarray(asv_scores, np.float64)
    asv_labels = np.asarray(asv_labels, np.int64)
    cm_scores = np.asarray(cm_scores, np.float64)
    cm_labels = np.asarray(cm_labels, np.int64)
    tar = asv_scores[asv_labels == 1]
    non = asv_scores[asv_labels == 0]
    spoof = asv_scores[asv_labels == -1]
    keep = asv_labels >= 0
    _, thr = compute_eer_bosaris(asv_scores[keep], asv_labels[keep])
    p_miss_asv = (tar < thr).mean()
    p_fa_asv = (non >= thr).mean()
    p_miss_spoof_asv = (spoof < thr).mean() if len(spoof) else 0.0

    c1 = (
        pi_tar * (c_miss_cm - c_miss_asv * p_miss_asv)
        - pi_non * c_fa_asv * p_fa_asv
    )
    c2 = c_fa_cm * pi_spoof * (1.0 - p_miss_spoof_asv)
    if c1 < 0 or c2 <= 0:
        raise ValueError("negative t-DCF weights; check ASV scores")
    beta = c1 / c2

    n_bona = int((cm_labels == 1).sum())
    n_spoof = int((cm_labels == 0).sum())
    order = np.lexsort((cm_labels, cm_scores))  # ascending, spoof first on ties
    l = cm_labels[order]
    p_miss_cm = np.concatenate([[0.0], np.cumsum(l) / n_bona])
    p_fa_cm = np.concatenate([[1.0], (n_spoof - np.cumsum(1 - l)) / n_spoof])
    return float(np.min(beta * p_miss_cm + p_fa_cm))


def retrieval_map(
    scores: np.ndarray,
    relevant: np.ndarray,
    top_n: int = 10,
) -> float:
    """Speaker-retrieval mean average precision @ top_n.

    Parity: recipe/cnsrc/sr/cal_mAP.py (CNSRC 2022 Task 2): for each query
    speaker, rank the pool by score, walk the top_n list accumulating
    precision-at-i for every position (the reference adds target_num/i at
    EVERY position, hit or miss — reproduced exactly), divide by top_n;
    mAP is the mean over query speakers.

    scores:   [n_spk, n_pool] query-vs-pool score matrix.
    relevant: [n_spk, n_pool] bool — pool item belongs to the query speaker.
    """
    scores = np.asarray(scores)
    relevant = np.asarray(relevant, bool)
    if scores.shape != relevant.shape:
        raise ValueError("scores and relevant must have the same shape")
    n = min(top_n, scores.shape[1])
    top = np.argsort(-scores, axis=1)[:, :n]  # [spk, n]
    hits = np.take_along_axis(relevant, top, axis=1)  # [spk, n]
    cum_hits = np.cumsum(hits, axis=1)
    ranks = np.arange(1, n + 1)[None, :]
    ap = (cum_hits / ranks).sum(axis=1) / top_n
    return float(ap.mean())
