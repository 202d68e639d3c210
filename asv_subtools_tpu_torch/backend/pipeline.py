"""Scoring pipeline orchestrator (parity: scoreSets.sh + score/process.sh
+ score/score.sh + gather_results_from_epochs.sh).

The reference drives per-dataset transform chains ("mean-lda-submean-
whiten-norm"), classifier dispatch (cosine/plda/aplda/svm/gmm/lr) and
metrics (eer/Cavg) through shell config files and Kaldi binaries. Here the
whole DAG is one python call over in-memory embedding tables.

Counterpart: asv_subtools_tpu/backend/pipeline.py, behaviour unchanged.
The fit, the transform chain, PLDA scoring, S-norm/AS-norm, the class
classifiers and the metrics are f64 numpy on the host; the cosine score
matrices are f32 torch on ``ScoreSets.device`` (the card unless
``device="cpu"``), each brought back with one copy to the host.

One change from the counterpart: each step of the chain keeps its own
fitted state. The counterpart keeps one mean for all mean steps, so on a
chain with two ("mean-lda-submean-whiten-norm", the reference's PLDA
chain) its transform subtracts the second mean from the input and fails;
chains with each step once give the same numbers on both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .adaptation import adapt_plda_unsupervised
from .metrics import compute_eer, compute_min_dcf
from .plda import Plda, PldaStats, estimate_plda
from .score_norm import asnorm, cosine_score_matrix, snorm
from .transforms import (
    PCAWhitening,
    ZCAWhitening,
    global_mean,
    length_norm,
    train_lda,
)
from .trials import Trials


@dataclasses.dataclass
class ScoreConfig:
    """One scoring run (a row of the reference's per-set config files)."""

    process: str = "submean-norm"  # '-'-joined: mean|submean|lda|whiten|pcawhiten|norm
    # cosine | plda | aplda score trials pairwise; svm | lr | gmm train a
    # per-class model on the ENROLL set (reference scoreSets.sh check
    # "cosine svm plda aplda gmm lr", svm/gmm/lr_process blocks) — the
    # LID path, where enroll classes come from `enroll_labels`
    classifier: str = "cosine"
    gmm_components: int = 64  # scoreSets.sh cnum
    classifier_c: float = 1.0  # SVM/LR regularization
    lda_dim: int = 128
    score_norm: Optional[str] = None  # None | snorm | asnorm
    top_n: int = 300
    plda_iters: int = 10
    metrics: Sequence[str] = ("eer", "mindcf")
    p_target: float = 0.01


def _apply_step(step: str, state, x: np.ndarray) -> np.ndarray:
    if step in ("mean", "submean"):
        return x - state
    if step == "lda":
        return x @ state
    if step in ("whiten", "pcawhiten"):
        return state.transform(x)
    return length_norm(x)


class ScoreSets:
    """Fit transforms/classifier on a training set of embeddings, then
    score enroll/test (+cohort) sets. All vectors are [N, D] numpy arrays
    keyed by utterance id. The cosine matrices are computed on ``device``
    (the card unless ``"cpu"``); ``device_fetches`` counts their copies
    back to the host."""

    def __init__(self, config: ScoreConfig = ScoreConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self.device_fetches = 0
        # (step, fitted state) per step of the chain, in order: a chain may
        # hold a step twice ("mean-lda-submean-..."), each with its own state
        self._fitted: Optional[List[Tuple[str, object]]] = None
        self._plda: Optional[Plda] = None

    # -- fitting ------------------------------------------------------------
    def fit(
        self,
        train_vectors: np.ndarray,
        train_spk_ids: np.ndarray,
        adapt_vectors: Optional[np.ndarray] = None,
    ) -> "ScoreSets":
        cfg = self.config
        x = train_vectors.astype(np.float64)
        self._fitted = []
        for step in cfg.process.split("-") if cfg.process else []:
            if step in ("mean", "submean"):
                state = global_mean(x)
            elif step == "lda":
                state = train_lda(x, train_spk_ids, cfg.lda_dim)
            elif step == "whiten":
                state = ZCAWhitening().fit(x)
            elif step == "pcawhiten":
                # process.sh:250-260 trainpcawhiten (Kaldi est-pca)
                state = PCAWhitening(dim=cfg.lda_dim).fit(x)
            elif step == "norm":
                state = None
            else:
                raise ValueError(f"unknown process step {step!r}")
            self._fitted.append((step, state))
            x = _apply_step(step, state, x)
        if cfg.classifier in ("plda", "aplda"):
            stats = PldaStats.from_vectors(x, train_spk_ids)
            self._plda = estimate_plda(stats, cfg.plda_iters)
            if cfg.classifier == "aplda":
                if adapt_vectors is None:
                    raise ValueError("aplda needs adapt_vectors")
                self._plda = adapt_plda_unsupervised(
                    self._plda, self.transform(adapt_vectors)
                )
        return self

    # -- application --------------------------------------------------------
    def transform(self, vectors: np.ndarray) -> np.ndarray:
        if self._fitted is None:
            raise RuntimeError("fit() first")
        x = vectors.astype(np.float64)
        for step, state in self._fitted:
            x = _apply_step(step, state, x)
        return x

    def score_matrix(
        self, enroll: np.ndarray, test: np.ndarray,
        enroll_counts: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        e = self.transform(enroll)
        t = self.transform(test)
        if self.config.classifier == "cosine":
            scores = cosine_score_matrix(self._to_device(e), self._to_device(t)).cpu().numpy()
            self.device_fetches += 1
            return scores
        if self.config.classifier in ("plda", "aplda"):
            n = 1 if enroll_counts is None else enroll_counts
            ep = self._plda.transform_vectors(e, num_examples=n)
            tp = self._plda.transform_vectors(t)
            return self._plda.llr_matrix(ep, tp, enroll_counts)
        raise ValueError(f"unknown classifier {self.config.classifier!r}")

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        # f32 on the host (round to nearest, as the counterpart's cast), then one copy
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def class_score_matrix(
        self,
        enroll: Dict[str, np.ndarray],
        test_mat: np.ndarray,
        enroll_labels: Optional[Dict[str, str]] = None,
    ) -> Tuple[np.ndarray, list]:
        """Per-class classifier scoring (the reference's svm/gmm/lr path):
        train one-vs-rest on the transformed ENROLL vectors grouped by
        `enroll_labels` (default: each enroll key is its own class), score
        the test set -> ([n_class, n_test] scores, class list).

        Parity: scoreSets.sh svm/gmm/lr dispatch + score/svm/svm_ratelimit,
        scoreByGMM.sh, Logistic Regression block (:104-109).
        """
        from .classifiers import (
            gmm_lid_scores,
            train_diag_gmm,
            train_logistic_regression,
            train_svm,
        )

        cfg = self.config
        e_keys = sorted(enroll)
        labels = np.asarray(
            [(enroll_labels or {}).get(k, k) for k in e_keys]
        )
        e = self.transform(np.stack([enroll[k] for k in e_keys]))
        t = self.transform(test_mat)
        classes = sorted(set(labels.tolist()))
        if cfg.classifier == "gmm":
            gmms = {
                c: train_diag_gmm(
                    e[labels == c],
                    num_components=min(cfg.gmm_components,
                                       int((labels == c).sum())),
                )
                for c in classes
            }
            scores, langs = gmm_lid_scores(gmms, t)
            return scores.T, list(langs)
        if cfg.classifier == "svm":
            clf = train_svm(e, labels, c=cfg.classifier_c)
        elif cfg.classifier == "lr":
            clf = train_logistic_regression(e, labels, c=cfg.classifier_c)
        else:
            raise ValueError(f"not a class classifier {cfg.classifier!r}")
        s = clf.scores(t)  # [n_test, C] in clf.classes order
        order = [list(clf.classes).index(c) for c in classes]
        return s[:, order].T, classes

    def run(
        self,
        enroll: Dict[str, np.ndarray],
        test: Dict[str, np.ndarray],
        trials: Trials,
        cohort: Optional[np.ndarray] = None,
        enroll_labels: Optional[Dict[str, str]] = None,
    ) -> Dict[str, float]:
        """Score trials end-to-end; returns metric dict."""
        cfg = self.config
        t_keys = sorted(test)
        t = np.stack([test[k] for k in t_keys])
        if cfg.classifier in ("svm", "lr", "gmm"):
            if cfg.score_norm:
                raise ValueError(
                    "score_norm applies to pairwise classifiers only"
                )
            raw, e_keys = self.class_score_matrix(enroll, t, enroll_labels)
            scores = trials.select_scores(
                raw, {k: i for i, k in enumerate(e_keys)},
                {k: i for i, k in enumerate(t_keys)},
            )
            return self._metrics(scores, trials)
        e_keys = sorted(enroll)
        e = np.stack([enroll[k] for k in e_keys])
        raw = self.score_matrix(e, t)
        if cfg.score_norm:
            if cohort is None:
                raise ValueError("score_norm needs a cohort")
            ec = self.score_matrix(e, cohort)
            tc = self.score_matrix(t, cohort)
            if cfg.score_norm == "snorm":
                raw = snorm(raw, ec, tc)
            elif cfg.score_norm == "asnorm":
                raw = asnorm(raw, ec, tc, top_n=cfg.top_n)
            else:
                raise ValueError(f"unknown score norm {cfg.score_norm!r}")
        scores = trials.select_scores(
            raw, {k: i for i, k in enumerate(e_keys)},
            {k: i for i, k in enumerate(t_keys)},
        )
        return self._metrics(scores, trials)

    def _metrics(self, scores: np.ndarray, trials: Trials) -> Dict[str, float]:
        cfg = self.config
        out: Dict[str, float] = {}
        if trials.labels is not None:
            if "eer" in cfg.metrics:
                eer, thr = compute_eer(scores, trials.labels)
                out["eer"] = eer
                out["eer_threshold"] = thr
            if "mindcf" in cfg.metrics:
                dcf, _ = compute_min_dcf(scores, trials.labels, p_target=cfg.p_target)
                out["min_dcf"] = dcf
        out["num_trials"] = float(len(scores))
        return out
