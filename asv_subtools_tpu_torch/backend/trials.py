"""Trials parsing + scoring harness (Kaldi trials format).

Parity: the shell scoring path scoreSets.sh/score.sh: trials files are
lines "enroll test target|nontarget"; scores files are "enroll test score".
Here trials are evaluated against a dense [E, T] score matrix by index —
the matrix form is what the scoring ops produce.

The port's own numpy copy of asv_subtools_tpu/backend/trials.py,
behaviour unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Trials:
    def __init__(
        self,
        enroll_keys: Sequence[str],
        test_keys: Sequence[str],
        labels: Optional[Sequence[int]] = None,
    ):
        self.enroll_keys = list(enroll_keys)
        self.test_keys = list(test_keys)
        self.labels = None if labels is None else np.asarray(labels)

    @staticmethod
    def read(path: str) -> "Trials":
        enr, tst, lab = [], [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                enr.append(parts[0])
                tst.append(parts[1])
                if len(parts) > 2:
                    lab.append(1 if parts[2] == "target" else 0)
        return Trials(enr, tst, lab if lab else None)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            for i, (e, t) in enumerate(zip(self.enroll_keys, self.test_keys)):
                if self.labels is not None:
                    f.write(f"{e} {t} {'target' if self.labels[i] else 'nontarget'}\n")
                else:
                    f.write(f"{e} {t}\n")

    def select_scores(
        self,
        score_matrix: np.ndarray,
        enroll_index: Dict[str, int],
        test_index: Dict[str, int],
    ) -> np.ndarray:
        """Gather per-trial scores out of a dense [E, T] matrix."""
        ei = np.asarray([enroll_index[k] for k in self.enroll_keys])
        ti = np.asarray([test_index[k] for k in self.test_keys])
        return np.asarray(score_matrix)[ei, ti]


def write_scores(path: str, trials: Trials, scores: np.ndarray) -> None:
    with open(path, "w") as f:
        for e, t, s in zip(trials.enroll_keys, trials.test_keys, scores):
            f.write(f"{e} {t} {float(s):.6f}\n")


def read_scores(path: str) -> Tuple[Trials, np.ndarray]:
    enr, tst, sc = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                enr.append(parts[0])
                tst.append(parts[1])
                sc.append(float(parts[2]))
    return Trials(enr, tst), np.asarray(sc)


def scores_to_table(
    trials: "Trials", scores: np.ndarray
) -> Tuple[List[str], List[str], np.ndarray]:
    """score2table.sh: per-trial score list -> dense [enroll x test] table
    (NaN where no trial exists)."""
    e_keys = sorted(set(trials.enroll_keys))
    t_keys = sorted(set(trials.test_keys))
    ei = {k: i for i, k in enumerate(e_keys)}
    ti = {k: i for i, k in enumerate(t_keys)}
    table = np.full((len(e_keys), len(t_keys)), np.nan)
    for e, t, s in zip(trials.enroll_keys, trials.test_keys, scores):
        table[ei[e], ti[t]] = s
    return e_keys, t_keys, table


def table_to_scores(
    e_keys: Sequence[str], t_keys: Sequence[str], table: np.ndarray
) -> Tuple["Trials", np.ndarray]:
    """table2score.sh: dense table -> per-trial list (skipping NaNs)."""
    enr, tst, sc = [], [], []
    for i, e in enumerate(e_keys):
        for j, t in enumerate(t_keys):
            if not np.isnan(table[i, j]):
                enr.append(e)
                tst.append(t)
                sc.append(float(table[i, j]))
    return Trials(enr, tst), np.asarray(sc)
