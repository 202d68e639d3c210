"""Score normalization: S-norm and adaptive AS-norm (top-N), and cosine
scoring on the device.

Counterpart: asv_subtools_tpu/backend/score_norm.py. Parity:
score/ScoreNormalization.py (snorm :70-107, asnorm :109-179 incl.
cross-select). ``snorm`` and ``asnorm`` are the port's own f64 numpy
copies, behaviour unchanged. ``asnorm_device`` and ``cosine_score_matrix``
are f32 torch on the device: cohort statistics are top-k reductions over
dense [N, cohort] score matrices, which reach VoxCeleb1-E/H scale (581k
trials x 6k cohort) where the reference's pandas groupby cannot
(gather_results_from_epochs.sh:31-33).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


def _mean_std_topk(scores: np.ndarray, top_n: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Row-wise mean/std over the top_n largest entries (ddof=1, matching
    pandas .std())."""
    s = np.asarray(scores, np.float64)
    if top_n is not None and top_n < s.shape[1]:
        part = -np.partition(-s, top_n - 1, axis=1)[:, :top_n]
    else:
        part = s
    mean = part.mean(axis=1)
    std = part.std(axis=1, ddof=1)
    return mean, std


def snorm(
    raw: np.ndarray,
    enroll_cohort: np.ndarray,
    test_cohort: np.ndarray,
) -> np.ndarray:
    """Symmetric normalization.

    raw [E, T] trial scores; enroll_cohort [E, C]; test_cohort [T, C].
    """
    em, es = _mean_std_topk(enroll_cohort, None)
    tm, ts = _mean_std_topk(test_cohort, None)
    return 0.5 * (
        (raw - em[:, None]) / es[:, None] + (raw - tm[None, :]) / ts[None, :]
    )


def asnorm(
    raw: np.ndarray,
    enroll_cohort: np.ndarray,
    test_cohort: np.ndarray,
    top_n: int = 300,
    cross_select: bool = False,
) -> np.ndarray:
    """Adaptive S-norm with top-N cohort selection.

    Standard: each side's cohort stats use its own top-N scores.
    Cross-select (ScoreNormalization.py:144-159): the enroll-side stats for
    trial (e, t) are computed over the cohort set selected by TEST t's
    top-N, and vice versa — a per-trial [E, T] statistic.
    """
    if not cross_select:
        em, es = _mean_std_topk(enroll_cohort, top_n)
        tm, ts = _mean_std_topk(test_cohort, top_n)
        return 0.5 * (
            (raw - em[:, None]) / es[:, None] + (raw - tm[None, :]) / ts[None, :]
        )

    e = np.asarray(enroll_cohort, np.float64)  # [E, C]
    t = np.asarray(test_cohort, np.float64)  # [T, C]
    c = e.shape[1]
    top_n = min(top_n, c)
    # top-N masks per row
    def topn_mask(m):
        thresh = -np.partition(-m, top_n - 1, axis=1)[:, top_n - 1 : top_n]
        return m >= thresh  # [rows, C] boolean (>= handles ties like head(n)~)

    e_sel = topn_mask(e)  # enroll's top cohort ids [E, C]
    t_sel = topn_mask(t)  # test's top cohort ids [T, C]

    # enroll stats over test-selected cohorts: for pair (i,j):
    # mean_ij = sum_c e[i,c]*t_sel[j,c] / n_j
    tw = t_sel.astype(np.float64)
    n_t = tw.sum(axis=1)  # [T]
    e_mean = (e @ tw.T) / n_t[None, :]  # [E, T]
    e_sq = (e**2) @ tw.T / n_t[None, :]
    e_std = np.sqrt(
        np.maximum(e_sq - e_mean**2, 1e-12) * (n_t / np.maximum(n_t - 1, 1))[None, :]
    )

    ew = e_sel.astype(np.float64)
    n_e = ew.sum(axis=1)  # [E]
    t_mean = (t @ ew.T) / n_e[None, :]  # [T, E]
    t_sq = (t**2) @ ew.T / n_e[None, :]
    t_std = np.sqrt(
        np.maximum(t_sq - t_mean**2, 1e-12) * (n_e / np.maximum(n_e - 1, 1))[None, :]
    )
    return 0.5 * ((raw - e_mean) / e_std + (raw - t_mean.T) / t_std.T)


def asnorm_device(
    raw,
    enroll_cohort,
    test_cohort,
    top_n: int = 300,
    mesh=None,
    device=None,
) -> torch.Tensor:
    """AS-norm in f32 with the top-k on the device: the [E, T] trial
    matrix ``raw`` normalised by each side's top-``top_n`` cohort mean and
    ddof-1 std (floored at 1e-12 before the root). Takes numpy arrays or
    tensors; returns a tensor on ``device`` (the card unless ``"cpu"``).

    With ``mesh`` (parallel/mesh.py; every rank passes the same inputs)
    the trial rows and both cohort matrices are split row-wise over
    ``"data"`` (zero rows pad them to a multiple of its size, as JAX's
    :136-167): each rank takes the top-k statistics of its enroll and test
    cohort rows, the test-side statistics are all-gathered, each rank
    normalises its trial rows, and the result is all-gathered whole on
    every rank.
    """
    dev = resolve_device(device)
    raw = torch.as_tensor(raw).to(device=dev, dtype=torch.float32)
    ec = torch.as_tensor(enroll_cohort).to(device=dev, dtype=torch.float32)
    tc = torch.as_tensor(test_cohort).to(device=dev, dtype=torch.float32)

    def stats(mat):
        k = min(top_n, mat.shape[1])
        top = torch.topk(mat, k, dim=1, sorted=False).values
        mean = top.mean(dim=1)
        var = ((top - mean[:, None]) ** 2).sum(dim=1) / max(k - 1, 1)
        return mean, torch.sqrt(torch.clamp_min(var, 1e-12))

    if mesh is None:
        em, es = stats(ec)
        tm, ts = stats(tc)
        return 0.5 * ((raw - em[:, None]) / es[:, None] + (raw - tm[None, :]) / ts[None, :])

    from ..parallel.comm import all_gather_rows
    from ..parallel.mesh import DATA_AXIS, mesh_axis

    axis = mesh_axis(mesh, DATA_AXIS)
    e, t = raw.shape

    def my_rows(m):
        """This rank's rows of ``m``, zero-padded to a multiple of the data size."""
        n = -(-m.shape[0] // axis.size)
        if n * axis.size != m.shape[0]:
            m = torch.nn.functional.pad(m, (0, 0, 0, n * axis.size - m.shape[0]))
        return m[axis.rank * n:(axis.rank + 1) * n]

    em, es = stats(my_rows(ec))
    tm, ts = (all_gather_rows(v, axis)[:t] for v in stats(my_rows(tc)))
    mine = my_rows(raw)
    out = 0.5 * ((mine - em[:, None]) / es[:, None] + (mine - tm[None, :]) / ts[None, :])
    return all_gather_rows(out, axis)[:e]


def cosine_score_matrix(enroll: torch.Tensor, test: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """[E, D] x [T, D] -> cosine scores [E, T] in f32, as one matrix
    product on the tensors' device."""
    e = torch.as_tensor(enroll).to(torch.float32)
    t = torch.as_tensor(test).to(device=e.device, dtype=torch.float32)
    if normalize:
        e = e / torch.clamp_min(torch.linalg.norm(e, dim=-1, keepdim=True), 1e-12)
        t = t / torch.clamp_min(torch.linalg.norm(t, dim=-1, keepdim=True), 1e-12)
    return e @ t.T
