"""DET curves and score-distribution plots (parity:
pytorch/libs/support/figure.py:1-261).

matplotlib is optional: `det_curve_points` returns the probit-warped
coordinates for any plotting front-end; `plot_det`/`plot_score_dist` draw
to a file when matplotlib is available.

The port's own numpy copy of asv_subtools_tpu/backend/figure.py,
behaviour unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .metrics import roc_curve


def _probit(p: np.ndarray) -> np.ndarray:
    """Inverse normal CDF via the erfinv identity."""
    from scipy.special import erfinv

    return np.sqrt(2.0) * erfinv(2.0 * np.clip(p, 1e-8, 1 - 1e-8) - 1.0)


def det_curve_points(
    scores: np.ndarray, labels: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(probit(fa), probit(miss)) points for a DET plot."""
    fa, miss, _ = roc_curve(scores, labels)
    keep = (fa > 0) & (fa < 1) & (miss > 0) & (miss < 1)
    return _probit(fa[keep]), _probit(miss[keep])


def plot_det(
    systems: Sequence[Tuple[str, np.ndarray, np.ndarray]],
    out_path: str,
    title: str = "DET curve",
) -> Optional[str]:
    """systems: [(name, scores, labels)]. Writes a PNG; returns its path."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return None
    fig, ax = plt.subplots(figsize=(6, 6))
    ticks = np.asarray([0.001, 0.01, 0.05, 0.1, 0.2, 0.4])
    for name, scores, labels in systems:
        x, y = det_curve_points(scores, labels)
        ax.plot(x, y, label=name)
    tick_pos = _probit(ticks)
    ax.set_xticks(tick_pos)
    ax.set_xticklabels([f"{t:g}" for t in ticks * 100])
    ax.set_yticks(tick_pos)
    ax.set_yticklabels([f"{t:g}" for t in ticks * 100])
    ax.set_xlabel("False alarm rate [%]")
    ax.set_ylabel("Miss rate [%]")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_score_distribution(
    scores: np.ndarray, labels: np.ndarray, out_path: str, bins: int = 60
) -> Optional[str]:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return None
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.hist(scores[labels == 1], bins=bins, alpha=0.6, density=True, label="target")
    ax.hist(scores[labels == 0], bins=bins, alpha=0.6, density=True, label="nontarget")
    ax.set_xlabel("score")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
