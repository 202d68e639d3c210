"""PLDA domain adaptation: Kaldi unsupervised ("aplda"), CORAL, CORAL+.

Parity: score/pyplda/plda_base.py:344-485 (PldaUnsupervisedAdaptor =
kaldi ivector-adapt-plda), ivector-adapt-plda-coral.py:15-85 (CORAL),
ivector-adapt-plda-coralplus.py (CORAL+). LIP/CIP variants are linear /
correlation-alignment interpolations over the same two-covariance form.

These operate on the (mean, within_var, between_var) two-covariance form;
`to_two_covariance`/`from_two_covariance` convert to the diagonalized
scoring form in plda.Plda.

The port's own numpy copy of asv_subtools_tpu/backend/adaptation.py,
behaviour unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .plda import Plda


@dataclasses.dataclass
class TwoCovPlda:
    """PLDA in two-covariance (mean, within, between) form."""

    mean: np.ndarray
    within_var: np.ndarray
    between_var: np.ndarray

    def to_scoring_form(self) -> Plda:
        """Diagonalize (plda_base.py get_output :186-214)."""
        c = np.linalg.inv(np.linalg.cholesky(self.within_var))
        b_proj = c @ self.between_var @ c.T
        s, u = np.linalg.eigh(b_proj)
        order = np.argsort(s)[::-1]
        s, u = np.maximum(s[order], 1e-10), u[:, order]
        return Plda(mean=self.mean.copy(), transform=u.T @ c, psi=s)

    @staticmethod
    def from_scoring_form(plda: Plda) -> "TwoCovPlda":
        """Invert the diagonalization: within = T^-1 T^-T, between = T^-1 diag(psi) T^-T."""
        t_inv = np.linalg.inv(plda.transform)
        within = t_inv @ t_inv.T
        between = t_inv @ np.diag(plda.psi) @ t_inv.T
        return TwoCovPlda(plda.mean.copy(), within, between)


def _adaptation_variance(
    vectors: np.ndarray, old_mean: np.ndarray, mean_diff_scale: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """In-domain mean + covariance with the mean-difference term added."""
    x = vectors.astype(np.float64)
    mean = x.mean(axis=0)
    var = x.T @ x / x.shape[0] - np.outer(mean, mean)
    diff = mean - old_mean
    var = var + mean_diff_scale * np.outer(diff, diff)
    return mean, var


def adapt_plda_unsupervised(
    plda: Plda,
    adapt_vectors: np.ndarray,
    mean_diff_scale: float = 1.0,
    within_covar_scale: float = 0.3,
    between_covar_scale: float = 0.7,
) -> Plda:
    """Kaldi ivector-adapt-plda (plda_base.py:344-485).

    Directions where the adaptation-data variance exceeds the training
    variance get the excess split between within/between covariances.
    """
    dim = plda.dim
    mean, variance = _adaptation_variance(adapt_vectors, plda.mean, mean_diff_scale)

    # transform into total-covariance-unit space
    transform_mod = plda.transform / np.sqrt(1.0 + plda.psi)[:, None]
    variance_proj = transform_mod @ variance @ transform_mod.T
    s, p = np.linalg.eigh(variance_proj)

    w = np.diag(1.0 / (1.0 + plda.psi))
    b = np.diag(plda.psi / (1.0 + plda.psi))
    w2 = p.T @ w @ p
    b2 = p.T @ b @ p
    excess = np.maximum(s - 1.0, 0.0)
    w2[np.diag_indices(dim)] += excess * within_covar_scale
    b2[np.diag_indices(dim)] += excess * between_covar_scale

    combined_inv = np.linalg.inv(p.T @ transform_mod)
    w_mod = combined_inv @ w2 @ combined_inv.T
    b_mod = combined_inv @ b2 @ combined_inv.T
    out = TwoCovPlda(mean, w_mod, b_mod).to_scoring_form()
    return out


def adapt_plda_coral(
    plda: TwoCovPlda,
    adapt_vectors: np.ndarray,
    mean_diff_scale: float = 1.0,
    within_covar_scale: float = 0.8,
    between_covar_scale: float = 0.8,
) -> TwoCovPlda:
    """CORAL adaptation (ivector-adapt-plda-coral.py:15-85).

    Aligns out-of-domain covariance to the in-domain one via
    A = C_in^{1/2} C_out^{-1/2} and maps both PLDA covariances through A.
    `*_covar_scale` are unused by the reference's update (kept for CLI
    parity) — the covariances are fully re-aligned.
    """
    return _coral_aligned(plda, adapt_vectors, mean_diff_scale)


def _covar_excess(base: np.ndarray, other: np.ndarray) -> np.ndarray:
    """inv(B).T @ max(0, E - I) @ inv(B): the part of `other` exceeding
    `base`, via simultaneous diagonalization (B maps base -> I and
    other -> diag(E)). The regularization core shared by CORAL+ and the
    LIP/CIP "Reg" variants (Wang et al. 2020; coralplus.py:77-93)."""
    dim = base.shape[0]
    e, q = np.linalg.eigh(base)
    e = np.maximum(e, 1e-12)
    t = np.diag(e**-0.5) @ q.T
    ev, p = np.linalg.eigh(t @ other @ t.T)
    b = q @ np.diag(e**-0.5) @ p
    b_inv = np.linalg.inv(b)
    return b_inv.T @ np.maximum(0.0, np.diag(ev) - np.eye(dim)) @ b_inv


def _coral_aligned(
    plda: TwoCovPlda, adapt_vectors: np.ndarray, mean_diff_scale: float
) -> TwoCovPlda:
    """CORAL alignment core shared by coral/coral+/cip
    (ivector-adapt-plda-coral.py:40-80)."""
    mean, variance = _adaptation_variance(
        adapt_vectors, plda.mean, mean_diff_scale
    )
    o_cov = plda.within_var + plda.between_var
    eig_o, q_o = np.linalg.eigh(o_cov)
    eig_i, q_i = np.linalg.eigh(variance)
    eig_o = np.maximum(eig_o, 1e-10)
    eig_i = np.maximum(eig_i, 1e-10)
    c_o = q_o @ np.diag(eig_o**-0.5) @ q_o.T
    c_i = q_i @ np.diag(eig_i**0.5) @ q_i.T
    a = c_i @ c_o
    return TwoCovPlda(
        mean=mean,
        within_var=a @ plda.within_var @ a.T,
        between_var=a @ plda.between_var @ a.T,
    )


def adapt_plda_coral_plus(
    plda: TwoCovPlda,
    adapt_vectors: np.ndarray,
    mean_diff_scale: float = 1.0,
    within_covar_scale: float = 0.8,
    between_covar_scale: float = 0.8,
) -> TwoCovPlda:
    """CORAL+ (ivector-adapt-plda-coralplus.py:40-93): add back the part
    of the CORAL-aligned covariances that EXCEEDS the originals, scaled —
    a regularized one-sided update rather than full re-alignment."""
    aligned = _coral_aligned(plda, adapt_vectors, mean_diff_scale)
    return TwoCovPlda(
        mean=aligned.mean,
        within_var=plda.within_var + within_covar_scale
        * _covar_excess(plda.within_var, aligned.within_var),
        between_var=plda.between_var + between_covar_scale
        * _covar_excess(plda.between_var, aligned.between_var),
    )


def adapt_plda_lip(
    plda_out: TwoCovPlda,
    plda_in: TwoCovPlda,
    interpolation_weight: float = 0.4,
) -> TwoCovPlda:
    """LIP (ivector-adapt-plda-lip.py:15-48, Garcia-Romero & McCree
    2014): covariances = w*OUT + (1-w)*IN; the mean stays the IN-domain
    mean (it is NOT interpolated)."""
    w = interpolation_weight
    return TwoCovPlda(
        mean=plda_in.mean.copy(),
        within_var=w * plda_out.within_var + (1 - w) * plda_in.within_var,
        between_var=w * plda_out.between_var + (1 - w) * plda_in.between_var,
    )


def adapt_plda_lip_reg(
    plda_out: TwoCovPlda,
    plda_in: TwoCovPlda,
    interpolation_weight: float = 0.6,
) -> TwoCovPlda:
    """LIP-Reg (ivector-adapt-plda-lip-reg.py:15-60, Wang et al. 2020):
    IN + (1-w) * excess(IN, OUT) per covariance; IN-domain mean."""
    w = interpolation_weight
    return TwoCovPlda(
        mean=plda_in.mean.copy(),
        within_var=plda_in.within_var + (1 - w)
        * _covar_excess(plda_in.within_var, plda_out.within_var),
        between_var=plda_in.between_var + (1 - w)
        * _covar_excess(plda_in.between_var, plda_out.between_var),
    )


def adapt_plda_cip(
    plda_out: TwoCovPlda,
    plda_in: TwoCovPlda,
    adapt_vectors: np.ndarray,
    interpolation_weight: float = 0.5,
    mean_diff_scale: float = 1.0,
) -> TwoCovPlda:
    """CIP (ivector-adapt-plda-cip.py:104-135): CORAL-align the
    OUT-domain model with the adaptation data, then covariances =
    w*coral + (1-w)*IN; IN-domain mean."""
    aligned = _coral_aligned(plda_out, adapt_vectors, mean_diff_scale)
    w = interpolation_weight
    return TwoCovPlda(
        mean=plda_in.mean.copy(),
        within_var=w * aligned.within_var + (1 - w) * plda_in.within_var,
        between_var=w * aligned.between_var + (1 - w) * plda_in.between_var,
    )


def adapt_plda_cip_reg(
    plda_out: TwoCovPlda,
    plda_in: TwoCovPlda,
    adapt_vectors: np.ndarray,
    interpolation_weight: float = 0.5,
    mean_diff_scale: float = 1.0,
) -> TwoCovPlda:
    """CIP-Reg (ivector-adapt-plda-cip-reg.py:98-128): CORAL-align the
    OUT-domain model, then IN + w * excess(IN, coral) per covariance;
    IN-domain mean."""
    aligned = _coral_aligned(plda_out, adapt_vectors, mean_diff_scale)
    w = interpolation_weight
    return TwoCovPlda(
        mean=plda_in.mean.copy(),
        within_var=plda_in.within_var + w
        * _covar_excess(plda_in.within_var, aligned.within_var),
        between_var=plda_in.between_var + w
        * _covar_excess(plda_in.between_var, aligned.between_var),
    )
