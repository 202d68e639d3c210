"""The numbers that decide ``correct``, each computed from the program's
outputs and the reference's on the same inputs.

Extraction (``emb_gap``): the widest relative L2 gap ||e - r|| / ||r||
of a served embedding e from the reference's r, over a seeded sample of
the answers the window yielded: every bucket the window filled, and the
longest utterance.

Training, over the first three steps:
- each step's loss as a relative gap: the worst of the three
  (``loss_gap``) and the first step's (``loss1_gap``);
- the first gradient as the optimiser got it (the program's from its
  SGD momentum trace after one step, less the weight decay's term), leaf
  by leaf: the gap between the two norms over the larger of the
  reference's norm of that leaf and of the median leaf; the worst
  leaf's (``grad_gap``) and the median leaf's (``grad_median_gap``);
- the first gradient's error, ||g - r|| over the same denominator, the
  median leaf's (``grad_err_median``);
- the parameters' change after three steps as the gradient's norms,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (a bias ahead of a train-mode BN: rounding alone
  moves them): the worst leaf of at least :data:`MIN_LEAF` elements
  (``change_gap``), the worst of every leaf (``change_gap_all``) and the
  median leaf (``change_median_gap``). A smaller leaf (a BN's scale or
  shift, the stem's 3x3 kernel) sums the gradient of the whole batch into
  a few dozen numbers, and every ReLU below it passes the gradient on a
  gate that a rounding of the forward flips: its gap carries that noise,
  in any implementation below float32;
- the first gradient of the head's leaves, those that no ReLU lies
  between and the loss (the class weights, the last BN's scale and
  shift), as one vector scaled to unit norm on each side: the distance
  between the two (``head_grad_err``). Below the head's ReLU, which a
  train-mode BN over the batch follows, a rounding of the forward that
  flips the gate of a unit that few rows fire carries that BN's gradient
  over its small batch deviation, about half the norm of every leaf's
  gradient below it, in any implementation below float32; the unit norm
  takes out the global clip's factor, which those leaves set;
- each train-mode BatchNorm's batch variance at the first step
  (:func:`bn_var_gaps`), the worst layer (``bn_var_gap``).
A cell's limits file says which of them decide ``correct``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

ZERO_GRAD = 1e-3  # a leaf under this share of the median leaf's gradient norm has none
MIN_LEAF = 1000  # the fewest elements of a leaf in ``change_gap``


def embedding_gaps(program: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    program, reference = program.float(), reference.float()
    return torch.linalg.vector_norm(program - reference, dim=-1) / torch.linalg.vector_norm(reference, dim=-1)


def sample_answers(by_bucket: Dict[int, List[int]], longest: int, size: int, rng: np.random.Generator
                   ) -> List[int]:
    """A seeded sample of answers: an equal share from each bucket (all of
    a bucket that holds fewer), and the longest answer."""
    share = max(1, size // max(1, len(by_bucket)))
    picked = {longest}
    for b in sorted(by_bucket):
        keys = by_bucket[b]
        picked.update(keys if len(keys) <= share else rng.choice(keys, share, replace=False).tolist())
    return sorted(picked)


def _norms(d: Dict[str, torch.Tensor], names: Sequence[str]) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(d[k].double())) for k in names])


def _gaps(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Each kept leaf's gap of norms over the larger of its reference norm
    and the median kept leaf's (nan where not kept)."""
    denom = np.maximum(ref, np.median(ref[keep]))
    return np.where(keep, np.abs(prog - ref) / denom, np.nan)


def bn_var_gaps(new_var: Dict[str, torch.Tensor], old_var: Dict[str, torch.Tensor], momentum,
                reference: Dict[str, tuple]) -> Dict[str, float]:
    """Each train-mode BatchNorm's batch variance at the first step, as the
    program's running average took it ((new - (1 - m) old) / m, m its
    ``momentum(name)``), against the reference's: ||v - r|| / ||r|| by
    layer, keyed by the BN's name."""
    out = {}
    for name, (_, ref_var) in reference.items():
        key, m = f"backbone.{name}.var", momentum(name)
        got = (new_var[key].double() - (1 - m) * old_var[key].double()) / m
        out[name] = float(torch.linalg.vector_norm(got - ref_var.double()) / torch.linalg.vector_norm(ref_var.double()))
    return out


def train_gaps(program: dict, reference: dict, params0: Dict[str, torch.Tensor],
               notes: Optional[List[str]] = None, head: Sequence[str] = ()) -> Dict[str, float]:
    """program and reference: ``losses`` (three floats), ``grad1`` (the
    first step's gradients as the optimiser took them) and ``params3``
    (the parameters after three steps), by the program's names; ``head``
    names the head's leaves."""
    names = list(params0)
    lp, lr = np.asarray(program["losses"], np.float64), np.asarray(reference["losses"], np.float64)
    g_ref = _norms(reference["grad1"], names)
    g_prog = _norms(program["grad1"], names)
    moved = g_ref >= ZERO_GRAD * np.median(g_ref)
    d_prog = _norms({k: program["params3"][k].double() - params0[k].double() for k in names}, names)
    d_ref = _norms({k: reference["params3"][k].double() - params0[k].double() for k in names}, names)
    grad = _gaps(g_prog, g_ref, np.ones(len(names), bool))
    change = _gaps(d_prog, d_ref, moved)
    large = np.array([params0[k].numel() >= MIN_LEAF for k in names])
    if notes is not None:
        notes.append(f"losses program {lp.tolist()} reference {lr.tolist()}")
        for what, gaps, p, r in (("grad", grad, g_prog, g_ref), ("change", change, d_prog, d_ref),
                                 ("change of a large leaf", np.where(large, change, np.nan), d_prog, d_ref)):
            for j in np.argsort(-np.nan_to_num(gaps, nan=-1.0))[:4]:
                notes.append(f"{what} {names[j]}: gap {gaps[j]:.4g} program {p[j]:.6g} reference {r[j]:.6g}")
        notes.append(f"change leaves left out (no gradient): {[names[j] for j in np.flatnonzero(~moved)]}")
    loss = np.abs(lp - lr) / np.abs(lr)
    g_diff = _norms({k: program["grad1"][k].double() - reference["grad1"][k].double() for k in names}, names)
    g_err = g_diff / np.maximum(g_ref, np.median(g_ref))
    out = {"loss_gap": float(np.max(loss)), "loss1_gap": float(loss[0]),
           "grad_gap": float(np.nanmax(grad)), "grad_median_gap": float(np.nanmedian(grad)),
           "grad_err_median": float(np.median(g_err)), "change_gap": float(np.nanmax(change[large])),
           "change_gap_all": float(np.nanmax(change)), "change_median_gap": float(np.nanmedian(change))}
    if head:
        unit = lambda g: (lambda v: v / torch.linalg.vector_norm(v))(torch.cat([g[k].double().flatten() for k in head]))
        out["head_grad_err"] = float(torch.linalg.vector_norm(unit(program["grad1"]) - unit(reference["grad1"])))
    return out
