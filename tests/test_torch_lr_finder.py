"""The port's run_lr_finder against JAX's on the same loss sequences.

A step function that ignores its state and returns the next loss of a
fixed sequence drives both finders (the JAX one with a PRNGKey, the port's
with a torch.Generator); the swept rates, the debiased smoothed losses and
the suggestion must be equal, and the port's raw losses are the
sequence's: a falling-then-diverging curve (stopped by
the divergence rule after step 10), one cut by a non-finite loss, one too
short for a suggestion, and a full sweep. The losses reach the port's
finder as 0-dim tensors, as a train step returns them.
"""

import jax
import numpy as np
import pytest
import torch

from asv_subtools_tpu.train.lr_finder import run_lr_finder as jax_run_lr_finder
from asv_subtools_tpu_torch.train import run_lr_finder


def _curve(kind, n):
    t = np.arange(n, dtype=np.float64)
    base = 5.0 * np.exp(-t / 8.0) + 1.0 + 0.05 * np.sin(3.0 * t)
    if kind == "diverging":
        return base + np.where(t > 20, np.exp((t - 20) / 2.0), 0.0)
    if kind == "nonfinite":
        out = base.copy()
        out[9] = np.inf
        return out
    return base


def _step(seq, wrap):
    it = iter(seq)

    def step(state, batch, rng, lr):
        return state + 1, {"loss": wrap(next(it))}

    return step


@pytest.mark.parametrize("kind,num_steps,batches", [("diverging", 60, 60), ("nonfinite", 30, 30),
                                                    ("plain", 40, 40), ("plain", 30, 5)])
def test_lr_finder_matches_jax(kind, num_steps, batches):
    seq = _curve(kind, batches)
    kw = dict(start_lr=1e-6, end_lr=3.0, num_steps=num_steps)
    ref = jax_run_lr_finder(_step(seq, lambda v: np.float32(v)), 0, range(batches), jax.random.PRNGKey(0), **kw)
    got = run_lr_finder(_step(seq, lambda v: torch.tensor(v, dtype=torch.float32)), 0, range(batches),
                        torch.Generator(), **kw)
    np.testing.assert_array_equal(got["lrs"], ref["lrs"])
    np.testing.assert_array_equal(got["losses"], ref["losses"])
    # the port also returns each step's own loss (as the f32 step gave it)
    np.testing.assert_array_equal(got["raw_losses"], seq[:len(got["lrs"])].astype(np.float32))
    assert got["suggested_lr"] == ref["suggested_lr"]
    if kind == "diverging":
        assert 10 < len(got["lrs"]) < num_steps
    if kind == "nonfinite":
        assert len(got["lrs"]) == 9
    if batches == 5:
        assert got["suggested_lr"] is None
    else:
        assert kw["start_lr"] <= got["suggested_lr"] <= kw["end_lr"]
