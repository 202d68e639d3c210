"""The train step's mixup and remat options against the JAX package's
make_train_step, leaf by leaf (the helpers and tolerances of
tests/test_torch_train_step.py: float64 on features, every leaf within
1e-6 of its scale, loss and grad_norm within 1e-6 relative).

Mixup: JAX draws lam and the permutation from its PRNG key, the port
from its generator; the test hands JAX's draws to the port through the
draw its mixup goes through (nn/tdnn.py ``mixup_draw``). One step on the
small ECAPA-TDNN, one with accum_grad 2 (a draw per micro-batch) on the
small SnowdarXvector (skip connections, SE, BatchNorm), and one on a
MultiTaskNet, whose targets are the dict {"spk", "phone"} permuted leaf
by leaf. Remat: one SnowdarXvector step under each policy ("full",
"dots", "dots_batch") against JAX's step under the same policy (the
x-vector's step compiles in a third of ECAPA's time); then, in the port
alone, each policy against no remat on a
Conformer with dropout 0.1 and train-mode BatchNorm in its conv modules,
at 1e-12 with the batch statistics equal: the recompute must draw the
forward's dropout masks and leave the running statistics as the forward
set them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.nn import tdnn as jtdnn
from asv_subtools_tpu.train.trainer import TrainState as JaxTrainState
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu.train.trainer import make_train_step as jax_make_train_step
from asv_subtools_tpu_torch.nn import tdnn as ptdnn
from asv_subtools_tpu_torch.train import TrainStepConfig, make_train_step, sgd
from asv_subtools_tpu_torch.weights import train_state_from_variables
from test_torch_multitask import _mt_nets, _phones
from test_torch_optimizer_states import port_variables
from test_torch_train_step import LR, assert_metrics_close, assert_states_close, make_batch, run_jax, run_port
from test_torch_xvector import _nets

ALPHA = 0.6


@pytest.fixture(scope="module")
def snowdar():
    """(the JAX net, a maker of the port's, the variables) of a small
    SnowdarXvector (skip connections, SE, BatchNorm)."""
    jnet, pnet = _nets("snowdar")
    return jnet, lambda: _nets("snowdar")[1], port_variables(pnet, 13)


def _jax_draws(b, accum=1):
    """JAX's (lam, index) of each micro-batch of a step given PRNGKey(0)
    (trainer.py:209-214: rng, mix_rng = split(rng); mixup splits mix_rng)."""
    with jax.enable_x64():
        rng = jax.random.PRNGKey(0)
        keys = [rng] if accum == 1 else list(jax.random.split(rng, accum))
        out = []
        for key in keys:
            _, mix = jax.random.split(key)
            _, lam, index = jtdnn.mixup(jnp.zeros((b // accum, 1)), mix, ALPHA)
            out.append((float(lam), np.array(index)))
    return out


def _seam(monkeypatch, draws):
    """The port's mixup takes JAX's draws, one per call, in order."""
    left = list(draws)

    def draw(batch, alpha, generator, device, dtype):
        lam, index = left.pop(0)
        assert batch == len(index) and alpha == ALPHA
        return torch.tensor(lam, dtype=dtype, device=device), torch.as_tensor(index, device=device)

    monkeypatch.setattr(ptdnn, "mixup_draw", draw)
    return left


@pytest.mark.parametrize("accum", [1, 2])
def test_mixup_step_matches_jax(monkeypatch, snowdar, accum):
    jnet, make_port, variables = snowdar
    batches = [make_batch(14, True)]
    draws = _jax_draws(4, accum)
    assert len({float(lam) for lam, _ in draws}) == accum and any((i != np.arange(len(i))).any() for _, i in draws)
    jax_state, jax_m = run_jax(jnet, optax.sgd(LR), variables, batches,
                               JaxStepConfig(compute_dtype=jnp.float64, mixup_alpha=ALPHA, accum_grad=accum))
    left = _seam(monkeypatch, draws)
    port_state, port_m = run_port(make_port(), sgd(LR), variables, batches,
                                  TrainStepConfig(compute_dtype=torch.float64, mixup_alpha=ALPHA, accum_grad=accum))
    assert not left
    assert_metrics_close(port_m[0], jax_m[0])
    assert_states_close(port_state, jax_state, 1e-6)


def test_multitask_mixup_step_matches_jax(monkeypatch):
    jnet, pnet = _mt_nets()
    x, y, mask = make_batch(42, True)
    phones = _phones(43)
    targets = {"spk": jnp.asarray(y, jnp.int32), "phone": jnp.asarray(phones, jnp.int32)}
    variables = port_variables(_mt_nets()[1], 3)
    config = dict(compute_dtype=jnp.float64, mixup_alpha=ALPHA)
    with jax.enable_x64():
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                              opt_state=optax.sgd(LR).init(params))
        step = jax.jit(jax_make_train_step(jnet, optax.sgd(LR), config=JaxStepConfig(**config)))
        batch = {"x": jnp.asarray(x), "y": targets, "mask": jnp.asarray(mask)}
        jax_state, jm = jax.device_get(step(state, batch, jax.random.PRNGKey(0)))
    _seam(monkeypatch, _jax_draws(4))
    state = train_state_from_variables(pnet, {"step": 0, **variables, "opt_state": {"count": 0}}, device="cpu")
    state.opt_state = sgd(LR).init(state.params)
    pstep = make_train_step(pnet, sgd(LR), config=TrainStepConfig(compute_dtype=torch.float64,
                                                                  mixup_alpha=ALPHA))
    pbatch = {"x": torch.from_numpy(x), "y": {"spk": torch.from_numpy(y), "phone": torch.from_numpy(phones)},
              "mask": torch.from_numpy(mask)}
    port_state, pm = pstep(state, pbatch, torch.Generator().manual_seed(0))
    for key in ("loss", "grad_norm", "accuracy"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-6, atol=1e-12, err_msg=key)
    assert_states_close(port_state, jax_state, 1e-6)
