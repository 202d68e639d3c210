"""The port's Trainer (train/trainer.py) against the JAX package's Trainer.

Both sides start from one JAX train state (the small ECAPA of
tests/test_torch_train_step.py, weights.train_state_from_variables) and
run two epochs over the same four masked batches in float64, with the
margin warm-up active (MarginWarm over epochs 1-3 at 2 steps an epoch,
its lambda clamped at 1e-3), ReduceOnPlateau fed by a validation at every
report point (report_interval 1, so the plateau scale falls inside the
epoch and reaches later steps), sgd with momentum on a cyclic schedule,
and a validation after each epoch. The head is the AAM margin softmax,
float64 end to end. JAX runs on one CPU device (a 1x1 mesh).

Tolerance 1e-6: every epoch metric (loss and accuracy means, the total
skipped, grad_norm and lr of the last step; relative, 1e-12 absolute),
the validation metrics, and every params and batch_stats leaf within 1e-6
of that leaf's scale (the bound of tests/test_torch_train_state.py). The
plateau scales must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.nn.loss import MarginWarm as JaxMarginWarm
from asv_subtools_tpu.parallel import make_mesh
from asv_subtools_tpu.train import lr_scheduler as jax_sched
from asv_subtools_tpu.train.optim import get_optimizer as jax_get_optimizer
from asv_subtools_tpu.train.trainer import Trainer as JaxTrainer
from asv_subtools_tpu.train.trainer import TrainState as JaxTrainState
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.nn import MarginWarm
from asv_subtools_tpu_torch.train import (ReduceOnPlateau, Trainer, TrainStepConfig, cyclic, get_optimizer,
                                          make_eval_step)
from asv_subtools_tpu_torch.weights import train_state_from_variables, train_state_to_variables
from test_torch_train_step import assert_states_close, init_variables, jax_net, make_batch, port_batch, port_net

SCHEDULE = dict(base_lr=1e-3, max_lr=5e-2, step_size_up=3)
WARM = dict(start_epoch=1, end_epoch=3, offset_margin=-0.2, init_lambda=0.0, epoch_iter=2)
PLATEAU = dict(factor=0.5, patience=0, threshold=0.5)  # any loss not halved cuts the scale


def _batches():
    return [dict(zip(("x", "y", "mask"), make_batch(40 + i, True))) for i in range(4)]


def _valid():
    return [dict(zip(("x", "y", "mask"), make_batch(60 + i, True))) for i in range(2)]


def _run_jax(variables, train, valid):
    with jax.enable_x64():
        tx = jax_get_optimizer("sgd", jax_sched.cyclic(**SCHEDULE), momentum=0.9, weight_decay=1e-3)
        trainer = JaxTrainer(jax_net(), tx, lr_schedule=jax_sched.cyclic(**SCHEDULE),
                             config=JaxStepConfig(compute_dtype=jnp.float64), mesh=make_mesh(devices=jax.devices()[:1]),
                             margin_warm=JaxMarginWarm(**WARM), plateau=jax_sched.ReduceOnPlateau(**PLATEAU),
                             report_interval=1)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                              opt_state=tx.init(params))
        epochs, scales = [], []
        for epoch in range(2):
            state, m = trainer.run_epoch(state, iter(train), jax.random.PRNGKey(0), epoch=epoch,
                                         valid_iter=lambda: iter(valid))
            epochs.append((m, trainer.validate(state, iter(valid))))
            scales.append(trainer.plateau.scale)
        return jax.device_get(state), epochs, scales


def _run_port(variables, train, valid):
    net = port_net()
    tx = get_optimizer("sgd", cyclic(**SCHEDULE), momentum=0.9, weight_decay=1e-3)
    state = train_state_from_variables(net, {"step": 0, "params": variables["params"],
                                             "batch_stats": variables["batch_stats"], "opt_state": {"count": 0}},
                                       device="cpu")
    state.opt_state = tx.init(state.params)
    trainer = Trainer(net, tx, lr_schedule=cyclic(**SCHEDULE), config=TrainStepConfig(compute_dtype=torch.float64),
                      margin_warm=MarginWarm(**WARM), plateau=ReduceOnPlateau(**PLATEAU), report_interval=1,
                      device="cpu")
    gen = torch.Generator().manual_seed(0)
    epochs, scales, stats = [], [], []
    for epoch in range(2):
        state, m = trainer.run_epoch(state, iter(train), gen, epoch=epoch, valid_iter=lambda: iter(valid))
        stats.append(trainer.epoch_stats)
        epochs.append((m, trainer.validate(state, iter(valid))))
        scales.append(trainer.plateau.scale)
    return state, epochs, scales, stats


@pytest.fixture(scope="module")
def runs():
    variables = init_variables(jax_net(), seed=12)
    train, valid = _batches(), _valid()
    return _run_jax(variables, train, valid), _run_port(variables, train, valid)


def test_epoch_metrics_match_jax(runs):
    (_, jax_epochs, jax_scales), (_, port_epochs, port_scales, _) = runs
    for (pm, pv), (jm, jv) in zip(port_epochs, jax_epochs):
        assert set(pm) == set(jm) == {"loss", "accuracy", "grad_norm", "skipped", "lr"}
        for key in jm:
            np.testing.assert_allclose(pm[key], jm[key], rtol=1e-6, atol=1e-12, err_msg=key)
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(pv[key], jv[key], rtol=1e-6, atol=1e-12, err_msg=f"valid {key}")
    assert port_scales == jax_scales and port_scales[-1] < 0.5  # the plateau cut the lr inside the run


def test_every_leaf_matches_jax(runs):
    (jax_state, _, _), (port_state, _, _, stats) = runs
    assert_states_close(port_state, jax_state, 1e-6)
    assert int(port_state.step) == int(jax_state.step) == 8
    assert [s["first_step"] for s in stats] == [0, 4] and [s["steps"] for s in stats] == [4, 4]
    assert all(len(s["data_wait_s"]) == len(s["turn_s"]) == 4 for s in stats)


def test_eval_step_weights_rows():
    """A row of weight 0 contributes nothing; the sums of the kept rows are
    those of the batch without them."""
    variables = init_variables(jax_net(), seed=13)
    net = port_net()
    state = train_state_from_variables(net, {"step": 0, **variables, "opt_state": {"count": 0}}, device="cpu")
    step = make_eval_step(net)
    x, y, mask = make_batch(70, True)
    full = port_batch(x, y, mask, torch.float64)
    weighted = step(state, dict(full, weight=torch.tensor([1.0, 1.0, 0.0, 0.0])))
    head = step(state, port_batch(x[:2], y[:2], mask[:2], torch.float64))
    assert float(weighted["n"]) == 2.0
    for key in ("loss_sum", "acc_sum"):
        np.testing.assert_allclose(float(weighted[key]), float(head[key]), rtol=1e-12)


def test_trainer_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(port_net(), get_optimizer("sgd", 0.1))


def test_state_round_trip_after_the_epochs(runs):
    """The trained state crosses back into the JAX layout unchanged."""
    _, (port_state, _, _, _) = runs
    tree = train_state_to_variables(port_state)
    again = train_state_from_variables(port_net(), tree, device="cpu")
    assert all(torch.equal(again.params[k], v) for k, v in port_state.params.items())
