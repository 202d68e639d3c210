"""The train step's remat option: one step under each policy ("full",
"dots", "dots_batch") of a small SnowdarXvector against the JAX
package's make_train_step under the same policy, leaf by leaf (the
helpers and tolerances of tests/test_torch_train_step.py: float64 on
features, every leaf within 1e-6 of its scale); then, in the port alone,
each policy against no remat on a Conformer with dropout 0.1 and
train-mode BatchNorm in its conv modules, at 1e-12 with the batch
statistics equal, with and without mixup: the recompute must draw the
forward's dropout masks and leave the running statistics as the forward
set them, and the generator must end where the plain step leaves it.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.train import TrainStepConfig, get_optimizer, init_train_state, make_train_step, sgd
from asv_subtools_tpu_torch.train.step_check import conformer_net
from test_torch_step_options import ALPHA, snowdar  # noqa: F401 (a fixture)
from test_torch_train_step import AAM, LR, assert_metrics_close, assert_states_close, make_batch, run_jax, run_port


@pytest.mark.parametrize("policy", ["full", "dots", "dots_batch"])
def test_remat_step_matches_jax(snowdar, policy):
    jnet, make_port, variables = snowdar
    batches = [make_batch(15, True)]
    jax_state, jax_m = run_jax(jnet, optax.sgd(LR), variables, batches,
                               JaxStepConfig(compute_dtype=jnp.float64, remat=policy))
    port_state, port_m = run_port(make_port(), sgd(LR), variables, batches,
                                  TrainStepConfig(compute_dtype=torch.float64, remat=policy))
    assert_metrics_close(port_m[0], jax_m[0])
    assert_states_close(port_state, jax_state, 1e-6)


def _conformer_step(config, mixup=False):
    """Two adamW steps of a narrow Conformer (dropout 0.1, BatchNorm in the
    conv modules) in f64 from one seed -> (state, metrics, the generator's
    next draw)."""
    net = conformer_net(AAM, 5, num_blocks=2, attention_dim=32, attention_heads=2, linear_units=64,
                        dropout_rate=0.1, encoder_params={"cnn_norm_type": "batch_norm"}).to(torch.float64)
    tx = get_optimizer("adamW", 1e-3)
    state = init_train_state(net, tx, "cpu")
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.float64, remat=config,
                                                           mixup_alpha=ALPHA if mixup else 0.0))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 60, 80, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    y = torch.tensor([0, 7, 9, 3])
    for _ in range(2):
        state, m = step(state, {"x": x, "y": y}, gen)
    return state, m, torch.rand(3, generator=gen)


@pytest.mark.parametrize("mixup", [False, True])
@pytest.mark.parametrize("policy", ["full", "dots", "dots_batch"])
def test_remat_keeps_dropout_masks_and_batch_stats(policy, mixup):
    ref, ref_m, ref_next = _conformer_step(None, mixup)
    assert any(k.endswith("conv_module.norm.mean") for k in ref.batch_stats)
    got, m, nxt = _conformer_step(policy, mixup)
    assert torch.equal(nxt, ref_next)  # the generator ends where the no-remat step leaves it
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-12)
    for k, v in ref.params.items():
        assert float((got.params[k] - v).abs().max()) <= 1e-12 * max(float(v.abs().max()), 1.0), k
    for k, v in ref.batch_stats.items():
        assert torch.equal(got.batch_stats[k], v), k
