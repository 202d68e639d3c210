"""Training the Conformer x-vector: the f64 train step against the JAX
package's make_train_step leaf by leaf, the model warm-up, dropout, and
the train state's round trip.

The step: a narrow Conformer (2 blocks, d = 64, 2 heads, linear_units
128, conv2d subsampling, 24 bins, embedding 16), B = 4, 20 targets, the
all-f64 AAM head, both sides in float64 on features at dropout 0 (the two
sides cannot draw the same dropout masks), with the helpers and
tolerances of tests/test_torch_train_step.py (every leaf within 1e-6 of
its scale). With ``model_warmup_steps`` = 4 the first two steps blend
each block at warmup 0 and 0.25 (alpha 0.1 and 0.35). The model has no
BatchNorm, so its train state holds no batch_stats.

Dropout is held on its own: the share of kept entries, the 1 / (1 - p)
scale, and the same generator seed giving the same step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models.conformer import ConformerXvector as JaxConformerXvector
from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.train import lr_scheduler as jax_sched
from asv_subtools_tpu.train.optim import get_optimizer as jax_get_optimizer
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.models import ConformerXvector, SpeakerNet
from asv_subtools_tpu_torch.nn import dropout
from asv_subtools_tpu_torch.train import (TrainStepConfig, get_optimizer, init_train_state, make_train_step, noam,
                                          sgd)
from asv_subtools_tpu_torch.train.step_check import OPTS, conformer_net
from asv_subtools_tpu_torch.weights import train_state_from_variables, train_state_to_variables
from test_torch_train_state import _jax_adam_state, _moments
from test_torch_train_step import (
    AAM,
    C,
    D,
    LR,
    assert_metrics_close,
    assert_states_close,
    init_variables,
    make_batch,
    port_batch,
    run_jax,
    run_port,
)

SMALL = dict(num_blocks=2, attention_dim=64, attention_heads=2, linear_units=128, embd_dim=16, out_dim=96)
WARMUP = 4


def jax_net(**kw):
    return JaxSpeakerNet(JaxConformerXvector(**{**SMALL, "dropout_rate": 0.0, **kw}), AAM[0], AAM[1],
                         num_targets=C)


def port_net(dtype=torch.float64, **kw):
    backbone = ConformerXvector(D, device="cpu", **{**SMALL, "dropout_rate": 0.0, **kw})
    return SpeakerNet(backbone, AAM[0], AAM[1], num_targets=C).to(dtype)


@pytest.fixture(scope="module")
def variables():
    v = init_variables(jax_net())
    assert "batch_stats" not in v
    return {**v, "batch_stats": {}}


@pytest.mark.parametrize("masked,warmup", [(False, 0), (True, 0), (True, WARMUP)])
def test_sgd_steps_match_jax_leaf_by_leaf(variables, masked, warmup):
    batches = [make_batch(1, masked), make_batch(2, masked)]
    jax_state, jax_m = run_jax(jax_net(), optax.sgd(LR), variables, batches,
                               JaxStepConfig(compute_dtype=jnp.float64, model_warmup_steps=warmup))
    port_state, port_m = run_port(port_net(), sgd(LR), variables, batches,
                                  TrainStepConfig(compute_dtype=torch.float64, model_warmup_steps=warmup))
    for p, j in zip(port_m, jax_m):
        assert_metrics_close(p, j)
    assert_states_close(port_state, jax_state, 1e-6)
    assert int(port_state.step) == 2 and port_state.batch_stats == {}


def test_adamw_step_from_jax_state_with_warmup(variables):
    """The recipe's optimizer family (adamW on the noam schedule) one step on
    from count 7, with the model warm-up blending every block."""
    params = variables["params"]
    mu, nu = _moments(params, 11)
    sched = dict(base_lr=1.0, model_dim=64, warmup_steps=20)
    with jax.enable_x64():
        jtx = jax_get_optimizer("adamW", jax_sched.noam(**sched), weight_decay=5e-2)
    ptx = get_optimizer("adamW", noam(**sched), weight_decay=5e-2)
    batches = [make_batch(12, True)]
    jax_state, jax_m = run_jax(jax_net(), jtx, variables, batches,
                               JaxStepConfig(compute_dtype=jnp.float64, model_warmup_steps=WARMUP),
                               _jax_adam_state(jtx, params, mu, nu, 7))
    port_state, port_m = run_port(port_net(), ptx, variables, batches,
                                  TrainStepConfig(compute_dtype=torch.float64, model_warmup_steps=WARMUP),
                                  {"count": 7, "mu": mu, "nu": nu})
    assert_metrics_close(port_m[0], jax_m[0])
    assert_states_close(port_state, jax_state, 1e-6)


def test_warmup_reaches_the_backbone_as_a_device_tensor():
    """step / model_warmup_steps in float32 on the state's device, through
    SpeakerNet to the backbone; 1.0 without model_warmup_steps."""
    seen = []
    net = port_net(torch.float32)
    net.backbone.register_forward_pre_hook(lambda mod, args, kwargs: seen.append(kwargs.get("warmup")),
                                           with_kwargs=True)
    x, y, mask = make_batch(13, True)
    batch = port_batch(x, y, mask, torch.float32)
    for steps in (WARMUP, 0):
        state = init_train_state(net, sgd(LR), "cpu")
        step = make_train_step(net, sgd(LR), config=TrainStepConfig(compute_dtype=torch.float32,
                                                                   model_warmup_steps=steps))
        gen = torch.Generator().manual_seed(0)
        for _ in range(3):
            state, _ = step(state, batch, gen)
    tensors, floats = seen[:3], seen[3:]
    assert all(isinstance(w, torch.Tensor) and w.dtype == torch.float32 and w.dim() == 0 for w in tensors)
    assert [float(w) for w in tensors] == [0.0, 0.25, 0.5]
    assert floats == [1.0, 1.0, 1.0]


def test_dropout_keeps_one_minus_p_and_scales_by_its_inverse():
    x = torch.full((400, 500), 3.0)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - 0.9) < 4 * (0.9 * 0.1 / x.numel()) ** 0.5
    assert torch.equal(y[kept], x[kept] / (1.0 - 0.1))
    assert torch.equal(y, dropout(x, 0.1, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, dropout(x, 0.1, torch.Generator().manual_seed(1)))


def test_dropout_draws_from_the_steps_generator(variables):
    """At dropout 0.1 (the bench's), the same seed gives the same step bit
    for bit and another seed another step; eval mode draws nothing."""
    net = port_net(torch.float32, dropout_rate=0.1)
    x, y, mask = make_batch(14, True)
    batch = port_batch(x, y, mask, torch.float32)
    tx = sgd(LR)
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.float32))
    tree = {"step": 0, "params": variables["params"], "batch_stats": {}, "opt_state": {"count": 0}}
    state = train_state_from_variables(net, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree),
                                       device="cpu")
    state.opt_state = tx.init(state.params)
    runs = [step(state, batch, torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    (a, ma), (b, mb), (c, mc) = runs
    assert float(ma["loss"]) == float(mb["loss"]) != float(mc["loss"])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert any(not torch.equal(a.params[k], c.params[k]) for k in a.params)
    model = net.backbone.eval()
    xt, mt = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(mask)
    with torch.no_grad():
        assert torch.equal(model(xt, mt, generator=torch.Generator().manual_seed(1)),
                           model(xt, mt, generator=torch.Generator().manual_seed(2)))


def _jax_train_state(variables):
    mu, nu = _moments(variables["params"], 15)
    return {"step": np.asarray(4, np.int32), "params": variables["params"], "batch_stats": {},
            "opt_state": {"count": np.asarray(4, np.int32), "mu": mu, "nu": nu}}


def test_train_state_round_trip_bit_for_bit(variables):
    tree = _jax_train_state(variables)
    state = train_state_from_variables(port_net(), tree, device="cpu")
    assert state.batch_stats == {}
    assert state.params["backbone.transformer.block_0.self_attn.pos_bias_u"].shape == (2, 32)
    assert state.opt_state["nu"]["backbone.transformer.block_1.conv_module.depthwise.weight"].shape == (64, 1, 15)
    back = train_state_to_variables(state)
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(back), flat(tree)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("fault", ["missing param", "extra param", "missing moment"])
def test_train_state_raises_on_unconsumed_or_missing_leaves(variables, fault):
    tree = _jax_train_state(variables)
    block = tree["params"]["backbone"]["transformer"]["block_1"]
    if fault == "missing param":
        del block["self_attn"]["pos_bias_v"]
    elif fault == "extra param":
        block["conv_module"]["stray"] = {"bias": np.zeros(4)}
    else:
        del tree["opt_state"]["mu"]["backbone"]["transformer"]["embed"]["proj"]
    with pytest.raises(ValueError):
        train_state_from_variables(port_net(), tree, device="cpu")


def test_bench_conformer_trains_on_waves():
    """bench.py's conformer family (6L-256D-4H conv2d, embedding 256,
    dropout 0.1, AAM m=0.2 over 5994 classes) through make_train_step with
    wave_input and the recipe's model warm-up: one adamW step on the CPU
    (float32, the plain front end)."""
    net = conformer_net(seed=1)
    assert len(net.backbone.transformer.blocks) == 6 and net.backbone.embd_dim == 256
    tx = get_optimizer("adamW", 1e-3)
    state = init_train_state(net, tx, "cpu")
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.float32, wave_input=True,
                                                           fbank_opts=OPTS, model_warmup_steps=1000))
    wave = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 16000)).astype(np.float32) * 1000.0)
    new, m = step(state, {"x": wave, "y": torch.as_tensor([3, 5000])}, torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0 and int(new.step) == 1
    key = "backbone.transformer.block_5.self_attn.pos_bias_u"
    assert not torch.equal(new.params[key], state.params[key])
