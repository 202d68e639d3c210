"""Train steps that carry state across: an AdamW step from a JAX state with
non-zero moments, accum_grad microbatches, a non-finite step, a 10-step
loop, and the train state's round trip through weights.py.

Both sides run in float64 on features (the small ECAPA of
tests/test_torch_train_step.py). The head is the recipe's sub-centre top-k
AAM loss (MarginSoftmaxLossV1), which computes in float32 on both sides
whatever the input, so its rounding (~1e-7 of the loss) reaches every
gradient: leaves are held to 1e-5 of their scale, loss and grad_norm to
1e-6 relative. accum_grad and the loop use the all-f64 AAM head at 1e-6.
AdamW is held only after moments exist: on a first step Adam moves every
parameter by about lr, so a leaf whose analytic gradient is 0 (a bias
ahead of a softmax over time) would move by lr in the direction of its
rounding noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.train import lr_scheduler as jax_sched
from asv_subtools_tpu.train.optim import get_optimizer as jax_get_optimizer
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.train import TrainStepConfig, cyclic, get_optimizer, make_train_step, sgd
from asv_subtools_tpu_torch.weights import train_state_from_variables, train_state_to_variables
from test_torch_train_step import (
    LR,
    SUBCENTER_TOPK,
    assert_metrics_close,
    assert_states_close,
    init_variables,
    jax_net,
    make_batch,
    port_batch,
    port_net,
    run_jax,
    run_port,
)

SCHEDULE = dict(base_lr=1e-4, max_lr=1e-2, step_size_up=5)  # lr moves between steps


def _moments(params, seed):
    rng = np.random.default_rng(seed)
    mu = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape) * 1e-2, params)
    nu = jax.tree_util.tree_map(lambda p: rng.uniform(1e-5, 1e-3, size=p.shape), params)
    return mu, nu


def _jax_adam_state(tx, params, mu, nu, count):
    """optax adamw's state (ScaleByAdamState, mask, ScaleByScheduleState) at `count`."""
    with jax.enable_x64():
        s = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
        to = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
        adam = s[0]._replace(count=jnp.asarray(count, jnp.int32), mu=to(mu), nu=to(nu))
        return (adam, s[1], s[2]._replace(count=jnp.asarray(count, jnp.int32)))


@pytest.fixture(scope="module")
def v1_variables():
    return init_variables(jax_net(SUBCENTER_TOPK), seed=3)


def test_adamw_step_from_jax_state(v1_variables):
    """The recipe's optimizer (adamW, weight decay on kernels only, a cyclic
    schedule read at the optimizer's count) one step on from count 7, with
    margin warm-up inputs and an lr_scale."""
    params = v1_variables["params"]
    mu, nu = _moments(params, 4)
    with jax.enable_x64():
        jtx = jax_get_optimizer("adamW", jax_sched.cyclic(**SCHEDULE), weight_decay=5e-2, decay_kernels_only=True)
    ptx = get_optimizer("adamW", cyclic(**SCHEDULE), weight_decay=5e-2, decay_kernels_only=True)
    step_kw = dict(lambda_m=0.6, margin_offset=-0.05, lr_scale=0.5)
    batches = [make_batch(5, True)]
    jax_state, jax_m = run_jax(jax_net(SUBCENTER_TOPK), jtx, v1_variables, batches,
                               JaxStepConfig(compute_dtype=jnp.float64), _jax_adam_state(jtx, params, mu, nu, 7),
                               step_kw)
    port_state, port_m = run_port(port_net(SUBCENTER_TOPK), ptx, v1_variables, batches,
                                  TrainStepConfig(compute_dtype=torch.float64),
                                  {"count": 7, "mu": mu, "nu": nu}, step_kw)
    assert_metrics_close(port_m[0], jax_m[0])
    assert_states_close(port_state, jax_state, 1e-5)
    assert int(port_state.opt_state["count"]) == 8 == int(jax_state.opt_state[0].count)
    got = train_state_to_variables(port_state)["opt_state"]
    for name in ("mu", "nu"):
        ref = jax.tree_util.tree_leaves(getattr(jax_state.opt_state[0], name))
        for a, b in zip(jax.tree_util.tree_leaves(got[name]), ref):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12 + 1e-5 * np.abs(b).max())


def test_accum_grad_two_microbatches_match_jax():
    """accum_grad=2 on one masked batch of 4: BN statistics chain from the
    first microbatch to the second, gradients and metrics average."""
    variables = init_variables(jax_net(), seed=6)
    batches = [make_batch(7, True)]
    jax_state, jax_m = run_jax(jax_net(), optax.sgd(LR), variables, batches,
                               JaxStepConfig(accum_grad=2, compute_dtype=jnp.float64))
    port_state, port_m = run_port(port_net(), sgd(LR), variables, batches,
                                  TrainStepConfig(accum_grad=2, compute_dtype=torch.float64))
    assert_metrics_close(port_m[0], jax_m[0])
    assert_states_close(port_state, jax_state, 1e-6)


def test_ten_step_loop_matches_jax():
    """Ten steps of sgd with momentum and weight decay over ten masked
    batches: every step's metrics and the final state."""
    variables = init_variables(jax_net(), seed=8)
    batches = [make_batch(20 + i, True) for i in range(10)]
    jtx = jax_get_optimizer("sgd", LR, momentum=0.9, weight_decay=1e-3)
    ptx = get_optimizer("sgd", LR, momentum=0.9, weight_decay=1e-3)
    jax_state, jax_m = run_jax(jax_net(), jtx, variables, batches, JaxStepConfig(compute_dtype=jnp.float64))
    port_state, port_m = run_port(port_net(), ptx, variables, batches, TrainStepConfig(compute_dtype=torch.float64))
    for p, j in zip(port_m, jax_m):
        assert_metrics_close(p, j)
    assert_states_close(port_state, jax_state, 1e-6)
    assert int(port_state.step) == 10 and int(port_state.opt_state["count"]) == 10


def test_nonfinite_step_keeps_the_old_state():
    """A NaN in the batch: params, optimizer state (its count included) and
    BN statistics stay as they were, the step counter advances, skipped is 1."""
    variables = init_variables(jax_net(), seed=9)
    net = port_net()
    tx = get_optimizer("adamW", 1e-3)
    state = train_state_from_variables(net, {"step": 0, "params": variables["params"],
                                             "batch_stats": variables["batch_stats"], "opt_state": {"count": 0}},
                                       device="cpu")
    state.opt_state = tx.init(state.params)
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.float64))
    gen = torch.Generator().manual_seed(0)
    state, m = step(state, port_batch(*make_batch(10, True), torch.float64), gen)
    assert float(m["skipped"]) == 0.0
    x, y, mask = make_batch(11, True)
    x[1, 3, 5] = np.nan
    new, m = step(state, port_batch(x, y, mask, torch.float64), gen)
    assert float(m["skipped"]) == 1.0 and not np.isfinite(float(m["loss"]))
    assert int(new.step) == 2 and int(new.opt_state["count"]) == 1
    before, after = train_state_to_variables(state), train_state_to_variables(new)
    for coll in ("params", "batch_stats"):
        for a, b in zip(jax.tree_util.tree_leaves(after[coll]), jax.tree_util.tree_leaves(before[coll])):
            np.testing.assert_array_equal(a, b)
    for name in ("mu", "nu"):
        for k, v in new.opt_state[name].items():
            assert torch.equal(v, state.opt_state[name][k]), (name, k)


def _jax_train_state(seed=12):
    """A JAX train state as numpy trees: params, batch_stats and adamW's
    count and moments."""
    v = init_variables(jax_net(SUBCENTER_TOPK), seed=seed)
    mu, nu = _moments(v["params"], seed)
    return {"step": np.asarray(5, np.int32), "params": v["params"], "batch_stats": v["batch_stats"],
            "opt_state": {"count": np.asarray(5, np.int32), "mu": mu, "nu": nu}}


def test_train_state_round_trip_bit_for_bit():
    tree = _jax_train_state()
    net = port_net(SUBCENTER_TOPK)
    state = train_state_from_variables(net, tree, device="cpu")
    assert set(state.params) == {k for k, _ in net.named_parameters()}
    assert set(state.batch_stats) == {k for k, _ in net.named_buffers()}
    assert state.params["loss.weight"].shape == (C_SUB, 16)
    back = train_state_to_variables(state)
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(back), flat(tree)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key


C_SUB = 20 * 2  # 20 targets, 2 sub-centres


@pytest.mark.parametrize("fault", ["extra param", "missing param", "missing stat", "missing moment",
                                   "extra moment", "extra entry"])
def test_train_state_raises_on_unconsumed_or_missing_leaves(fault):
    tree = _jax_train_state()
    if fault == "extra param":
        tree["params"]["backbone"]["layer1"]["extra"] = np.zeros(3)
    elif fault == "missing param":
        del tree["params"]["backbone"]["fc2_affine"]["bias"]
    elif fault == "missing stat":
        del tree["batch_stats"]["backbone"]["bn_stats"]["var"]
    elif fault == "missing moment":
        del tree["opt_state"]["nu"]["loss"]["weight"]
    elif fault == "extra moment":
        tree["opt_state"]["mu"]["backbone"]["mfa"]["affine"]["conv"]["scale"] = np.ones(96)
    else:
        tree["rng"] = np.zeros(2)
    with pytest.raises(ValueError):
        train_state_from_variables(port_net(SUBCENTER_TOPK), tree, device="cpu")
