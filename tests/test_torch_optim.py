"""The port's optimizers and learning-rate schedules against the JAX package's.

Optimizers: the same sequence of 10 float64 gradients goes through the
port's get_optimizer and the JAX one (optax) from the same parameters;
the parameters after every step agree to 1e-10 relative (both sides run
optax's formulas in f64, in other orders). Schedules: float64 on both
sides, 1e-12 relative at chosen steps. The optimizers, step options and
loss heads that once raised NotImplementedError build and train (their
parity with JAX: tests/test_torch_optimizers.py,
test_torch_step_options.py, test_torch_loss.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.train import lr_scheduler as jax_sched
from asv_subtools_tpu.train.optim import get_optimizer as jax_get_optimizer
from asv_subtools_tpu_torch.models import EcapaTdnn, SpeakerNet
from asv_subtools_tpu_torch.train import (
    TrainStepConfig,
    get_optimizer,
    init_train_state,
    make_train_step,
    no_weight_decay_mask,
)
from asv_subtools_tpu_torch.train import lr_scheduler as port_sched

SHAPES = {"conv.weight": (5, 3, 4), "fc.weight": (4, 6), "fc.bias": (6,), "bn.scale": (6,)}


def _params_and_grads(seed, steps=10):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s) * 10 ** rng.uniform(-3, 1) for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("lr", ["float", "schedule"])
@pytest.mark.parametrize("decay_kernels_only", [False, True])
@pytest.mark.parametrize("name", ["adamW", "adam", "sgd", "sgdw"])
def test_get_optimizer_matches_optax(name, decay_kernels_only, lr):
    kw = dict(weight_decay=0.05, decay_kernels_only=decay_kernels_only, momentum=0.9)
    sched = dict(base_lr=1e-3, max_lr=0.1, step_size_up=3)
    params, grads = _params_and_grads(0)
    with jax.enable_x64():
        jtx = jax_get_optimizer(name, jax_sched.cyclic(**sched) if lr == "schedule" else 0.01, **kw)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        js = jtx.init(jp)
        ref = []
        for g in grads:
            u, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            jp = optax.apply_updates(jp, u)
            ref.append({k: np.asarray(v) for k, v in jp.items()})
    ptx = get_optimizer(name, port_sched.cyclic(**sched) if lr == "schedule" else 0.01, **kw)
    pp = {k: torch.as_tensor(v) for k, v in params.items()}
    ps = ptx.init(pp)
    for i, g in enumerate(grads):
        u, ps = ptx.update({k: torch.as_tensor(v) for k, v in g.items()}, ps, pp)
        pp = {k: pp[k] + u[k] for k in pp}
        for k in pp:
            np.testing.assert_allclose(pp[k].numpy(), ref[i][k], rtol=1e-10, atol=1e-13, err_msg=f"step {i} {k}")
    assert int(ps["count"]) == len(grads)


def test_no_weight_decay_mask_keeps_kernels():
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    assert no_weight_decay_mask(params) == {"conv.weight": True, "fc.weight": True, "fc.bias": False,
                                            "bn.scale": False}


STEPS = [0, 1, 2, 7, 9, 10, 15, 29, 30, 31, 59, 100, 299, 1234, 40000]
SCHEDULES = [
    ("warmR", dict(base_lr=0.1, t_0=10)),
    ("warmR", dict(base_lr=0.1, t_0=10, t_mult=2)),
    ("warmR", dict(base_lr=0.1, t_0=7, factor=0.5, log_decay=True, eta_min=1e-5)),
    ("warmR", dict(base_lr=0.1, t_0=10, warmup_steps=5)),
    ("cyclic", dict(base_lr=1e-8, max_lr=1e-3, step_size_up=15)),
    ("cyclic", dict(base_lr=1e-4, max_lr=1e-2, step_size_up=10, step_size_down=20, mode="triangular")),
    ("cyclic", dict(base_lr=1e-4, max_lr=1e-2, step_size_up=10, mode="exp_range", gamma=0.999)),
    ("1cycle", dict(max_lr=0.01, total_steps=300)),
    ("noam", dict(base_lr=1e-3, warmup_steps=25)),
    ("noam", dict(base_lr=1e-3, warmup_steps=25, step_decay=True, step_size=50, step_rate=0.5)),
    ("noam", dict(base_lr=2.0, warmup_steps=25, model_dim=256)),
    ("constant", dict(base_lr=0.02)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_schedules_match_jax(name, kw):
    port = port_sched.get_lr_schedule(name, **kw)
    with jax.enable_x64():
        ref = jax_sched.get_lr_schedule(name, **kw)
        want = [float(ref(s)) for s in STEPS]
    got = [port(s) for s in STEPS]
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # a tensor step (the optimizer's count) gives a float64 tensor
    t = port(torch.tensor(STEPS, dtype=torch.int32))
    assert t.dtype == torch.float64
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-12)


def test_reduce_on_plateau_and_cycle_ends_match_jax():
    metrics = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 2.0]
    kw = dict(factor=0.5, patience=2, cooldown=1, min_lr_scale=0.2)
    jr, pr = jax_sched.ReduceOnPlateau(**kw), port_sched.ReduceOnPlateau(**kw)
    for m in metrics:
        assert pr.update(m) == jr.update(m)
        assert pr.scale == jr.scale
    assert pr.scale < 1.0
    assert port_sched.cycle_end_steps(15, None, 3) == jax_sched.cycle_end_steps(15, None, 3)
    with pytest.raises(ValueError):
        port_sched.get_lr_schedule("reduceP")


def _small_net():
    return SpeakerNet(EcapaTdnn(input_dim=8, channels=16, mfa_conv=32, embd_dim=8, device="cpu"),
                      "margin_softmax_v1", {"sub_k": 2}, num_targets=5)


def _one_step(net, tx, config):
    step = make_train_step(net, tx, config=config)
    state = init_train_state(net, tx, "cpu")
    batch = {"x": torch.randn(2, 30, 8, generator=torch.Generator().manual_seed(1)), "y": torch.tensor([0, 3])}
    return step(state, batch, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kw", [dict(name="ralamb"), dict(name="adamod"), dict(name="novograd"), dict(name="eve"),
                                dict(name="adamW", gc=True), dict(name="sgd", lookahead=True)], ids=str)
def test_optimizers_not_ported_raise(kw):
    """These optimizers raised once, not ported; they build now, and one
    f32 train step through each runs finite (their parity with JAX:
    tests/test_torch_optimizers.py)."""
    tx = get_optimizer(learning_rate=1e-3, **kw)
    new, m = _one_step(_small_net(), tx, TrainStepConfig(compute_dtype=torch.float32))
    assert int(new.step) == 1 and np.isfinite(float(m["loss"])) and float(m["skipped"]) == 0.0


@pytest.mark.parametrize("kw", [dict(mixup_alpha=0.2), dict(use_semi_orth=True), dict(remat="full"),
                                dict(model_warmup_steps=10)], ids=str)
def test_step_options_not_ported_raise(kw):
    """Each option raised once; each is ported now (mixup and remat:
    tests/test_torch_step_options.py; the Conformer's warm-up,
    tests/test_torch_train_conformer.py; the F-TDNN's semi-orthogonal
    step, tests/test_torch_xvector.py): their steps build and run on a
    backbone that takes no warmup and holds no factor1 weight."""
    new, m = _one_step(_small_net(), get_optimizer("sgd", 0.1), TrainStepConfig(**kw))
    assert int(new.step) == 1 and bool(torch.isfinite(m["loss"]))


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError):
        make_train_step(_small_net(), get_optimizer("sgd", 0.1), config=TrainStepConfig(remat="offload"))


@pytest.mark.parametrize("loss", ["focal", "logistic_affinity", "ocsoftmax"])
def test_losses_not_ported_raise(loss):
    """These heads were not ported once and raised; they build now, and
    one f32 train step through each runs finite (their parity with JAX is
    in tests/test_torch_loss.py)."""
    net = SpeakerNet(EcapaTdnn(input_dim=8, channels=16, mfa_conv=32, embd_dim=8, device="cpu"), loss, num_targets=5)
    tx = get_optimizer("sgd", 1e-2)
    state = init_train_state(net, tx, "cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn(4, 30, 8, generator=g), "y": torch.tensor([0, 1, 1, 0])}
    new, m = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.float32))(state, batch, g)
    assert np.isfinite(float(m["loss"])) and float(m["skipped"]) == 0.0 and int(new.step) == 1
