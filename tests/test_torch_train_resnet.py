"""Training the ResNet x-vector: the four faults of the ResNet train path,
the f64 train step against the JAX package's make_train_step leaf by leaf,
and the train state's round trip.

The faults: the ResNet BatchNorms must run at the JAX model's momentum
0.5; ResNetXvector must name its embedding width (``embd_dim``), which
SpeakerNet reads; SpeakerNet hands a backbone ``generator`` and
``warmup`` only where its forward takes them; and the statistics pooling
takes its fused kernel (which has no backward) in eval mode only.

The step: a narrow ResNet (base 8, layers 1-1-1-1, 24 bins, embedding
16), B = 4, 20 targets, the all-f64 AAM head, both sides in float64 on
features, with the helpers and tolerances of tests/test_torch_train_step.py
(every leaf within 1e-6 of its scale). The running statistics after one
train-mode forward are held to 1e-9 relative (float64; the convolutions
sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.train import lr_scheduler as jax_sched
from asv_subtools_tpu.models.resnet_xvector import ResNetXvector as JaxResNetXvector
from asv_subtools_tpu.train.optim import get_optimizer as jax_get_optimizer
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.features import fused_fbank
from asv_subtools_tpu_torch.models import ResNetXvector, SpeakerNet
from asv_subtools_tpu_torch.nn import fused_stats_pooling
from asv_subtools_tpu_torch.nn import pooling as port_pooling
from asv_subtools_tpu_torch.train import (TrainStepConfig, cyclic, get_optimizer, init_train_state, make_train_step,
                                          sgd)
from asv_subtools_tpu_torch.train.step_check import OPTS, resnet_net
from asv_subtools_tpu_torch.weights import load_variables, train_state_from_variables, train_state_to_variables
from test_torch_train_state import SCHEDULE, _jax_adam_state, _moments
from test_torch_train_step import (
    AAM,
    C,
    D,
    LR,
    assert_metrics_close,
    assert_states_close,
    init_variables,
    make_batch,
    run_jax,
    run_port,
)

SMALL = dict(layers=(1, 1, 1, 1), base_planes=8, embd_dim=16)


def jax_net():
    return JaxSpeakerNet(JaxResNetXvector(**SMALL), AAM[0], AAM[1], num_targets=C)


def port_net(dtype=torch.float64, **kw):
    return SpeakerNet(ResNetXvector(D, device="cpu", **{**SMALL, **kw}), AAM[0], AAM[1], num_targets=C).to(dtype)


@pytest.fixture(scope="module")
def variables():
    return init_variables(jax_net())


@pytest.mark.parametrize("masked", [False, True])
def test_train_mode_running_statistics_match_jax(variables, masked):
    """One train-mode forward from the same weights: every BatchNorm's new
    running mean and variance (momentum 0.5, the trunk's and the head's)."""
    x, _, mask = make_batch(2, masked)
    backbone = {"params": variables["params"]["backbone"], "batch_stats": variables["batch_stats"]["backbone"]}
    with jax.enable_x64():
        _, mut = JaxResNetXvector(**SMALL).apply(
            jax.tree_util.tree_map(jnp.asarray, backbone), jnp.asarray(x), mask=None if mask is None else
            jnp.asarray(mask), train=True, mutable=["batch_stats"])
        ref = jax.device_get(mut["batch_stats"])
    port = ResNetXvector(D, device="cpu", **SMALL).double()
    load_variables(port, backbone)
    assert port.resnet.stem_bn.momentum == port.head.fc2_bn.momentum == 0.5
    port.train()
    with torch.no_grad():
        port(torch.as_tensor(x), None if mask is None else torch.as_tensor(mask))
    got = {k: v.numpy() for k, v in port.state_dict().items() if k.endswith((".mean", ".var"))}
    flat = {".".join(k.key for k in path): np.asarray(leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    assert set(got) == set(flat) and len(got) == 2 * 13
    for key, value in flat.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-9, atol=1e-12, err_msg=key)


def test_speaker_net_builds_and_runs_with_a_generator():
    """SpeakerNet reads embd_dim and hands the generator to ECAPA only: the
    ResNet's forward takes neither it nor warmup."""
    net = port_net(torch.float32)
    assert net.backbone.embd_dim == 16 and tuple(net.loss.weight.shape) == (C, 16)
    x, y, mask = make_batch(3, True)
    loss, logits, emb = net.train()(torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y),
                                    torch.as_tensor(mask), generator=torch.Generator().manual_seed(0), warmup=0.5)
    assert bool(torch.isfinite(loss)) and tuple(logits.shape) == (4, C) and tuple(emb.shape) == (4, 16)


class _Plain(torch.nn.Module):
    """A backbone whose forward takes neither generator nor warmup."""

    def __init__(self):
        super().__init__()
        self.embd_dim, self.seen = 4, []
        self.lin = torch.nn.Linear(3, 4)

    def forward(self, x, mask=None):
        self.seen.append({})
        return self.lin(x.mean(1))


class _WithGenerator(_Plain):
    def forward(self, x, mask=None, generator=None):
        self.seen.append({"generator": generator})
        return self.lin(x.mean(1))


class _WithBoth(_Plain):
    def forward(self, x, mask=None, generator=None, warmup=1.0):
        self.seen.append({"generator": generator, "warmup": warmup})
        return self.lin(x.mean(1))


@pytest.mark.parametrize("cls", [_Plain, _WithGenerator, _WithBoth])
def test_speaker_net_hands_a_backbone_only_what_its_forward_declares(cls):
    """As JAX's SpeakerNet does with inspect.signature."""
    backbone = cls()
    gen = torch.Generator()
    SpeakerNet(backbone, AAM[0], AAM[1], num_targets=C)(torch.zeros(2, 5, 3), torch.as_tensor([1, 2]),
                                                         generator=gen, warmup=0.5)
    expected = {_Plain: {}, _WithGenerator: {"generator": gen}, _WithBoth: {"generator": gen, "warmup": 0.5}}
    assert backbone.seen == [expected[cls]]


def test_fused_pooling_flag_takes_the_unfused_path_in_train_mode(monkeypatch):
    """With ``fused_inference`` on, train mode never reaches the fused
    wrapper (no launch either) and gives the unfused path's trunk gradients
    bit for bit; eval mode does reach it."""
    calls = []
    wrapper = port_pooling.fused_stats_pooling
    monkeypatch.setattr(port_pooling, "fused_stats_pooling", lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    x, _, mask = make_batch(4, True)
    xt, mt = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(mask)
    grads = {}
    for fused in (False, True):
        torch.manual_seed(0)
        model = ResNetXvector(D, device="cpu", pooling_params={"fused_inference": fused}, **SMALL).train()
        before = fused_stats_pooling.launches
        model(xt, mt).square().sum().backward()
        assert fused_stats_pooling.launches == before
        grads[fused] = {k: p.grad.clone() for k, p in model.named_parameters()}
    assert not calls
    for key, g in grads[False].items():
        assert float(g.abs().max()) > 0 and torch.equal(g, grads[True][key]), key
    with torch.no_grad():
        model.eval()(xt, mt)
    assert len(calls) == 1


@pytest.mark.parametrize("masked", [False, True])
def test_sgd_step_matches_jax_leaf_by_leaf(variables, masked):
    batches = [make_batch(5, masked), make_batch(6, masked)]
    jax_state, jax_m = run_jax(jax_net(), optax.sgd(LR), variables, batches,
                               JaxStepConfig(compute_dtype=jnp.float64))
    port_state, port_m = run_port(port_net(), sgd(LR), variables, batches,
                                  TrainStepConfig(compute_dtype=torch.float64))
    for p, j in zip(port_m, jax_m):
        assert_metrics_close(p, j)
    assert_states_close(port_state, jax_state, 1e-6)


def test_adamw_step_from_jax_state(variables):
    """adamW (weight decay on kernels only, a cyclic schedule) one step on
    from count 7, moments on every leaf, the 2-D conv kernels' included."""
    params = variables["params"]
    mu, nu = _moments(params, 8)
    with jax.enable_x64():
        jtx = jax_get_optimizer("adamW", jax_sched.cyclic(**SCHEDULE), weight_decay=5e-2, decay_kernels_only=True)
    ptx = get_optimizer("adamW", cyclic(**SCHEDULE), weight_decay=5e-2, decay_kernels_only=True)
    batches = [make_batch(9, True)]
    jax_state, jax_m = run_jax(jax_net(), jtx, variables, batches, JaxStepConfig(compute_dtype=jnp.float64),
                               _jax_adam_state(jtx, params, mu, nu, 7))
    port_state, port_m = run_port(port_net(), ptx, variables, batches, TrainStepConfig(compute_dtype=torch.float64),
                                  {"count": 7, "mu": mu, "nu": nu})
    assert_metrics_close(port_m[0], jax_m[0])
    assert_states_close(port_state, jax_state, 1e-6)
    got = train_state_to_variables(port_state)["opt_state"]
    for name in ("mu", "nu"):
        ref = jax.tree_util.tree_leaves(getattr(jax_state.opt_state[0], name))
        for a, b in zip(jax.tree_util.tree_leaves(got[name]), ref):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12 + 1e-6 * np.abs(b).max())


def _jax_train_state(variables):
    mu, nu = _moments(variables["params"], 10)
    return {"step": np.asarray(3, np.int32), "params": variables["params"], "batch_stats": variables["batch_stats"],
            "opt_state": {"count": np.asarray(3, np.int32), "mu": mu, "nu": nu}}


def test_train_state_round_trip_bit_for_bit(variables):
    tree = _jax_train_state(variables)
    net = port_net()
    state = train_state_from_variables(net, tree, device="cpu")
    assert state.params["backbone.resnet.layer2_0.conv1.weight"].shape == (16, 8, 3, 3)
    assert state.opt_state["mu"]["backbone.resnet.stem.weight"].shape == (8, 1, 3, 3)
    back = train_state_to_variables(state)
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(back), flat(tree)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("fault", ["missing moment", "extra moment", "missing stat"])
def test_train_state_raises_on_unconsumed_or_missing_leaves(variables, fault):
    tree = _jax_train_state(variables)
    if fault == "missing moment":
        del tree["opt_state"]["mu"]["backbone"]["resnet"]["layer3_0"]["conv2"]
    elif fault == "extra moment":
        tree["opt_state"]["nu"]["backbone"]["resnet"]["stem"]["extra"] = {"kernel": np.zeros((3, 3, 1, 8))}
    else:
        del tree["batch_stats"]["backbone"]["resnet"]["layer4_0"]["downsample_bn"]
    with pytest.raises(ValueError):
        train_state_from_variables(port_net(), tree, device="cpu")


def test_bench_resnet34_trains_on_waves():
    """bench.py's resnet34 family (base32, layers 3-4-6-3, embedding 512, AAM
    m=0.2 over 5994 classes) through make_train_step with wave_input: one
    adamW step on the CPU (float32, the plain front end)."""
    net = resnet_net(seed=1)
    assert net.backbone.embd_dim == 512 and len(net.backbone.resnet.blocks) == 16
    tx = get_optimizer("adamW", 1e-3)
    state = init_train_state(net, tx, "cpu")
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.float32, wave_input=True,
                                                           fbank_opts=OPTS))
    rng = np.random.default_rng(0)
    wave = torch.as_tensor(rng.normal(size=(2, 8000)).astype(np.float32) * 1000.0)
    before = fused_fbank.launches
    new, m = step(state, {"x": wave, "y": torch.as_tensor([3, 5000])}, torch.Generator().manual_seed(0))
    assert fused_fbank.launches == before  # the plain version on the CPU
    assert bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0 and int(new.step) == 1
    assert not torch.equal(new.params["backbone.resnet.stem.weight"], state.params["backbone.resnet.stem.weight"])
