"""The port's losses against the JAX package's, on the same embeddings,
targets and classifier weights.

Loss and the gradients with respect to the embeddings and the weight are
compared. MarginSoftmaxLossV1 computes in float32 on both sides (the JAX
module casts to f32 whatever the input): 2e-5 relative, 1e-6 absolute.
MarginSoftmaxLoss keeps float64 in float64: 1e-10. 20 targets, embedding
16, B = 6, margin warm-up inputs lambda_m = 0.7 and margin_offset = -0.05.

The other four heads: loss, logits and the gradients with respect to the
embeddings and every parameter. SoftmaxLoss and FocalLoss in float64 at
1e-10; LogisticAffinityLoss and OCSoftmax take their cosines in float32 on
both sides: 2e-5 relative, 1e-6 absolute. Then one f64 SGD step of a
small ECAPA with each of the four heads against JAX's step leaf by leaf
(tests/test_torch_train_step.py; 1e-6 of each leaf's scale, 1e-5 for the
two float32 heads), its loss, grad_norm and the accuracy JAX reports.
JAX's SpeakerNet hands ``num_targets`` to every head, which
LogisticAffinityLoss does not take (a TypeError); its step runs here on a
net that builds the head without it.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.nn import loss as jax_loss
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.models import EcapaTdnn, SpeakerNet
from asv_subtools_tpu_torch.nn import loss as port_loss
from asv_subtools_tpu_torch.train import TrainStepConfig, sgd
from asv_subtools_tpu_torch.weights import state_dict_to_variables, variables_to_state_dict

B, E, C = 6, 16, 20
WARM = dict(lambda_m=0.7, margin_offset=-0.05)


def _inputs(seed, rows, dtype):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, E)).astype(dtype)
    w = (rng.normal(size=(rows, E)) * 0.5).astype(dtype)
    y = rng.integers(0, C, size=B)
    return emb, w, y


def _jax_loss_and_grads(module, emb, w, y, train, extra_params=None, stats=None):
    def f(e, ww):
        v = {"params": {"weight": ww, **(extra_params or {})}}
        if stats is not None:
            v["batch_stats"] = stats
            (loss, logits), mut = module.apply(v, e, jnp.asarray(y), train=train, mutable=["batch_stats"], **WARM)
            return loss, (logits, mut["batch_stats"])
        loss, logits = module.apply(v, e, jnp.asarray(y), train=train, **WARM)
        return loss, (logits, None)

    (loss, (logits, new_stats)), (ge, gw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(emb), jnp.asarray(w))
    return jax.device_get((loss, logits, ge, gw, new_stats))


def _port_loss_and_grads(module, emb, w, y):
    e = torch.as_tensor(emb).requires_grad_()
    with torch.no_grad():
        module.weight.copy_(torch.as_tensor(w))
    loss, logits = module(e, torch.as_tensor(y), **WARM)
    ge, gw = torch.autograd.grad(loss, (e, module.weight))
    return loss.detach().numpy(), logits.detach().numpy(), ge.numpy(), gw.numpy()


def _check(port, ref, tol, atol):
    for name, a, b in zip(("loss", "logits", "d/d embeddings", "d/d weight"), port, ref):
        np.testing.assert_allclose(a, b, rtol=tol, atol=atol, err_msg=name)


@pytest.mark.parametrize("loss_type", ["softmax", "rectangle"])
@pytest.mark.parametrize("adapt_method", ["topk", "batch_mean", None])
@pytest.mark.parametrize("method", ["am", "aam"])
def test_margin_softmax_v1_matches_jax(method, adapt_method, loss_type):
    kw = dict(sub_k=2, method=method, m=0.2, adapt_method=adapt_method, s=30.0, topk=5, loss_type=loss_type)
    emb, w, y = _inputs(0, C * 2, np.float32)
    ref = _jax_loss_and_grads(jax_loss.MarginSoftmaxLossV1(num_targets=C, **kw), emb, w, y, True)
    port = port_loss.MarginSoftmaxLossV1(E, C, **kw).train()
    _check(_port_loss_and_grads(port, emb, w, y), ref[:4], 2e-5, 1e-6)


CASES_V0 = [dict(method=m) for m in ("am", "aam", "sm1", "sm2", "sm3")] + [
    dict(method="am", double=True),
    dict(method="aam", double=True),
    dict(method="aam", feature_normalize=False),
    dict(method="aam", label_smoothing=0.1, t=2.0),
    dict(method="am", mhe_loss=True),
    dict(method="aam", inter_loss=0.5),
    dict(method="aam", ring_loss=0.01),
    dict(method="aam", curricular=True),
]


@pytest.mark.parametrize("kw", CASES_V0, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_margin_softmax_matches_jax(kw):
    emb, w, y = _inputs(1, C, np.float64)
    extra = {"ring_r": np.float64(18.0)} if kw.get("ring_loss") else None
    stats = {"curricular_t": np.float64(0.3)} if kw.get("curricular") else None
    with jax.enable_x64():
        ref = _jax_loss_and_grads(jax_loss.MarginSoftmaxLoss(num_targets=C, **kw), emb, w, y, True,
                                  extra_params=extra, stats=stats)
    port = port_loss.MarginSoftmaxLoss(E, C, **kw).double().train()
    if extra:
        with torch.no_grad():
            port.ring_r.fill_(18.0)
    if stats:
        port.curricular_t.fill_(0.3)
    _check(_port_loss_and_grads(port, emb, w, y), ref[:4], 1e-10, 1e-12)
    if stats:
        np.testing.assert_allclose(float(port.curricular_t), float(ref[4]["curricular_t"]), rtol=1e-12)


@pytest.mark.parametrize("name", ["margin_softmax", "margin_softmax_v1"])
def test_eval_mode_is_the_plain_cross_entropy(name):
    kw = {"sub_k": 2, "adapt_method": "topk"} if name == "margin_softmax_v1" else {"method": "aam"}
    rows = C * 2 if name == "margin_softmax_v1" else C
    emb, w, y = _inputs(2, rows, np.float32)
    ref = _jax_loss_and_grads(jax_loss.LOSSES[name](num_targets=C, **kw), emb, w, y, False)
    port = port_loss.LOSSES[name](E, C, **kw).eval()
    _check(_port_loss_and_grads(port, emb, w, y), ref[:4], 2e-5, 1e-6)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.2])
def test_cross_entropy_and_accuracy(label_smoothing):
    rng = np.random.default_rng(3)
    logits, y = rng.normal(size=(7, 5)), rng.integers(0, 5, size=7)
    with jax.enable_x64():
        ref = float(jax_loss.cross_entropy(jnp.asarray(logits), jnp.asarray(y), label_smoothing))
        acc = float(jax_loss.accuracy(jnp.asarray(logits), jnp.asarray(y)))
    got = port_loss.cross_entropy(torch.as_tensor(logits), torch.as_tensor(y), label_smoothing)
    np.testing.assert_allclose(float(got), ref, rtol=1e-12)
    assert float(port_loss.accuracy(torch.as_tensor(logits), torch.as_tensor(y))) == acc


def test_margin_warm_and_lambda_anneal_match_jax():
    steps = [0, 1, 5, 99, 100, 101, 150, 250, 299, 300, 301, 1000]
    jw = jax_loss.MarginWarm(2, 4, -0.2, 0.0, epoch_iter=100)
    pw = port_loss.MarginWarm(2, 4, -0.2, 0.0, epoch_iter=100)
    ja, pa = jax_loss.LambdaMAnneal(), port_loss.LambdaMAnneal()
    for s in steps:
        assert pw.step(s) == jw.step(s)
        assert pa.step(s) == ja.step(s)
    with pytest.raises(ValueError):
        port_loss.MarginWarm(2, 4).step(0)


# -- the other four heads --------------------------------------------------------

HEADS = {
    "softmax": dict(),
    "softmax-t2-ls0.1": dict(t=2.0, label_smoothing=0.1),
    "focal": dict(),
    "focal-gamma0.5-mean": dict(gamma=0.5, reduction="mean"),
    "logistic_affinity": dict(init_w=4.0, init_b=-0.5),
    "ocsoftmax": dict(),
    "ocsoftmax-paper": dict(convention="paper", r_real=0.7, r_fake=0.3),
}
F32_HEADS = ("logistic_affinity", "ocsoftmax")


def _head_name(case):
    return case.split("-")[0]


def _jax_head(case):
    name, kw = _head_name(case), HEADS[case]
    if name == "logistic_affinity":
        return jax_loss.LogisticAffinityLoss(**kw)
    return jax_loss.LOSSES[name](num_targets=C, **kw)


@pytest.mark.parametrize("case", list(HEADS))
def test_other_heads_match_jax(case):
    name = _head_name(case)
    emb, _, y = _inputs(4, C, np.float64)
    if name == "ocsoftmax":
        y = y % 2
    if name == "logistic_affinity":
        y = y % 3  # pairs of one class in the batch
    module = _jax_head(case)
    with jax.enable_x64():
        params = jax.device_get(module.init(jax.random.PRNGKey(4), jnp.asarray(emb), jnp.asarray(y))["params"])
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)

        def f(e, p):
            loss, logits = module.apply({"params": p}, e, jnp.asarray(y))
            return loss, logits

        (loss, logits), (ge, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(emb), params)
        ref = jax.device_get((loss, logits, ge, gp))
    port = port_loss.LOSSES[name](E, C, **HEADS[case]).double()
    # the leaves as SpeakerNet's head holds them, under "loss"
    state = variables_to_state_dict({"params": {"loss": params}})
    assert sorted(state) == sorted(f"loss.{k}" for k in port.state_dict())
    port.load_state_dict({k[len("loss."):]: v for k, v in state.items()})
    e = torch.as_tensor(emb).requires_grad_()
    got_loss, got_logits = port(e, torch.as_tensor(y))
    names = [k for k, _ in port.named_parameters()]
    grads = torch.autograd.grad(got_loss, [e] + [p for _, p in port.named_parameters()])
    tol, atol = (2e-5, 1e-6) if name in F32_HEADS else (1e-10, 1e-12)
    want_grads = variables_to_state_dict({"params": {"loss": ref[3]}})
    np.testing.assert_allclose(float(got_loss.detach()), float(ref[0]), rtol=tol, atol=atol)
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(ref[1]), rtol=tol, atol=atol)
    assert got_logits.shape == {"logistic_affinity": (B, B), "ocsoftmax": (B, 1)}.get(name, (B, C))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref[2]), rtol=tol, atol=atol)
    for key, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), want_grads[f"loss.{key}"].numpy(), rtol=tol, atol=atol, err_msg=key)
    # the head's leaves cross to JAX and back bit for bit
    back = state_dict_to_variables(state)["params"]["loss"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    assert all(np.array_equal(a, b) and np.shape(a) == np.shape(b) for a, b in
               zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)))


def test_the_port_takes_every_head_of_jax():
    assert sorted(port_loss.LOSSES) == sorted(jax_loss.LOSSES)
    backbone = EcapaTdnn(8, channels=16, mfa_conv=32, embd_dim=8, device="cpu")
    for name in port_loss.LOSSES:
        net = SpeakerNet(backbone, name, {}, num_targets=4)
        assert isinstance(net.loss, port_loss.LOSSES[name])
    with pytest.raises(TypeError, match="num_targets"):  # the JAX net's fault
        JaxSpeakerNet(JaxEcapa(channels=16, mfa_conv=32, embd_dim=8), "logistic_affinity", {},
                      num_targets=4).init(jax.random.PRNGKey(0), jnp.zeros((2, 10, 8)), jnp.zeros((2,), jnp.int32),
                                          train=False)


class _JaxPairNet(flax_nn.Module):
    """JAX's SpeakerNet for the logistic affinity head, built without the
    num_targets it does not take."""

    backbone: flax_nn.Module

    @flax_nn.compact
    def __call__(self, x, targets, mask=None, train=True, lambda_m=1.0, margin_offset=0.0):
        emb = self.backbone(x, mask=mask, train=train)
        loss, logits = jax_loss.LogisticAffinityLoss(name="loss")(emb, targets, train=train)
        return loss, logits, emb


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["softmax", "focal", "logistic_affinity", "ocsoftmax"])
def test_step_with_each_head_matches_jax(name, masked):
    from test_torch_train_step import LR, SMALL, assert_metrics_close, assert_states_close, init_variables, \
        make_batch, run_jax, run_port

    backbone = JaxEcapa(**SMALL)
    if name == "logistic_affinity":
        jnet = _JaxPairNet(backbone)
    else:
        jnet = JaxSpeakerNet(backbone, name, {}, num_targets=C)
    pnet = SpeakerNet(EcapaTdnn(24, **SMALL, device="cpu"), name, {}, num_targets=C).double()
    variables = init_variables(jnet, seed=9)
    x, y, mask = make_batch(70, masked)
    batches = [(x, y % (2 if name == "ocsoftmax" else 3), mask)]
    jax_state, jax_m = run_jax(jnet, optax.sgd(LR), variables, batches, JaxStepConfig(compute_dtype=jnp.float64))
    port_state, port_m = run_port(pnet, sgd(LR), variables, batches, TrainStepConfig(compute_dtype=torch.float64))
    tol = 1e-5 if name in F32_HEADS else 1e-6
    assert_metrics_close(port_m[0], jax_m[0], tol)
    assert_states_close(port_state, jax_state, tol)
