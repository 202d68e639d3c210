"""The port's margin losses against the JAX package's, on the same
embeddings, targets and classifier weights.

Loss and the gradients with respect to the embeddings and the weight are
compared. MarginSoftmaxLossV1 computes in float32 on both sides (the JAX
module casts to f32 whatever the input): 2e-5 relative, 1e-6 absolute.
MarginSoftmaxLoss keeps float64 in float64: 1e-10. 20 targets, embedding
16, B = 6, margin warm-up inputs lambda_m = 0.7 and margin_offset = -0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.nn import loss as jax_loss
from asv_subtools_tpu_torch.nn import loss as port_loss

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
