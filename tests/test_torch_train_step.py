"""The port's train step against the JAX package's make_train_step, leaf by leaf.

One plain-SGD step (an update is -lr * grad, so every leaf shows its
gradient) from the same state on the same batch, with a small
ECAPA-TDNN (channels 32, MFA 96, 24 bins, embedding 16), B = 4, 20
targets, masked and unmasked, with the max_change clip idle and engaged.
Both sides run in float64 (torch.float64 and jax.enable_x64) with
features as input: in f32 the train-mode bn_stats z-scores of a batch of
4 turn rounding noise into errors of ~1e-2.

Tolerance: every leaf of params and batch_stats within 1e-6 of that
leaf's scale (its largest magnitude), plus 1e-12 absolute for leaves whose
analytic gradient is 0 (a bias ahead of a softmax over time), where both
sides hold rounding noise of ~1e-18. Loss within 1e-6 relative (both
sides report it rounded to f32), grad_norm and accuracy within 1e-6.
The head here is MarginSoftmaxLoss (aam), f64 end to end on both sides;
MarginSoftmaxLossV1 computes in f32 whatever the input (JAX nn/loss.py:
245), so the steps through it (tests/test_torch_train_state.py) hold the
leaves to 1e-5.

The helpers here are shared by tests/test_torch_train_state.py and
tests/test_torch_train_wave.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.train.trainer import TrainState as JaxTrainState
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu.train.trainer import make_train_step as jax_make_train_step
from asv_subtools_tpu_torch.models import EcapaTdnn, SpeakerNet
from asv_subtools_tpu_torch.train import TrainStepConfig, make_train_step, sgd
from asv_subtools_tpu_torch.weights import train_state_from_variables, train_state_to_variables

torch.set_num_threads(2)

B, T, D, C = 4, 60, 24, 20
SMALL = dict(channels=32, mfa_conv=96, embd_dim=16)
AAM = ("margin_softmax", {"method": "aam", "m": 0.2})
SUBCENTER_TOPK = ("margin_softmax_v1", {"method": "aam", "m": 0.2, "s": 30.0, "sub_k": 2,
                                        "adapt_method": "topk", "topk": 5})
LR = 0.05


def jax_net(loss=AAM, **backbone):
    return JaxSpeakerNet(JaxEcapa(**{**SMALL, **backbone}), loss[0], loss[1], num_targets=C)


def port_net(loss=AAM, dtype=torch.float64, **backbone):
    net = SpeakerNet(EcapaTdnn(input_dim=D, device="cpu", **{**SMALL, **backbone}), loss[0], loss[1],
                     num_targets=C)
    return net.to(dtype)


def make_batch(seed, masked, b=B, t=T, d=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, d))
    y = rng.integers(0, C, size=b)
    mask = None
    if masked:
        lengths = rng.integers(t // 3, t + 1, size=b)
        lengths[0] = t
        mask = np.arange(t)[None, :] < lengths[:, None]
    return x, y, mask


def _randomize(tree, rng):
    """Non-trivial biases, BN affines and running statistics."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif key in ("bias", "mean"):
            tree[key] = rng.normal(size=val.shape) * 0.1
        elif key == "scale":
            tree[key] = rng.uniform(0.8, 1.2, size=val.shape)
        elif key == "var":
            tree[key] = rng.uniform(0.5, 2.0, size=val.shape)


def init_variables(net, seed=0):
    """f64 numpy {"params", "batch_stats"} of the JAX net, randomised."""
    x, y, mask = make_batch(seed, True)
    v = net.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed)},
                 jnp.asarray(x, jnp.float32), jnp.asarray(y), mask=jnp.asarray(mask), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float64), jax.device_get(v))
    _randomize(v, np.random.default_rng(seed))
    return v


def jax_batch(x, y, mask, dtype):
    out = {"x": jnp.asarray(x, dtype), "y": jnp.asarray(y, jnp.int32)}
    if mask is not None:
        out["mask"] = jnp.asarray(mask)
    return out


def port_batch(x, y, mask, dtype):
    out = {"x": torch.as_tensor(x, dtype=dtype), "y": torch.as_tensor(y)}
    if mask is not None:
        out["mask"] = torch.as_tensor(mask)
    return out


def run_jax(net, tx, variables, batches, config, opt_state=None, step_kw=None):
    """JAX steps over `batches` from `variables` in float64 -> (state
    as numpy trees, metrics of each step)."""
    with jax.enable_x64():
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                              opt_state=opt_state if opt_state is not None else tx.init(params))
        step = jax.jit(jax_make_train_step(net, tx, config=config))
        metrics = []
        for x, y, mask in batches:
            state, m = step(state, jax_batch(x, y, mask, jnp.float64), jax.random.PRNGKey(0), **(step_kw or {}))
            metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        state = jax.device_get(state)
    return state, metrics


def run_port(net, tx, variables, batches, config, opt_state=None, step_kw=None, dtype=torch.float64):
    """The port's steps from the same variables -> (state, metrics of each step)."""
    tree = {"step": 0, "params": variables["params"], "batch_stats": variables["batch_stats"],
            "opt_state": opt_state or {"count": 0}}
    state = train_state_from_variables(net, tree, device="cpu")
    if opt_state is None:
        state.opt_state = tx.init(state.params)
    step = make_train_step(net, tx, config=config)
    gen = torch.Generator().manual_seed(0)
    metrics = []
    for x, y, mask in batches:
        state, m = step(state, port_batch(x, y, mask, dtype), gen, **(step_kw or {}))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def leaf_errors(ours, ref, atol=1e-12):
    """{path: error / leaf scale} over two numpy trees of the same structure."""
    a = dict(jax.tree_util.tree_leaves_with_path(ours))
    b = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert set(map(jax.tree_util.keystr, a)) == set(map(jax.tree_util.keystr, b))
    b = {jax.tree_util.keystr(k): v for k, v in b.items()}
    out = {}
    for path, va in a.items():
        key = jax.tree_util.keystr(path)
        vb = np.asarray(b[key], np.float64)
        err = np.abs(np.asarray(va, np.float64) - vb).max()
        out[key] = max(err - atol, 0.0) / max(np.abs(vb).max(), 1e-300)
    return out


def assert_states_close(port_state, jax_state, tol):
    got = train_state_to_variables(port_state)
    for coll, ref in (("params", jax_state.params), ("batch_stats", jax_state.batch_stats)):
        errs = leaf_errors(got[coll], ref)
        bad = {k: e for k, e in errs.items() if e > tol}
        assert not bad, f"{coll} leaves off by more than {tol} of their scale: {bad}"


def assert_metrics_close(port_m, jax_m, tol=1e-6):
    for key in ("loss", "grad_norm", "accuracy", "skipped"):
        np.testing.assert_allclose(port_m[key], jax_m[key], rtol=tol, atol=1e-12, err_msg=key)


@pytest.fixture(scope="module")
def aam_variables():
    return init_variables(jax_net())


@pytest.mark.parametrize("clip", ["idle", "engaged"])
@pytest.mark.parametrize("masked", [False, True])
def test_sgd_step_matches_jax_leaf_by_leaf(aam_variables, masked, clip):
    max_change = 1e6 if clip == "idle" else 1.0
    batches = [make_batch(1, masked)]
    jax_state, jax_m = run_jax(jax_net(), optax.sgd(LR), aam_variables, batches,
                               JaxStepConfig(max_change=max_change, compute_dtype=jnp.float64))
    port_state, port_m = run_port(port_net(), sgd(LR), aam_variables, batches,
                                  TrainStepConfig(max_change=max_change, compute_dtype=torch.float64))
    assert (jax_m[0]["grad_norm"] > max_change) == (clip == "engaged")
    assert_metrics_close(port_m[0], jax_m[0])
    assert_states_close(port_state, jax_state, 1e-6)
    assert int(port_state.step) == 1
