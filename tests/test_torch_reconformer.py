"""The ReConformer against the JAX package: the activation balancer's
forward and backward (JAX's jax.custom_vjp, the port's
torch.autograd.Function), BasicNorm, ReConv2dSubsampling4, the
ConformerXvector with transformer_type="re_conformer" and the Conformer
options it is made of, in three more configurations (re_layer, re_scale,
the basic_norm block and conv norms, the balancers, the block-level
batch_norm), its f64 train step leaf by leaf, and its weights' round
trip. The models take the port's seeded weights in JAX's layout
(weights.py), randomised; JAX's init is held to give the same tree.

Sizes as tests/test_torch_conformer.py: d = 32, 2 heads, 2 blocks (1
for the single options), linear_units 64, 24 bins, T = 83 frames with
ragged lengths. The
balancer in float64 at 1e-12; in bfloat16 both sides take the
statistics in bf16 (a mean of bf16 values accumulated in f32, rounded
to bf16) and agree to bf16's rounding of the gradient (2e-2 of its
scale). Modules and the model in float64 at 1e-10 of the output's
scale, float32 at 1e-5 for a module and 1e-4 for the model (ECAPA's
bar, tests/test_torch_conformer.py). The step: the helpers and
tolerances of tests/test_torch_train_step.py (every leaf within 1e-6 of
its scale), two SGD steps on features at dropout 0; the BasicNorm
``eps`` leaves are randomised away from log(0.25).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models.conformer import ConformerXvector as JaxConformerXvector
from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.nn.conformer import scaling as jscaling
from asv_subtools_tpu.nn.conformer import subsampling as jsub
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.models import ConformerXvector, SpeakerNet
from asv_subtools_tpu_torch.nn.conformer import scaling as pscaling
from asv_subtools_tpu_torch.nn.conformer import subsampling as psub
from asv_subtools_tpu_torch.train import TrainStepConfig, sgd
from asv_subtools_tpu_torch.weights import init_weights_, load_variables, state_dict_to_variables
from test_torch_conformer import _randomize
from test_torch_optimizer_states import port_variables
from test_torch_train_step import AAM, C, D, LR, assert_metrics_close, assert_states_close, make_batch, run_jax, run_port

torch.set_num_threads(2)

B, T, F = 3, 83, 24
LENGTHS = (83, 50, 31)
SMALL = dict(num_blocks=2, attention_dim=32, attention_heads=2, linear_units=64, embd_dim=16, out_dim=48)
RE = dict(transformer_type="re_conformer", input_layer="re_conv2d")


def _mask(t=T):
    return np.arange(t)[None, :] < np.asarray(LENGTHS)[:, None]


def _randomize_eps(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomize_eps(val, rng)
        elif key == "eps" or key.startswith("scale_"):
            tree[key] = np.asarray(val + rng.normal() * 0.3, val.dtype)


def _variables(module, *args, seed=0, **kw):
    init = jax.jit(lambda k, *a: module.init({"params": k, "dropout": k}, *a, **kw))
    v = jax.tree_util.tree_map(np.array, init(jax.random.PRNGKey(seed), *args))
    rng = np.random.default_rng(seed)
    _randomize(v, rng)
    _randomize_eps(v, rng)
    return v


# -- the balancer -----------------------------------------------------------------

def _balancer_input(seed, shape, channel_axis):
    """Channels that engage each branch: mostly negative (below
    min_positive), mostly positive (above max_positive), tiny (mean |x|
    under min_abs), huge (over max_abs) and plain."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    c = shape[channel_axis]
    offsets = np.array([-3.0, 3.0, 0.0, 0.0, 0.0] * (c // 5 + 1))[:c]
    scales = np.array([1.0, 1.0, 1e-2, 300.0, 1.0] * (c // 5 + 1))[:c]
    view = [1] * len(shape)
    view[channel_axis] = c
    return x * scales.reshape(view) + offsets.reshape(view)


ARGS = {
    "default": (0.05, 0.95, 0.01, 0.2, 100.0),
    "conv_first": (0.05, 1.0, 0.01, 0.2, 10.0),
    "out": (0.45, 0.55, 0.01, 0.2, 100.0),
    "no_min": (0.0, 0.9, 0.04, 0.5, 50.0),
}


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("args", list(ARGS))
def test_balancer_matches_the_custom_vjp(args, dtype):
    """Forward: the identity. Backward: JAX's rule, channels last in JAX
    and on dim 1 of the port's [B, C, T, F] maps."""
    x = _balancer_input(1, (2, 7, 5, 10), -1)
    g = np.random.default_rng(2).normal(size=x.shape)
    with jax.enable_x64(dtype == "float64"):
        jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
        y, vjp = jax.vjp(lambda v: jscaling.activation_balancer(v, -1, *ARGS[args]), jx)
        ref = np.asarray(vjp(jg)[0], np.float64)
        assert np.array_equal(np.asarray(y), np.asarray(jx))
    tdt = getattr(torch, dtype)
    px = torch.tensor(x.transpose(0, 3, 1, 2), dtype=tdt, requires_grad=True)
    py = pscaling.activation_balancer(px, 1, *ARGS[args])
    assert torch.equal(py, px)
    (got,) = torch.autograd.grad(py, px, torch.tensor(g.transpose(0, 3, 1, 2), dtype=tdt))
    got = got.double().numpy().transpose(0, 2, 3, 1)
    assert not np.allclose(ref, g)  # the rule moved the gradient
    tol = 1e-12 if dtype == "float64" else 2e-2
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_balancer_is_the_identity_without_gradients():
    x = torch.randn(2, 3, 4)
    assert pscaling.activation_balancer(x) is x
    with torch.no_grad():
        w = x.clone().requires_grad_()
        assert pscaling.activation_balancer(w) is w


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("learn_eps", [True, False])
def test_basic_norm_matches_jax(learn_eps, dtype):
    x = np.random.default_rng(3).normal(size=(B, 11, 16)) * 2.0
    jm = jscaling.BasicNorm(learn_eps=learn_eps)
    v = _variables(jm, jnp.asarray(x, jnp.float32))
    with jax.enable_x64(dtype == "float64"):
        ref = np.asarray(jm.apply(jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v),
                                  jnp.asarray(x, dtype)), np.float64)
    port = pscaling.BasicNorm(learn_eps=learn_eps).to(getattr(torch, dtype))
    load_variables(port, v)
    got = port(torch.as_tensor(x, dtype=getattr(torch, dtype))).detach().double().numpy()
    assert [k for k, _ in port.named_parameters()] == (["eps"] if learn_eps else [])
    assert np.abs(got - ref).max() <= (1e-12 if dtype == "float64" else 1e-6) * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("masked", [False, True])
def test_re_conv2d_subsampling_matches_jax(masked, dtype):
    x = np.random.default_rng(4).normal(size=(B, T, F))
    mask = _mask() if masked else None
    jm = jsub.ReConv2dSubsampling4(odim=32)
    v = _variables(jm, jnp.asarray(x, jnp.float32), None if mask is None else jnp.asarray(mask))
    with jax.enable_x64(dtype == "float64"):
        ref, ref_mask = jax.jit(jm.apply)(jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v),
                                          jnp.asarray(x, dtype), None if mask is None else jnp.asarray(mask))
        ref = np.asarray(ref, np.float64)
    port = psub.make_subsampling("re_conv2d", F, 32).to(getattr(torch, dtype))
    load_variables(port, v)
    with torch.no_grad():
        got, got_mask = port(torch.as_tensor(x, dtype=getattr(torch, dtype)),
                             None if mask is None else torch.as_tensor(mask))
    assert got.shape == ref.shape == (B, (T - 3) // 4 + 1 - 1 + ((T - 3) // 2 + 1 - 3) // 2 + 1 - ((T - 3) // 4), 32)
    assert np.abs(got.double().numpy() - ref).max() <= (1e-10 if dtype == "float64" else 1e-5) * np.abs(ref).max()
    if masked:
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))


# -- the model --------------------------------------------------------------------

OPTIONS = {
    "re_conformer": RE,
    # the ReConformer's blocks behind the plain conv2d subsampling
    "re_conformer_conv2d": dict(transformer_type="re_conformer"),
    # pre-norm blocks with BasicNorm norms (the conv module's too), learned
    # branch scales and the balancers
    "basic_norm_re_scale_balancer": dict(encoder_params={
        "norm_type": "basic_norm", "cnn_norm_type": "basic_norm", "re_scale": True, "use_balancer": True,
        "activation_type": "double_swish"}),
    # re_layer alone keeps normalize_before, hence a batch_norm after_norm
    "re_layer_batch_norm": dict(encoder_params={"re_layer": True, "norm_type": "batch_norm"}),
    # the block-level batch_norm (statistics over B and T, no mask)
    "block_batch_norm_re_scale": dict(encoder_params={"norm_type": "batch_norm", "re_scale": True}),
}


def _model_pair(name, dtype, seed=0):
    """(JAX model, variables, the port's model with them, input); the
    variables are the port's seeded weights in JAX's layout, randomised
    (no JAX init to compile). One block for the single options (a shorter
    JAX compile), two for the ReConformer."""
    cfg = {**SMALL, **OPTIONS[name], **({} if name == "re_conformer" else {"num_blocks": 1})}
    x = np.random.default_rng(seed).normal(size=(B, T, F))
    port = ConformerXvector(F, device="cpu", **cfg)
    v = jax.tree_util.tree_map(np.array, state_dict_to_variables(init_weights_(port, seed).state_dict()))
    rng = np.random.default_rng(seed)
    _randomize(v, rng)
    _randomize_eps(v, rng)
    port = load_variables(port.to(getattr(torch, dtype)), v)
    return JaxConformerXvector(**cfg), v, port, x


@pytest.fixture(scope="module")
def re_f64():
    return _model_pair("re_conformer", "float64")


@pytest.mark.parametrize("name,dtype", [("re_conformer", "float32")] + [(n, "float64") for n in OPTIONS])
def test_model_matches_jax_in_eval(name, dtype):
    jm, v, port, x = _model_pair(name, dtype)
    with jax.enable_x64(dtype == "float64"):
        apply = jax.jit(lambda v, x, m: jm.apply(v, x, m, train=False))
        ref = np.asarray(apply(jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v), jnp.asarray(x, dtype),
                               jnp.asarray(_mask())), np.float64)
    with torch.no_grad():
        got = port(torch.as_tensor(x, dtype=getattr(torch, dtype)), torch.as_tensor(_mask())).double().numpy()
    assert np.abs(got - ref).max() <= (1e-10 if dtype == "float64" else 1e-4) * np.abs(ref).max()


def test_reconformer_leaves_and_defaults(re_f64):
    """The ReConformer's blocks hold no per-branch norms, a learnable
    BasicNorm norm_final, no after_norm; its subsampling is re_conv2d. JAX's
    init makes the same tree."""
    jm, v, port, x = re_f64
    init = jax.jit(lambda k, x, m: jm.init({"params": k, "dropout": k}, x, m, train=False))
    shapes = jax.tree_util.tree_map(lambda a: a.shape, init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
                                                            jnp.asarray(_mask())))
    assert shapes == jax.tree_util.tree_map(lambda a: a.shape, {"params": v["params"]})
    block = v["params"]["transformer"]["block_0"]
    assert set(block) == {"ff_macaron", "self_attn", "conv_module", "ff", "norm_final"}
    assert block["norm_final"]["eps"].shape == () and "norm" not in block["conv_module"]
    assert "after_norm" not in v["params"]["transformer"] and port.transformer.after_norm is None
    assert v["batch_stats"] == {}
    assert type(port.transformer.embed).__name__ == "ReConv2dSubsampling4"
    seeded = init_weights_(ConformerXvector(F, device="cpu", **SMALL, **RE), 0)
    eps = seeded.transformer.block_0.norm_final.eps
    assert eps.dim() == 0 and float(eps) == pytest.approx(np.log(0.25), abs=1e-7)


def test_weights_round_trip_bit_for_bit(re_f64):
    _, v, port, _ = re_f64
    back = state_dict_to_variables(port.state_dict())
    flat = lambda t: {jax.tree_util.keystr(k): a for k, a in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(back), flat({"params": v["params"], "batch_stats": v.get("batch_stats", {})})
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key].astype(np.float64), err_msg=key)


def test_f64_train_step_matches_jax_leaf_by_leaf():
    """Two SGD steps of the narrow ReConformer on features (mask on), the
    balancers' backward in every block and in the subsampling."""
    cfg = {**SMALL, **RE, "dropout_rate": 0.0}
    jnet = JaxSpeakerNet(JaxConformerXvector(**cfg), AAM[0], AAM[1], num_targets=C)
    pnet = SpeakerNet(ConformerXvector(D, device="cpu", **cfg), AAM[0], AAM[1], num_targets=C).to(torch.float64)
    v = port_variables(pnet)
    _randomize_eps(v, np.random.default_rng(1))
    batches = [make_batch(1, True), make_batch(2, True)]
    jax_state, jax_m = run_jax(jnet, optax.sgd(LR), v, batches, JaxStepConfig(compute_dtype=jnp.float64))
    port_state, port_m = run_port(pnet, sgd(LR), v, batches, TrainStepConfig(compute_dtype=torch.float64))
    for p, j in zip(port_m, jax_m):
        assert_metrics_close(p, j)
    assert_states_close(port_state, jax_state, 1e-6)
