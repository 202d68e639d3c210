"""The port's lawlict ECAPA-TDNN (models/ecapa_lawlict.py) against the JAX
package, on the same carried weights.

Its four parts (LawlictRes2Block, SEConnectLinear, LawlictSERes2Block,
LawlictAttentiveStatsPool) and EcapaLawlict at every position, with fc1,
with the zoo's mqmha pooling, masked and not, in eval mode; the blocks
and the model in train mode too (the output and the new running
statistics). The parts in f32 at atol 1e-5 (sums in another order), as
tests/test_torch_xvector.py; the model in f32 at 1e-4 (the pooled std's
cancellation, below) and in f64 at 1e-10. The pooling in bf16 against f32 (0.05). One f64 SGD
step of SpeakerNet(EcapaLawlict) with ecapa_lawlict.yaml's AM head against
JAX's step leaf by leaf at 1e-6 of each leaf's scale. weights.py carries
the tree there and back bit for bit.

Small size: channels 32 (splits of 4), 24 bins, T = 37, B = 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models import ecapa_lawlict as jlaw
from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.models import (MODELS, EcapaLawlict, LawlictAttentiveStatsPool, LawlictRes2Block,
                                           LawlictSERes2Block, SEConnectLinear, SpeakerNet)
from asv_subtools_tpu_torch.train import TrainStepConfig, sgd
from asv_subtools_tpu_torch.weights import load_variables, state_dict_to_variables, variables_to_state_dict
from test_torch_train_step import C, D, LR, assert_metrics_close, assert_states_close, init_variables, make_batch, \
    run_jax, run_port

torch.set_num_threads(2)

B, T, F = 3, 37, 24
LENGTHS = (37, 20, 9)
ATOL = 1e-5
# the model in f32: its pooled std is E[x^2] - mean^2 in f32 over MFA
# outputs up to ~12, whose rounding differs between the two sides' orders
# of summation by up to 1e-4 of a std of 4.5 (measured); the f64 case
# holds the model at 1e-10
MODEL_ATOL = 1e-4
CH = 32


def _randomize(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif key in ("bias", "mean"):
            tree[key] = (rng.normal(size=val.shape) * 0.1).astype(val.dtype)
        elif key == "scale":
            tree[key] = rng.uniform(0.8, 1.2, size=val.shape).astype(val.dtype)
        elif key == "var":
            tree[key] = rng.uniform(0.5, 2.0, size=val.shape).astype(val.dtype)


def _variables(module, *args, seed=0, **kw):
    v = module.init({"params": jax.random.PRNGKey(seed)}, *map(jnp.asarray, args), **kw)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    _randomize(v, np.random.default_rng(seed + 100))
    return v


def _inputs(seed=0, d=F):
    x = np.random.default_rng(seed).normal(size=(B, T, d)).astype(np.float32)
    return x, np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]


def _bct(x):
    return torch.from_numpy(x).transpose(1, 2).contiguous()


def _assert_stats_match(port, upd):
    got = {jax.tree_util.keystr(p): a for p, a in
           jax.tree_util.tree_leaves_with_path(state_dict_to_variables(port.state_dict())["batch_stats"])}
    want = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(jax.device_get(upd))}
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=1e-5, err_msg=key)


PARTS = {
    "res2": (lambda: jlaw.LawlictRes2Block(CH, dilation=3), lambda: LawlictRes2Block(CH, dilation=3), True),
    "se": (lambda: jlaw.SEConnectLinear(), lambda: SEConnectLinear(CH), False),
    "se_res2": (lambda: jlaw.LawlictSERes2Block(CH, dilation=2), lambda: LawlictSERes2Block(CH, dilation=2), True),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("part,train", [(p, t) for p in PARTS for t in (False, True) if PARTS[p][2] or not t])
def test_part_matches_jax(part, train, masked):
    """SEConnectLinear has no BatchNorm, so no train mode of its own."""
    make_jax, make_port, has_bn = PARTS[part]
    x, mask = _inputs(1, CH)
    jm, port = make_jax(), make_port()
    kw = {"train": False} if has_bn else {}
    v = _variables(jm, x, seed=1, **kw)
    load_variables(port, v)
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    if train:
        ref, upd = jm.apply(v, jnp.asarray(x), train=True, mask=jmask, mutable=["batch_stats"])
        got = port.train()(_bct(x), tmask).detach()
        _assert_stats_match(port, upd["batch_stats"])
    else:
        ref = jm.apply(v, jnp.asarray(x), mask=jmask, **kw)
        with torch.no_grad():
            got = port.eval()(_bct(x), tmask)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(ref), atol=ATOL)


def test_res2_block_convolves_the_first_split_and_passes_the_last():
    port = LawlictRes2Block(CH)
    assert all(getattr(port, f"block_{i}").affine.conv.bias is None for i in range(7))
    assert port.block_6.act_bn.bn.momentum == 0.1
    x = _bct(_inputs(2, CH)[0])
    with torch.no_grad():
        y = port.eval()(x)
    np.testing.assert_array_equal(y[:, -CH // 8:].numpy(), x[:, -CH // 8:].numpy())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bottleneck", [128, 16])
def test_attentive_pooling_matches_jax(bottleneck, masked):
    x, mask = _inputs(3, CH)
    jm, port = jlaw.LawlictAttentiveStatsPool(bottleneck=bottleneck), LawlictAttentiveStatsPool(CH, bottleneck)
    v = _variables(jm, x, seed=3)
    load_variables(port, v)
    ref = jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask) if masked else None)
    assert got.shape == (B, 2 * CH)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_attentive_pooling_in_bf16_against_f32():
    """In bf16 the weighted sums run in f32 and the result is cast once;
    against the f32 pooling within 0.05 (the JAX bf16 pooling test's
    bound, atol = rtol = 0.05), on frames offset from 0."""
    x, mask = _inputs(4, CH)
    x = x + 1.0
    port = LawlictAttentiveStatsPool(CH, 16)
    with torch.no_grad():
        ref = port(torch.from_numpy(x), torch.from_numpy(mask))
        got = port.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=0.05, rtol=0.05)


MODEL_CASES = {
    "default": dict(),
    "fc1": dict(fc1=True),
    "hidden_64": dict(pooling_params={"hidden_size": 64}),
    "mqmha": dict(pooling="mqmha", pooling_params={"num_q": 2, "num_head": 2}),
}


@pytest.fixture(scope="module")
def lawlict_variables():
    x, mask = _inputs(5)
    return {name: _variables(jlaw.EcapaLawlict(channels=CH, embd_dim=16, **kw), x, seed=5, mask=jnp.asarray(mask),
                             train=False)
            for name, kw in MODEL_CASES.items()}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_matches_jax_at_every_position(lawlict_variables, case, masked, dtype):
    """f32 at MODEL_ATOL, f64 at 1e-10."""
    kw = MODEL_CASES[case]
    v = jax.tree_util.tree_map(lambda a: a.astype(dtype), lawlict_variables[case])
    jm = jlaw.EcapaLawlict(channels=CH, embd_dim=16, **kw)
    port = load_variables(EcapaLawlict(F, channels=CH, embd_dim=16, **kw, device="cpu").to(getattr(torch, dtype)), v)
    x, mask = _inputs(6)
    x = x.astype(dtype)
    tmask = torch.from_numpy(mask) if masked else None
    for position in ("near", "near_affine") + (("far",) if kw.get("fc1") else ()):
        with jax.enable_x64(dtype == "float64"):
            ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask) if masked else None, train=False,
                                      position=position))
        with torch.no_grad():
            got = port(torch.from_numpy(x), tmask, position=position)
        assert got.dtype == getattr(torch, dtype) and ref.dtype == dtype
        np.testing.assert_allclose(got.numpy(), ref, atol=MODEL_ATOL if dtype == "float32" else 1e-10,
                                   err_msg=position)
    if not kw.get("fc1"):
        with pytest.raises(ValueError, match="fc1=True"):
            port(torch.from_numpy(x), position="far")


@pytest.mark.parametrize("case", ["default", "mqmha"])
def test_model_train_mode_matches_jax(lawlict_variables, case):
    kw = MODEL_CASES[case]
    v = lawlict_variables[case]
    jm = jlaw.EcapaLawlict(channels=CH, embd_dim=16, **kw)
    port = load_variables(EcapaLawlict(F, channels=CH, embd_dim=16, **kw, device="cpu"), v).train()
    x, mask = _inputs(7)
    ref, upd = jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=True, mutable=["batch_stats"])
    got = port(torch.from_numpy(x), torch.from_numpy(mask)).detach()
    # the train-mode bn_stats and fc BNs normalise over B = 3 rows: 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    _assert_stats_match(port, upd["batch_stats"])


def test_bn_momenta_are_the_jax_models():
    port = EcapaLawlict(F, channels=CH, embd_dim=16, fc1=True, device="cpu")
    assert port.layer1.act_bn.bn.momentum == port.mfa.act_bn.bn.momentum == port.bn_stats.momentum == 0.1
    assert port.layer2.conv1.act_bn.bn.momentum == port.layer3.res2net.block_0.act_bn.bn.momentum == 0.1
    assert port.fc1_bn.momentum == port.fc2_bn.momentum == 0.5
    assert port.layer1.affine.conv.bias is None and port.mfa.affine.conv.bias is not None
    assert port.mfa.affine.conv.out_channels == 3 * CH and port.layer2.se.linear1.out_features == CH // 4


def test_models_table_builds_the_preset_width():
    model = MODELS["ecapa_lawlict"](input_dim=80, channels=512, embd_dim=192, device="cpu")
    assert type(model) is EcapaLawlict and model.embd_dim == 192 and model.bn_stats.mean.shape == (3072,)


def test_dropout_draws_from_the_generator():
    port = EcapaLawlict(F, channels=CH, embd_dim=16, aug_dropout=0.2, tail_dropout=0.2, device="cpu").train()
    x = torch.from_numpy(_inputs(8)[0])
    a = port(x, generator=torch.Generator().manual_seed(1))
    b = port(x, generator=torch.Generator().manual_seed(1))
    c = port(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_weights_round_trip_bit_for_bit(lawlict_variables, case):
    v = lawlict_variables[case]
    back = state_dict_to_variables(variables_to_state_dict(v))
    for coll in v:
        flat = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(back[coll])}
        for path, a in jax.tree_util.tree_leaves_with_path(v[coll]):
            assert np.array_equal(flat.pop(jax.tree_util.keystr(path)), a)
        assert not flat
    load_variables(EcapaLawlict(F, channels=CH, embd_dim=16, **MODEL_CASES[case], device="cpu"), v)


# -- the train step -------------------------------------------------------------

AM = ("margin_softmax", {"method": "am", "m": 0.2, "s": 30.0})  # ecapa_lawlict.yaml


@pytest.mark.parametrize("masked", [False, True])
def test_sgd_step_matches_jax_leaf_by_leaf(masked):
    jnet = JaxSpeakerNet(jlaw.EcapaLawlict(channels=CH, embd_dim=16), *AM, num_targets=C)
    pnet = SpeakerNet(EcapaLawlict(D, channels=CH, embd_dim=16, device="cpu"), *AM, num_targets=C).double()
    variables = init_variables(jnet, seed=8)
    batches = [make_batch(60, masked)]
    jax_state, jax_m = run_jax(jnet, optax.sgd(LR), variables, batches, JaxStepConfig(compute_dtype=jnp.float64))
    port_state, port_m = run_port(pnet, sgd(LR), variables, batches, TrainStepConfig(compute_dtype=torch.float64))
    assert_metrics_close(port_m[0], jax_m[0])
    assert_states_close(port_state, jax_state, 1e-6)
