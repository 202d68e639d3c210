"""The port's pooling zoo (nn/pooling.py) against the JAX package's poolings.

Every one of the ten poolings and their options on seeded numpy inputs
[3, 37, 24] with lengths 37, 20 and 9, masked and not, in eval mode; the
ones that hold a BatchNorm (``mqmha``, ``mqmha-linear``, ``xi``) also in
train mode, with the updated running statistics. Biases, BN affines, the
running statistics and the learnable temperatures are randomised.
Tolerance: 1e-5 absolute in f32 (sums in another order).

Also: the output widths against JAX's ``pooling_output_dim``; frames past
the mask do not reach the result; an ``mqmha`` tree (whose grouped
``att1`` is no split conv) crosses weights.py and back bit for bit; the
Conformer x-vector with a zoo pooling against JAX's; and the bf16 sums
kept in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.models.conformer import ConformerXvector as JaxConformerXvector
from asv_subtools_tpu.nn import pooling as jpool
from asv_subtools_tpu_torch.models import ConformerXvector
from asv_subtools_tpu_torch.nn import pooling as ppool
from asv_subtools_tpu_torch.weights import load_variables, state_dict_to_variables, variables_to_state_dict

torch.set_num_threads(2)

B, T, D = 3, 37, 24
LENGTHS = (37, 20, 9)
ATOL = 1e-5

CASES = {
    "statistics": ("statistics", {}),
    "statistics_unbiased": ("statistics", {"unbiased": True}),
    "statistics_mean": ("statistics", {"stddev": False}),
    "free-statistics": ("free-statistics", {}),
    "lde": ("lde", {"c_num": 4}),
    "attentive": ("attentive", {"hidden_size": 8}),
    "attentive_context": ("attentive", {"hidden_size": 8, "context": (-2, 0, 2)}),
    "attentive_one_layer": ("attentive", {"affine_layers": 1, "stddev_attention": False}),
    "attentive_mean": ("attentive", {"hidden_size": 8, "stddev": False}),
    "multi-head": ("multi-head", {"hidden_size": 8}),
    "multi-head_full": ("multi-head", {"affine_layers": 2, "hidden_size": 8, "share": False}),
    "multi-head_learned_t": ("multi-head", {"affine_layers": 2, "hidden_size": 8, "temperature": True,
                                            "fixed": False}),
    "multi-head_no_att_std": ("multi-head", {"stddev_attention": False}),
    "global-multi": ("global-multi", {"hidden_size": 8}),
    "global-multi_full": ("global-multi", {"hidden_size": 8, "share": False, "num_head": 2}),
    "global-multi_no_att_std": ("global-multi", {"hidden_size": 8, "stddev_attention": False}),
    "multi-resolution": ("multi-resolution", {"hidden_size": 8}),
    "multi-resolution_learned_t": ("multi-resolution", {"hidden_size": 8, "fixed": False}),
    "mqmha": ("mqmha", {"hidden_size": 8}),
    "mqmha_layer_norm": ("mqmha", {"hidden_size": 8, "norm_type": "layer_norm"}),
    "mqmha_time_attention": ("mqmha", {"hidden_size": 8, "time_attention": True}),
    "mqmha_one_layer": ("mqmha", {"affine_layers": 1, "share": False}),
    "mqmha_mean": ("mqmha", {"hidden_size": 8, "stddev": False, "num_q": 3}),
    "mqmha-linear": ("mqmha-linear", {"hidden_size": 8}),
    "xi": ("xi", {"hidden_size": 8}),
    "xi_stddev": ("xi", {"hidden_size": 8, "stddev": True}),
}
WITH_TRAIN = ("mqmha", "mqmha-linear", "xi")


def _randomize(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif key in ("bias", "mean"):
            tree[key] = (rng.normal(size=val.shape) * 0.1).astype(np.float32)
        elif key in ("scale", "s"):
            tree[key] = rng.uniform(0.8, 1.2, size=val.shape).astype(np.float32)
        elif key == "var":
            tree[key] = rng.uniform(0.5, 2.0, size=val.shape).astype(np.float32)
        elif key in ("t", "prior_mean", "prior_logprec"):
            tree[key] = rng.normal(size=val.shape).astype(np.float32)


def _inputs(seed=0):
    x = np.random.default_rng(seed).normal(size=(B, T, D)).astype(np.float32)
    return x, np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]


def _pair(case, seed=0):
    """(JAX module, its variables (numpy), the port module with them)."""
    name, kw = CASES[case]
    jm = jpool.POOLINGS[name](**kw)
    x, _ = _inputs(seed)
    extra = {"train": False} if name in WITH_TRAIN else {}
    v = jax.tree_util.tree_map(np.array, jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), **extra))
    _randomize(v, np.random.default_rng(seed + 50))
    port = ppool.build_pooling(name, D, kw)
    if v:
        load_variables(port, v)
    return jm, v, port


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_pooling_matches_jax(case, masked):
    jm, v, port = _pair(case, 1)
    x, mask = _inputs(2)
    m = mask if masked else None
    extra = {"train": False} if CASES[case][0] in WITH_TRAIN else {}
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=None if m is None else jnp.asarray(m), **extra))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), None if m is None else torch.from_numpy(m)).numpy()
    assert got.shape == ref.shape == (B, port.output_dim(D))
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("case", ["mqmha", "mqmha_time_attention", "mqmha-linear", "xi", "xi_stddev"])
def test_pooling_train_mode_matches_jax(case):
    jm, v, port = _pair(case, 3)
    x, mask = _inputs(4)
    ref, upd = jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=True, mutable=["batch_stats"])
    got = port.train()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL)
    want = variables_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.array, upd["batch_stats"])})
    assert want
    for key, value in want.items():
        np.testing.assert_allclose(port.state_dict()[key].numpy(), value.numpy(), atol=1e-6, err_msg=key)
    got.sum().backward()  # the train path has a backward
    assert all(p.grad is not None for p in port.parameters())


@pytest.mark.parametrize("case", list(CASES))
def test_output_dim_matches_jax(case):
    name, kw = CASES[case]
    _, _, port = _pair(case)
    assert port.output_dim(D) == ppool.pooling_output_dim(name, D, **kw)
    if name != "free-statistics":  # the JAX table has no entry for it
        assert port.output_dim(D) == jpool.pooling_output_dim(name, D, **kw)


@pytest.mark.parametrize("case", [c for c in CASES if c not in ("free-statistics", "mqmha_layer_norm",
                                                                 "attentive_context")])
def test_masked_frames_do_not_reach_the_result(case):
    """Other values in the padded frames give the same vector. (The free
    statistics read every frame by design; the GroupNorm of mqmha's
    layer_norm, and an attention context wider than one frame, read padded
    frames in the JAX modules too.)"""
    _, _, port = _pair(case, 5)
    x, mask = _inputs(6)
    y = np.where(mask[..., None], x, np.random.default_rng(7).normal(size=x.shape) * 5).astype(np.float32)
    with torch.no_grad():
        a = port.eval()(torch.from_numpy(x), torch.from_numpy(mask))
        b = port(torch.from_numpy(y), torch.from_numpy(mask))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_every_name_builds_and_pools():
    """No name of the table raises: each pools a [3, 37, 24] batch to a finite vector."""
    assert set(ppool.POOLINGS) == set(jpool.POOLINGS)
    x, mask = _inputs(8)
    for name in ppool.POOLINGS:
        port = ppool.build_pooling(name, D).eval()
        with torch.no_grad():
            out = port(torch.from_numpy(x), torch.from_numpy(mask))
        assert out.shape == (B, port.output_dim(D)) and bool(torch.isfinite(out).all()), name


def _keyed(tree):
    return {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("case", ["mqmha", "mqmha_one_layer", "mqmha_layer_norm", "mqmha-linear", "lde", "xi",
                                  "multi-head_learned_t"])
def test_weights_round_trip_bit_for_bit(case):
    """An mqmha tree names its grouped TdnnAffine ``att1`` beside an
    ``att2`` (or none): it must take the conv rule, not the split rule of
    ECAPA's ``att1``."""
    _, v, port = _pair(case, 9)
    state = variables_to_state_dict(v)
    if CASES[case][0].startswith("mqmha"):
        att1 = [k for k in state if ".att1." in f".{k}"]
        assert att1 and all(k.endswith(("att1.conv.weight", "att1.conv.bias")) for k in att1), att1
    back = state_dict_to_variables(state)
    for coll in v:
        got, want = _keyed(back[coll]), _keyed(v[coll])
        assert set(got) == set(want)
        for k, a in want.items():
            assert np.array_equal(got[k], a), k
    assert set(port.state_dict()) == set(state)


def test_bf16_statistics_sum_in_f32():
    """The attentive statistics of a bf16 model run in f32: the std of
    features riding on a mean four times their spread stays within 1% of
    the f32 result (bf16 products alone would cancel to ~3%)."""
    _, _, port = _pair("attentive", 10)
    x, mask = _inputs(11)
    x = x + 4.0
    with torch.no_grad():
        want = port.eval()(torch.from_numpy(x), torch.from_numpy(mask))
        got = port.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    std_err = (got[:, D:].float() - want[:, D:]).abs().max()
    assert float(std_err) < 0.01 * float(want[:, D:].abs().max())


CONFORMER = dict(num_blocks=2, attention_dim=64, attention_heads=2, linear_units=128, embd_dim=16, out_dim=32)


@pytest.mark.parametrize("pooling,params", [("lde", {"c_num": 2}), ("mqmha", {"hidden_size": 8}),
                                            ("multi-head", {})])
def test_conformer_with_a_zoo_pooling_matches_jax(pooling, params):
    """The Conformer x-vector takes any pooling of the zoo (eval, masked)."""
    x = np.random.default_rng(12).normal(size=(B, 83, D)).astype(np.float32)
    mask = np.arange(83)[None, :] < np.asarray((83, 60, 31))[:, None]
    jm = JaxConformerXvector(pooling=pooling, pooling_params=params, **CONFORMER)
    v = jm.init({"params": jax.random.PRNGKey(13), "dropout": jax.random.PRNGKey(13)}, jnp.asarray(x), train=False)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    _randomize(v, np.random.default_rng(14))
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=False))
    port = load_variables(ConformerXvector(D, pooling=pooling, pooling_params=params, device="cpu", **CONFORMER), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
