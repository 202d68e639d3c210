"""Port ECAPA-TDNN (eval) and its layers against the JAX model on the same
weights, carried by asv_subtools_tpu_torch.weights.

Tolerances: embeddings allclose at atol 1e-4 in f32; per-utterance cosine
>= 0.999 in bf16 (both sides round every layer to bf16, in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from asv_subtools_tpu.models.ecapa import Res2NetBlock as JaxRes2Net
from asv_subtools_tpu.models.ecapa import SEConnect as JaxSE
from asv_subtools_tpu.nn.norm import BatchNorm as JaxBatchNorm
from asv_subtools_tpu.nn.tdnn import ReluBatchNormTdnnLayer as JaxTdnnLayer
from asv_subtools_tpu_torch.models import EcapaTdnn, Res2NetBlock, SEConnect
from asv_subtools_tpu_torch.nn import BatchNorm, ReluBatchNormTdnnLayer
from asv_subtools_tpu_torch.weights import (
    ecapa_state_dict_to_variables,
    ecapa_variables_to_state_dict,
    init_ecapa_weights_,
    load_ecapa_variables,
)

torch.set_num_threads(2)

B, T, D = 3, 120, 40
SMALL = dict(channels=128, mfa_conv=256, embd_dim=32)


def _randomize(v, rng):
    """Non-trivial biases, BN affine and running statistics (numpy tree)."""
    for key, val in v.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif key in ("bias", "mean"):
            v[key] = (rng.normal(size=val.shape) * 0.1).astype(np.float32)
        elif key == "scale":
            v[key] = rng.uniform(0.8, 1.2, size=val.shape).astype(np.float32)
        elif key == "var":
            v[key] = rng.uniform(0.5, 2.0, size=val.shape).astype(np.float32)


def _variables(module, x, seed=0, **kw):
    v = module.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), **kw)
    v = jax.tree_util.tree_map(np.array, v)
    _randomize(v, np.random.default_rng(seed))
    return v


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, 77, 20])[:, None]
    return x, mask


@pytest.fixture(scope="module")
def small_model():
    x, _ = _inputs()
    v = _variables(JaxEcapa(**SMALL), x, train=False)
    port = EcapaTdnn(input_dim=D, device="cpu", **SMALL)
    load_ecapa_variables(port, v)
    return v, port


@pytest.mark.parametrize("masked", [False, True])
def test_embedding_matches_jax_f32(small_model, masked):
    v, port = small_model
    x, mask = _inputs(1)
    m = mask if masked else None
    ref = np.asarray(JaxEcapa(**SMALL).apply(
        v, jnp.asarray(x), mask=None if m is None else jnp.asarray(m), train=False))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), None if m is None else torch.from_numpy(m)).numpy()
    assert got.shape == (B, 32)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_embedding_matches_jax_bf16(small_model, masked):
    v, port = small_model
    x, mask = _inputs(2)
    m = mask if masked else None
    vb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    ref = np.asarray(JaxEcapa(**SMALL).apply(
        vb, jnp.asarray(x, jnp.bfloat16), mask=None if m is None else jnp.asarray(m), train=False),
        np.float32)
    pb = EcapaTdnn(input_dim=D, device="cpu", **SMALL)
    pb.load_state_dict(port.state_dict())
    pb = pb.to(torch.bfloat16)
    with torch.inference_mode():
        got = pb(torch.from_numpy(x).bfloat16(), None if m is None else torch.from_numpy(m)).float().numpy()
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert np.all(cos >= 0.999), cos


def test_fused_pooling_inside_model_matches_jax(small_model):
    """The model with its pooling switched to the fused path (the plain
    version on CPU) gives the JAX embedding."""
    v, port = small_model
    x, mask = _inputs(3)
    ref = np.asarray(JaxEcapa(**SMALL).apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=False))
    port.stats.fused_inference = True
    try:
        with torch.inference_mode():
            got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    finally:
        port.stats.fused_inference = False
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_weights_round_trip_bit_for_bit(small_model):
    v, port = small_model
    jax_leaves = jax.tree_util.tree_leaves_with_path(v)
    sd = ecapa_variables_to_state_dict(v)
    # every leaf consumed once, every port tensor set
    assert len(sd) == len(jax_leaves) == len(port.state_dict())
    assert set(sd) == set(port.state_dict())
    back = dict(jax.tree_util.tree_leaves_with_path(ecapa_state_dict_to_variables(sd)))
    assert set(back) == {p for p, _ in jax_leaves}
    for path, leaf in jax_leaves:
        assert back[path].dtype == leaf.dtype
        np.testing.assert_array_equal(back[path], leaf)
    back_port = ecapa_state_dict_to_variables(port.state_dict())
    for path, leaf in jax_leaves:
        np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(back_port))[path], leaf)


def test_weight_mapping_layouts(small_model):
    v, _ = small_model
    sd = ecapa_variables_to_state_dict(v)
    p = v["params"]
    np.testing.assert_array_equal(sd["layer1.affine.conv.weight"].numpy(),
                                  p["layer1"]["affine"]["conv"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["fc2_affine.weight"].numpy(), p["fc2_affine"]["kernel"].T)
    np.testing.assert_array_equal(sd["stats.att1.kernel"].numpy(), p["stats"]["att1"]["kernel"])
    assert tuple(sd["stats.att1.kernel"].shape) == (1, 3 * 256, 128)
    np.testing.assert_array_equal(sd["bn_stats.var"].numpy(), v["batch_stats"]["bn_stats"]["var"])


def test_load_raises_on_unconsumed_or_missing(small_model):
    v, _ = small_model
    port = EcapaTdnn(input_dim=D, device="cpu", **SMALL)
    extra = jax.tree_util.tree_map(lambda a: a, v)
    extra["params"]["layer1"]["stray"] = {"kernel": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError):
        load_ecapa_variables(port, extra)
    missing = jax.tree_util.tree_map(lambda a: a, v)
    del missing["batch_stats"]["fc2_bn"]
    with pytest.raises(ValueError):
        load_ecapa_variables(port, missing)
    odd = jax.tree_util.tree_map(lambda a: a, v)
    odd["params"]["fc2_bn"]["gamma"] = np.ones(32, np.float32)
    with pytest.raises(ValueError):
        ecapa_variables_to_state_dict(odd)


def _layer_case(jax_mod, port_mod, x, mask=None, **call_kw):
    v = _variables(jax_mod, x, **call_kw)
    load_ecapa_variables(port_mod, v)
    jkw = dict(call_kw)
    if mask is not None:
        jkw["mask"] = jnp.asarray(mask)
    ref = np.asarray(jax_mod.apply(v, jnp.asarray(x), **jkw))
    args = (torch.from_numpy(x).transpose(1, 2),)
    if mask is not None:
        args += (torch.from_numpy(mask),)
    with torch.inference_mode():
        got = port_mod.eval()(*args)  # the JAX side runs train=False
    return got, ref


@pytest.mark.parametrize("context", [(0,), (-2, -1, 0, 1, 2), (-3, 0, 3), (-2, 0)])
def test_tdnn_layer_matches_jax(context):
    x, _ = _inputs(4)
    got, ref = _layer_case(JaxTdnnLayer(24, context=context), ReluBatchNormTdnnLayer(D, 24, context),
                           x, train=False)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_batchnorm_matches_jax():
    x = np.random.default_rng(5).normal(size=(4, 10, 6)).astype(np.float32) * 3
    got, ref = _layer_case(JaxBatchNorm(), BatchNorm(6), x, train=False)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_batchnorm_on_4d_maps_matches_jax():
    """The eval BN broadcasts over [B, C, T, F] maps (features on dim 1);
    the JAX module takes them channels-last."""
    x = np.random.default_rng(8).normal(size=(2, 9, 7, 6)).astype(np.float32) * 3  # [B, T, F, C]
    jm = JaxBatchNorm()
    v = _variables(jm, x, train=False)
    port = BatchNorm(6).eval()
    load_ecapa_variables(port, v)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    maps = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        for xt in (maps.contiguous(), maps.contiguous(memory_format=torch.channels_last)):
            got = port(xt)
            assert got.stride() == xt.stride()  # the memory format is kept
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=1e-5)
        got16 = port(maps.bfloat16())
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().permute(0, 2, 3, 1).numpy(), ref, atol=0.05, rtol=0.02)


def test_res2net_block_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 50, 64)).astype(np.float32)
    got, ref = _layer_case(JaxRes2Net(64, dilation=3), Res2NetBlock(64, dilation=3), x, train=False)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_se_connect_masked_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 50, 64)).astype(np.float32)
    mask = np.arange(50)[None, :] < np.array([50, 13])[:, None]
    got, ref = _layer_case(JaxSE(), SEConnect(64), x, mask=mask)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_init_weights_is_seeded():
    a = init_ecapa_weights_(EcapaTdnn(input_dim=D, device="cpu", **SMALL), 3)
    b = init_ecapa_weights_(EcapaTdnn(input_dim=D, device="cpu", **SMALL), 3)
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(ta, tb, rtol=0, atol=0)
    w = a.layer1.affine.conv.weight.detach()
    assert abs(float(w.std()) - (D * 5) ** -0.5) < 0.01


def test_res2net_rejects_channels_not_divisible_by_scale():
    with pytest.raises(ValueError):
        Res2NetBlock(60)
