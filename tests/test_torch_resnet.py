"""Port ResNet trunk, its blocks and the ResNet x-vector (eval) against the
JAX modules on the same weights, carried by asv_subtools_tpu_torch.weights.

Small size: layers (1, 1, 1, 1), base_planes 8, T = 203 (the trunk gives
26 frames, so the mask is subsampled with stride 7, not a power of two),
40 bins. Tolerances: atol 1e-4 in f32 (sums in another order through
seven convolutions); per-utterance cosine >= 0.999 in bf16 (both sides
round every layer to bf16, in other orders).

The JAX maps are [B, T, F, C]; the port's are [B, C, T, F], compared after
a permutation. The flatten order (f major, then c) is held by the trunk
test and, through fc2's weight taken as it is, by the embedding tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.models.resnet_xvector import ResNetXvector as JaxResNetXvector
from asv_subtools_tpu.nn.resnet import BasicBlock as JaxBasicBlock
from asv_subtools_tpu.nn.resnet import Bottleneck as JaxBottleneck
from asv_subtools_tpu.nn.resnet import ResNet as JaxResNet
from asv_subtools_tpu.nn.tdnn import SEBlock2D as JaxSEBlock2D
from asv_subtools_tpu_torch.models import ResNetXvector
from asv_subtools_tpu_torch.nn import BasicBlock, Bottleneck, ResNet, SEBlock2D, resnet18, resnet34, resnet50, resnet101
from asv_subtools_tpu_torch.weights import (
    init_weights_,
    load_variables,
    state_dict_to_variables,
    variables_to_state_dict,
)

torch.set_num_threads(2)

B, T, F = 3, 203, 40
LENGTHS = (203, 120, 31)
SMALL = dict(layers=(1, 1, 1, 1), base_planes=8, embd_dim=16)


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
    x = np.random.default_rng(seed).normal(size=(B, T, F)).astype(np.float32)
    return x, np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]


def _maps(seed, c, t=37, f=20):
    """A [B, T, F, C] map for the JAX side and its [B, C, T, F] twin."""
    x = np.random.default_rng(seed).normal(size=(2, t, f, c)).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _block_case(jax_mod, port_mod, seed, c, **call_kw):
    x, xt = _maps(seed, c)
    v = _variables(jax_mod, x, seed, **call_kw)
    load_variables(port_mod, v)
    ref = np.asarray(jax_mod.apply(v, jnp.asarray(x), **call_kw))
    with torch.inference_mode():
        got = port_mod.eval()(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("use_se", [False, True])
@pytest.mark.parametrize("stride,planes", [((1, 1), 16), ((2, 2), 16), ((1, 1), 24), ((2, 2), 32)])
@pytest.mark.parametrize("full_pre_activation", [True, False])
def test_basic_block_matches_jax(full_pre_activation, stride, planes, use_se):
    _block_case(
        JaxBasicBlock(planes, stride=stride, use_se=use_se, se_ratio=4, full_pre_activation=full_pre_activation),
        BasicBlock(16, planes, stride, use_se=use_se, se_ratio=4, full_pre_activation=full_pre_activation),
        seed=1, c=16, train=False)


@pytest.mark.parametrize("use_se", [False, True])
@pytest.mark.parametrize("stride,c_in", [((1, 1), 32), ((2, 2), 32), ((1, 1), 16)])
def test_bottleneck_matches_jax(stride, c_in, use_se):
    _block_case(JaxBottleneck(8, stride=stride, use_se=use_se, se_ratio=4),
                Bottleneck(c_in, 8, stride, use_se=use_se, se_ratio=4), seed=2, c=c_in, train=False)


def test_blocks_without_shape_change_have_no_downsample():
    assert not BasicBlock(16, 16).has_downsample and not Bottleneck(32, 8).has_downsample
    assert BasicBlock(16, 16, (2, 2)).has_downsample and Bottleneck(16, 8).has_downsample


@pytest.mark.parametrize("c,ratio", [(32, 16), (8, 16), (24, 4)])
def test_se_block_2d_matches_jax(c, ratio):
    _block_case(JaxSEBlock2D(ratio=ratio), SEBlock2D(c, ratio), seed=3, c=c)


TRUNKS = {
    "basic": dict(),
    "basic_post_act": dict(full_pre_activation=False),
    "basic_se": dict(use_se=True, se_ratio=4),
    "bottleneck": dict(block="bottleneck"),
    "maxpool": dict(head_maxpool=True),
    "no_head_conv": dict(head_conv=False),
    "two_blocks": dict(layers=(2, 1, 2, 1)),
}


@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_matches_jax(name):
    kw = {"layers": (1, 1, 1, 1), "base_planes": 8, **TRUNKS[name]}
    x, _ = _inputs(4)
    jm = JaxResNet(**kw)
    v = _variables(jm, x, 4, train=False)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x)))
    port = ResNet(**kw).eval()
    load_variables(port, v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape == (B, ref.shape[1], port.output_dim(F))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("t,f", [(998, 80), (203, 40), (64, 23), (7, 5)])
def test_strided_conv_geometry(t, f):
    """flax padding [(1, 1), (1, 1)] with stride 2 is torch padding=1:
    998 -> 499 -> 250 -> 125 frames, 80 -> 40 -> 20 -> 10 bins."""
    port = ResNet(layers=(1, 1, 1, 1), base_planes=2).eval()
    with torch.inference_mode():
        got = port(torch.zeros(1, t, f))
    jm = JaxResNet(layers=(1, 1, 1, 1), base_planes=2)
    ref = jax.eval_shape(lambda x: jm.init_with_output({"params": jax.random.PRNGKey(0)}, x, train=False)[0],
                         jax.ShapeDtypeStruct((1, t, f), jnp.float32))
    assert tuple(got.shape) == ref.shape
    if (t, f) == (998, 80):
        assert tuple(got.shape) == (1, 125, 10 * 16)
        assert ResNet().output_dim(80) == 2560


def test_channels_last_flatten_is_a_view():
    port = ResNet(layers=(1, 1, 1, 1), base_planes=8).eval()
    seen = {}
    port.layer4_0.register_forward_hook(lambda mod, args, out: seen.update(out=out))
    with torch.inference_mode():
        flat = port(torch.zeros(2, 40, 16))
    assert seen["out"].is_contiguous(memory_format=torch.channels_last)
    assert flat.data_ptr() == seen["out"].data_ptr() and flat.stride(2) == 1


def test_resnet_depths():
    for make, blocks in ((resnet18, 8), (resnet34, 16), (resnet50, 16), (resnet101, 33)):
        assert len(make(base_planes=2).blocks) == blocks
    assert resnet50(base_planes=2).out_planes == 2 * 8 * 4


@pytest.fixture(scope="module")
def small_model():
    x, mask = _inputs()
    jm = JaxResNetXvector(**SMALL)
    v = _variables(jm, x, 0, mask=jnp.asarray(mask), train=False)
    port = ResNetXvector(F, device="cpu", **SMALL)
    load_variables(port, v)
    return v, port


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("position", ["near", "near_affine"])
def test_embedding_matches_jax_f32(small_model, position, masked):
    v, port = small_model
    x, mask = _inputs(1)
    m = mask if masked else None
    ref = np.asarray(JaxResNetXvector(**SMALL).apply(
        v, jnp.asarray(x), mask=None if m is None else jnp.asarray(m), train=False, position=position))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), None if m is None else torch.from_numpy(m), position=position).numpy()
    assert got.shape == (B, 16)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("position", ["near", "near_affine", "far"])
def test_embedding_with_fc1_matches_jax_f32(position):
    x, mask = _inputs(2)
    kw = dict(fc1=True, **SMALL)
    jm = JaxResNetXvector(**kw)
    v = _variables(jm, x, 2, mask=jnp.asarray(mask), train=False)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=False, position=position))
    port = ResNetXvector(F, device="cpu", **kw)
    load_variables(port, v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(mask), position=position).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_far_needs_fc1_and_positions_are_checked(small_model):
    _, port = small_model
    x, _ = _inputs(3)
    with pytest.raises(ValueError):
        port(torch.from_numpy(x), position="far")
    with pytest.raises(ValueError):
        port(torch.from_numpy(x), position="nearest")


def test_mask_is_subsampled_with_stride_t_over_t_out(small_model):
    """T = 203 gives 26 frames and stride 203 // 26 = 7: the pooling sees
    mask[:, 0:182:7], which differs from a stride-8 subsampling here."""
    _, port = small_model
    x, mask = _inputs(4)
    seen = {}
    hook = port.head.stats.register_forward_hook(lambda mod, args, out: seen.update(h=args[0], mask=args[1]))
    with torch.inference_mode():
        port(torch.from_numpy(x), torch.from_numpy(mask))
    hook.remove()
    assert seen["h"].shape[1] == 26
    np.testing.assert_array_equal(seen["mask"].numpy(), mask[:, :182:7])
    assert not np.array_equal(mask[:, :182:7], mask[:, ::8][:, :26])


@pytest.mark.parametrize("masked", [False, True])
def test_embedding_matches_jax_bf16(small_model, masked):
    v, port = small_model
    x, mask = _inputs(5)
    m = mask if masked else None
    vb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    ref = np.asarray(JaxResNetXvector(**SMALL).apply(
        vb, jnp.asarray(x, jnp.bfloat16), mask=None if m is None else jnp.asarray(m), train=False), np.float32)
    pb = ResNetXvector(F, device="cpu", **SMALL)
    pb.load_state_dict(port.state_dict())
    pb = pb.to(torch.bfloat16)
    with torch.inference_mode():
        got = pb(torch.from_numpy(x).bfloat16(), None if m is None else torch.from_numpy(m)).float().numpy()
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert np.all(cos >= 0.999), cos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_pooling_inside_model_matches_jax(small_model, dtype):
    """The model with its pooling switched to the fused path (the plain
    version on CPU) gives the JAX embedding."""
    v, port = small_model
    x, mask = _inputs(6)
    ref = np.asarray(JaxResNetXvector(**SMALL).apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=False))
    fused = ResNetXvector(F, device="cpu", pooling_params={"fused_inference": True}, **SMALL)
    assert fused.head.stats.fused_inference and not port.head.stats.fused_inference
    fused.load_state_dict(port.state_dict())
    fused = fused.to(dtype)
    with torch.inference_mode():
        got = fused(torch.from_numpy(x).to(dtype), torch.from_numpy(mask)).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    else:
        cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
        assert np.all(cos >= 0.999), cos


def test_weights_round_trip_bit_for_bit(small_model):
    v, port = small_model
    jax_leaves = jax.tree_util.tree_leaves_with_path(v)
    sd = variables_to_state_dict(v)
    assert len(sd) == len(jax_leaves) == len(port.state_dict())
    assert set(sd) == set(port.state_dict())
    back = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_variables(port.state_dict())))
    assert set(back) == {p for p, _ in jax_leaves}
    for path, leaf in jax_leaves:
        assert back[path].dtype == leaf.dtype
        np.testing.assert_array_equal(back[path], leaf)


def test_weight_mapping_layouts(small_model):
    v, _ = small_model
    sd = variables_to_state_dict(v)
    p = v["params"]["resnet"]
    k = p["layer2_0"]["conv1"]["kernel"]  # [kh, kw, in, out], kh over T
    assert k.shape == (3, 3, 8, 16)
    w = sd["resnet.layer2_0.conv1.weight"].numpy()
    assert w.shape == (16, 8, 3, 3)
    np.testing.assert_array_equal(w[5, 2, 0, 1], k[0, 1, 2, 5])
    np.testing.assert_array_equal(sd["resnet.layer2_0.downsample_conv.weight"].numpy()[:, :, 0, 0],
                                  p["layer2_0"]["downsample_conv"]["kernel"][0, 0].T)
    # fc2 takes the JAX Dense weight as it is: the trunk flattens in the JAX order
    np.testing.assert_array_equal(sd["head.fc2_affine.weight"].numpy(), v["params"]["head"]["fc2_affine"]["kernel"].T)
    np.testing.assert_array_equal(sd["resnet.stem_bn.var"].numpy(), v["batch_stats"]["resnet"]["stem_bn"]["var"])


def test_load_raises_on_unconsumed_or_missing(small_model):
    v, _ = small_model
    port = ResNetXvector(F, device="cpu", **SMALL)
    extra = jax.tree_util.tree_map(lambda a: a, v)
    extra["params"]["resnet"]["layer1_0"]["stray"] = {"kernel": np.zeros((3, 3, 8, 8), np.float32)}
    with pytest.raises(ValueError):
        load_variables(port, extra)
    missing = jax.tree_util.tree_map(lambda a: a, v)
    del missing["batch_stats"]["resnet"]["layer3_0"]["downsample_bn"]
    with pytest.raises(ValueError):
        load_variables(port, missing)
    odd = jax.tree_util.tree_map(lambda a: a, v)
    odd["params"]["resnet"]["stem"]["kernel"] = np.zeros((3, 3, 3, 1, 8), np.float32)
    with pytest.raises(ValueError):
        variables_to_state_dict(odd)
    wrong = jax.tree_util.tree_map(lambda a: a, v)
    wrong["params"]["resnet"]["stem"]["kernel"] = np.zeros((3, 3, 1, 9), np.float32)
    with pytest.raises(ValueError):
        load_variables(port, wrong)


def test_init_weights_is_seeded_and_scaled():
    a = init_weights_(ResNetXvector(F, device="cpu", **SMALL), 3)
    b = init_weights_(ResNetXvector(F, device="cpu", **SMALL), 3)
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(ta, tb, rtol=0, atol=0)
    w = a.resnet.layer4_0.conv2.weight.detach()
    assert abs(float(w.std()) - (64 * 9) ** -0.5) < 0.005


def test_defaults_are_the_resnet34_base32_recipe():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError):
        ResNetXvector()
    model = ResNetXvector(device="cpu")
    assert len(model.resnet.blocks) == 16 and model.resnet.stem.out_channels == 32
    assert model.head.fc2_affine.in_features == 2 * 2560 and model.head.fc2_affine.out_features == 512
    assert not model.head.has_fc1 and not model.head.stats.fused_inference
