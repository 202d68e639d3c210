"""The port's Conformer modules and the Conformer x-vector against the JAX
package on the same weights, carried by asv_subtools_tpu_torch.weights.

Small size: d = 32 or 64, 2 heads, 2 blocks, linear_units 64-128, 24
bins, T = 83 frames with ragged lengths (83, 50, 31). Tolerances: 1e-5
for a module in f32 (one summation order against another), 1e-4 for the
whole model (ECAPA's bar); bf16 by per-utterance cosine >= 0.999 against
the JAX f32 model (both sides round in other places; the port's LayerNorm
statistics and the attention's softmax run in f32, as flax's do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu import extract as jex
from asv_subtools_tpu.features import FbankOptions as JaxFbankOptions
from asv_subtools_tpu.models.conformer import ConformerXvector as JaxConformerXvector
from asv_subtools_tpu.models.ecapa import EcapaAttentiveStatsPool as JaxAttPool
from asv_subtools_tpu.nn.conformer import attention as jatt
from asv_subtools_tpu.nn.conformer import convolution as jconv
from asv_subtools_tpu.nn.conformer import embedding as jemb
from asv_subtools_tpu.nn.conformer import encoder as jenc
from asv_subtools_tpu.nn.conformer import mask as jmask
from asv_subtools_tpu.nn.conformer import subsampling as jsub
from asv_subtools_tpu.nn.norm import LayerNorm as JaxLayerNorm
from asv_subtools_tpu_torch import extract as tex
from asv_subtools_tpu_torch.features import FbankOptions
from asv_subtools_tpu_torch.models import ConformerXvector, EcapaAttentiveStatsPool
from asv_subtools_tpu_torch.models import ecapa as port_ecapa
from asv_subtools_tpu_torch.nn import LayerNorm
from asv_subtools_tpu_torch.nn import conformer as pc
from asv_subtools_tpu_torch.weights import (
    init_weights_,
    load_variables,
    state_dict_to_variables,
    variables_to_state_dict,
)

torch.set_num_threads(2)

B, T, F = 3, 83, 24
LENGTHS = (83, 50, 31)
SMALL = dict(num_blocks=2, attention_dim=64, attention_heads=2, linear_units=128, embd_dim=16, out_dim=96)


def _randomize(v, rng):
    for key, val in v.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif key in ("bias", "mean"):
            v[key] = (rng.normal(size=val.shape) * 0.1).astype(val.dtype)
        elif key == "scale":
            v[key] = rng.uniform(0.8, 1.2, size=val.shape).astype(val.dtype)
        elif key == "var":
            v[key] = rng.uniform(0.5, 2.0, size=val.shape).astype(val.dtype)


def _variables(module, *args, seed=0, **kw):
    v = module.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed)}, *args, **kw)
    v = jax.tree_util.tree_map(np.array, v)
    _randomize(v, np.random.default_rng(seed))
    return v


def _mask(lengths=LENGTHS, t=T):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _att_mask(mask):
    return None if mask is None else mask[:, None, None, :] & mask[:, None, :, None]


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_tables_and_masks():
    for t, d in ((1, 4), (48, 64), (248, 256)):
        np.testing.assert_array_equal(pc.sinusoid_table(t, d), jemb.sinusoid_table(t, d))
        np.testing.assert_allclose(pc.position_table(t, d, torch.device("cpu")).numpy(),
                                   jemb.sinusoid_table(t, d), rtol=0, atol=1e-7)
    lengths = np.array([5, 0, 9])
    np.testing.assert_array_equal(pc.make_pad_mask(torch.as_tensor(lengths), 9).numpy(),
                                  np.asarray(jmask.make_pad_mask(jnp.asarray(lengths), 9)))
    m = _mask()
    np.testing.assert_array_equal(pc.add_optional_chunk_mask(torch.as_tensor(m), T).numpy(),
                                  np.asarray(jmask.add_optional_chunk_mask(jnp.asarray(m), T)))
    assert pc.add_optional_chunk_mask(None, T) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(dtype):
    """flax parameter names, eps 1e-5, statistics in f32 for bf16 input."""
    x = _x(1, (2, 7, 48)) * 3.0 + 1.0
    v = _variables(JaxLayerNorm(epsilon=1e-5), jnp.asarray(x))
    ref = np.asarray(JaxLayerNorm(epsilon=1e-5).apply(v, jnp.asarray(x, dtype)), np.float32)
    ln = LayerNorm(48)
    load_variables(ln, v)
    got = ln(torch.from_numpy(x).to(getattr(torch, dtype))).float().detach().numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("layer,t,t_out", [("conv2d", 998, 248), ("conv2d", 198, 48), ("conv2d2", 998, 496),
                                           ("conv2d2", 83, 39)])
def test_subsampling_time_arithmetic(layer, t, t_out):
    port = pc.SUBSAMPLINGS[layer](80, 4)
    with torch.inference_mode():
        h, m = port(torch.zeros(1, t, 80), torch.ones(1, t, dtype=torch.bool))
    jm = jsub.SUBSAMPLINGS[layer](odim=4)
    ref = jax.eval_shape(lambda x: jm.init_with_output({"params": jax.random.PRNGKey(0)}, x)[0][0],
                         jax.ShapeDtypeStruct((1, t, 80), jnp.float32))
    assert tuple(h.shape) == ref.shape == (1, t_out, 4) and tuple(m.shape) == (1, t_out)


@pytest.mark.parametrize("layer", ["conv2d", "conv2d2"])
def test_subsampling_matches_jax(layer):
    """Output and sub_mask on ragged lengths; proj takes the JAX Dense
    weight as it is, so the flatten order must be JAX's (F' major, C
    fastest)."""
    x, mask = _x(2, (B, T, F)), _mask()
    jm = jsub.SUBSAMPLINGS[layer](odim=16)
    v = _variables(jm, jnp.asarray(x))
    ref, ref_mask = jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask))
    port = pc.SUBSAMPLINGS[layer](F, 16)
    load_variables(port, v)
    with torch.inference_mode():
        got, got_mask = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    factor, offset = (4, 6) if layer == "conv2d" else (2, 2)
    np.testing.assert_array_equal(got_mask.numpy(), mask[:, offset::factor][:, :got.shape[1]])
    np.testing.assert_array_equal(got_mask.numpy().sum(1) > 0, [True, True, True])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["rel_pos", "plain"])
def test_attention_matches_jax(kind, masked):
    """Padded query rows (every key masked) come out as JAX's: NEG_INF
    gives them a uniform softmax, then zeros, so only the output bias."""
    x = _x(3, (B, 21, 32))
    mask = _att_mask(_mask((21, 12, 5), 21)) if masked else None
    jcls, pcls = ((jatt.RelPositionMultiHeadedAttention, pc.RelPositionMultiHeadedAttention) if kind == "rel_pos"
                  else (jatt.MultiHeadedAttention, pc.MultiHeadedAttention))
    jm = jcls(num_heads=2)
    v = _variables(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask)))
    port = pcls(32, 2)
    load_variables(port, v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    if masked:
        np.testing.assert_allclose(got[2, 5:], np.broadcast_to(v["params"]["out"]["bias"], (16, 32)), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("norm_type,train", [("layer_norm", False), ("batch_norm", False), ("batch_norm", True)])
def test_convolution_module_matches_jax(norm_type, train, masked):
    x = _x(4, (B, T, 32))
    mask = _mask() if masked else None
    jm = jconv.ConvolutionModule(kernel_size=15, norm_type=norm_type)
    v = _variables(jm, jnp.asarray(x))
    out = jm.apply(v, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask), train=train,
                   mutable=["batch_stats"] if train else False)
    ref, stats = (out if train else (out, None))
    port = pc.ConvolutionModule(32, 15, norm_type)
    load_variables(port, v)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    if masked:
        assert not np.any(got[~mask])
    if train:
        np.testing.assert_allclose(port.norm.var.numpy(), np.asarray(stats["batch_stats"]["norm"]["var"]),
                                   rtol=1e-5)


BLOCK = dict(attention_heads=2, linear_units=64, dropout_rate=0.0)


@pytest.fixture(scope="module")
def block_case():
    x, mask = _x(5, (B, 19, 32)), _mask((19, 11, 4), 19)
    jm = jenc.ConformerBlock(**BLOCK)
    v = _variables(jm, jnp.asarray(x))
    port = pc.ConformerBlock(32, **BLOCK)
    load_variables(port, v)
    return x, mask, jm, v, port


@pytest.mark.parametrize("warmup", [None, 0.0, 0.35, 1.0])
def test_block_matches_jax(block_case, warmup):
    """Eval mode (None), and train mode at dropout 0 with the blend
    alpha = min(0.1 + warmup, 1)."""
    x, mask, jm, v, port = block_case
    train = warmup is not None
    kw = dict(train=True, warmup=warmup) if train else dict(train=False)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), att_mask=jnp.asarray(_att_mask(mask)), pad_mask=jnp.asarray(mask),
                              **kw))
    port.train(train)
    with torch.no_grad():
        m = torch.from_numpy(mask)
        got = port(torch.from_numpy(x), pc.add_optional_chunk_mask(m, 19), m,
                   **({"warmup": warmup} if train else {})).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_warmup_blend_at_one_is_an_exact_identity(block_case):
    """At warmup >= 0.9, as a Python number or a 0-dim tensor, the train
    blend gives the block's own output bit for bit (dropout 0, no
    BatchNorm: eval mode computes the same block without the blend)."""
    x, mask, _, _, port = block_case
    m = torch.from_numpy(mask)
    args = (torch.from_numpy(x), pc.add_optional_chunk_mask(m, 19), m)
    with torch.no_grad():
        plain = port.eval()(*args)
        port.train()
        for w in (1.0, 0.9, torch.tensor(1.0), torch.tensor(3.0)):
            assert torch.equal(port(*args, warmup=w), plain), w
        assert not torch.equal(port(*args, warmup=torch.tensor(0.5)), plain)


@pytest.mark.parametrize("layer", ["conv2d", "conv2d2"])
def test_encoder_matches_jax(layer):
    x, mask = _x(6, (B, T, F)), _mask()
    kw = dict(attention_dim=32, attention_heads=2, linear_units=64, num_blocks=2, input_layer=layer)
    jm = jenc.ConformerEncoder(**kw)
    v = _variables(jm, jnp.asarray(x), mask=jnp.asarray(mask))
    ref, ref_mask = jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask))
    port = pc.ConformerEncoder(F, **kw).eval()
    load_variables(port, v)
    with torch.inference_mode():
        got, got_mask = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))


@pytest.mark.parametrize("masked", [False, True])
def test_attentive_pooling_without_time_attention_matches_jax(masked, monkeypatch):
    """att1 a plain 1x1 conv, att_norm a LayerNorm: the Conformer's pooling.
    The fused flag is not taken there (JAX models/ecapa.py:201-208)."""
    x, mask = _x(7, (B, 17, 40)), _mask((17, 9, 3), 17)
    m = mask if masked else None
    jm = JaxAttPool(bottleneck=8, time_attention=False, norm_type="layer_norm")
    v = _variables(jm, jnp.asarray(x), train=False)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False, mask=None if m is None else jnp.asarray(m)))
    port = EcapaAttentiveStatsPool(40, 8, fused_inference=True, time_attention=False, norm_type="layer_norm").eval()
    load_variables(port, v)
    calls = []
    monkeypatch.setattr(port_ecapa, "fused_attentive_stats_pool", lambda *a, **k: calls.append(1))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), None if m is None else torch.from_numpy(m)).numpy()
    assert not calls
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.fixture(scope="module", params=["conv2d", "conv2d2"])
def small_model(request):
    x, mask = _x(0, (B, T, F)), _mask()
    jm = JaxConformerXvector(input_layer=request.param, **SMALL)
    v = _variables(jm, jnp.asarray(x), mask=jnp.asarray(mask), train=False)
    port = ConformerXvector(F, input_layer=request.param, device="cpu", **SMALL)
    load_variables(port, v)
    return jm, v, port, request.param


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("position", ["near", "near_affine"])
def test_embedding_matches_jax_f32(small_model, position, masked):
    jm, v, port, _ = small_model
    x, mask = _x(1, (B, T, F)), _mask()
    m = mask if masked else None
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=None if m is None else jnp.asarray(m), train=False,
                              position=position))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), None if m is None else torch.from_numpy(m), position=position).numpy()
    assert got.shape == (B, 16)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_embedding_bf16_against_jax_f32(small_model, masked):
    jm, v, port, layer = small_model
    x, mask = _x(2, (B, T, F)), _mask()
    m = mask if masked else None
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=None if m is None else jnp.asarray(m), train=False))
    pb = ConformerXvector(F, input_layer=layer, device="cpu", **SMALL)
    pb.load_state_dict(port.state_dict())
    pb = pb.to(torch.bfloat16)
    with torch.inference_mode():
        got = pb(torch.from_numpy(x).bfloat16(), None if m is None else torch.from_numpy(m)).float().numpy()
    cos = _cos(got, ref)
    assert np.all(cos >= 0.999), cos


@pytest.mark.parametrize("layer", ["conv2d", "conv2d2"])
def test_full_size_model_matches_jax(layer):
    """The bench's Conformer at full width and depth (6L-256D-4H, linear
    units 2048, 1536 to the pooling, embedding 256, 80 bins) on a short
    ragged batch: f32 to 1e-4, bf16 by cosine >= 0.999 against JAX's f32."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 70, 80)).astype(np.float32)
    mask = _mask((70, 45), 70)
    jm = JaxConformerXvector(input_layer=layer)
    v = jax.jit(lambda x, m: jm.init({"params": jax.random.PRNGKey(9)}, x, mask=m, train=False))(
        jnp.asarray(x), jnp.asarray(mask))
    v = jax.tree_util.tree_map(np.array, v)
    _randomize(v, rng)
    ref = np.asarray(jax.jit(lambda v, x, m: jm.apply(v, x, mask=m, train=False))(v, jnp.asarray(x), jnp.asarray(mask)))
    port = ConformerXvector(80, input_layer=layer, device="cpu")
    load_variables(port, v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        got16 = port.to(torch.bfloat16)(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask)).float().numpy()
    assert got.shape == (2, 256)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert np.all(_cos(got16, ref) >= 0.999), _cos(got16, ref)


def test_position_other_than_near_raises(small_model):
    port = small_model[2]
    with pytest.raises(ValueError):
        port(torch.zeros(1, 40, F), position="far")


def test_weights_round_trip_bit_for_bit(small_model):
    _, v, port, _ = small_model
    leaves = jax.tree_util.tree_leaves_with_path(v)
    sd = variables_to_state_dict(v)
    assert set(sd) == set(port.state_dict()) and len(sd) == len(leaves)
    back = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_variables(port.state_dict())))
    assert set(back) == {p for p, _ in leaves}
    for path, leaf in leaves:
        assert back[path].dtype == leaf.dtype
        np.testing.assert_array_equal(back[path], leaf)
    p = v["params"]["transformer"]["block_0"]
    np.testing.assert_array_equal(sd["transformer.block_0.self_attn.pos_bias_u"].numpy(),
                                  p["self_attn"]["pos_bias_u"])
    dw = p["conv_module"]["depthwise"]["kernel"]  # flax [k, 1, d]
    assert dw.shape == (15, 1, 64)
    np.testing.assert_array_equal(sd["transformer.block_0.conv_module.depthwise.weight"].numpy(), dw.transpose(2, 1, 0))
    assert v["params"]["stats"]["att1"]["kernel"].shape == (1, 96, 128)
    np.testing.assert_array_equal(sd["stats.att1.weight"].numpy(), v["params"]["stats"]["att1"]["kernel"].T)


def test_att1_rule_tells_the_split_conv_from_a_plain_conv():
    """Under the module name att1, a [1, 3C, K] kernel beside att2 [1, K, C]
    is the split conv (kept as ``kernel``), a [1, C, K] one a plain 1x1 conv
    (``weight`` [K, C, 1]); each round-trips."""
    c, k = 12, 5
    att2 = {"kernel": np.zeros((1, k, c), np.float32), "bias": np.zeros(c, np.float32)}
    for width, key in ((3 * c, "stats.att1.kernel"), (c, "stats.att1.weight")):
        kern = np.random.default_rng(width).normal(size=(1, width, k)).astype(np.float32)
        v = {"params": {"stats": {"att1": {"kernel": kern, "bias": np.zeros(k, np.float32)}, "att2": att2}}}
        sd = variables_to_state_dict(v)
        assert key in sd
        np.testing.assert_array_equal(sd[key].numpy(), kern if width == 3 * c else kern.transpose(2, 1, 0))
        back = state_dict_to_variables(sd)["params"]["stats"]["att1"]["kernel"]
        np.testing.assert_array_equal(back, kern)
    odd = {"params": {"stats": {"att1": {"kernel": np.zeros((1, 2 * c, k), np.float32)}, "att2": att2}}}
    with pytest.raises(ValueError):
        variables_to_state_dict(odd)


def test_load_raises_on_unconsumed_or_missing(small_model):
    _, v, port, _ = small_model
    extra = jax.tree_util.tree_map(lambda a: a, v)
    extra["params"]["transformer"]["block_1"]["self_attn"]["stray"] = {"kernel": np.zeros((4, 4), np.float32)}
    with pytest.raises(ValueError):
        load_variables(port, extra)
    missing = jax.tree_util.tree_map(lambda a: a, v)
    del missing["params"]["transformer"]["block_0"]["self_attn"]["pos_bias_v"]
    with pytest.raises(ValueError):
        load_variables(port, missing)


def test_init_weights_is_seeded():
    a = init_weights_(ConformerXvector(F, device="cpu", **SMALL), 3)
    b = init_weights_(ConformerXvector(F, device="cpu", **SMALL), 3)
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb), ka
    u = a.transformer.block_0.self_attn.pos_bias_u.detach()
    assert float(u.abs().max()) <= (6 / (2 + 32)) ** 0.5


def test_defaults_are_the_bench_configuration():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError):
        ConformerXvector()
    model = ConformerXvector(device="cpu")
    assert len(model.transformer.blocks) == 6 and model.embd_dim == 256
    assert model.transformer.embed.proj.in_features == 19 * 256
    assert model.fc2_affine.in_features == 2 * 1536


UNPORTED = {
    "transformer_type": dict(transformer_type="transformer"),
    "re_conformer": dict(transformer_type="re_conformer"),
    "input_layer": dict(input_layer="conv2d6"),
    "conv2d8": dict(input_layer="conv2d8"),
    "linear": dict(input_layer="linear"),
    "rot_pos": dict(pos_enc_type="rot_pos"),
    "abs_pos": dict(pos_enc_type="abs_pos"),
    "no_macaron": dict(encoder_params={"macaron": False}),
    "no_cnn": dict(encoder_params={"use_cnn": False}),
    "gau": dict(att_type="gau"),
    "mfa": dict(combiner_type="mfa"),
    "random_layer": dict(combiner_type="random_layer"),
    "t5": dict(encoder_params={"add_t5rel_bias": True}),
    "softmax_plus": dict(encoder_params={"attention_norm_args": {"norm_method": "softmax_plus"}}),
    "relu_plus": dict(encoder_params={"attention_norm_args": {"norm_method": "relu_plus"}}),
    "scale_adapt": dict(encoder_params={"attention_norm_args": {"scale_adapt": True}}),
    "g_sa": dict(encoder_params={"attention_norm_args": {"g_sa": True}}),
    "diag_mask": dict(encoder_params={"attention_norm_args": {"diag_mask": True}}),
    "conv_out": dict(encoder_params={"attention_conv_out": True}),
    "layer_dropout": dict(encoder_params={"layer_dropout": 0.1}),
    "re_layer": dict(encoder_params={"re_layer": True}),
    "re_scale": dict(encoder_params={"re_scale": True}),
    "basic_norm": dict(encoder_params={"norm_type": "basic_norm"}),
    "cnn_basic_norm": dict(encoder_params={"cnn_norm_type": "basic_norm"}),
    "use_balancer": dict(encoder_params={"use_balancer": True}),
    "convfnn_blocks": dict(encoder_params={"convfnn_blocks": 1}),
    "concat_after": dict(encoder_params={"concat_after": True}),
    "post_norm": dict(encoder_params={"normalize_before": False}),
    "conv_ffn": dict(encoder_params={"positionwise_layer_type": "conv1d"}),
    "static_chunk": dict(encoder_params={"static_chunk_size": 4}),
    "dynamic_chunk": dict(encoder_params={"use_dynamic_chunk": True}),
    "rope_abs_plus": dict(encoder_params={"rope_abs_plus": True}),
}


# every option listed here raised NotImplementedError before it was ported;
# each now builds and one f32 train step runs finite (their parity with JAX:
# tests/test_torch_reconformer.py, test_torch_conformer_options.py and
# test_torch_transformer.py). The random combiners and the aux taps need
# more than one tap: they run with aux_layer_start 3, period 1 (taps 0 and 1).
AUX = {"aux_layer_start": 3, "aux_layer_period": 1}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_options_raise(name):
    from asv_subtools_tpu_torch.models import SpeakerNet
    from asv_subtools_tpu_torch.train import TrainStepConfig, get_optimizer, init_train_state, make_train_step

    kw = {**SMALL, **UNPORTED[name]}
    if name in ("mfa", "random_layer"):
        kw["encoder_params"] = AUX
    net = SpeakerNet(ConformerXvector(F, device="cpu", **kw), "margin_softmax", {"method": "am", "m": 0.2},
                     num_targets=5)
    tx = get_optimizer("adamW", 1e-3)
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.float32))
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn(2, 40, F, generator=g), "y": torch.tensor([0, 4])}
    new, m = step(init_train_state(net, tx, "cpu"), batch, g)
    assert int(new.step) == 1 and np.isfinite(float(m["loss"])) and float(m["skipped"]) == 0.0


def test_unported_module_options_raise():
    """The five module options that raised build and run: the shifted
    relative attention, the causal conv module (no frame sees a later
    one), the TransformerEncoder and the two chunk masks."""
    x = torch.randn(2, 9, 32)
    with torch.no_grad():
        out = pc.RelPositionMultiHeadedAttention(32, 2, rel_shift=True)(x)
        assert out.shape == (2, 9, 32) and bool(torch.isfinite(out).all())
        causal = pc.ConvolutionModule(32, causal=True).eval()
        later = x.clone()
        later[:, 5:] += 1.0
        torch.testing.assert_close(causal(later)[:, :5], causal(x)[:, :5], rtol=0, atol=0)
        enc = pc.TransformerEncoder(F, attention_dim=32, attention_heads=2, linear_units=64, num_blocks=1).eval()
        h, _ = enc(torch.randn(2, 40, F))
        assert h.shape == (2, 9, 32) and not hasattr(enc.block_0, "conv_module")
    static = pc.add_optional_chunk_mask(None, 10, static_chunk_size=2)
    assert static.shape == (1, 1, 10, 10) and bool(static[0, 0, 3, 3]) and not bool(static[0, 0, 3, 4])
    g = torch.Generator().manual_seed(0)
    dynamic = pc.add_optional_chunk_mask(None, 10, use_dynamic_chunk=True, draw=True, generator=g)
    assert dynamic.shape == (1, 1, 10, 10) and bool(torch.diagonal(dynamic[0, 0]).all())
    assert pc.add_optional_chunk_mask(None, 10, use_dynamic_chunk=True) is None  # eval: full context
    # the ReConformer's conv module options are ported: the balancers leave the forward as it is
    plain, balanced = pc.ConvolutionModule(32), pc.ConvolutionModule(32, use_balancer=True)
    balanced.load_state_dict(plain.state_dict())
    torch.testing.assert_close(balanced(x), plain(x), rtol=0, atol=0)


CONFIG = dict(buckets=(16000, 32000), default_batch=2, max_chunk=24000)
WAVE_LENGTHS = (9000, 20000, 31000, 50000, 14000)


def test_extractor_matches_jax_and_the_direct_embedding():
    """The same waves and weights through the JAX and the port's
    make_wave_embed_fn + Extractor (utterance 3 is chunked); and each
    unchunked utterance against the port's embedding of it alone, unpadded."""
    rng = np.random.default_rng(3)
    waves = [(f"u{i}", (rng.standard_normal(n) * 1000).astype(np.float32)) for i, n in enumerate(WAVE_LENGTHS)]
    kw = dict(SMALL, num_blocks=1)
    jm = JaxConformerXvector(**kw)
    v = _variables(jm, jnp.ones((1, 50, 23)), mask=jnp.ones((1, 50), bool), train=False)
    jax_embed = jex.make_wave_embed_fn(lambda x, m: jm.apply(v, x, mask=m, train=False), JaxFbankOptions())
    ref = jex.Extractor(jax_embed, jex.ExtractConfig(**CONFIG)).extract_all(iter(waves))
    port = ConformerXvector(23, device="cpu", **kw)
    load_variables(port, v)
    embed = tex.make_wave_embed_fn(lambda x, m: port(x, m), FbankOptions())
    got = tex.Extractor(embed, tex.ExtractConfig(**CONFIG), device="cpu").extract_all(iter(waves))
    assert set(got) == set(ref)
    for key in ref:
        assert _cos(got[key], np.asarray(ref[key])) >= 0.9999, key
    with torch.inference_mode():
        for key, wave in waves:
            if len(wave) > CONFIG["max_chunk"]:
                continue
            w = torch.from_numpy(wave)[None]
            direct = embed(w, torch.ones_like(w, dtype=torch.bool))[0].numpy()
            assert _cos(got[key], direct) >= 0.9999, key
