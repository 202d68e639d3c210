"""The Conformer family's modules and options against the JAX package:
the position encodings (abs, relative, RoPE), the attention normalisation's
options (relu_plus, softmax_plus, scale_adapt, g_sa, diag_mask), the conv
output projection, the shifted relative attention, RoPE self-attention,
the T5 relative bias, GAU, the chunk masks (static, and the dynamic draw
split into its draw and its apply), the linear, conv2d6 and conv2d8
subsamplings and the causal convolution module.

Each module takes the port's seeded weights carried to JAX's layout by
weights.py, with the biases, norm scales and the normalisation's learned
constants randomised away from their initial values (no JAX init to
compile). Narrow: d = 32, 2 heads, T = 19-40, B = 3, ragged lengths.
Tolerances, each against JAX on the same inputs: float64 to 1e-10 of the
output's scale, float32 to 1e-5 (a module: one summation order against
another), bfloat16 to 3e-2 of the output's scale against JAX's float32
(the port rounds q, k, v and the attention weights to bf16; its scores
and normalisation run in f32). The dynamic chunk draw's full-context
share within 0.025 of its exact value over 8,000 draws (4 standard
deviations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.nn.conformer import attention as jatt
from asv_subtools_tpu.nn.conformer import convolution as jconv
from asv_subtools_tpu.nn.conformer import embedding as jemb
from asv_subtools_tpu.nn.conformer import mask as jmask
from asv_subtools_tpu.nn.conformer import subsampling as jsub
from asv_subtools_tpu_torch.nn import conformer as pc
from asv_subtools_tpu_torch.weights import init_weights_, load_variables, state_dict_to_variables
from test_torch_conformer import _randomize

torch.set_num_threads(2)

B, D, H = 3, 32, 2
TOL = {"float64": 1e-10, "float32": 1e-5}
BF16_TOL = 3e-2
CONSTANTS = ("att_scale", "g_sa_omiga", "g_sa_bias", "train_len", "beta")


def _randomize_constants(tree, rng):
    """Move the normalisation's learned constants and GAU's beta off their
    initial values, so that a leaf read from the wrong place shows."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomize_constants(val, rng)
        elif key in CONSTANTS:
            tree[key] = np.asarray(val + rng.normal(size=np.shape(val)) * 0.05, np.float64)


def port_variables(module, seed=0):
    """The module's seeded weights in JAX's layout (float64), randomised,
    loaded back into the module."""
    v = state_dict_to_variables(init_weights_(module, seed).double().state_dict())
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float64), v)
    rng = np.random.default_rng(seed)
    _randomize(v, rng)
    _randomize_constants(v, rng)
    load_variables(module, v)
    return v


def _cast(v, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v)


def _err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _mask(t, lengths):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _att_mask(mask):
    return None if mask is None else mask[:, None, None, :] & mask[:, None, :, None]


# -- position encodings -------------------------------------------------------------


@pytest.mark.parametrize("t,d", [(1, 4), (40, 32), (248, 256)])
def test_position_tables_match_jax(t, d):
    """The tables on the device are JAX's numpy tables (f64 math, f32)."""
    cpu = torch.device("cpu")
    np.testing.assert_allclose(pc.rel_position_encoding(t, d, cpu).numpy(),
                               np.asarray(jemb.rel_position_encoding(t, d)), rtol=0, atol=1e-7)
    for got, ref in zip(pc.rope_freqs(t, d, cpu), jemb.rope_freqs(t, d)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-7)
    x = np.random.default_rng(t).normal(size=(2, t, d))
    with jax.enable_x64():
        ref = np.asarray(jemb.abs_position_encoding(jnp.asarray(x)))
    assert _err(pc.abs_position_encoding(torch.as_tensor(x)).numpy(), ref) <= 1e-12


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rope_rotates_interleaved_pairs_as_jax(dtype):
    """JAX rotates (x[..., 0::2], x[..., 1::2]) and interleaves them back;
    a rotation of the two halves gives another result."""
    x = np.random.default_rng(1).normal(size=(B, H, 21, 16))
    with jax.enable_x64(dtype == "float64"):
        cos, sin = jemb.rope_freqs(21, 16)
        ref = np.asarray(jemb.apply_rope(jnp.asarray(x, dtype), cos, sin), np.float64)
    cos, sin = pc.rope_freqs(21, 16, torch.device("cpu"))
    got = pc.apply_rope(torch.as_tensor(x, dtype=getattr(torch, dtype)), cos, sin)
    assert got.dtype == getattr(torch, dtype)
    assert _err(got.double().numpy(), ref) <= TOL[dtype]
    x1, x2 = x[..., :8], x[..., 8:]
    c, s = cos.double().numpy(), sin.double().numpy()
    halves = np.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], -1)
    assert _err(halves, ref) > 0.1


# -- attention ----------------------------------------------------------------------

# name: (JAX class, port class, options, T5 bias)
ATTENTION = {
    "softmax": ("multi", {}, False),
    "relu_plus": ("multi", {"norm_method": "relu_plus"}, False),
    "softmax_plus": ("multi", {"norm_method": "softmax_plus", "train_len": 100.0}, False),
    "scale_adapt": ("multi", {"scale_adapt": True}, False),
    "g_sa": ("multi", {"g_sa": True}, False),
    "diag_mask": ("multi", {"diag_mask": True}, False),
    "conv_out": ("multi", {"conv_out": True}, False),
    "t5_multi": ("multi", {}, True),
    "t5_scale_adapt": ("multi", {"scale_adapt": True}, True),
    "rel_shift": ("rel", {"rel_shift": True}, False),
    "rel_options_t5": ("rel", {"norm_method": "softmax_plus", "scale_adapt": True, "g_sa": True, "conv_out": True},
                       True),
    "rope": ("rope", {}, False),
    "rope_no_value": ("rope", {"rotary_value": False}, False),
    "rope_relu_plus_diag": ("rope", {"norm_method": "relu_plus", "diag_mask": True}, False),
    "gau": ("gau", {}, False),
    "gau_t5": ("gau", {}, True),
    "gau_no_rope_conv_out": ("gau", {"use_rope": False, "conv_out": True}, False),
    "gau_norm_options": ("gau", {"norm_method": "softmax_plus", "scale_adapt": True, "g_sa": True,
                                 "diag_mask": True}, True),
    "gau_relu_plus": ("gau", {"norm_method": "relu_plus"}, False),
}
CLASSES = {"multi": (jatt.MultiHeadedAttention, pc.MultiHeadedAttention),
           "rel": (jatt.RelPositionMultiHeadedAttention, pc.RelPositionMultiHeadedAttention),
           "rope": (jatt.RoPESelfAttention, pc.RoPESelfAttention), "gau": (jatt.GAU, pc.GAU)}


def _attention_pair(name, t, seed=0):
    kind, opts, t5 = ATTENTION[name]
    jcls, pcls = CLASSES[kind]
    if kind == "gau":
        jm, port = jcls(expansion_units=48, key_dim=16, **opts), pcls(D, 48, 16, **opts)
    else:
        jm, port = jcls(num_heads=H, **opts), pcls(D, H, **opts)
    holder = torch.nn.Module()
    holder.att = port
    if t5:
        holder.t5_bias = pc.T5RelPositionBias()
    v = port_variables(holder, seed)
    return jm, v, holder, t5


def _jax_attention(jm, v, x, mask, t5, dtype):
    with jax.enable_x64(dtype == "float64"):
        vv = _cast(v, dtype)
        kw = {}
        if t5:
            kw["extra_score"] = jatt.T5RelPositionBias().apply({"params": vv["params"]["t5_bias"]}, x.shape[1])
        out = jm.apply({"params": vv["params"]["att"]}, jnp.asarray(x, dtype),
                       mask=None if mask is None else jnp.asarray(mask), **kw)
        return np.asarray(out, np.float64)


def _port_attention(holder, x, mask, t5, dtype):
    holder = holder.to(getattr(torch, dtype))
    with torch.no_grad():
        xt = torch.as_tensor(x, dtype=getattr(torch, dtype))
        extra = holder.t5_bias(x.shape[1], xt.device) if t5 else None
        return holder.att(xt, None if mask is None else torch.as_tensor(mask), None, extra)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(ATTENTION))
def test_attention_matches_jax(name, masked):
    """float64 and float32, each against JAX in the same type; padded
    query rows come out as JAX's (zeros before the projection)."""
    t = 19
    x = np.random.default_rng(2).normal(size=(B, t, D))
    mask = _att_mask(_mask(t, (19, 11, 4))) if masked else None
    jm, v, holder, t5 = _attention_pair(name, t)
    for dtype in ("float64", "float32"):
        ref = _jax_attention(jm, v, x, mask, t5, dtype)
        got = _port_attention(holder, x, mask, t5, dtype)
        assert got.dtype == getattr(torch, dtype) and bool(torch.isfinite(got).all())
        assert _err(got.double().numpy(), ref) <= TOL[dtype], dtype


@pytest.mark.parametrize("name", ["rope", "t5_multi", "gau_t5", "gau_norm_options", "rel_options_t5"])
def test_attention_bf16_against_jax_f32(name):
    t = 40
    x = np.random.default_rng(3).normal(size=(B, t, D))
    mask = _att_mask(_mask(t, (40, 23, 9)))
    jm, v, holder, t5 = _attention_pair(name, t)
    ref = _jax_attention(jm, v, x, mask, t5, "float32")
    got = _port_attention(holder, x, mask, t5, "bfloat16")
    assert got.dtype == torch.bfloat16
    assert _err(got.float().numpy(), ref) <= BF16_TOL


def test_t5_buckets_and_bias_match_jax():
    """Buckets computed in float32 and truncated, as JAX does: equal at
    every distance up to 511, boundaries (16, 32, 64, 128) included; the
    bias is rel_bias at the buckets."""
    t = 512
    pos = np.arange(t)
    ref = np.asarray(jatt.T5RelPositionBias._bucket(jnp.asarray(pos[None, :] - pos[:, None]), 32, 128))
    port = pc.T5RelPositionBias()
    got = port.buckets(t, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.min() == 0 and got.max() == 31
    v = port_variables(port, 4)
    bias = jatt.T5RelPositionBias().apply(v, 37)
    np.testing.assert_array_equal(port(37, torch.device("cpu")).detach().numpy(), np.asarray(bias))


def test_attention_leaves_start_at_jax_constants():
    """att_scale log(d_k^-0.5), g_sa 0.001 and -0.001, train_len log(512):
    the port's constructor values are flax's initial values, leaf by leaf,
    with the shapes of JAX's tree (GAU's, whose key_dim is its d_k; the
    attentions share JAX's attention_normalize)."""
    opts = {"scale_adapt": True, "g_sa": True, "norm_method": "softmax_plus"}
    jm, port = jatt.GAU(expansion_units=48, key_dim=16, **opts), pc.GAU(D, 48, 16, **opts)
    ref = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 7, D)))["params"]
    got = state_dict_to_variables(init_weights_(port, 0).state_dict())["params"]
    assert jax.tree_util.tree_map(np.shape, got) == jax.tree_util.tree_map(np.shape, ref)
    for leaf in ("att_scale", "g_sa_omiga", "g_sa_bias", "train_len", "beta"):
        np.testing.assert_allclose(got[leaf], np.asarray(ref[leaf]), rtol=1e-7, err_msg=leaf)
    np.testing.assert_allclose(got["att_scale"], np.log(16 ** -0.5), rtol=1e-7)


# -- masks --------------------------------------------------------------------------


@pytest.mark.parametrize("size,chunk,left", [(10, 2, -1), (10, 3, 1), (40, 25, 0), (40, 1, 2), (7, 10, -1)])
def test_chunk_masks_match_jax(size, chunk, left):
    ref = np.asarray(jmask.subsequent_chunk_mask(size, chunk, left))
    np.testing.assert_array_equal(pc.chunk_mask(size, chunk, left).numpy(), ref)
    traced = pc.chunk_mask(size, torch.tensor(chunk), torch.tensor(left))
    np.testing.assert_array_equal(traced.numpy(), ref)
    np.testing.assert_array_equal(
        traced.numpy(), np.asarray(jmask._traced_chunk_mask(size, jnp.asarray(chunk), jnp.asarray(left))))


@pytest.mark.parametrize("branch", ["static", "static_left", "decoding", "full_context", "eval", "pad_only"])
def test_add_optional_chunk_mask_matches_jax(branch):
    t = 12
    pad = _mask(t, (12, 7, 3))
    kw = {"static": dict(static_chunk_size=4), "static_left": dict(static_chunk_size=3, num_left_chunks=1),
          "decoding": dict(use_dynamic_chunk=True, decoding_chunk_size=5, num_left_chunks=0),
          "full_context": dict(use_dynamic_chunk=True, decoding_chunk_size=-1),
          "eval": dict(use_dynamic_chunk=True), "pad_only": {}}[branch]
    for p in (pad, None):
        ref = jmask.add_optional_chunk_mask(None if p is None else jnp.asarray(p), t, **kw)
        got = pc.add_optional_chunk_mask(None if p is None else torch.as_tensor(p), t, **kw)
        if ref is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jax_chunk_draw(key, size, use_left):
    """JAX's draw (mask.py:60-68) with the same key, taken apart."""
    r1, r2 = jax.random.split(key)
    c = int(jax.random.randint(r1, (), 1, max(size, 2)))
    full = c > size // 2
    chunk = size if full else c % 25 + 1
    left = -1
    if use_left and not full:
        left = int(jax.random.randint(r2, (), 0, max((size - 1) // chunk, 1)))
    return chunk, left


@pytest.mark.parametrize("use_left", [False, True])
def test_dynamic_chunk_apply_matches_jax_on_its_draw(use_left):
    """JAX's dynamic_chunk_mask with a key, and the port's apply on the
    chunk and left count that key draws: the same mask."""
    size = 40
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jmask.dynamic_chunk_mask(key, size, use_left))
        chunk, left = _jax_chunk_draw(key, size, use_left)
        got = pc.chunk_mask(size, torch.tensor(chunk), torch.tensor(left))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_dynamic_chunk_draw_distribution():
    """c ~ U[1, T): full context (chunk T, left -1) when c > T // 2, share
    (T - 1 - T // 2) / (T - 1); else chunk in 1..25 and left in [0,
    max((T - 1) // chunk, 1))."""
    size, n = 40, 8000
    g = torch.Generator().manual_seed(0)
    draws = [pc.dynamic_chunk_draw(g, size, True) for _ in range(n)]
    chunk = np.array([int(c) for c, _ in draws])
    left = np.array([int(l) for _, l in draws])
    full = chunk == size
    expected = (size - 1 - size // 2) / (size - 1)
    assert abs(full.mean() - expected) <= 0.025, full.mean()
    assert np.all(left[full] == -1)
    part = ~full
    assert chunk[part].min() >= 1 and chunk[part].max() <= 25
    max_left = np.maximum((size - 1) // chunk[part], 1)
    assert np.all((left[part] >= 0) & (left[part] < max_left))
    assert len(set(left[part])) > 5
    no_left = pc.dynamic_chunk_draw(torch.Generator().manual_seed(1), size, False)[1]
    assert int(no_left) == -1


# -- subsampling and the causal conv module -----------------------------------------


@pytest.mark.parametrize("layer,t,t_out", [("conv2d6", 998, 165), ("conv2d8", 998, 123), ("linear", 998, 998),
                                           ("conv2d6", 40, 5), ("conv2d8", 40, 4)])
def test_subsampling_time_arithmetic(layer, t, t_out):
    port = pc.SUBSAMPLINGS[layer](80, 4)
    with torch.inference_mode():
        h, m = port(torch.zeros(1, t, 80), torch.ones(1, t, dtype=torch.bool))
    jm = jsub.SUBSAMPLINGS[layer](odim=4)
    ref = jax.eval_shape(lambda x: jm.init_with_output({"params": jax.random.PRNGKey(0)}, x)[0][0],
                         jax.ShapeDtypeStruct((1, t, 80), jnp.float32))
    assert tuple(h.shape) == ref.shape == (1, t_out, 4) and tuple(m.shape) == (1, t_out)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layer", ["linear", "conv2d6", "conv2d8"])
def test_subsampling_matches_jax(layer, masked):
    t, f = 61, 24
    x = np.random.default_rng(5).normal(size=(B, t, f))
    mask = _mask(t, (61, 40, 17)) if masked else None
    port = pc.SUBSAMPLINGS[layer](f, 16)
    v = port_variables(port, 5)
    jm = jsub.SUBSAMPLINGS[layer](odim=16)
    for dtype in ("float64", "float32"):
        with jax.enable_x64(dtype == "float64"):
            ref, ref_mask = jm.apply(_cast(v, dtype), jnp.asarray(x, dtype),
                                     mask=None if mask is None else jnp.asarray(mask))
            ref = np.asarray(ref, np.float64)
        with torch.no_grad():
            got, got_mask = port.to(getattr(torch, dtype))(torch.as_tensor(x, dtype=getattr(torch, dtype)),
                                                           None if mask is None else torch.as_tensor(mask))
        assert _err(got.double().numpy(), ref) <= TOL[dtype], dtype
        if masked:
            np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
        else:
            assert got_mask is None


def test_linear_subsampling_dropout_draws_from_the_generator():
    port = pc.LinearNoSubsampling(24, 16, dropout_rate=0.5).train()
    x = torch.randn(2, 30, 24)
    a = port(x, None, torch.Generator().manual_seed(3))[0]
    b = port(x, None, torch.Generator().manual_seed(3))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert 0.4 <= float(kept.float().mean()) <= 0.6
    with torch.no_grad():
        plain = port.eval()(x)[0]
    torch.testing.assert_close(a[kept], plain[kept] * 2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("norm_type,train", [("layer_norm", False), ("batch_norm", True)])
def test_causal_convolution_module_matches_jax(norm_type, train, masked):
    t = 29
    x = np.random.default_rng(6).normal(size=(B, t, D))
    mask = _mask(t, (29, 16, 5)) if masked else None
    port = pc.ConvolutionModule(D, 7, norm_type, causal=True)
    v = port_variables(port, 6)
    jm = jconv.ConvolutionModule(kernel_size=7, norm_type=norm_type, causal=True)
    port.train(train)
    for dtype in ("float64", "float32"):
        with jax.enable_x64(dtype == "float64"):
            out = jm.apply(_cast(v, dtype), jnp.asarray(x, dtype), mask=None if mask is None else jnp.asarray(mask),
                           train=train, mutable=["batch_stats"] if train else False)
            ref = np.asarray(out[0] if train else out, np.float64)
        with torch.no_grad():
            p = port.to(getattr(torch, dtype))
            got = p(torch.as_tensor(x, dtype=getattr(torch, dtype)), None if mask is None else torch.as_tensor(mask))
        assert _err(got.double().numpy(), ref) <= TOL[dtype], dtype
        load_variables(port, v)  # the train-mode forward moved the running statistics
