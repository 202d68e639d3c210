"""The Conformer family's blocks, encoders and models against the JAX
package: every encoder option in eval mode (positions, GAU, the T5 bias,
the attention-normalize options, the block shapes, the conv
feed-forwards, the combiners, chunk masks, the input layers), the
train-mode random ops split into their draw and their apply (layer drop,
RandomCombine, the dynamic chunk), the Transformer x-vector and the GAU
Conformer of chip_smoke's phase 24 narrow, their f64 train steps leaf by
leaf, and their weights.

Narrow: d = 32, 2 heads, 1-2 blocks, linear_units 64, 24 bins, T = 61
frames with ragged lengths (61, 40, 17). Each net takes the port's seeded
weights carried to JAX's layout by weights.py, randomised
(test_torch_conformer_options.port_variables): no JAX init to compile.
Tolerances: float64 to 1e-10 of the output's scale, float32 to 1e-5 for
an encoder of 1-2 blocks and 1e-4 for the model (ECAPA's bar), bfloat16
by per-utterance cosine >= 0.999 against JAX's float32 model. Random
ops: the apply against JAX fed JAX's own draw (its ``_random_pure_weights``
and ``_random_mixed_weights`` with a key, a fixed layer-drop keep, a
fixed chunk), injected on both sides; the draws' shares over many draws
within 4 standard deviations. The steps: the helpers and tolerances of
tests/test_torch_train_step.py (every leaf within 1e-6 of its scale), two
SGD steps on features at dropout 0 with the draws injected.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models.conformer import ConformerXvector as JaxConformerXvector
from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.nn.conformer import attention as jatt
from asv_subtools_tpu.nn.conformer import encoder as jenc
from asv_subtools_tpu.nn.conformer import mask as jmask
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.models import ConformerXvector, SpeakerNet
from asv_subtools_tpu_torch.nn import conformer as pc
from asv_subtools_tpu_torch.nn.conformer import encoder as penc
from asv_subtools_tpu_torch.nn.conformer import mask as pmask
from asv_subtools_tpu_torch.train import TrainStepConfig, sgd
from asv_subtools_tpu_torch.weights import init_weights_, state_dict_to_variables, variables_to_state_dict
from test_torch_conformer import _randomize
from test_torch_conformer_options import _cast, _err, _mask, _randomize_constants, port_variables
from test_torch_train_step import (AAM, C, D, LR, assert_metrics_close, assert_states_close, make_batch, run_jax,
                                   run_port)

torch.set_num_threads(2)

B, T, F = 3, 61, 24
LENGTHS = (61, 40, 17)
ENC = dict(attention_dim=32, attention_heads=2, linear_units=64, dropout_rate=0.0)
GAU = dict(gau_units=48, gau_key=16)
TOL = {"float64": 1e-10, "float32": 1e-5}

# one block unless an option needs two (the aux taps, convfnn's head block)
OPTIONS = {
    "transformer": dict(cls="transformer"),
    "transformer_abs_pos": dict(cls="transformer", pos_enc_type="abs_pos"),
    "abs_pos": dict(pos_enc_type="abs_pos"),
    "no_pos": dict(pos_enc_type="no_pos"),
    "rot_pos": dict(pos_enc_type="rot_pos"),
    "rope_abs_plus_no_value": dict(pos_enc_type="rot_pos", rope_abs_plus=True, rotary_value=False),
    "gau": dict(att_type="gau", pos_enc_type="rot_pos", **GAU),
    "gau_t5_no_rope": dict(att_type="gau", add_t5rel_bias=True, **GAU),
    "t5": dict(add_t5rel_bias=True),
    "norm_options": dict(attention_norm_args={"norm_method": "softmax_plus", "scale_adapt": True, "g_sa": True,
                                              "diag_mask": True, "train_len": 64.0}),
    "relu_plus_conv_out": dict(attention_norm_args={"norm_method": "relu_plus"}, attention_conv_out=True),
    "no_macaron": dict(macaron=False),
    "no_cnn": dict(use_cnn=False),
    "post_norm": dict(normalize_before=False),
    "post_norm_concat_after": dict(normalize_before=False, concat_after=True),
    "concat_after_re_scale": dict(concat_after=True, re_scale=True),
    "convfnn": dict(convfnn_blocks=1, num_blocks=2, positionwise_conv_kernel_size=3),
    "convfnn_gau": dict(convfnn_blocks=1, num_blocks=2, att_type="gau", positionwise_layer_type="gau",
                        pos_enc_type="rot_pos", **GAU),
    "conv1d_ffn": dict(positionwise_layer_type="conv1d", positionwise_conv_kernel_size=3),
    "conv1d_linear_ffn": dict(positionwise_layer_type="conv1d-linear", positionwise_conv_kernel_size=3),
    "gau_ffn": dict(positionwise_layer_type="gau", pos_enc_type="rot_pos",
                    attention_norm_args={"norm_method": "relu_plus"}),
    "mfa_taps": dict(combiner_type="mfa", num_blocks=2, aux_layer_start=3, aux_layer_period=1),
    "mfa_default": dict(combiner_type="mfa", num_blocks=2),
    "random_frame_eval": dict(combiner_type="random_frame", num_blocks=2, aux_layer_start=3, aux_layer_period=1),
    "static_chunk_causal": dict(static_chunk_size=4, left_chunk_size=1),
    "dynamic_chunk_eval": dict(use_dynamic_chunk=True, use_dynamic_left_chunk=True, layer_dropout=0.5),
    "linear": dict(input_layer="linear"),
    "conv2d6": dict(input_layer="conv2d6"),
    "conv2d8": dict(input_layer="conv2d8"),
}


def encoder_pair(name, seed=0, **extra):
    kw = {"num_blocks": 1, **ENC, **OPTIONS[name], **extra}
    cls = kw.pop("cls", "conformer")
    jcls, pcls = ((jenc.TransformerEncoder, pc.TransformerEncoder) if cls == "transformer"
                  else (jenc.ConformerEncoder, pc.ConformerEncoder))
    port = pcls(F, **kw)
    return jcls(**kw), port_variables(port, seed), port


def run_jax_encoder(jm, v, x, mask, dtype, train=False, warmup=1.0):
    with jax.enable_x64(dtype == "float64"):
        fn = jax.jit(lambda v, x, m: jm.apply(v, x, mask=m, train=train, warmup=warmup,
                                              rngs={"dropout": jax.random.PRNGKey(0)}))
        out, m = fn(_cast(v, dtype), jnp.asarray(x, dtype), jnp.asarray(mask))
        return np.asarray(out, np.float64), np.asarray(m)


def run_port_encoder(port, x, mask, dtype, warmup=1.0):
    port = port.to(getattr(torch, dtype))
    with torch.no_grad():
        return port(torch.as_tensor(x, dtype=getattr(torch, dtype)), torch.as_tensor(mask), warmup,
                    torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_encoder_option_matches_jax(name):
    """Eval mode on a ragged batch, float64 and float32."""
    x, mask = np.random.default_rng(1).normal(size=(B, T, F)), _mask(T, LENGTHS)
    jm, v, port = encoder_pair(name)
    port.eval()
    for dtype in ("float64", "float32"):
        ref, ref_mask = run_jax_encoder(jm, v, x, mask, dtype)
        got, got_mask = run_port_encoder(port, x, mask, dtype)
        assert got.shape[-1] == port.output_dim and bool(torch.isfinite(got).all())
        assert _err(got.double().numpy(), ref) <= TOL[dtype], dtype
        np.testing.assert_array_equal(got_mask.numpy(), ref_mask)


def test_encoder_structure_follows_jax():
    """The JAX init's tree (shapes only, no compile) is the port's, for the
    forms whose leaves differ: no norm_final without the conv module or
    with post-norm, after_norm as wide as the mfa taps, no scale_mha under
    concat_after, a GAU's key_dim of 64 in the feed-forward whatever gau_key."""
    x = jnp.zeros((1, T, F))
    for name in ("transformer", "post_norm_concat_after", "mfa_taps", "concat_after_re_scale", "gau_ffn",
                 "convfnn_gau"):
        jm, _, port = encoder_pair(name)
        shapes = jax.eval_shape(lambda x: jm.init({"params": jax.random.PRNGKey(0),
                                                   "dropout": jax.random.PRNGKey(0)}, x), x)
        want = jax.tree_util.tree_map(lambda a: a.shape, shapes["params"])
        got = jax.tree_util.tree_map(np.shape, state_dict_to_variables(port.state_dict())["params"])
        assert got == want, name
    assert port.block_0.ff.s == 64 and port.block_0.self_attn.s == 16
    assert pc.ConformerEncoder(F, num_blocks=6, combiner_type="mfa").output_dim == 256  # default taps: the last


# -- the random ops: draw and apply ---------------------------------------------------


class _Uniform:
    """jax in JAX's encoder module with its 0-dim uniform draws (layer
    drop's) replaced by a fixed cycle of values; all else is jax."""

    def __init__(self, values):
        self._values = itertools.cycle(values)
        self.random = self

    def uniform(self, key, shape=(), *args, **kwargs):
        if tuple(shape) == ():
            return jnp.asarray(next(self._values), jnp.float32)
        return jax.random.uniform(key, shape, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(jax.random if name in ("split", "randint", "normal", "PRNGKey") else jax, name)


def inject_layer_drop(monkeypatch, keeps):
    """Block i keeps (True) or drops (False) by ``keeps[i % len]`` on both sides."""
    monkeypatch.setattr(jenc, "jax", _Uniform([0.0 if k else 1.0 for k in keeps]))
    cycle = itertools.cycle(keeps)
    monkeypatch.setattr(penc, "layer_drop_keep", lambda g, rate, device: torch.tensor(next(cycle), device=device))


def inject_chunk(monkeypatch, chunk, left):
    monkeypatch.setattr(jmask, "dynamic_chunk_mask",
                        lambda rng, size, use_left=False: jmask._traced_chunk_mask(size, jnp.asarray(chunk),
                                                                                    jnp.asarray(left)))
    monkeypatch.setattr(pmask, "dynamic_chunk_draw",
                        lambda g, size, use_left=False, device=None: (torch.tensor(chunk), torch.tensor(left)))


def inject_combiner(monkeypatch, weights):
    """Both of JAX's draws return ``weights`` (so its pure/mixed choice
    picks them either way); the port's draw returns them too."""
    monkeypatch.setattr(jenc, "_random_pure_weights", lambda *a: jnp.asarray(weights))
    monkeypatch.setattr(jenc, "_random_mixed_weights", lambda *a: jnp.asarray(weights))
    monkeypatch.setattr(penc, "random_combine_weights", lambda *a, **k: torch.tensor(weights))


@pytest.mark.parametrize("keeps,warmup", [((True, False), 0.35), ((False, True), 1.0)])
def test_layer_drop_apply_matches_jax(monkeypatch, keeps, warmup):
    """Train mode, float64, two blocks at layer_dropout 0.5 with the keep
    injected: a kept block blends at min(0.1 + warmup, 1), a dropped one at 0.1."""
    x, mask = np.random.default_rng(2).normal(size=(B, T, F)), _mask(T, LENGTHS)
    jm, v, port = encoder_pair("no_cnn", layer_dropout=0.5, num_blocks=2)
    inject_layer_drop(monkeypatch, keeps)
    ref, _ = run_jax_encoder(jm, v, x, mask, "float64", train=True, warmup=warmup)
    got, _ = run_port_encoder(port.train(), x, mask, "float64", warmup)
    assert _err(got.numpy(), ref) <= 1e-10
    ref_eval, _ = run_jax_encoder(jm, v, x, mask, "float64")
    assert _err(ref, ref_eval) > 1e-3  # the blend moved the output


@pytest.mark.parametrize("combiner,draw", [("random_layer", "pure"), ("random_layer", "mixed"),
                                           ("random_frame", "pure"), ("random_frame", "mixed")])
def test_random_combine_apply_matches_jax_on_its_draw(monkeypatch, combiner, draw):
    """JAX's own weights (its draw functions with a key) mix the two taps
    on both sides, per utterance or per frame."""
    x, mask = np.random.default_rng(3).normal(size=(B, T, F)), _mask(T, LENGTHS)
    jm, v, port = encoder_pair("random_frame_eval", combiner_type=combiner)
    t_out = port.embed(torch.zeros(1, T, F, dtype=torch.float64))[0].shape[1]
    num = B * t_out if combiner == "random_frame" else B
    key = jax.random.PRNGKey(5)
    w = (jenc._random_pure_weights(key, num, 2, 0.5) if draw == "pure"
         else jenc._random_mixed_weights(key, num, 2, 0.5, 2.0))
    w = np.array(w)
    inject_combiner(monkeypatch, w)
    ref, _ = run_jax_encoder(jm, v, x, mask, "float64", train=True)
    got, _ = run_port_encoder(port.train(), x, mask, "float64")
    assert _err(got.numpy(), ref) <= 1e-10
    # the apply alone: the taps mixed by the same weights
    taps = [torch.randn(B, t_out, 5, dtype=torch.float64) for _ in range(2)]
    mixed = pc.combine(torch.tensor(w), taps, combiner)
    wt = torch.as_tensor(w, dtype=torch.float64).view(B, -1, 1, 2) if combiner == "random_frame" else \
        torch.as_tensor(w, dtype=torch.float64).view(B, 1, 1, 2)
    torch.testing.assert_close(mixed, taps[0] * wt[..., 0] + taps[1] * wt[..., 1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("chunk,left", [(3, 1), (5, -1), (14, -1)])
def test_dynamic_chunk_apply_matches_jax(monkeypatch, chunk, left):
    x, mask = np.random.default_rng(4).normal(size=(B, T, F)), _mask(T, LENGTHS)
    jm, v, port = encoder_pair("dynamic_chunk_eval", layer_dropout=0.0)
    inject_chunk(monkeypatch, chunk, left)
    ref, _ = run_jax_encoder(jm, v, x, mask, "float64", train=True)
    got, _ = run_port_encoder(port.train(), x, mask, "float64")
    assert _err(got.numpy(), ref) <= 1e-10


def test_random_draws_distribution():
    """The combiner's draw: a pure (one-hot) row with probability 0.333,
    the last layer in half of the pure rows, every row summing to 1; the
    layer-drop keep with probability 1 - rate. 20,000 rows and 8,000
    keeps; bounds at 4 standard deviations."""
    g = torch.Generator().manual_seed(0)
    w = pc.random_combine_weights(g, 20000, 3, torch.device("cpu"))
    torch.testing.assert_close(w.sum(1), torch.ones(20000), rtol=0, atol=1e-6)
    pure = (w == 1.0).any(1) & ((w == 0.0).sum(1) == 2)
    assert abs(float(pure.float().mean()) - 0.333) <= 0.015
    final = w[pure].argmax(1) == 2
    assert abs(float(final.float().mean()) - 0.5) <= 0.025
    nonfinal = w[pure].argmax(1)[~final]
    assert set(nonfinal.tolist()) == {0, 1}
    mixed_last = w[~pure][:, 2].mean()  # log-weight bias log(0.5 / 0.5 * 2) toward the last layer
    assert float(mixed_last) > float(w[~pure][:, 0].mean())
    keeps = torch.stack([pc.layer_drop_keep(g, 0.1, torch.device("cpu")) for _ in range(8000)])
    assert abs(float(keeps.float().mean()) - 0.9) <= 0.015
    combiner = pc.RandomCombine("random_layer").eval()
    taps = [torch.randn(2, 5, 4) for _ in range(3)]
    assert combiner(taps) is taps[-1]


# -- the models: (a) the Transformer x-vector, (b) the GAU Conformer of phase 24 -----

MODEL = dict(num_blocks=2, attention_dim=32, attention_heads=2, linear_units=64, embd_dim=16, out_dim=48)
TRANSFORMER = dict(transformer_type="transformer")
GAU_CONFORMER = dict(att_type="gau", pos_enc_type="rot_pos", input_layer="conv2d2", encoder_params={
    **GAU, "attention_norm_args": {"norm_method": "softmax_plus"}, "add_t5rel_bias": True, "layer_dropout": 0.1,
    "use_dynamic_chunk": True, "use_dynamic_left_chunk": True})
COMBINER = dict(combiner_type="random_frame", encoder_params={"aux_layer_start": 3, "aux_layer_period": 1})
MODELS = {"transformer": TRANSFORMER, "gau_conformer": GAU_CONFORMER, "random_frame": COMBINER}


def model_pair(name, seed=0, dtype="float64", **extra):
    cfg = {**MODEL, **MODELS[name], **extra}
    port = ConformerXvector(F, device="cpu", **cfg)
    v = port_variables(port, seed)
    return JaxConformerXvector(**cfg), v, port.to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["transformer", "gau_conformer"])
def test_model_matches_jax_in_eval(name, dtype):
    x, mask = np.random.default_rng(6).normal(size=(B, T, F)), _mask(T, LENGTHS)
    jm, v, port = model_pair(name, dtype=dtype)
    with jax.enable_x64(dtype == "float64"):
        ref = np.asarray(jax.jit(lambda v, x, m: jm.apply(v, x, m, train=False))(
            _cast(v, dtype), jnp.asarray(x, dtype), jnp.asarray(mask)), np.float64)
    with torch.no_grad():
        got = port(torch.as_tensor(x, dtype=getattr(torch, dtype)), torch.as_tensor(mask)).double().numpy()
    assert got.shape == (B, 16)
    assert np.abs(got - ref).max() <= (1e-10 if dtype == "float64" else 1e-4) * np.abs(ref).max()


@pytest.mark.parametrize("name", ["transformer", "gau_conformer"])
def test_model_bf16_against_jax_f32(name):
    x, mask = np.random.default_rng(7).normal(size=(B, T, F)), _mask(T, LENGTHS)
    jm, v, port = model_pair(name, dtype="float32")
    ref = np.asarray(jax.jit(lambda v, x, m: jm.apply(v, x, m, train=False))(
        _cast(v, jnp.float32), jnp.asarray(x, jnp.float32), jnp.asarray(mask)))
    with torch.no_grad():
        got = port.to(torch.bfloat16)(torch.as_tensor(x).bfloat16(), torch.as_tensor(mask)).float().numpy()
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert np.all(cos >= 0.999), cos


@pytest.mark.parametrize("name", ["transformer", "gau_conformer"])
def test_weights_round_trip_and_seeded_draws(name):
    """The state_dict to JAX's tree and back, bit for bit; the JAX init's
    tree (shapes) is the port's; each new leaf's seeded draw at flax's
    init: rel_bias and gamma normal(0.02), beta 0, train_len log(512)."""
    jm, _, port = model_pair(name, dtype="float32")
    seeded = init_weights_(ConformerXvector(F, device="cpu", **{**MODEL, **MODELS[name], "num_blocks": 6}), 3)
    sd = seeded.state_dict()
    v = state_dict_to_variables(sd)
    back = variables_to_state_dict(v)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key
    x, m = jnp.zeros((1, T, F)), jnp.ones((1, T), bool)
    shapes = jax.eval_shape(lambda x, m: jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                                                  x, m, train=False), x, m)
    want = jax.tree_util.tree_map(lambda a: a.shape, shapes["params"])
    assert jax.tree_util.tree_map(np.shape, state_dict_to_variables(port.state_dict())["params"]) == want
    if name == "gau_conformer":
        leaves = {k: torch.cat([t.flatten() for n, t in sd.items() if n.endswith("." + k)]) for k in
                  ("rel_bias", "gamma", "beta", "train_len")}
        for k in ("rel_bias", "gamma"):  # 192 and 192 draws: the std within 20% of 0.02
            assert abs(float(leaves[k].std()) - 0.02) <= 0.004 and abs(float(leaves[k].mean())) <= 0.006, k
        assert float(leaves["beta"].abs().max()) == 0.0
        np.testing.assert_allclose(leaves["train_len"].numpy(), np.log(512.0), rtol=1e-7)
        # flax's own draws of the same leaves, over six keys: the same law
        keys = jax.random.split(jax.random.PRNGKey(0), 6)
        flax = jax.jit(jax.vmap(lambda k: jatt.T5RelPositionBias().init(k, 8)["params"]["rel_bias"]))(keys)
        gau = jax.jit(jax.vmap(lambda k: jatt.GAU(expansion_units=8, key_dim=16).init(
            k, jnp.zeros((1, 4, 8)))["params"]))(keys)
        for draw in (np.ravel(flax), np.ravel(gau["gamma"])):
            assert abs(draw.std() - 0.02) <= 0.004 and abs(draw.mean()) <= 0.006
        assert float(np.abs(gau["beta"]).max()) == 0.0


# -- the f64 train steps, leaf by leaf -------------------------------------------------


def _step_nets(name):
    cfg = {**MODEL, **MODELS[name], "dropout_rate": 0.0}
    jnet = JaxSpeakerNet(JaxConformerXvector(**cfg), AAM[0], AAM[1], num_targets=C)
    pnet = SpeakerNet(ConformerXvector(D, device="cpu", **cfg), AAM[0], AAM[1], num_targets=C).to(torch.float64)
    v = state_dict_to_variables(init_weights_(pnet, 0).double().state_dict())
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float64), v)
    rng = np.random.default_rng(0)
    _randomize(v, rng)
    _randomize_constants(v, rng)
    return jnet, pnet, v


@pytest.mark.parametrize("name", ["transformer", "gau_conformer", "random_frame"])
def test_f64_train_step_matches_jax_leaf_by_leaf(monkeypatch, name):
    """Two SGD steps on masked features. The GAU Conformer's layer drop
    (block 0 kept, block 1 dropped) and its dynamic chunk (chunk 4, one
    left chunk) are injected on both sides, as are the combiner's frame
    weights (JAX's own mixed draw)."""
    jnet, pnet, v = _step_nets(name)
    batches = [make_batch(1, True), make_batch(2, True)]
    if name == "gau_conformer":
        inject_layer_drop(monkeypatch, (True, False))
        inject_chunk(monkeypatch, 4, 1)
    if name == "random_frame":
        t_out = pnet.backbone.transformer.embed(torch.zeros(1, batches[0][0].shape[1], D, dtype=torch.float64))[0]
        num = batches[0][0].shape[0] * t_out.shape[1]
        inject_combiner(monkeypatch, np.asarray(jenc._random_mixed_weights(jax.random.PRNGKey(2), num, 2, 0.5, 2.0)))
    jax_state, jax_m = run_jax(jnet, optax.sgd(LR), v, batches, JaxStepConfig(compute_dtype=jnp.float64))
    port_state, port_m = run_port(pnet, sgd(LR), v, batches, TrainStepConfig(compute_dtype=torch.float64))
    for p, j in zip(port_m, jax_m):
        assert_metrics_close(p, j)
    assert_states_close(port_state, jax_state, 1e-6)


# -- full size --------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", ["transformer", "gau_conformer"])
def test_full_size_model_matches_jax(name):
    """Phase 24's (a) and (b) at full width and depth (6L-256D-4H, linear
    units 2048, gau_units 512, key 64, 80 bins) on a short ragged batch:
    f32 to 1e-4 of the output's scale."""
    cfg = {**MODELS[name], "num_blocks": 6, "attention_dim": 256, "attention_heads": 4}
    if name == "gau_conformer":
        cfg["encoder_params"] = {**cfg["encoder_params"], "gau_units": 512, "gau_key": 64}
    port = ConformerXvector(80, device="cpu", **cfg)
    v = port_variables(port, 9)
    x = np.random.default_rng(9).normal(size=(2, 90, 80)).astype(np.float32)
    mask = _mask(90, (90, 55))
    jm = JaxConformerXvector(**cfg)
    ref = np.asarray(jax.jit(lambda v, x, m: jm.apply(v, x, m, train=False))(_cast(v, jnp.float32), jnp.asarray(x),
                                                                             jnp.asarray(mask)))
    with torch.no_grad():
        got = port.float()(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 256)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("name", ["transformer", "gau_conformer"])
def test_launcher_builds_the_family_by_name(name):
    """The Launcher's model by name passes the params through as they are:
    "conformer_xvector" with transformer_type and encoder_params builds
    the same net as ConformerXvector does."""
    from asv_subtools_tpu_torch.launcher import Launcher

    params = {"model": {"name": "conformer_xvector", "params": {**MODEL, **MODELS[name]}},
              "loss": {"name": "margin_softmax", "params": {"method": "am", "m": 0.2}}}
    launcher = Launcher(params, device="cpu")
    launcher.num_targets, launcher.feat_dim = 7, F
    net = launcher.build_model()
    enc = net.backbone.transformer
    assert type(enc).__name__ == ("TransformerEncoder" if name == "transformer" else "ConformerEncoder")
    direct = ConformerXvector(F, device="cpu", **{**MODEL, **MODELS[name]})
    assert {k: v.shape for k, v in net.backbone.state_dict().items()} == \
        {k: v.shape for k, v in direct.state_dict().items()}
    if name == "gau_conformer":
        assert isinstance(enc.block_0.self_attn, pc.GAU) and enc.block_0.layer_dropout == 0.1
        assert enc.chunk["use_dynamic_chunk"] and enc.chunk["use_dynamic_left_chunk"]


def test_rope_attention_with_the_t5_bias_raises_in_jax_and_runs_in_the_port():
    """JAX's RoPESelfAttention takes no extra_score, so a JAX block with
    "rot_pos", att_type "multi" and the T5 bias raises TypeError; the
    port's adds the bias at raw scale, as the other attentions do."""
    x = np.random.default_rng(8).normal(size=(2, 15, 32))
    with pytest.raises(TypeError):
        jenc.ConformerBlock(attention_heads=2, linear_units=64, pos_enc_type="rot_pos", add_t5rel_bias=True).init(
            jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32))
    block = pc.ConformerBlock(32, attention_heads=2, linear_units=64, pos_enc_type="rot_pos", add_t5rel_bias=True)
    init_weights_(block, 0).eval()
    with torch.no_grad():
        out = block(torch.as_tensor(x, dtype=torch.float32))
        bias = block.t5_bias(15, torch.device("cpu"))
        h = block.norm_mha(block.ff_macaron(block.norm_ff_macaron(torch.as_tensor(x, dtype=torch.float32))) * 0.5
                           + torch.as_tensor(x, dtype=torch.float32))
        with_bias = block.self_attn(h, None, None, bias)
        without = block.self_attn(h)
    assert bool(torch.isfinite(out).all()) and not torch.allclose(with_bias, without)
