"""ASV-Subtools checkpoint conversion: the port's converters against JAX's.

The image holds no ASV-Subtools model code, so the reference-format
state_dicts are built here: every key and shape that JAX's converters read
(``num_batches_tracked`` and a ``loss.weight`` head included), filled from
a numpy seed. ``reference_state_dict`` names the reference's tensors for
each tensor of the port's narrow model; the masked TDNN
kernels are full width. Each converter must give exactly
``weights.variables_to_state_dict`` of JAX's converter on the same dict:
keys, dtypes and bits. The converted dict must also load into the port's
model. Conversion is numpy: no JAX jit, except one shared forward check.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu import convert as jconvert
from asv_subtools_tpu.models import EcapaTdnn as JaxEcapa
from asv_subtools_tpu_torch import convert
from asv_subtools_tpu_torch.models import (ConformerXvector, EcapaLawlict, EcapaTdnn, FactoredXvector, FDXvector,
                                           MultiTaskXvector, RepVggXvector, ResNetXvector, SnowdarXvector)
from asv_subtools_tpu_torch.weights import variables_to_state_dict

torch.set_num_threads(2)

F_IN = 20  # feature bins of the narrow nets
NUM_TARGETS = 11

_NORM_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


class _Ref:
    """A reference-format state_dict drawn from a numpy seed."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.sd = {}

    def put(self, key, shape, kind="weight"):
        if key in self.sd:
            raise AssertionError(f"two port tensors name {key}")
        r = self.rng
        if kind == "running_var":
            v = r.uniform(0.5, 2.0, size=shape)
        elif kind in ("bias", "running_mean"):
            v = r.normal(size=shape) * 0.1
        elif kind == "norm_weight":
            v = r.uniform(0.8, 1.2, size=shape)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            v = r.normal(size=shape) / np.sqrt(max(fan_in, 1))
        self.sd[key] = np.asarray(v, np.float32)

    def norm(self, ref, leaves):
        """A BatchNorm (with ``num_batches_tracked``) or a LayerNorm."""
        for leaf, shape in leaves.items():
            name = _NORM_LEAVES[leaf]
            self.put(f"{ref}.{name}", shape, "norm_weight" if name == "weight" else name)
        if "mean" in leaves:
            self.sd[f"{ref}.num_batches_tracked"] = np.asarray(7, np.int64)

    def weight(self, ref, shape, bias=None):
        self.put(f"{ref}.weight", shape)
        if bias is not None:
            self.put(f"{ref}.bias", bias, "bias")


def _modules(port_sd):
    """{module path: {leaf: shape}} of a port state_dict, in order."""
    mods = {}
    for key, value in port_sd.items():
        mod, leaf = key.rsplit(".", 1)
        mods.setdefault(mod, {})[leaf] = tuple(value.shape)
    return mods


def reference_state_dict(model, rule, seed=0, loss_dim=None):
    """The reference state_dict of a port model: ``rule(mod, leaves, ref)``
    writes the reference's tensors of each port module."""
    ref = _Ref(seed)
    for mod, leaves in _modules(model.state_dict()).items():
        rule(mod, leaves, ref)
    if loss_dim is not None:  # the margin head, which no converter reads
        ref.put("loss.weight", (NUM_TARGETS, loss_dim, 1))
    return {k: torch.from_numpy(v) for k, v in ref.sd.items()}


def _generic(ref, rmod, leaves, kind="conv", taps_width=None):
    """One module's tensors under the reference name ``rmod``. kind: "norm",
    "conv" ([out, in, k], a masked kernel ``taps_width`` wide), "dense3" (a
    TdnnAffine / 1x1 Conv1d holding a Dense, [out, in, 1]), "dense"
    (Linear) or "conv2d" ([out, in, kT, kF] -> [out, in, kF, kT])."""
    if kind == "norm" or "mean" in leaves or "scale" in leaves:
        ref.norm(rmod, leaves)
        return
    w = leaves["weight"]
    if kind == "conv" and taps_width is not None:
        w = w[:2] + (taps_width,)
    elif kind == "dense3":
        w = w + (1,)
    elif kind == "conv2d":
        w = w[:2] + (w[3], w[2])
    ref.weight(rmod, w, leaves.get("bias"))


def _tdnn(mod, leaves, ref, rmod, taps_width=None):
    """A ReluBatchNormTdnnLayer's ``affine.conv`` and ``act_bn.bn``."""
    if mod.endswith(".affine.conv"):
        _generic(ref, f"{rmod}.affine", leaves, taps_width=taps_width)
    else:
        _generic(ref, f"{rmod}.batchnorm", leaves, "norm")


def ecapa_rule(mod, leaves, ref):
    m = re.match(r"(layer(\d))\.(conv[12]|res2net\.block_(\d)|se\.fc[12])", mod)
    if mod.startswith("layer1.") or mod.startswith("mfa."):
        _tdnn(mod, leaves, ref, mod.split(".")[0])
    elif m and m.group(3).startswith("conv"):
        _tdnn(mod, leaves, ref, f"{m.group(1)}.conv_relu_bn{m.group(3)[-1]}")
    elif m and m.group(3).startswith("res2net"):
        d = int(m.group(2))
        _tdnn(mod, leaves, ref, f"{m.group(1)}.res2net_block.blocks.{m.group(4)}", taps_width=2 * d + 1)
    elif m:
        _generic(ref, f"{m.group(1)}.se.se.{1 if mod.endswith('fc1') else 3}", leaves, "dense3")
    elif mod == "stats.att1":  # _SplitGlobalConv's kernel [1, 3C, K] is the conv [K, 3C, 1]
        k = leaves["kernel"]
        ref.weight("stats.attention.0", (k[2], k[1], 1), leaves["bias"])
    else:
        rmod = {"stats.att_bn": "stats.attention.2", "stats.att2": "stats.attention.4", "bn_stats": "bn_stats",
                "fc1_affine": "fc1.affine", "fc1_bn": "fc1.batchnorm", "fc2_affine": "fc2.affine",
                "fc2_bn": "fc2.batchnorm"}[mod]
        _generic(ref, rmod, leaves, "dense3" if "affine" in mod else "conv")


def lawlict_rule(mod, leaves, ref):
    m = re.match(r"(layer\d)\.(conv1|conv2|res2net\.block_(\d)|se\.linear[12])\.?", mod)
    if mod.startswith("layer1."):
        _generic(ref, "layer1.conv" if "conv" in mod.split(".")[-1] else "layer1.bn", leaves)
    elif m and m.group(2) in ("conv1", "conv2"):
        i = 0 if m.group(2) == "conv1" else 2
        _generic(ref, f"{m.group(1)}.{i}.{'conv' if mod.endswith('.conv') else 'bn'}", leaves)
    elif m and m.group(3) is not None:
        b = m.group(3)
        _generic(ref, f"{m.group(1)}.1.{'convs' if mod.endswith('.conv') else 'bns'}.{b}", leaves)
    elif m:
        _generic(ref, f"{m.group(1)}.3.{mod.rsplit('.', 1)[1]}", leaves, "dense")
    elif mod.startswith("mfa."):
        _generic(ref, "conv" if mod.endswith(".conv") else "bn_conv", leaves)
    else:
        rmod = {"stats.linear1": "stats.linear1", "stats.linear2": "stats.linear2", "bn_stats": "bn_stats",
                "fc1_affine": "fc1.affine", "fc1_bn": "fc1.batchnorm", "fc2_affine": "fc2.affine",
                "fc2_bn": "fc2.batchnorm"}[mod]
        _generic(ref, rmod, leaves, "dense3" if "affine" in mod else "conv")


def _head_rule(mod, leaves, ref):
    """The fc head after a 2-D trunk (``head.fc{1,2}_{affine,bn}``)."""
    m = re.fullmatch(r"head\.(fc[12])_(affine|bn)", mod)
    _generic(ref, f"{m.group(1)}.{'affine' if m.group(2) == 'affine' else 'batchnorm'}", leaves, "dense3")


def resnet_rule(mod, leaves, ref):
    if mod.startswith("head."):
        return _head_rule(mod, leaves, ref)
    m = re.fullmatch(r"resnet\.layer(\d)_(\d+)\.(\w+)(\.fc[12])?", mod)
    if mod in ("resnet.stem", "resnet.stem_bn"):
        _generic(ref, "resnet.conv1" if mod == "resnet.stem" else "resnet.bn1", leaves, "conv2d")
    elif m.group(4):  # the SE's two Linears
        _generic(ref, f"resnet.layer{m.group(1)}.{m.group(2)}.se.fc.{0 if m.group(4) == '.fc1' else 2}", leaves,
                 "dense")
    else:
        name = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(m.group(3), m.group(3))
        _generic(ref, f"resnet.layer{m.group(1)}.{m.group(2)}.{name}", leaves, "conv2d")


def repvgg_rule(mod, leaves, ref):
    if mod.startswith("head."):
        return _head_rule(mod, leaves, ref)
    m = re.fullmatch(r"repvgg\.stage(\d)(?:_(\d+))?\.(\w+)", mod)
    block = f"repvgg.stage{m.group(1)}" + (f".{m.group(2)}" if m.group(2) is not None else "")
    name = {"reparam": "rbr_reparam", "dense_conv": "rbr_dense.conv", "dense_bn": "rbr_dense.bn",
            "dil_conv": "rbr_dense_dilation.conv", "dil_bn": "rbr_dense_dilation.bn", "one_conv": "rbr_1x1.conv",
            "one_bn": "rbr_1x1.bn", "id_bn": "rbr_identity"}[m.group(3)]
    _generic(ref, f"{block}.{name}", leaves, "conv2d")


_SNOWDAR_TAPS = {"tdnn2": 5, "tdnn3": 7, "ex_tdnn4": 9}


def snowdar_rule(mod, leaves, ref):
    top = mod.split(".")[0]
    m = re.fullmatch(r"(se\d)\.fc([12])", mod)
    if re.fullmatch(r"(ex_|phonetic_)?tdnn\d", top) and top not in ("tdnn6", "tdnn7"):
        _tdnn(mod, leaves, ref, top, _SNOWDAR_TAPS.get(top))
    elif m:
        _generic(ref, f"{m.group(1)}.fc_{m.group(2)}", leaves, "dense3")
    elif mod == "stats":  # the xi-vector prior: [D] -> [1, D]
        for leaf, shape in leaves.items():
            ref.put(f"stats.{leaf}", (1,) + shape)
    elif mod.startswith("stats.lin1_relu_bn"):
        _tdnn(mod, leaves, ref, "stats.lin1_relu_bn")
    elif mod == "stats.lin2.conv":
        _generic(ref, "stats.lin2", leaves)
    elif mod in ("att_fc1", "att_fc2"):
        _generic(ref, f"att.fc_{mod[-1]}", leaves, "dense3")
    else:
        name, part = mod.split("_")
        _generic(ref, f"{name}.{'affine' if part == 'affine' else 'batchnorm'}", leaves, "dense3")


_FTDNN_CONTEXT = {2: 2, 3: 0, 4: 3, 5: 0, 6: 3, 7: 3, 8: 3, 9: 0}


def ftdnn_rule(mod, leaves, ref):
    m = re.fullmatch(r"layer(\d\d)\.(factor1\.conv|factor2\.conv|bn)", mod)
    if mod.startswith(("layer01.", "layer10.")):
        _tdnn(mod, leaves, ref, mod.split(".")[0])
    elif m:
        c = _FTDNN_CONTEXT[int(m.group(1))]
        name = {"factor1.conv": "factor", "factor2.conv": "affine", "bn": "bn"}[m.group(2)]
        _generic(ref, f"layer{m.group(1)}.{name}", leaves, taps_width=c + 1 if c else None)
    else:
        i, part = re.fullmatch(r"embed(\d)_(affine|bn)", mod).groups()
        _generic(ref, f"embedding{i}.{'affine' if part == 'affine' else 'batchnorm'}", leaves, "dense3")


def conformer_rule(mod, leaves, ref, re_embed=False, scaled=False, gau_parts=None):
    """Trans_Bat norms nest their BatchNorm at ``.norm``; the ReConformer's
    Scaled* layers (``scaled``) carry ``weight_scale``/``bias_scale``.
    ``gau_parts``: {reference GAU prefix: its to_qk width} (uv splits into
    to_gate, to_v and to_qk rows)."""
    def scales(rmod):
        if scaled:
            for leaf in ("weight", "bias"):
                if f"{rmod}.{leaf}" in ref.sd:
                    ref.sd[f"{rmod}.{leaf}_scale"] = np.asarray(ref.rng.normal() * 0.3, np.float32)

    m = re.fullmatch(r"transformer\.embed\.(conv(\d)|proj)", mod)
    if m and m.group(2):
        rmod = f"transformer.embed.conv.{(0, 3, 6)[int(m.group(2)) - 1] if re_embed else (0, 2, 4)[int(m.group(2)) - 1]}"
        ref.weight(rmod, leaves["weight"], leaves["bias"])
        return scales(rmod)
    if m:
        rmod = "transformer.embed.out" if re_embed else "transformer.embed.out.0"
        ref.weight(rmod, leaves["weight"], leaves["bias"])
        return scales(rmod)
    b = re.fullmatch(r"transformer\.block_(\d+)\.(.+)", mod)
    if b is None:
        if mod == "transformer.after_norm":
            return _enc_norm(ref, "transformer.after_norm", leaves)
        rmod = {"transform_out_affine": "transform_out.affine", "transform_out_norm": "transform_out.batchnorm",
                "stats.att_norm": "stats.attention.2", "stats.att2": "stats.attention.4",
                "bn_stats": "stats.norm_stats", "fc2_affine": "fc2.affine", "fc2_norm": "fc2.batchnorm"}.get(mod)
        if mod == "stats.att1":
            return _generic(ref, "stats.attention.0", leaves)
        return _generic(ref, rmod, leaves, "dense3" if mod in ("fc2_affine", "transform_out_affine") else "dense")
    pre, sub = f"transformer.encoders.{b.group(1)}", b.group(2)
    if sub.startswith("norm_"):
        return _enc_norm(ref, f"{pre}.{sub}", leaves)
    if sub == "conv_module.norm":
        if "eps" in leaves or "mean" not in leaves:
            return _enc_norm(ref, f"{pre}.conv_module.norm", leaves)
        return ref.norm(f"{pre}.conv_module.norm", leaves)  # a bare BatchNorm1d
    f = re.fullmatch(r"(ff_macaron|ff)\.(w[12])", sub)
    if f:
        rmod = f"{pre}.feed_forward{'_macaron' if f.group(1) == 'ff_macaron' else ''}.w_{f.group(2)[1]}"
        ref.weight(rmod, leaves["weight"], leaves["bias"])
        return scales(rmod)
    c = re.fullmatch(r"conv_module\.(pointwise1|depthwise|pointwise2)", sub)
    if c:
        rmod = f"{pre}.conv_module.{dict(pointwise1='pointwise_conv1', depthwise='depthwise_conv', pointwise2='pointwise_conv2')[c.group(1)]}"
        ref.weight(rmod, leaves["weight"], leaves["bias"])
        return scales(rmod)
    if sub == "concat_linear":
        return ref.weight(f"{pre}.concat_linear", leaves["weight"], leaves["bias"])
    if sub == "t5_bias":
        return ref.put(f"{pre}.self_attn.t5rel_module.relative_attention_bias.weight", leaves["rel_bias"])
    a = re.fullmatch(r"(self_attn|ff_macaron|ff)(?:\.(\w+))?", sub)
    rattn = {"self_attn": f"{pre}.self_attn", "ff_macaron": f"{pre}.feed_forward_macaron",
             "ff": f"{pre}.feed_forward"}[a.group(1)]
    part = a.group(2)
    if part is None:  # the attention's own leaves
        for leaf, shape in leaves.items():
            name = {"att_scale": "att_norm.scale", "train_len": "att_norm.train_len", "g_sa_omiga": "att_norm.omiga",
                    "g_sa_bias": "att_norm.bias"}.get(leaf, leaf)
            if leaf in ("gamma", "beta"):  # GAU's OffsetScales, rows [q, k]
                ref.put(f"{rattn}.scale_q.{leaf}", (1,) + shape[1:])
                ref.put(f"{rattn}.scale_k.{leaf}", (1,) + shape[1:])
            else:
                ref.put(f"{rattn}.{name}", shape)
        return None
    if part == "qkv":
        d = leaves["weight"][1]
        for n in "qkv":
            ref.weight(f"{rattn}.linear_{n}", (d, d), (d,))
            scales(f"{rattn}.linear_{n}")
        return None
    if part == "uv":  # to_gate, to_v (e rows each), to_qk (s rows)
        n, d = leaves["weight"]
        s = gau_parts[rattn]
        for name, rows in (("to_gate", (n - s) // 2), ("to_v", (n - s) // 2), ("to_qk", s)):
            ref.weight(f"{rattn}.{name}.0", (rows, d), (rows,))
        return None
    if part == "out":
        rmod = f"{rattn}.to_out.0" if rattn in gau_parts else f"{rattn}.linear_out"
        ref.weight(rmod, leaves["weight"], leaves["bias"])
        return scales(rmod)
    if part == "pos":
        ref.weight(f"{rattn}.linear_pos", leaves["weight"])
        return scales(f"{rattn}.linear_pos")
    raise AssertionError(f"no rule for {mod}")


def _enc_norm(ref, rmod, leaves):
    """LayerNorm, Trans_Bat (BatchNorm at ``.norm``) or BasicNorm's eps."""
    if "eps" in leaves:
        ref.sd[f"{rmod}.eps"] = np.asarray(ref.rng.normal() * 0.1 - 2.0, np.float32)
    elif "mean" in leaves:
        ref.norm(f"{rmod}.norm", leaves)
    else:
        ref.norm(rmod, leaves)


def _conformer_ref(model, seed=0, **kw):
    gau_parts = {}
    for key, value in model.state_dict().items():
        b = re.fullmatch(r"transformer\.block_(\d+)\.(self_attn|ff_macaron|ff)\.gamma", key)
        if b:
            rattn = {"self_attn": "self_attn", "ff_macaron": "feed_forward_macaron", "ff": "feed_forward"}[b.group(2)]
            gau_parts[f"transformer.encoders.{b.group(1)}.{rattn}"] = value.shape[1]
    rule = functools.partial(conformer_rule, gau_parts=gau_parts, **kw)
    return reference_state_dict(model, rule, seed, loss_dim=model.embd_dim)


# --- the families: (port model, reference state_dict, port converter, JAX converter) ----------------------------

def _resnet_freq(f):
    return -(-f // 8)


def _family(name):
    cpu = dict(device="cpu")
    if name.startswith("ecapa"):
        fc1 = name == "ecapa_fc1"
        model = EcapaTdnn(input_dim=F_IN, channels=16, mfa_conv=24, embd_dim=8, fc1=fc1, **cpu)
        sd = reference_state_dict(model, ecapa_rule, loss_dim=8)
        return model, sd, convert.convert_ecapa_state_dict, jconvert.convert_ecapa_state_dict
    if name == "lawlict":
        model = EcapaLawlict(input_dim=F_IN, channels=16, embd_dim=8, **cpu)
        sd = reference_state_dict(model, lawlict_rule, loss_dim=8)
        return model, sd, convert.convert_ecapa_lawlict_state_dict, jconvert.convert_ecapa_lawlict_state_dict
    if name.startswith("resnet"):
        model = ResNetXvector(input_dim=F_IN, layers=(1, 2, 1, 1), base_planes=4, embd_dim=8,
                              use_se=name == "resnet_se", fc1=name == "resnet_fc1", **cpu)
        sd = reference_state_dict(model, resnet_rule, loss_dim=8)
        fo = _resnet_freq(F_IN)
        return (model, sd, functools.partial(convert.convert_resnet_state_dict, freq_out=fo),
                functools.partial(jconvert.convert_resnet_state_dict, freq_out=fo))
    if name.startswith("repvgg"):
        blocks = (1, 2, 1, 1)
        model = RepVggXvector(input_dim=F_IN, num_blocks=blocks, base_channels=4, embd_dim=8,
                              block="vgg" if name == "repvgg_vgg" else "spk", deploy=name == "repvgg_deploy", **cpu)
        sd = reference_state_dict(model, repvgg_rule, loss_dim=8)
        fo = _resnet_freq(F_IN)
        return (model, sd, functools.partial(convert.convert_repvgg_state_dict, freq_out=fo, num_blocks=blocks),
                functools.partial(jconvert.convert_repvgg_state_dict, freq_out=fo, num_blocks=blocks))
    if name == "ftdnn":
        model = FactoredXvector(input_dim=F_IN, width=0.0625, embd_dim=8, **cpu)
        sd = reference_state_dict(model, ftdnn_rule, loss_dim=8)
        return model, sd, convert.convert_ftdnn_state_dict, jconvert.convert_ftdnn_state_dict
    if name.startswith("snowdar"):
        kw = dict(snowdar_extend_se=dict(extend=True, se_block=True), snowdar_xi=dict(pooling="xi", bn_affine=True),
                  snowdar=dict())[name]
        model = SnowdarXvector(input_dim=F_IN, num_frame_channels=16, embd_dim=8, **kw, **cpu)
        sd = reference_state_dict(model, snowdar_rule, loss_dim=8)
        return model, sd, convert.convert_snowdar_state_dict, jconvert.convert_snowdar_state_dict
    if name == "multitask":
        model = MultiTaskXvector(input_dim=F_IN, num_frame_channels=16, embd_dim=8, **cpu)
        sd = reference_state_dict(model, snowdar_rule, loss_dim=8)
        return model, sd, convert.convert_multitask_state_dict, jconvert.convert_multitask_state_dict
    if name == "fd":
        model = FDXvector(input_dim=F_IN, num_frame_channels=16, embd_dim=8, **cpu)
        sd = reference_state_dict(model, snowdar_rule, loss_dim=8)
        return model, sd, convert.convert_fd_state_dict, jconvert.convert_fd_state_dict
    if name.startswith("conformer") or name == "reconformer":
        kw, num_blocks, freq = CONFORMERS[name]
        model = ConformerXvector(input_dim=F_IN, embd_dim=8, attention_dim=16, attention_heads=2, linear_units=24,
                                 num_blocks=num_blocks, out_dim=24, **kw, **cpu)
        re_conf = name == "reconformer"
        sd = _conformer_ref(model, re_embed=re_conf, scaled=re_conf)
        return (model, sd, functools.partial(convert.convert_conformer_state_dict, num_blocks=num_blocks,
                                             freq_out=freq),
                functools.partial(jconvert.convert_conformer_state_dict, num_blocks=num_blocks, freq_out=freq))
    raise KeyError(name)


CONFORMERS = {
    "conformer_conv2d_rel_pos": (dict(input_layer="conv2d"), 2, ((F_IN - 1) // 2 - 1) // 2),
    "conformer_conv2d2_gau": (dict(input_layer="conv2d2", att_type="gau"), 1, F_IN - 4),
    "conformer_conv2d6_abs_pos": (dict(input_layer="conv2d6", pos_enc_type="abs_pos"), 1, ((F_IN - 1) // 2 - 2) // 3),
    "conformer_conv2d8_bn": (dict(input_layer="conv2d8", encoder_params=dict(norm_type="batch_norm",
                                                                            cnn_norm_type="batch_norm")),
                             1, (((F_IN - 1) // 2 - 1) // 2 - 1) // 2),
    "conformer_gau_ff_t5_concat": (dict(att_type="gau", encoder_params=dict(
        positionwise_layer_type="gau", add_t5rel_bias=True, concat_after=True,
        attention_norm_args=dict(norm_method="softmax_plus", train_len=100))), 1, ((F_IN - 1) // 2 - 1) // 2),
    "conformer_conv_ff_conv_out": (dict(encoder_params=dict(positionwise_layer_type="conv1d",
                                                            positionwise_conv_kernel_size=3,
                                                            attention_conv_out=True)),
                                   1, ((F_IN - 1) // 2 - 1) // 2),
    "reconformer": (dict(transformer_type="re_conformer"), 2, ((F_IN - 1) // 2 - 1) // 2),
}

FAMILIES = ["ecapa", "ecapa_fc1", "lawlict", "resnet", "resnet_se", "resnet_fc1", "repvgg", "repvgg_vgg",
            "repvgg_deploy", "ftdnn", "snowdar", "snowdar_extend_se", "snowdar_xi", "multitask", "fd",
            *CONFORMERS]


def assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("name", FAMILIES)
def test_converter_matches_jax_bit_for_bit(name):
    model, sd, port_convert, jax_convert = _family(name)
    params, stats = jax_convert(sd)
    want = variables_to_state_dict({"params": params, "batch_stats": stats})
    got = port_convert(sd)
    assert_state_dicts_equal(got, want)
    model.load_state_dict(got)  # every tensor of the port's model, strictly


@pytest.mark.parametrize("name", ["ecapa", "resnet", "conformer_conv2d_rel_pos"])
def test_converter_takes_numpy_and_keeps_the_source_type(name):
    _, sd, port_convert, _ = _family(name)
    from_numpy = port_convert({k: v.numpy() for k, v in sd.items()})
    assert_state_dicts_equal(from_numpy, port_convert(sd))
    f64 = port_convert({k: v.double() if v.is_floating_point() else v for k, v in sd.items()})
    kernels = [k for k in f64 if k.endswith((".weight", ".kernel"))]
    assert kernels and all(f64[k].dtype == torch.float64 for k in kernels)
    assert all(f64[k].dtype == torch.float32 for k in f64 if k.endswith((".bias", ".mean", ".var", ".scale")))


def test_converter_raises_key_error_on_a_missing_tensor():
    _, sd, port_convert, _ = _family("ecapa")
    del sd["layer3.res2net_block.blocks.2.batchnorm.running_var"]
    with pytest.raises(KeyError):
        port_convert(sd)


def test_masked_taps_and_ignored_keys():
    model, sd, port_convert, _ = _family("ecapa")
    got = port_convert(sd)
    w = sd["layer4.res2net_block.blocks.0.affine.weight"]  # [h, h, 9] at dilation 4
    assert w.shape[2] == 9
    torch.testing.assert_close(got["layer4.res2net.block_0.affine.conv.weight"], w[:, :, [0, 4, 8]], rtol=0, atol=0)
    assert not any("num_batches_tracked" in k or k.startswith("loss") for k in got)
    sd2 = {k: v for k, v in sd.items() if "num_batches_tracked" not in k and not k.startswith("loss")}
    assert_state_dicts_equal(port_convert(sd2), got)


def test_head_columns_go_freq_major():
    """The first fc after the trunk: the reference flattens [C, F'] channel
    major, the port [F', C] freq major; the std half moves as the mean half."""
    _, sd, port_convert, _ = _family("resnet")
    w = sd["fc2.affine.weight"][:, :, 0]
    got = port_convert(sd)["head.fc2_affine.weight"]
    fo = _resnet_freq(F_IN)
    half = w.shape[1] // 2
    c_dim = half // fo
    for f, c in ((0, 0), (1, 3), (fo - 1, c_dim - 1)):
        assert torch.equal(got[:, f * c_dim + c], w[:, c * fo + f])
        assert torch.equal(got[:, half + f * c_dim + c], w[:, half + c * fo + f])


def test_reconformer_fold_is_float64_then_float32():
    _, sd, port_convert, _ = _family("reconformer")
    key = "transformer.encoders.0.feed_forward.w_1.weight"
    want = (sd[key].numpy().astype(np.float64) * np.exp(np.float64(sd[key + "_scale"].numpy()))).astype(np.float32)
    assert np.array_equal(port_convert(sd)["transformer.block_0.ff.w1.weight"].numpy(), want)


def test_load_reference_ecapa_reads_a_params_file(tmp_path):
    _, sd, _, _ = _family("ecapa")
    path = tmp_path / "6.params"
    torch.save(sd, path)
    wrapped = tmp_path / "wrapped.params"
    torch.save({"state_dict": sd}, wrapped)
    want = variables_to_state_dict(dict(zip(("params", "batch_stats"), jconvert.load_reference_ecapa(str(path)))))
    assert_state_dicts_equal(convert.load_reference_ecapa(str(path)), want)
    assert_state_dicts_equal(convert.load_reference_ecapa(str(wrapped)), want)


@pytest.fixture(scope="module")
def ecapa_forward():
    """One JAX jit of the converted ECAPA's embedding, shared by the dtypes."""
    jmodel = JaxEcapa(channels=16, mfa_conv=24, embd_dim=8)
    fn = jax.jit(lambda v, x, m: jmodel.apply(v, x, mask=m, train=False))
    return fn


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-5)])
def test_converted_ecapa_embeds_as_jax(ecapa_forward, dtype, tol):
    model, sd, port_convert, jax_convert = _family("ecapa")
    sd = {k: v.to(torch.float64) if v.is_floating_point() and dtype == np.float64 else v for k, v in sd.items()}
    params, stats = jax_convert(sd)
    cast = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), t)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 60, F_IN)).astype(dtype)
    mask = np.arange(60)[None, :] < np.asarray([60, 41, 17])[:, None]
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(ecapa_forward({"params": cast(params), "batch_stats": cast(stats)}, jnp.asarray(x),
                                        jnp.asarray(mask)))
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    model = model.to(tdtype)
    model.load_state_dict(port_convert(sd))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["ecapa_c1024", "resnet34"])
def test_full_size_conversion_matches_jax(name):
    if name == "ecapa_c1024":
        model = EcapaTdnn(input_dim=80, device="cpu")
        sd = reference_state_dict(model, ecapa_rule, loss_dim=192)
        port_convert, jax_convert = convert.convert_ecapa_state_dict, jconvert.convert_ecapa_state_dict
    else:
        model = ResNetXvector(input_dim=80, embd_dim=256, device="cpu")
        sd = reference_state_dict(model, resnet_rule, loss_dim=256)
        port_convert = functools.partial(convert.convert_resnet_state_dict, freq_out=10)
        jax_convert = functools.partial(jconvert.convert_resnet_state_dict, freq_out=10)
    params, stats = jax_convert(sd)
    got = port_convert(sd)
    assert_state_dicts_equal(got, variables_to_state_dict({"params": params, "batch_stats": stats}))
    model.load_state_dict(got)
