"""ASV-Subtools checkpoints -> the port's state_dicts (counterpart:
asv_subtools_tpu/convert.py:24-911).

A state_dict of the reference (ASV-Subtools, PyTorch) maps straight onto
the port's state_dict: both are torch layouts, so most of a mapping is
renaming. Each converter takes a dict of torch tensors or numpy arrays
and returns ``{port key: CPU tensor}``, the dict that
``model.load_state_dict`` of the port's model takes (the backbone's keys;
loss heads are the caller's). Keys a converter does not read are ignored
(``num_batches_tracked``, ``loss.*``); a key it needs and cannot find
raises ``KeyError``.

Layout rules (the port's names are the flax module names, weights.py):

* a reference ``TdnnAffine`` with a dilated context ``[-d, 0, d]`` stores
  a masked full-width kernel ``[out, in, 2d+1]``: the port keeps taps
  ``{0, d, 2d}``; conv1d weights ``[out, in, k]`` are otherwise the port's;
* a Linear ``[out, in]`` or a 1x1 conv ``[out, in, 1]`` becomes a Dense
  ``weight [out, in]``;
* a 2-D conv ``[out, in, kF, kT]`` over the reference's ``[B, C, F, T]``
  maps becomes ``[out, in, kT, kF]`` (the port's maps put H = T, W = F);
* a BatchNorm's ``weight``/``bias``/``running_mean``/``running_var`` become
  ``scale``/``bias``/``mean``/``var`` in float32; an affine-free one has no
  ``scale``/``bias``;
* ECAPA's attention ``att1`` over [x; mean; std] keeps the flax layout
  ``kernel [1, 3C, K]``;
* the first fc after a 2-D trunk permutes its input columns from the
  reference's channel-major ``[C, F']`` flatten to the port's freq-major
  ``[F', C]``, the std half like the mean half.

Kernels keep the source's type; biases and norm leaves are float32, as
JAX's converters give them (the ``variables_to_state_dict`` of JAX's
result equals the port's, bit for bit).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch


def _numpy(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v) for k, v in sd.items()}


class _Out:
    """The port's state_dict, written key by key from a numpy reference dict."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self.out: Dict[str, torch.Tensor] = {}

    def put(self, key: str, value: np.ndarray) -> None:
        if key in self.out:
            raise ValueError(f"two reference tensors map to {key}")
        self.out[key] = torch.from_numpy(np.array(value, order="C"))  # a copy; keeps a 0-d leaf 0-d

    def f32(self, ref: str) -> np.ndarray:
        return np.asarray(self.sd[ref], np.float32)

    def conv(self, port: str, ref: str, taps: Optional[Sequence[int]] = None, bias: bool = True) -> None:
        """conv1d ``[out, in, k]`` (a masked kernel's ``taps`` kept) + bias."""
        w = np.asarray(self.sd[f"{ref}.weight"])
        self.put(f"{port}.weight", w if taps is None else w[:, :, list(taps)])
        if bias:
            self.put(f"{port}.bias", self.f32(f"{ref}.bias"))

    def dense(self, port: str, ref: str, bias: bool = True) -> None:
        """Linear ``[out, in]`` or 1x1 conv ``[out, in, 1]`` -> Dense ``[out, in]``."""
        w = np.asarray(self.sd[f"{ref}.weight"])
        self.put(f"{port}.weight", w[:, :, 0] if w.ndim == 3 else w)
        if bias:
            self.put(f"{port}.bias", self.f32(f"{ref}.bias"))

    def conv2d(self, port: str, ref: str, bias: bool = False) -> None:
        """2-D conv ``[out, in, kF, kT]`` -> ``[out, in, kT, kF]``."""
        self.put(f"{port}.weight", np.asarray(self.sd[f"{ref}.weight"]).transpose(0, 1, 3, 2))
        if bias:
            self.put(f"{port}.bias", self.f32(f"{ref}.bias"))

    def bn(self, port: str, ref: str) -> None:
        self.put(f"{port}.mean", self.f32(f"{ref}.running_mean"))
        self.put(f"{port}.var", self.f32(f"{ref}.running_var"))
        if f"{ref}.weight" in self.sd:  # an affine-free BN has no scale/bias
            self.put(f"{port}.scale", self.f32(f"{ref}.weight"))
            self.put(f"{port}.bias", self.f32(f"{ref}.bias"))

    def ln(self, port: str, ref: str) -> None:
        self.put(f"{port}.scale", self.f32(f"{ref}.weight"))
        self.put(f"{port}.bias", self.f32(f"{ref}.bias"))

    def tdnn_layer(self, port: str, ref: str, taps: Optional[Sequence[int]] = None) -> None:
        """ReluBatchNormTdnnLayer: ``affine.conv`` + ``act_bn.bn``."""
        self.conv(f"{port}.affine.conv", f"{ref}.affine", taps)
        self.bn(f"{port}.act_bn.bn", f"{ref}.batchnorm")

    def att1(self, port: str, ref: str, att2_ref: str) -> None:
        """The attention's first 1x1 conv: over [x; mean; std] (3C inputs,
        ``_SplitGlobalConv``'s ``kernel [1, 3C, K]``) or over x alone (a
        plain conv); the width of ``att2`` (``[C, K, 1]``) tells which."""
        w = np.asarray(self.sd[f"{ref}.weight"])
        if w.shape[1] == 3 * np.shape(self.sd[f"{att2_ref}.weight"])[0]:
            self.put(f"{port}.kernel", w.transpose(2, 1, 0))
        else:
            self.put(f"{port}.weight", w)
        self.put(f"{port}.bias", self.f32(f"{ref}.bias"))


def convert_ecapa_state_dict(sd: Mapping[str, Any], scale: int = 8) -> Dict[str, torch.Tensor]:
    """ASV-Subtools ECAPA_TDNN state_dict -> the port's EcapaTdnn
    (pooling "ecpa-attentive"; ``fc1`` when the reference has it)."""
    o = _Out(_numpy(sd))
    o.tdnn_layer("layer1", "layer1")
    for li, dilation in ((2, 2), (3, 3), (4, 4)):
        name = f"layer{li}"
        o.tdnn_layer(f"{name}.conv1", f"{name}.conv_relu_bn1")
        for b in range(scale - 1):
            o.tdnn_layer(f"{name}.res2net.block_{b}", f"{name}.res2net_block.blocks.{b}",
                         taps=(0, dilation, 2 * dilation))
        o.tdnn_layer(f"{name}.conv2", f"{name}.conv_relu_bn2")
        o.dense(f"{name}.se.fc1", f"{name}.se.se.1")
        o.dense(f"{name}.se.fc2", f"{name}.se.se.3")
        if f"{name}.shortcut.weight" in o.sd:
            o.conv(f"{name}.shortcut", f"{name}.shortcut")
    o.tdnn_layer("mfa", "mfa")
    o.att1("stats.att1", "stats.attention.0", "stats.attention.4")
    o.bn("stats.att_bn", "stats.attention.2")
    o.conv("stats.att2", "stats.attention.4")
    o.bn("bn_stats", "bn_stats")
    o.dense("fc2_affine", "fc2.affine")
    o.bn("fc2_bn", "fc2.batchnorm")
    if "fc1.affine.weight" in o.sd:
        o.dense("fc1_affine", "fc1.affine")
        o.bn("fc1_bn", "fc1.batchnorm")
    return o.out


def load_reference_ecapa(checkpoint_path: str, **kwargs) -> Dict[str, torch.Tensor]:
    """A reference ``{epoch}.params`` checkpoint -> the port's ECAPA state_dict."""
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_ecapa_state_dict(sd, **kwargs)


def _freq_major_columns(in_dim: int, freq_out: int) -> np.ndarray:
    """Column order that takes a channel-major ``[C, F']`` flatten to the
    port's freq-major ``[F', C]`` (one half of the pooled [mean, std])."""
    c_dim = in_dim // freq_out
    perm = np.zeros(in_dim, np.int64)
    for f in range(freq_out):
        for c in range(c_dim):
            perm[f * c_dim + c] = c * freq_out + f
    return perm


def _channelmajor_head(o: _Out, freq_out: int) -> None:
    """The fc layers after a 2-D trunk (keys ``head.*``)."""
    first_fc = "fc1" if "fc1.affine.weight" in o.sd else "fc2"
    w = np.asarray(o.sd[f"{first_fc}.affine.weight"])
    if w.ndim == 3:
        w = w[:, :, 0]
    half = w.shape[1] // 2  # statistics pooling: [mean, std]
    perm = _freq_major_columns(half, freq_out)
    o.put(f"head.{first_fc}_affine.weight", w[:, np.concatenate([perm, perm + half])])
    o.put(f"head.{first_fc}_affine.bias", o.f32(f"{first_fc}.affine.bias"))
    o.bn(f"head.{first_fc}_bn", f"{first_fc}.batchnorm")
    if first_fc == "fc1" and "fc2.affine.weight" in o.sd:
        o.dense("head.fc2_affine", "fc2.affine")
        o.bn("head.fc2_bn", "fc2.batchnorm")


def convert_resnet_state_dict(sd: Mapping[str, Any], freq_out: int) -> Dict[str, torch.Tensor]:
    """ASV-Subtools ResNetXvector state_dict -> the port's ResNetXvector
    (full pre-activation, SE blocks when present, fc1 optional).
    ``freq_out``: F' after the trunk (ceil(F/8) for 3 stride-2 stages)."""
    o = _Out(_numpy(sd))
    o.conv2d("resnet.stem", "resnet.conv1")
    o.bn("resnet.stem_bn", "resnet.bn1")
    for stage in range(1, 5):
        b = 0
        while f"resnet.layer{stage}.{b}.conv1.weight" in o.sd:
            port, ref = f"resnet.layer{stage}_{b}", f"resnet.layer{stage}.{b}"
            o.conv2d(f"{port}.conv1", f"{ref}.conv1")
            o.conv2d(f"{port}.conv2", f"{ref}.conv2")
            o.bn(f"{port}.bn1", f"{ref}.bn1")
            o.bn(f"{port}.bn2", f"{ref}.bn2")
            if f"{ref}.downsample.0.weight" in o.sd:
                o.conv2d(f"{port}.downsample_conv", f"{ref}.downsample.0")
                o.bn(f"{port}.downsample_bn", f"{ref}.downsample.1")
            if f"{ref}.se.fc.0.weight" in o.sd:
                o.dense(f"{port}.se.fc1", f"{ref}.se.fc.0")
                o.dense(f"{port}.se.fc2", f"{ref}.se.fc.2")
            b += 1
    _channelmajor_head(o, freq_out)
    return o.out


def convert_repvgg_state_dict(sd: Mapping[str, Any], freq_out: int,
                              num_blocks: Sequence[int] = (2, 4, 14, 1)) -> Dict[str, torch.Tensor]:
    """ASV-Subtools RepVggXvector state_dict -> the port's RepVggXvector:
    RepSPK and plain RepVGG blocks, in the train shape or deployed
    (``rbr_reparam``)."""
    o = _Out(_numpy(sd))

    def block(ref: str, port: str) -> None:
        port = f"repvgg.{port}"
        if f"{ref}.rbr_reparam.weight" in o.sd:  # a deployed checkpoint
            o.conv2d(f"{port}.reparam", f"{ref}.rbr_reparam", bias=True)
            return
        o.conv2d(f"{port}.dense_conv", f"{ref}.rbr_dense.conv")
        o.bn(f"{port}.dense_bn", f"{ref}.rbr_dense.bn")
        if f"{ref}.rbr_dense_dilation.conv.weight" in o.sd:  # RepSPK
            o.conv2d(f"{port}.dil_conv", f"{ref}.rbr_dense_dilation.conv")
            o.bn(f"{port}.dil_bn", f"{ref}.rbr_dense_dilation.bn")
        else:
            o.conv2d(f"{port}.one_conv", f"{ref}.rbr_1x1.conv")
            o.bn(f"{port}.one_bn", f"{ref}.rbr_1x1.bn")
        if f"{ref}.rbr_identity.running_mean" in o.sd:
            o.bn(f"{port}.id_bn", f"{ref}.rbr_identity")

    block("repvgg.stage0", "stage0")
    for stage in range(4):
        for b in range(num_blocks[stage]):
            block(f"repvgg.stage{stage + 1}.{b}", f"stage{stage + 1}_{b}")
    _channelmajor_head(o, freq_out)
    return o.out


def convert_ftdnn_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """ASV-Subtools factored x-vector (F-TDNN) state_dict -> the port's
    FactoredXvector. An FTdnnBlock's ``factor`` is a masked kernel over
    ``[-c, 0]`` and its ``affine`` one over ``[0, c]``: taps ``{0, c}``."""
    o = _Out(_numpy(sd))
    o.tdnn_layer("layer01", "layer01")
    for idx, ctx in ((2, 2), (3, 0), (4, 3), (5, 0), (6, 3), (7, 3), (8, 3), (9, 0)):
        name = f"layer{idx:02d}"
        taps = (0, ctx) if ctx > 0 else (0,)
        o.conv(f"{name}.factor1.conv", f"{name}.factor", taps, bias=False)
        o.conv(f"{name}.factor2.conv", f"{name}.affine", taps)
        o.bn(f"{name}.bn", f"{name}.bn")
    o.tdnn_layer("layer10", "layer10")
    for i in (1, 2):
        o.dense(f"embed{i}_affine", f"embedding{i}.affine")
        o.bn(f"embed{i}_bn", f"embedding{i}.batchnorm")
    return o.out


def _snowdar(o: _Out) -> None:
    taps_by_layer = {
        "tdnn1": None,       # [-2..2] contiguous
        "tdnn2": (0, 2, 4),  # [-2, 0, 2] in a width-5 masked kernel
        "tdnn3": (0, 3, 6),  # [-3, 0, 3] in a width-7 masked kernel
        "tdnn4": None,
        "tdnn5": None,
    }
    if "ex_tdnn1.affine.weight" in o.sd:  # extend=True (the E-TDNN interleave)
        taps_by_layer.update({"ex_tdnn1": None, "ex_tdnn2": None, "ex_tdnn3": None,
                              "ex_tdnn4": (0, 4, 8), "ex_tdnn5": None})
    for name, taps in taps_by_layer.items():
        o.tdnn_layer(name, name, taps)
    for i in (1, 2, 3, 4):  # the SE blocks (se4 under extend)
        if f"se{i}.fc_1.weight" in o.sd:
            o.dense(f"se{i}.fc1", f"se{i}.fc_1")
            o.dense(f"se{i}.fc2", f"se{i}.fc_2")
    if "stats.prior_mean" in o.sd:  # the xi-vector pooling: prior rows [1, D] -> [D]
        o.put("stats.prior_mean", np.asarray(o.sd["stats.prior_mean"][0], np.float32))
        o.put("stats.prior_logprec", np.asarray(o.sd["stats.prior_logprec"][0], np.float32))
        o.tdnn_layer("stats.lin1_relu_bn", "stats.lin1_relu_bn")
        o.conv("stats.lin2.conv", "stats.lin2", bias="stats.lin2.bias" in o.sd)
    for name in ("tdnn6", "tdnn7"):
        o.dense(f"{name}_affine", f"{name}.affine")
        o.bn(f"{name}_bn", f"{name}.batchnorm")


def convert_snowdar_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """ASV-Subtools Xvector / snowdar_xvector state_dict -> the port's TDNN
    x-vector (5 TDNN layers, statistics or xi-vector pooling, the
    tdnn6/tdnn7 head; SE blocks and the extended interleave when present).
    Dilated contexts stored as masked full-width kernels keep their taps."""
    o = _Out(_numpy(sd))
    _snowdar(o)
    return o.out


def convert_multitask_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """multi_task_xvector_fix.py state_dict -> the port's MultiTaskXvector:
    the snowdar mapping and the phonetic_tdnn5/6/7 branch (the loss heads
    are the caller's)."""
    o = _Out(_numpy(sd))
    _snowdar(o)
    for name in ("phonetic_tdnn5", "phonetic_tdnn6", "phonetic_tdnn7"):
        o.tdnn_layer(name, name)
    return o.out


def convert_fd_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """snowdar-xvector-FD-AL.py state_dict -> the port's FDXvector: the
    snowdar mapping and the attention gate (SEBlock fc_1/fc_2; the DAL
    projections and the two loss heads are the caller's)."""
    o = _Out(_numpy(sd))
    _snowdar(o)
    o.dense("att_fc1", "att.fc_1")
    o.dense("att_fc2", "att.fc_2")
    return o.out


def convert_ecapa_lawlict_state_dict(sd: Mapping[str, Any], scale: int = 8) -> Dict[str, torch.Tensor]:
    """lawlict ECAPA_TDNN state_dict (ecapa-tdnn-xvector.py) -> the port's
    EcapaLawlict: bias-free convs, full dilated Res2 kernels (no taps to
    select), a two-Linear SE, an MFA conv with a bias."""
    o = _Out(_numpy(sd))

    def conv_relu_bn(port: str, ref: str, bias: bool = False) -> None:
        o.conv(f"{port}.affine.conv", f"{ref}.conv", bias=bias)
        o.bn(f"{port}.act_bn.bn", f"{ref}.bn")

    conv_relu_bn("layer1", "layer1")
    for li in (2, 3, 4):
        name = f"layer{li}"
        conv_relu_bn(f"{name}.conv1", f"{name}.0")
        for b in range(scale - 1):
            o.conv(f"{name}.res2net.block_{b}.affine.conv", f"{name}.1.convs.{b}", bias=False)
            o.bn(f"{name}.res2net.block_{b}.act_bn.bn", f"{name}.1.bns.{b}")
        conv_relu_bn(f"{name}.conv2", f"{name}.2")
        o.dense(f"{name}.se.linear1", f"{name}.3.linear1")
        o.dense(f"{name}.se.linear2", f"{name}.3.linear2")
    o.conv("mfa.affine.conv", "conv")
    o.bn("mfa.act_bn.bn", "bn_conv")
    o.conv("stats.linear1", "stats.linear1")
    o.conv("stats.linear2", "stats.linear2")
    o.bn("bn_stats", "bn_stats")
    if "fc1.affine.weight" in o.sd:
        o.dense("fc1_affine", "fc1.affine")
        o.bn("fc1_bn", "fc1.batchnorm")
    o.dense("fc2_affine", "fc2.affine")
    o.bn("fc2_bn", "fc2.batchnorm")
    return o.out


def _fold_scaled(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The ReConformer's Scaled* layers: weight * exp(weight_scale) and
    bias * exp(bias_scale), in float64 numpy, then float32; the scales go."""
    folded = {}
    for k, v in sd.items():
        if (k.endswith(".weight_scale") or k.endswith(".bias_scale")) and k.rsplit("_scale", 1)[0] in sd:
            continue
        sc = sd.get(f"{k}_scale")
        if sc is not None and (k.endswith(".weight") or k.endswith(".bias")):
            v = (np.asarray(v, np.float64) * np.exp(np.asarray(sc, np.float64))).astype(np.float32)
        folded[k] = v
    return folded


# the attention normalisation's learned leaves (reference name -> port name)
_ATT_NORM = (("att_norm.scale", "att_scale"), ("att_norm.train_len", "train_len"),
             ("att_norm.omiga", "g_sa_omiga"), ("att_norm.bias", "g_sa_bias"))


def convert_conformer_state_dict(sd: Mapping[str, Any], num_blocks: int, freq_out: int) -> Dict[str, torch.Tensor]:
    """ASV-Subtools TransformerXvector (Conformer, ReConformer) state_dict
    -> the port's ConformerXvector.

    Every subsampling (conv2d2/conv2d/conv2d6 have convs at torch indices
    0/2, conv2d8 adds 4; the ReConformer's sit at 0/3/6), every position
    type (rel_pos's ``linear_pos`` and ``pos_bias_u/v`` when present), GAU
    and the ReConformer's Scaled* layers (folded). q, k and v fuse into
    the port's ``qkv``; GAU's to_gate/to_v/to_qk into ``uv``.

    ``freq_out``: F' after the subsampling convs — conv2d:
    ((F-1)//2-1)//2; conv2d2: F-4; conv2d6: ((F-1)//2-2)//3; conv2d8:
    (((F-1)//2-1)//2-1)//2.
    """
    o = _Out(_fold_scaled(_numpy(sd)))
    sd = o.sd
    f32 = o.f32

    # subsampling: the torch maps are [B, 1, T, F], kernels [out, in, kT, kF]: the port's layout
    re_embed = "transformer.embed.conv.3.weight" in sd
    out_ref = "transformer.embed.out" if re_embed else "transformer.embed.out.0"
    proj_w = np.asarray(sd[f"{out_ref}.weight"])  # [d, C*F']
    o.put("transformer.embed.proj.weight", proj_w[:, _freq_major_columns(proj_w.shape[1], freq_out)])
    o.put("transformer.embed.proj.bias", f32(f"{out_ref}.bias"))
    conv_idx = ((1, 0), (2, 3), (3, 6)) if re_embed else ((1, 0), (2, 2), (3, 4))
    for n, idx in conv_idx:
        ref = f"transformer.embed.conv.{idx}"
        if f"{ref}.weight" in sd:
            o.put(f"transformer.embed.conv{n}.weight", np.asarray(sd[f"{ref}.weight"]))
            o.put(f"transformer.embed.conv{n}.bias", f32(f"{ref}.bias"))

    def linear_or_conv(port: str, ref: str) -> None:
        """A Linear, or a Conv1d ``[out, in, k]`` (cast to float32)."""
        w = np.asarray(sd[f"{ref}.weight"])
        o.put(f"{port}.weight", w.astype(np.float32) if w.ndim == 3 else w)
        o.put(f"{port}.bias", f32(f"{ref}.bias"))

    def att_norm(port: str, ref: str) -> None:
        for tkey, pkey in _ATT_NORM:
            if f"{ref}.{tkey}" in sd:
                o.put(f"{port}.{pkey}", f32(f"{ref}.{tkey}"))

    def gau(port: str, ref: str) -> None:
        """GAU: to_gate/to_v/to_qk fuse into ``uv`` (u = gate, v, base =
        qk); the two OffsetScales stack into gamma/beta rows [q, k]."""
        parts = [f"{ref}.to_gate.0", f"{ref}.to_v.0", f"{ref}.to_qk.0"]
        o.put(f"{port}.uv.weight", np.concatenate([np.asarray(sd[f"{p}.weight"]) for p in parts], axis=0))
        o.put(f"{port}.uv.bias", np.concatenate([f32(f"{p}.bias") for p in parts]))
        for leaf in ("gamma", "beta"):
            o.put(f"{port}.{leaf}", np.concatenate([f32(f"{ref}.scale_q.{leaf}"), f32(f"{ref}.scale_k.{leaf}")],
                                                   axis=0))
        linear_or_conv(f"{port}.out", f"{ref}.to_out.0")
        att_norm(port, ref)

    def positionwise(port: str, ref: str) -> None:
        """A GAU, or w_1/w_2 (each a Linear or a Conv1d)."""
        if f"{ref}.to_gate.0.weight" in sd:
            gau(port, ref)
            return
        linear_or_conv(f"{port}.w1", f"{ref}.w_1")
        linear_or_conv(f"{port}.w2", f"{ref}.w_2")

    def enc_norm(port: str, ref: str) -> None:
        """LayerNorm; a BatchNorm (Trans_Bat nests it at ``.norm``; the conv
        module's sits at the prefix); or BasicNorm's log-eps scalar. A
        ReConformer layer has no per-branch norms."""
        if f"{ref}.norm.running_mean" in sd:
            o.bn(port, f"{ref}.norm")
        elif f"{ref}.running_mean" in sd:
            o.bn(port, ref)
        elif f"{ref}.eps" in sd:
            o.put(f"{port}.eps", f32(f"{ref}.eps"))
        elif f"{ref}.weight" in sd:
            o.ln(port, ref)

    for i in range(num_blocks):
        pre, port = f"transformer.encoders.{i}", f"transformer.block_{i}"
        attn = f"{port}.self_attn"
        if f"{pre}.self_attn.to_gate.0.weight" in sd:
            gau(attn, f"{pre}.self_attn")
        else:
            qkv = [f"{pre}.self_attn.linear_{n}" for n in "qkv"]
            o.put(f"{attn}.qkv.weight", np.concatenate([np.asarray(sd[f"{p}.weight"]) for p in qkv], axis=0))
            o.put(f"{attn}.qkv.bias", np.concatenate([f32(f"{p}.bias") for p in qkv]))
            linear_or_conv(f"{attn}.out", f"{pre}.self_attn.linear_out")
            att_norm(attn, f"{pre}.self_attn")
        for name in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff", "norm_final"):
            enc_norm(f"{port}.{name}", f"{pre}.{name}")
        positionwise(f"{port}.ff_macaron", f"{pre}.feed_forward_macaron")
        positionwise(f"{port}.ff", f"{pre}.feed_forward")
        cm, cm_ref = f"{port}.conv_module", f"{pre}.conv_module"
        o.conv(f"{cm}.pointwise1", f"{cm_ref}.pointwise_conv1")
        o.conv(f"{cm}.depthwise", f"{cm_ref}.depthwise_conv")
        enc_norm(f"{cm}.norm", f"{cm_ref}.norm")
        o.conv(f"{cm}.pointwise2", f"{cm_ref}.pointwise_conv2")
        if f"{pre}.concat_linear.weight" in sd:  # concat_after=True
            o.dense(f"{port}.concat_linear", f"{pre}.concat_linear")
        t5 = f"{pre}.self_attn.t5rel_module.relative_attention_bias.weight"
        if t5 in sd:
            o.put(f"{port}.t5_bias.rel_bias", f32(t5))
        if f"{pre}.self_attn.linear_pos.weight" in sd:  # rel_pos only
            o.dense(f"{attn}.pos", f"{pre}.self_attn.linear_pos", bias=False)
            o.put(f"{attn}.pos_bias_u", f32(f"{pre}.self_attn.pos_bias_u"))
            o.put(f"{attn}.pos_bias_v", f32(f"{pre}.self_attn.pos_bias_v"))

    # after_norm exists iff normalize_before or the "mfa" combiner
    if any(f"transformer.after_norm.{k}" in sd for k in ("weight", "norm.weight", "eps")):
        enc_norm("transformer.after_norm", "transformer.after_norm")

    o.dense("transform_out_affine", "transform_out.affine")
    o.ln("transform_out_norm", "transform_out.batchnorm")
    o.att1("stats.att1", "stats.attention.0", "stats.attention.4")
    o.ln("stats.att_norm", "stats.attention.2")
    o.conv("stats.att2", "stats.attention.4")
    o.ln("bn_stats", "stats.norm_stats")
    o.dense("fc2_affine", "fc2.affine")
    o.ln("fc2_norm", "fc2.batchnorm")
    return o.out
