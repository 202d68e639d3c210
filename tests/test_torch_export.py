"""Export (torch.export programs, nnet_config.yaml) and weight quantization
against JAX's export.py and quantize.py.

On the CPU: an exported embed function equals eager at 1e-6; the kernels'
custom ops survive save and load (their CPU implementations are the plain
versions); ``write_nnet_config`` + ``load_model_from_config`` rebuild the
model. ``quantize_params`` against JAX's leaf by leaf: the int8 values
equal, the scales bit for bit (the output axis of a port leaf is where
weights.py puts JAX's last axis); the round trip within 1% and the size
under 1/3.5, as JAX's tests require.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch import nn

from asv_subtools_tpu import quantize as jquant
from asv_subtools_tpu_torch import quantize
from asv_subtools_tpu_torch.export import export_embed_fn, load_embed_fn, load_model_from_config, write_nnet_config
from asv_subtools_tpu_torch.models import ConformerXvector, EcapaTdnn, SpeakerNet
from asv_subtools_tpu_torch.nn.fused_att_pooling import (fused_attentive_stats_pool_op,
                                                         fused_attentive_stats_pool_plain)
from asv_subtools_tpu_torch.nn.fused_res2 import fused_res2_chain_op, fused_res2_chain_plain
from asv_subtools_tpu_torch.nn.fused_stats_pooling import fused_stats_pooling_op, fused_stats_pooling_plain
from asv_subtools_tpu_torch.train import get_optimizer, init_train_state, save_checkpoint
from asv_subtools_tpu_torch.weights import init_weights_, state_dict_to_variables

torch.set_num_threads(2)

NARROW = dict(input_dim=10, channels=16, mfa_conv=24, embd_dim=8)


def _ecapa(seed=0, **kw):
    return init_weights_(EcapaTdnn(device="cpu", **{**NARROW, **kw}), seed)


def _feats(b=2, t=64, d=10, seed=1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, t, d)).astype(np.float32))
    mask = torch.from_numpy(np.arange(t)[None, :] < np.asarray([t, t - 21][:b])[:, None])
    return x, mask


@pytest.mark.parametrize("fused", [False, True])
def test_exported_program_equals_eager(tmp_path, fused):
    model = _ecapa()
    for blk in (model.layer2, model.layer3, model.layer4):
        blk.res2net.fused_inference = fused
    model.stats.fused_inference = fused
    paths = export_embed_fn(lambda x, m: model(x, m), feat_dim=10, out_dir=str(tmp_path),
                            bucket_lengths=(64,), batch_sizes=(2,), device="cpu")
    assert set(paths) == {"b2_t64"} and paths["b2_t64"].endswith("model_b2_t64.pt2")
    fn = load_embed_fn(paths["b2_t64"], device="cpu")
    x, mask = _feats()
    with torch.no_grad():
        want = model(x, mask)
    torch.testing.assert_close(fn(x, mask), want, atol=1e-6, rtol=0)


class _Kernels(nn.Module):
    """The three kernels' custom ops in one program."""

    def __init__(self, c=32, k=8, h=4):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.att = nn.ParameterList([nn.Parameter(torch.randn(s, generator=g) * 0.3) for s in
                                     ((c, k), (c, k), (c, k), (k,), (k,), (k,), (k, c), (c,))])
        self.res2 = nn.ParameterList([nn.Parameter(torch.randn(s, generator=g) * 0.3) for s in
                                      ((7, 3, h, h), (7, h), (7, h), (7, h))])

    def forward(self, x, mask):
        y = fused_res2_chain_op(x, *self.res2, 2)
        return (fused_attentive_stats_pool_op(y, *self.att, mask)
                + fused_stats_pooling_op(y, mask, 1e-10))


def test_kernel_custom_ops_survive_export_save_and_load(tmp_path):
    module = _Kernels()
    x, mask = _feats(t=40, d=32)
    program = torch.export.export(module, (x, mask))
    names = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"asv_subtools_tpu_torch.fused_res2_chain.default",
            "asv_subtools_tpu_torch.fused_attentive_stats_pool.default",
            "asv_subtools_tpu_torch.fused_stats_pooling.default"} <= names
    torch.export.save(program, tmp_path / "k.pt2")
    loaded = torch.export.load(tmp_path / "k.pt2").module()
    y = fused_res2_chain_plain(x, *module.res2, 2)
    want = fused_attentive_stats_pool_plain(y, *module.att, mask) + fused_stats_pooling_plain(y, mask, 1e-10)
    with torch.no_grad():
        torch.testing.assert_close(loaded(x, mask), want, atol=1e-6, rtol=0)


def test_a_fresh_process_loads_a_program_with_the_kernels(tmp_path):
    """load_embed_fn's module registers the custom ops itself: a process
    that imports only asv_subtools_tpu_torch.export loads and runs it."""
    module = _Kernels()
    x, mask = _feats(t=40, d=32)
    torch.export.save(torch.export.export(module, (x, mask)), tmp_path / "k.pt2")
    torch.save({"x": x, "mask": mask}, tmp_path / "in.pt")
    code = ("import sys, torch; from asv_subtools_tpu_torch.export import load_embed_fn; "
            f"d = torch.load({str(tmp_path / 'in.pt')!r}); "
            f"torch.save(load_embed_fn({str(tmp_path / 'k.pt2')!r}, device='cpu')(d['x'], d['mask']), "
            f"{str(tmp_path / 'out.pt')!r})")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    with torch.no_grad():
        torch.testing.assert_close(torch.load(tmp_path / "out.pt"), module(x, mask), atol=1e-6, rtol=0)


def test_load_embed_fn_refuses_another_device(tmp_path):
    model = _ecapa()
    paths = export_embed_fn(model, 10, str(tmp_path), bucket_lengths=(32,), batch_sizes=(1,), device="cpu")
    program = torch.export.load(paths["b1_t32"])
    assert {t.device.type for t in program.state_dict.values()} == {"cpu"}
    with pytest.raises(RuntimeError):  # no card here: the default device raises
        load_embed_fn(paths["b1_t32"])


def test_nnet_config_rebuilds_the_model(tmp_path):
    params = dict(NARROW)
    net = init_weights_(SpeakerNet(EcapaTdnn(device="cpu", **params), "margin_softmax", {"method": "aam"},
                                   num_targets=5), 2)
    state = init_train_state(net, get_optimizer("adamW", 1e-3), "cpu")
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), state, "final")
    cfg_path = write_nnet_config(str(tmp_path), "ecapa_tdnn", params, ckpt, feat_config={"num_bins": 10})
    import yaml

    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    assert list(cfg) == ["model_name", "model_params", "checkpoint", "feat_config"]
    module, variables, cfg = load_model_from_config(cfg_path, device="cpu")
    assert isinstance(module, EcapaTdnn) and cfg["feat_config"] == {"num_bins": 10}
    tree = {**variables["params"], **variables["batch_stats"]}
    module.load_state_dict({k[len("backbone."):]: v for k, v in tree.items() if k.startswith("backbone.")})
    x, mask = _feats()
    with torch.no_grad():
        assert torch.equal(module(x, mask), net.backbone.eval()(x, mask))


def _jax_leaves(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family,min_size", [("ecapa", 1024), ("ecapa", 64), ("conformer", 16)])
def test_quantize_matches_jax_leaf_by_leaf(family, min_size):
    if family == "ecapa":
        model = _ecapa(channels=32, mfa_conv=48)
    else:
        model = init_weights_(ConformerXvector(input_dim=20, embd_dim=8, attention_dim=16, attention_heads=2,
                                               linear_units=24, num_blocks=1, out_dim=24, device="cpu"), 0)
    sd = model.state_dict()
    got = quantize.quantize_params(sd, min_size=min_size)
    want = jquant.quantize_params(state_dict_to_variables(sd)["params"], min_size=min_size)
    qkeys = [k for k, v in got.items() if isinstance(v, dict)]
    assert any(k.endswith(".kernel") for k in qkeys) == (family == "ecapa")  # _SplitGlobalConv's [1, 3C, K]
    if family == "conformer":
        assert any(k.endswith("pos_bias_u") for k in qkeys)  # [H, Dh]: JAX's last axis, the port's too
    flat_want = _jax_leaves(want)
    n_int8 = 0
    for part in ("int8_values", "int8_scales"):
        as_jax = state_dict_to_variables({k: got[k][part] for k in qkeys})["params"]
        for path, leaf in _jax_leaves(as_jax).items():
            ref = flat_want[path + (part,)]
            assert leaf.dtype == ref.dtype and leaf.shape == ref.shape, path
            assert np.array_equal(leaf, ref), path
            n_int8 += 1
    assert n_int8 == 2 * sum(isinstance(v, dict) for v in jax.tree_util.tree_leaves(
        want, is_leaf=lambda n: isinstance(n, dict) and "int8_values" in n))
    for k, v in got.items():  # the rest stays as it was
        if not isinstance(v, dict):
            assert torch.equal(v, sd[k])


def test_quantized_ecapa_round_trip():
    model = _ecapa(channels=32, mfa_conv=48)
    sd = model.state_dict()
    q = quantize.quantize_params(sd, min_size=64)
    assert quantize.quantization_error(sd, q) < 0.01
    deq = EcapaTdnn(device="cpu", **{**NARROW, "channels": 32, "mfa_conv": 48})
    deq.load_state_dict(quantize.dequantize_params(q))
    x, mask = _feats()
    with torch.no_grad():
        a, b = model(x, mask).numpy(), deq(x, mask).numpy()
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() > 0.999, cos


def test_quantized_size_is_under_a_third_and_a_half():
    w = {"k.weight": torch.from_numpy(np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32))}
    q = quantize.quantize_params(w)["k.weight"]
    assert q["int8_values"].dtype == torch.int8 and tuple(q["int8_scales"].shape) == (256, 1)
    size = sum(t.numel() * t.element_size() for t in q.values())
    assert size < w["k.weight"].numel() * 4 / 3.5
