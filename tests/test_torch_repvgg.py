"""The port's RepVGG (nn/repvgg.py), its reparameterization and the RepVGG
x-vector against the JAX package, on the same carried weights.

* Each block type ("vgg": 3x3 + 1x1 + identity BN; "spk": 3x3 + dilated
  3x3 + identity BN) in eval and train mode (the train-mode running
  statistics too), with a stride, a width change, groups and SE; the
  trunk with an override_groups_map. f32, atol 1e-4 (sums in another
  order through the convolutions), as tests/test_torch_resnet.py.
* The reparameterization against JAX's repvgg_model_convert on the same
  variables in float64: every folded kernel and bias within 1e-10.
* The deployed port model against the train-shape port model and against
  JAX's deployed model (f32, atol 1e-4), the x-vector at every position.
* One f64 SGD step of SpeakerNet(RepVggXvector) against JAX's step leaf by
  leaf at 1e-6 of each leaf's scale (tests/test_torch_train_step.py).
* weights.py carries the train and deploy trees there and back bit for bit.

Small size: blocks (1, 1, 1, 1) or (1, 2, 1, 1), base 8, 24 bins,
T = 45 (the trunk gives 6 frames: the mask is subsampled with stride 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.models.resnet_xvector import RepVggXvector as JaxRepVggXvector
from asv_subtools_tpu.nn import repvgg as jrep
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.models import MODELS, RepVggXvector, SpeakerNet, deploy_repvgg_xvector
from asv_subtools_tpu_torch.nn import RepVGG, RepVGGBlock, repvgg_a0, repvgg_b1, repvgg_model_convert
from asv_subtools_tpu_torch.train import TrainStepConfig, sgd
from asv_subtools_tpu_torch.weights import load_variables, state_dict_to_variables, variables_to_state_dict
from test_torch_train_step import C, D, LR, assert_metrics_close, assert_states_close, init_variables, make_batch, \
    run_jax, run_port

torch.set_num_threads(2)

B, T, F = 3, 45, 24
LENGTHS = (45, 30, 12)
ATOL = 1e-4
SMALL = dict(num_blocks=(1, 1, 1, 1), base_channels=8, width_multiplier=(1.0, 1.0, 1.0, 2.0))


def _randomize(v, rng, dtype=np.float32):
    for key, val in v.items():
        if isinstance(val, dict):
            _randomize(val, rng, dtype)
        elif key in ("bias", "mean"):
            v[key] = (rng.normal(size=val.shape) * 0.1).astype(dtype)
        elif key == "scale":
            v[key] = rng.uniform(0.8, 1.2, size=val.shape).astype(dtype)
        elif key == "var":
            v[key] = rng.uniform(0.5, 2.0, size=val.shape).astype(dtype)
        else:
            v[key] = np.asarray(val, dtype)


def _variables(module, x, seed=0, dtype=np.float32, **kw):
    v = module.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x, jnp.float32), **kw)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    _randomize(v, np.random.default_rng(seed), dtype)
    return v


def _maps(seed, c, t=19, f=12):
    x = np.random.default_rng(seed).normal(size=(2, t, f, c)).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _inputs(seed=0):
    x = np.random.default_rng(seed).normal(size=(B, T, F)).astype(np.float32)
    return x, np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]


BLOCKS = {
    "identity": dict(c_in=8, out=8, stride=(1, 1)),
    "strided": dict(c_in=8, out=16, stride=(2, 2)),
    "wider": dict(c_in=8, out=12, stride=(1, 1)),
    "grouped": dict(c_in=8, out=8, stride=(1, 1), groups=2),
    "grouped_strided": dict(c_in=8, out=16, stride=(2, 2), groups=4),
    "se": dict(c_in=8, out=8, stride=(1, 1), use_se=True),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", list(BLOCKS))
@pytest.mark.parametrize("block_type", ["vgg", "spk"])
def test_block_matches_jax(block_type, case, train):
    kw = dict(BLOCKS[case])
    c_in, out, stride = kw.pop("c_in"), kw.pop("out"), kw.pop("stride")
    jm = jrep.RepVGGBlock(out, stride=stride, block_type=block_type, momentum=0.5, **kw)
    port = RepVGGBlock(c_in, out, stride, block_type=block_type, momentum=0.5, **kw)
    x, xt = _maps(1, c_in)
    v = _variables(jm, x, 1, train=False)
    load_variables(port, v)
    assert port.has_identity == (case in ("identity", "grouped", "se"))
    if train:
        ref, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        got = port.train()(xt)
        new = state_dict_to_variables(port.state_dict())["batch_stats"]
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(new),
                                     jax.tree_util.tree_leaves_with_path(jax.device_get(upd["batch_stats"]))):
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=jax.tree_util.keystr(path))
    else:
        ref = jm.apply(v, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = port.eval()(xt)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=ATOL)


TRUNKS = {
    "spk": dict(block="spk"),
    "vgg": dict(block="vgg"),
    "vgg_groups_se": dict(block="vgg", num_blocks=(1, 2, 1, 1), override_groups_map={2: 2, 3: 4}, use_se=True),
    "spk_groups": dict(block="spk", num_blocks=(1, 2, 1, 1), override_groups_map={1: 2, 3: 2}),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_matches_jax(name, train):
    kw = {**SMALL, **TRUNKS[name]}
    x, _ = _inputs(2)
    jm = jrep.RepVGG(**kw)
    v = _variables(jm, x, 2, train=False)
    port = RepVGG(**kw)
    load_variables(port, v)
    if train:
        ref, _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        got = port.train()(torch.from_numpy(x)).detach()
    else:
        ref = jm.apply(v, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape == (B, ref.shape[1], port.output_dim(F))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_first_width_is_the_references_constant():
    """min(64, int(base * width[0])), not base_channels."""
    assert RepVGG(base_channels=128, width_multiplier=(1, 1, 1, 1)).stage0.out_channels == 64
    assert RepVGG(base_channels=32, width_multiplier=(0.75, 1, 1, 1)).stage0.out_channels == 24
    assert repvgg_a0().stage0.out_channels == 48 and repvgg_b1().stage0.out_channels == 64
    assert len(repvgg_a0().blocks) == 22 and repvgg_b1().out_planes == 2048


@pytest.mark.parametrize("name", list(TRUNKS))
def test_reparameterization_matches_jax_in_f64(name):
    kw = {**SMALL, **TRUNKS[name]}
    x, _ = _inputs(3)
    jm = jrep.RepVGG(**kw)
    v = _variables(jm, x, 3, dtype=np.float64, train=False)
    with jax.enable_x64():
        ref = jax.device_get(jrep.repvgg_model_convert(v, jm))
    port = RepVGG(**kw).double()
    load_variables(port, v)
    got = repvgg_model_convert(port)
    want = variables_to_state_dict({"params": jax.tree_util.tree_map(np.array, ref["params"])})
    assert sorted(got) == sorted(want)
    assert sorted(got) == sorted(RepVGG(**kw, deploy=True).state_dict())
    for key, value in want.items():
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=0, atol=1e-10, err_msg=key)


def _xvector_pair(seed, **kw):
    jm = JaxRepVggXvector(embd_dim=16, **SMALL, **kw)
    x, mask = _inputs(seed)
    v = _variables(jm, x, seed, train=False)
    port = RepVggXvector(F, embd_dim=16, **SMALL, **kw, device="cpu")
    load_variables(port, v)
    return jm, v, port, x, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("position", ["near", "near_affine"])
@pytest.mark.parametrize("block", ["spk", "vgg"])
def test_xvector_and_its_deployed_form_match_jax(block, position, masked):
    jm, v, port, x, mask = _xvector_pair(4, block=block)
    m = jnp.asarray(mask) if masked else None
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=m, train=False, position=position))
    jdeploy = JaxRepVggXvector(embd_dim=16, deploy=True, block=block, **SMALL)
    trunk = jrep.RepVGG(block=block, **SMALL)
    folded = jrep.repvgg_model_convert({"params": v["params"]["repvgg"], "batch_stats": v["batch_stats"]["repvgg"]},
                                       trunk)
    jv = {"params": {**v["params"], "repvgg": folded["params"]},
          "batch_stats": {k: s for k, s in v["batch_stats"].items() if k != "repvgg"}}
    ref_deploy = np.asarray(jdeploy.apply(jv, jnp.asarray(x), mask=m, train=False, position=position))
    deployed = deploy_repvgg_xvector(port)
    assert all(blk.deploy for blk in deployed.repvgg.blocks)
    tm = torch.from_numpy(mask) if masked else None
    with torch.no_grad():
        got = port(torch.from_numpy(x), tm, position=position).numpy()
        got_deploy = deployed(torch.from_numpy(x), tm, position=position).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got_deploy, ref_deploy, atol=ATOL)
    np.testing.assert_allclose(got_deploy, got, atol=ATOL)


def test_deployed_model_keeps_the_device_type_and_pooling_flag():
    port = RepVggXvector(F, embd_dim=16, pooling_params={"fused_inference": True}, **SMALL, device="cpu").double()
    deployed = deploy_repvgg_xvector(port)
    assert next(deployed.parameters()).dtype == torch.float64 and deployed.head.stats.fused_inference
    assert not deployed.training
    with pytest.raises(ValueError, match="deployed already"):
        repvgg_model_convert(deployed.repvgg)


def test_fused_pooling_flag_serves_through_the_fused_path(monkeypatch):
    """pooling_params={"fused_inference": True}: eval mode goes through the
    fused wrapper (its plain version on the CPU), train mode does not."""
    from asv_subtools_tpu_torch.nn import pooling as port_pooling

    calls = []
    real = port_pooling.fused_stats_pooling
    monkeypatch.setattr(port_pooling, "fused_stats_pooling", lambda *a, **k: calls.append(1) or real(*a, **k))
    jm, v, _, x, mask = _xvector_pair(5)
    port = load_variables(RepVggXvector(F, embd_dim=16, pooling_params={"fused_inference": True}, **SMALL,
                                        device="cpu"), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=False))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert len(calls) == 1
    port.train()(torch.from_numpy(x), torch.from_numpy(mask))
    assert len(calls) == 1


def test_models_table_builds_it_with_the_references_defaults():
    model = MODELS["repvgg_xvector"](input_dim=80, device="cpu")
    assert type(model) is RepVggXvector and model.embd_dim == 256
    assert model.repvgg.block == "spk" and model.repvgg.num_blocks == (2, 4, 14, 1)
    assert model.repvgg.out_planes == 640 and model.repvgg.output_dim(80) == 6400
    assert model.head.fc2_bn.momentum == model.repvgg.stage1_0.dense_bn.momentum == 0.5
    assert model.repvgg.stage0.dil_conv.dilation == (2, 2) and model.repvgg.stage0.dil_conv.padding == (2, 2)


@pytest.mark.parametrize("deploy", [False, True])
def test_weights_round_trip_bit_for_bit(deploy):
    jm = JaxRepVggXvector(embd_dim=16, deploy=deploy, use_se=True, **SMALL)
    v = _variables(jm, _inputs(6)[0], 6, train=False)
    back = state_dict_to_variables(variables_to_state_dict(v))
    for coll in v:
        flat = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(back[coll])}
        for path, a in jax.tree_util.tree_leaves_with_path(v[coll]):
            assert np.array_equal(flat.pop(jax.tree_util.keystr(path)), a)
        assert not flat
    port = RepVggXvector(F, embd_dim=16, deploy=deploy, use_se=True, **SMALL, device="cpu")
    load_variables(port, v)  # every leaf consumed, no parameter unset
    assert any(k.endswith("reparam.weight") for k in port.state_dict()) == deploy


# -- the train step -------------------------------------------------------------

STEP = dict(num_blocks=(1, 1, 1, 1), base_channels=4, width_multiplier=(1.0, 1.0, 1.0, 2.0), embd_dim=16)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block", ["spk", "vgg"])
def test_sgd_step_matches_jax_leaf_by_leaf(block, masked):
    head = ("margin_softmax", {"method": "aam", "m": 0.2})  # repvgg.yaml's AAM, f64 end to end
    jnet = JaxSpeakerNet(JaxRepVggXvector(block=block, **STEP), *head, num_targets=C)
    pnet = SpeakerNet(RepVggXvector(D, block=block, **STEP, device="cpu"), *head, num_targets=C).double()
    variables = init_variables(jnet, seed=7)
    batches = [make_batch(50, masked)]
    jax_state, jax_m = run_jax(jnet, optax.sgd(LR), variables, batches, JaxStepConfig(compute_dtype=jnp.float64))
    port_state, port_m = run_port(pnet, sgd(LR), variables, batches, TrainStepConfig(compute_dtype=torch.float64))
    assert_metrics_close(port_m[0], jax_m[0])
    assert_states_close(port_state, jax_state, 1e-6)
