"""EcapaTdnn's pooling options (``pooling``, ``pooling_params``) against the
JAX model, on the same carried weights.

The zoo's mqmha (the roadmap presets' 2 queries x 2 heads), mqmha-linear,
xi and statistics, and "ecpa-attentive" with time_attention False and
hidden_size 64, masked and not: eval mode in f32 at atol 1e-4 (the ECAPA
embedding tolerance of tests/test_torch_ecapa.py) and in f64 at 1e-10;
one train-mode forward in f64 (output at 1e-8, every new running
statistic at 1e-10). Inside an ECAPA only mqmha and mqmha-linear get the train flag, as
in both JAX ECAPAs: the xi pooling's BatchNorm normalises with its running
statistics in train mode and never updates them. One f64 SGD step of the
MQMHA ECAPA against JAX's step leaf by leaf at 1e-6; weights.py round
trips. Small size: channels 32, MFA 96, 24 bins, T = 60, B = 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.models import EcapaAttentiveStatsPool, EcapaTdnn, Res2NetBlock, SpeakerNet
from asv_subtools_tpu_torch.nn import MQMHASP, XiVectorPooling
from asv_subtools_tpu_torch.train import TrainStepConfig, sgd
from asv_subtools_tpu_torch.weights import load_variables, state_dict_to_variables, variables_to_state_dict
from test_torch_train_step import (AAM, C, D, LR, SMALL, assert_metrics_close, assert_states_close, init_variables,
                                   make_batch, run_jax, run_port)

torch.set_num_threads(2)

ATOL = 1e-4
POOLINGS = {
    "mqmha": dict(pooling="mqmha", pooling_params={"num_q": 2, "num_head": 2}),
    "mqmha_linear": dict(pooling="mqmha-linear", pooling_params={"num_q": 2, "num_head": 2}),
    "xi": dict(pooling="xi", pooling_params={"hidden_size": 32}),
    "statistics": dict(pooling="statistics"),
    "attentive_no_time": dict(pooling="ecpa-attentive", pooling_params={"time_attention": False, "hidden_size": 64}),
}


def _jax_net(case, loss=AAM):
    return JaxSpeakerNet(JaxEcapa(**SMALL, **POOLINGS[case]), *loss, num_targets=C)


def _port_backbone(case, dtype=torch.float32):
    return EcapaTdnn(D, **SMALL, **POOLINGS[case], device="cpu").to(dtype)


@pytest.fixture(scope="module")
def pooling_variables():
    """f64 {"params", "batch_stats"} of each case's backbone, randomised."""
    return {case: init_variables(_jax_net(case), seed=11) for case in POOLINGS}


def _backbone_vars(v, dtype):
    return {coll: jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), v[coll]["backbone"])
            for coll in ("params", "batch_stats")}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", list(POOLINGS))
def test_eval_matches_jax(pooling_variables, case, masked, dtype):
    v = _backbone_vars(pooling_variables[case], dtype)
    port = load_variables(_port_backbone(case, getattr(torch, dtype)), v)
    x, _, mask = make_batch(12, masked)
    x = x.astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        ref = np.asarray(JaxEcapa(**SMALL, **POOLINGS[case]).apply(
            v, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape == (x.shape[0], SMALL["embd_dim"]) and ref.dtype == dtype
    np.testing.assert_allclose(got, ref, atol=ATOL if dtype == "float32" else 1e-10)


@pytest.mark.parametrize("case", list(POOLINGS))
def test_train_mode_matches_jax(pooling_variables, case):
    """In f64: the train-mode bn_stats z-scores a batch of 4 rows, which
    turns f32 rounding into errors of ~1e-3 (tests/test_torch_train_step.py)."""
    v = _backbone_vars(pooling_variables[case], np.float64)
    port = load_variables(_port_backbone(case, torch.float64), v).train()
    x, _, mask = make_batch(13, True)
    with jax.enable_x64():
        ref, upd = JaxEcapa(**SMALL, **POOLINGS[case]).apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=True,
                                                             mutable=["batch_stats"])
        ref, upd = jax.device_get((ref, upd))
    got = port(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-8)
    new = {jax.tree_util.keystr(p): a for p, a in
           jax.tree_util.tree_leaves_with_path(state_dict_to_variables(port.state_dict())["batch_stats"])}
    want = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(
        jax.device_get(upd["batch_stats"]))}
    assert sorted(new) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(new[key], value, atol=1e-10, err_msg=key)


def test_xi_pooling_keeps_its_running_statistics_in_train_mode(pooling_variables):
    """The JAX quirk the port keeps: inside an ECAPA the xi pooling's
    lin1_relu_bn normalises with its running statistics in train mode and
    leaves them as they were, while every other BatchNorm updates."""
    v = _backbone_vars(pooling_variables["xi"], np.float32)
    port = load_variables(_port_backbone("xi"), v)
    net = SpeakerNet(port, *AAM, num_targets=C)
    net.train()
    bn = port.stats.lin1_relu_bn.act_bn.bn
    assert port.training and port.mfa.training and not bn.training
    before = {k: t.clone() for k, t in port.state_dict().items()}
    x, y, mask = make_batch(14, True)
    net(torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y), torch.as_tensor(mask))
    after = port.state_dict()
    for key in ("stats.lin1_relu_bn.act_bn.bn.mean", "stats.lin1_relu_bn.act_bn.bn.var"):
        assert torch.equal(after[key], before[key]), key
    assert not torch.equal(after["mfa.act_bn.bn.mean"], before["mfa.act_bn.bn.mean"])
    upd = JaxEcapa(**SMALL, **POOLINGS["xi"]).apply(v, jnp.asarray(x, jnp.float32), mask=jnp.asarray(mask),
                                                    train=True, mutable=["batch_stats"])[1]["batch_stats"]
    np.testing.assert_array_equal(np.asarray(upd["stats"]["lin1_relu_bn"]["act_bn"]["bn"]["mean"]),
                                  v["batch_stats"]["stats"]["lin1_relu_bn"]["act_bn"]["bn"]["mean"])
    # the model's eval() and train() keep it so; the pooling alone trains its BN
    port.eval()
    port.train()
    assert not bn.training
    assert XiVectorPooling(8, hidden_size=4).train().lin1_relu_bn.training


def test_pooling_widths():
    """bn_stats and fc2 take the pooling's output width: 6144 for mqmha with
    2 queries at MFA 1536 (ecapa_roadmap.yaml); the attentive pooling's BN
    keeps momentum 0.1 whatever the model's."""
    roadmap = EcapaTdnn(80, channels=64, mfa_conv=1536, **POOLINGS["mqmha"], device="cpu")
    assert isinstance(roadmap.stats, MQMHASP) and roadmap.bn_stats.mean.shape == (6144,)
    assert roadmap.fc2_affine.in_features == 6144
    att = EcapaTdnn(D, **SMALL, **POOLINGS["attentive_no_time"], momentum=0.3, device="cpu")
    assert isinstance(att.stats, EcapaAttentiveStatsPool) and not att.stats.time_attention
    assert att.stats.att1.out_channels == 64 and att.stats.att_bn.momentum == 0.1 and att.bn_stats.momentum == 0.3
    assert EcapaTdnn(D, **SMALL, pooling="xi", device="cpu").bn_stats.mean.shape == (96,)


def test_fused_res2_chains_serve_the_mqmha_model(pooling_variables, monkeypatch):
    """Res2NetBlock.fused_inference is the same with any pooling: the MQMHA
    ECAPA with its three chains fused (the kernel's plain version on the
    CPU) matches it unfused."""
    from asv_subtools_tpu_torch.models import ecapa as port_ecapa

    calls = []
    real = port_ecapa.fused_res2_chain
    monkeypatch.setattr(port_ecapa, "fused_res2_chain", lambda *a, **k: calls.append(1) or real(*a, **k))
    port = load_variables(_port_backbone("mqmha"), _backbone_vars(pooling_variables["mqmha"], np.float32))
    x, _, mask = make_batch(15, True)
    xt, mt = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(mask)
    with torch.no_grad():
        ref = port(xt, mt)
        for m in port.modules():
            if isinstance(m, Res2NetBlock):
                m.fused_inference = True
        got = port(xt, mt)
    assert len(calls) == 3
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("case", list(POOLINGS))
def test_weights_round_trip_bit_for_bit(pooling_variables, case):
    v = pooling_variables[case]
    back = state_dict_to_variables(variables_to_state_dict(v))
    for coll in v:
        flat = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(back[coll])}
        for path, a in jax.tree_util.tree_leaves_with_path(v[coll]):
            assert np.array_equal(flat.pop(jax.tree_util.keystr(path)), a)
        assert not flat
    load_variables(SpeakerNet(_port_backbone(case), *AAM, num_targets=C), v)


@pytest.mark.parametrize("masked", [False, True])
def test_mqmha_sgd_step_matches_jax_leaf_by_leaf(pooling_variables, masked):
    batches = [make_batch(16, masked)]
    jax_state, jax_m = run_jax(_jax_net("mqmha"), optax.sgd(LR), pooling_variables["mqmha"], batches,
                               JaxStepConfig(compute_dtype=jnp.float64))
    port_state, port_m = run_port(SpeakerNet(_port_backbone("mqmha"), *AAM, num_targets=C).double(), sgd(LR),
                                  pooling_variables["mqmha"], batches, TrainStepConfig(compute_dtype=torch.float64))
    assert_metrics_close(port_m[0], jax_m[0])
    assert_states_close(port_state, jax_state, 1e-6)
