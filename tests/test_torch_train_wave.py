"""Train mode of the port's layers, the wave-input train step, SpecAugment,
and the fused inference flags under training.

Tolerances: train-mode BatchNorm in float64 to 1e-10 relative (outputs,
input gradients, running statistics; the same one-pass formula), in
float32 to 2e-5 (another summation order over B*T values, amplified by
the division by the batch std). The f32 wave-input step: loss within 1e-3
relative of the JAX step's (the fbank of both sides sums its DFT in
another order, CMVN and the f32 forward carry that), grad_norm within
1e-2. The fused-flag steps are compared for exact equality with the
unfused ones: train mode must take the same code path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.features import FbankOptions as JaxFbankOptions
from asv_subtools_tpu.features import MelOptions as JaxMelOptions
from asv_subtools_tpu.nn.norm import BatchNorm as JaxBatchNorm
from asv_subtools_tpu.nn.tdnn import ReluBatchNormTdnnLayer as JaxTdnnLayer
from asv_subtools_tpu.train.trainer import TrainState as JaxTrainState
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu.train.trainer import make_train_step as jax_make_train_step
from asv_subtools_tpu_torch.features import FbankOptions, MelOptions
from asv_subtools_tpu_torch.models import ecapa as port_ecapa
from asv_subtools_tpu_torch.nn import BatchNorm, ReluBatchNormTdnnLayer
from asv_subtools_tpu_torch.train import TrainStepConfig, device_spec_augment, make_train_step, sgd
from asv_subtools_tpu_torch.weights import load_variables, train_state_from_variables
from test_torch_train_step import (
    C,
    D,
    LR,
    SUBCENTER_TOPK,
    init_variables,
    jax_net,
    make_batch,
    port_batch,
    port_net,
)


def _bn_inputs(seed, masked, b=3, t=17, c=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, c)) * 2.0 + 0.5
    w = rng.normal(size=(b, t, c))
    mask = np.arange(t)[None, :] < np.array([t, 11, 4])[:, None] if masked else None
    return x, w, mask


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_mode_matches_jax(masked, dtype):
    """Output, input gradient of sum(y * w) and the updated running
    statistics (momentum 0.5, unbiased running variance)."""
    x, w, mask = _bn_inputs(0, masked)
    rng = np.random.default_rng(1)
    c = x.shape[-1]
    scale, bias = rng.uniform(0.5, 1.5, c), rng.normal(size=c) * 0.2
    mean0, var0 = rng.normal(size=c) * 0.1, rng.uniform(0.5, 2.0, c)
    tol = 1e-10 if dtype == "float64" else 2e-5
    with jax.enable_x64(dtype == "float64"):
        jdt = jnp.dtype(dtype)
        v = {"params": {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)},
             "batch_stats": {"mean": jnp.asarray(mean0, jdt), "var": jnp.asarray(var0, jdt)}}
        jm = None if mask is None else jnp.asarray(mask)

        def f(xx):
            y, mut = JaxBatchNorm(momentum=0.5).apply(v, xx, train=True, mask=jm, mutable=["batch_stats"])
            return jnp.sum(y * jnp.asarray(w, jdt)), (y, mut["batch_stats"])

        (_, (jy, jstats)), jgrad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x, jdt))
        jy, jstats, jgrad = jax.device_get((jy, jstats, jgrad))
    tdt = getattr(torch, dtype)
    bn = BatchNorm(c, momentum=0.5).to(tdt).train()
    with torch.no_grad():
        bn.scale.copy_(torch.as_tensor(scale))
        bn.bias.copy_(torch.as_tensor(bias))
        bn.mean.copy_(torch.as_tensor(mean0))
        bn.var.copy_(torch.as_tensor(var0))
    xt = torch.as_tensor(x, dtype=tdt).transpose(1, 2).requires_grad_()
    y = bn(xt, None if mask is None else torch.as_tensor(mask))
    (y * torch.as_tensor(w, dtype=tdt).transpose(1, 2)).sum().backward()
    np.testing.assert_allclose(y.detach().transpose(1, 2).numpy(), jy, rtol=tol, atol=tol)
    np.testing.assert_allclose(xt.grad.transpose(1, 2).numpy(), jgrad, rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.mean.numpy(), jstats["mean"], rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.var.numpy(), jstats["var"], rtol=tol, atol=tol)


def test_batchnorm_under_functional_call_leaves_the_inputs_alone():
    """Under torch.func.functional_call the new running statistics land in
    the dict handed in; the tensors handed in are not written."""
    bn = BatchNorm(4, momentum=0.5).double().train()
    x = torch.randn(2, 4, 9, dtype=torch.float64)
    old = {"mean": torch.zeros(4, dtype=torch.float64), "var": torch.ones(4, dtype=torch.float64)}
    tensors = {**dict(bn.named_parameters()), **old}
    torch.func.functional_call(bn, tensors, (x,))
    assert torch.equal(old["mean"], torch.zeros(4, dtype=torch.float64))
    np.testing.assert_allclose(tensors["mean"].numpy(), 0.5 * x.mean((0, 2)).numpy(), rtol=1e-12)
    assert torch.equal(bn.mean, torch.zeros(4, dtype=torch.float64))


@pytest.mark.parametrize("masked", [False, True])
def test_tdnn_layer_train_mode_matches_jax(masked):
    """relu then BN with masked batch statistics, after a k=3 dilated conv."""
    x, _, mask = _bn_inputs(2, masked, c=8)
    with jax.enable_x64():
        layer = JaxTdnnLayer(5, context=(-2, 0, 2), momentum=0.5)
        v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(v))
        y, mut = layer.apply(v, jnp.asarray(x), train=True, mask=None if mask is None else jnp.asarray(mask),
                             mutable=["batch_stats"])
        y, stats = np.asarray(y), jax.device_get(mut["batch_stats"])
    port = ReluBatchNormTdnnLayer(8, 5, (-2, 0, 2), momentum=0.5).double()
    load_variables(port, v)
    got = port.train()(torch.as_tensor(x).transpose(1, 2), None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(got.detach().transpose(1, 2).numpy(), y, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(port.act_bn.bn.mean.numpy(), stats["act_bn"]["bn"]["mean"], rtol=1e-10)
    np.testing.assert_allclose(port.act_bn.bn.var.numpy(), stats["act_bn"]["bn"]["var"], rtol=1e-10)


def _waves(seed, b=4, seconds=0.6):
    rng = np.random.default_rng(seed)
    s = int(16000 * seconds)
    wave = (rng.standard_normal((b, s)) * 1000.0).astype(np.float32)
    lengths = rng.integers(s // 2, s + 1, size=b)
    lengths[0] = s
    return wave, rng.integers(0, C, size=b), np.arange(s)[None, :] < lengths[:, None]


def test_wave_input_step_f32_matches_jax():
    """The f32 step on raw waves: the fused fbank (interpret mode in JAX,
    the plain version here), frame masks from the sample masks, masked
    CMVN, the forward and the loss."""
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), init_variables(jax_net(SUBCENTER_TOPK)))
    wave, y, mask = _waves(0)
    net = jax_net(SUBCENTER_TOPK)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                          opt_state=optax.sgd(LR).init(params))
    jstep = jax.jit(jax_make_train_step(net, optax.sgd(LR), config=JaxStepConfig(
        compute_dtype=jnp.float32, wave_input=True, fbank_opts=JaxFbankOptions(mel_opts=JaxMelOptions(num_bins=D)))))
    _, jm = jstep(state, {"x": jnp.asarray(wave), "y": jnp.asarray(y, jnp.int32), "mask": jnp.asarray(mask)},
                  jax.random.PRNGKey(0))
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}

    pnet = port_net(SUBCENTER_TOPK, dtype=torch.float32)
    pstate = train_state_from_variables(pnet, {"step": 0, **variables, "opt_state": {"count": 0}}, device="cpu")
    pstep = make_train_step(pnet, sgd(LR), config=TrainStepConfig(
        compute_dtype=torch.float32, wave_input=True, fbank_opts=FbankOptions(mel_opts=MelOptions(num_bins=D))))
    _, pm = pstep(pstate, port_batch(wave, y, mask, torch.float32), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(pm["loss"]), jm["loss"], rtol=1e-3)
    np.testing.assert_allclose(float(pm["grad_norm"]), jm["grad_norm"], rtol=1e-2)
    assert float(pm["skipped"]) == 0.0


def test_spec_augment_bands_and_determinism():
    b, t, d = 64, 40, 20
    feats = torch.ones(b, t, d)
    out = device_spec_augment(feats, torch.Generator().manual_seed(3), num_t_mask=1, num_f_mask=1,
                              max_t=5, max_f=3)
    time_zero = (out == 0).all(-1).sum(-1)  # frames zeroed across every bin
    freq_zero = (out == 0).all(-2).sum(-1)
    assert int(time_zero.min()) >= 1 and int(time_zero.max()) <= 5
    assert int(freq_zero.min()) >= 1 and int(freq_zero.max()) <= 3
    assert len(set(time_zero.tolist())) > 1  # widths vary from row to row
    # each band is one run of consecutive frames
    for row in (out == 0).all(-1):
        idx = torch.nonzero(row)[:, 0]
        assert int(idx[-1] - idx[0]) + 1 == len(idx)
    again = device_spec_augment(feats, torch.Generator().manual_seed(3), max_t=5, max_f=3)
    assert torch.equal(out, again)
    other = device_spec_augment(feats, torch.Generator().manual_seed(4), max_t=5, max_f=3)
    assert not torch.equal(out, other)


def test_spec_augment_skips_a_band_as_wide_as_its_axis():
    """A width drawn from [1, max] that reaches the axis size skips the band:
    on one frame every time band is skipped, on one bin every frequency band."""
    g = torch.Generator().manual_seed(0)
    one_frame = device_spec_augment(torch.ones(32, 1, 20), g, num_t_mask=2, num_f_mask=0, max_t=4)
    assert torch.equal(one_frame, torch.ones(32, 1, 20))
    one_bin = device_spec_augment(torch.ones(32, 30, 1), g, num_t_mask=0, num_f_mask=2, max_f=4)
    assert torch.equal(one_bin, torch.ones(32, 30, 1))


def test_fused_flags_take_the_unfused_path_in_train_mode(monkeypatch):
    """With every fused flag set, a train step equals the unfused step
    exactly and reaches neither fused wrapper; in eval mode the flags do
    reach them."""
    variables = init_variables(jax_net(SUBCENTER_TOPK), seed=2)
    x, y, mask = make_batch(3, True)
    calls = {"res2": 0, "pool": 0}
    res2, pool = port_ecapa.fused_res2_chain, port_ecapa.fused_attentive_stats_pool

    def counting(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(port_ecapa, "fused_res2_chain", counting("res2", res2))
    monkeypatch.setattr(port_ecapa, "fused_attentive_stats_pool", counting("pool", pool))
    results = {}
    for fused in (False, True):
        net = port_net(SUBCENTER_TOPK, dtype=torch.float32)
        for m in net.modules():
            if isinstance(m, (port_ecapa.Res2NetBlock, port_ecapa.EcapaAttentiveStatsPool)):
                m.fused_inference = fused
        state = train_state_from_variables(
            net, {"step": 0, **jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables),
                  "opt_state": {"count": 0}}, device="cpu")
        step = make_train_step(net, sgd(LR), config=TrainStepConfig(compute_dtype=torch.float32))
        results[fused] = step(state, port_batch(x, y, mask, torch.float32), torch.Generator().manual_seed(0))
        assert calls == {"res2": 0, "pool": 0}
    (s0, m0), (s1, m1) = results[False], results[True]
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    for coll in ("params", "batch_stats"):
        for k, v in getattr(s0, coll).items():
            assert torch.equal(v, getattr(s1, coll)[k]), k
    net.eval()
    with torch.no_grad():
        net.embed(torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(mask))
    assert calls == {"res2": 3, "pool": 1}


@pytest.mark.parametrize("position", ["near", "far"])
def test_ecapa_with_fc1_train_mode_matches_jax(position):
    """Train-mode forward of the backbone with its optional fc1 layer
    (fc1_bn and fc2_bn on unmasked batch statistics), float64: the
    embedding at `position` and every updated running statistic."""
    from asv_subtools_tpu.models.ecapa import EcapaTdnn as JaxEcapa
    from asv_subtools_tpu_torch.models import EcapaTdnn

    small = dict(channels=32, mfa_conv=96, embd_dim=16, fc1=True)
    x, _, mask = make_batch(4, True)
    with jax.enable_x64():
        jm = JaxEcapa(**small)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=jnp.asarray(mask), train=False)
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(v))
        ref, mut = jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=True, position=position,
                            mutable=["batch_stats"])
        ref, stats = np.asarray(ref), jax.device_get(mut["batch_stats"])
    port = load_variables(EcapaTdnn(input_dim=D, device="cpu", **small).double(), v).train()
    got = port(torch.as_tensor(x), torch.as_tensor(mask), position=position).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
    # "far" returns before fc1_bn and fc2_bn see the batch
    names = ["bn_stats", "fc1_bn", "fc2_bn"] if position == "near" else ["bn_stats"]
    for name in names:
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(getattr(getattr(port, name), leaf).numpy(), stats[name][leaf], rtol=1e-9)


def test_dropout_draws_from_the_generator_in_train_mode_only():
    """aug_dropout / tail_dropout: each value kept with probability 1 - rate
    and scaled by 1 / (1 - rate), the same mask from the same generator;
    eval mode passes x through."""
    x = torch.ones(200, 50)
    a = port_ecapa.dropout(x, 0.3, torch.Generator().manual_seed(5))
    b = port_ecapa.dropout(x, 0.3, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    from asv_subtools_tpu_torch.models import EcapaTdnn

    net = EcapaTdnn(input_dim=D, channels=16, mfa_conv=32, embd_dim=8, aug_dropout=0.5, tail_dropout=0.5,
                    device="cpu")
    xs = torch.randn(4, 30, D)
    with torch.no_grad():
        assert torch.equal(net.eval()(xs), net(xs))
        g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
        net.train()
        assert torch.equal(net(xs, generator=g1), net(xs, generator=g2))
