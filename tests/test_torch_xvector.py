"""The port's TDNN x-vector family against the JAX package, on the same weights.

Modules: the non-affine BatchNorm, every TdnnAffine variant (even and
irregular contexts, pad, stride, groups, no bias), the TDNN layer's
options, SEBlock and FTdnnBlock, the semi-orthogonal update and the four
x-vectors (Xvector, SnowdarXvector, ExtendedXvector, FactoredXvector) in
eval mode at every ``position``, masked and not. Inputs are seeded numpy
[3, 37, 24] (widths 16, the F-TDNN at width 0.0625); biases, BN affines
and running statistics are randomised. Tolerances: 1e-5 absolute in f32
(sums in another order), 1e-10 for the f64 semi-orthogonal update.

The train step: one f64 SGD step of each family from the same state on
the same batch against JAX's make_train_step, leaf by leaf to 1e-6 of
each leaf's scale (the helpers and tolerances of
tests/test_torch_train_step.py), and four F-TDNN steps with
``use_semi_orth``, so that the step that applies the constraint (step 0)
and the three that skip it are both held.

weights.py: every family's JAX tree crosses to the port's state_dict and
back bit for bit, every leaf consumed once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models import xvector as jxv
from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.nn import tdnn as jtdnn
from asv_subtools_tpu.nn.norm import BatchNorm as JaxBatchNorm
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu_torch.models import MODELS, SpeakerNet
from asv_subtools_tpu_torch.models import xvector as pxv
from asv_subtools_tpu_torch.nn import BatchNorm, tdnn as ptdnn
from asv_subtools_tpu_torch.train import TrainStepConfig, sgd
from asv_subtools_tpu_torch.weights import (
    init_weights_,
    load_variables,
    state_dict_to_variables,
    variables_to_state_dict,
)
from test_torch_train_step import (
    C,
    D,
    LR,
    assert_metrics_close,
    assert_states_close,
    init_variables,
    make_batch,
    run_jax,
    run_port,
)

torch.set_num_threads(2)

B, T, F = 3, 37, 24
LENGTHS = (37, 20, 9)
ATOL = 1e-5
AM = ("margin_softmax", {"method": "am", "m": 0.2})


def _randomize(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif key in ("bias", "mean"):
            tree[key] = (rng.normal(size=val.shape) * 0.1).astype(val.dtype)
        elif key == "scale":
            tree[key] = rng.uniform(0.8, 1.2, size=val.shape).astype(val.dtype)
        elif key == "var":
            tree[key] = rng.uniform(0.5, 2.0, size=val.shape).astype(val.dtype)


def _variables(module, *args, seed=0, **kw):
    v = module.init({"params": jax.random.PRNGKey(seed)}, *map(jnp.asarray, args), **kw)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    _randomize(v, np.random.default_rng(seed + 100))
    return v


def _inputs(seed=0, d=F):
    x = np.random.default_rng(seed).normal(size=(B, T, d)).astype(np.float32)
    return x, np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]


def _port_bct(x):
    """[B, T, D] numpy -> the port's [B, D, T] tensor."""
    return torch.from_numpy(x).transpose(1, 2).contiguous()


# -- BatchNorm without affine ------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_without_affine_matches_jax(train, masked):
    x, mask = _inputs(1)
    jm = JaxBatchNorm(momentum=0.5, use_scale=False, use_bias=False)
    v = _variables(jm, x, train=False)
    assert set(v) == {"batch_stats"}
    port = BatchNorm(F, momentum=0.5, use_scale=False, use_bias=False)
    assert not list(port.parameters())
    load_variables(port, v)
    m = mask if masked else None
    if train:
        ref, upd = jm.apply(v, jnp.asarray(x), train=True, mask=None if m is None else jnp.asarray(m),
                            mutable=["batch_stats"])
        got = port.train()(_port_bct(x), None if m is None else torch.from_numpy(m))
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(upd["batch_stats"][k]), atol=1e-6)
    else:
        ref = jm.apply(v, jnp.asarray(x), train=False)
        got = port.eval()(_port_bct(x))
    np.testing.assert_allclose(got.detach().transpose(1, 2).numpy(), np.asarray(ref), atol=ATOL)
    s, t = port.folded()
    np.testing.assert_allclose(s.numpy(), 1 / np.sqrt(port.var.numpy() + 1e-5), rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), -port.mean.numpy() * s.numpy(), rtol=1e-6)


# -- TdnnAffine ----------------------------------------------------------------

AFFINES = {
    "frame": dict(context=(0,)),
    "five_tap": dict(context=(-2, -1, 0, 1, 2)),
    "dilated": dict(context=(-3, 0, 3)),
    "gapped_left": dict(context=(-3, 0)),
    "right": dict(context=(0, 2)),
    "irregular": dict(context=(-2, 0, 1)),
    "irregular_no_pad": dict(context=(-3, -1, 0, 2), pad=False),
    "no_pad": dict(context=(-2, 0, 2), pad=False),
    "stride": dict(context=(-1, 0, 1), stride=2),
    "irregular_stride": dict(context=(-1, 0, 2), stride=3),
    "groups": dict(context=(0,), groups=4),
    "groups_ctx": dict(context=(-1, 0, 1), groups=2),
    "irregular_groups": dict(context=(-2, 0, 1), groups=4),
    "no_bias": dict(context=(-2, 0, 2), use_bias=False),
}


@pytest.mark.parametrize("name", list(AFFINES))
def test_tdnn_affine_matches_jax(name):
    kw = AFFINES[name]
    x, _ = _inputs(2)
    jm = jtdnn.TdnnAffine(16, **kw)
    v = _variables(jm, x)
    port = ptdnn.TdnnAffine(F, 16, **kw)
    load_variables(port, v)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_port_bct(x)).transpose(1, 2).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)
    irregular = kw["context"] in ((-2, 0, 1), (-3, -1, 0, 2), (-1, 0, 2))
    assert hasattr(port, "conv") == (not irregular) and hasattr(port, "affine") == irregular


LAYERS = {
    "default": dict(context=(-2, 0, 2)),
    "bn_relu": dict(context=(0,), bn_relu=True),
    "no_bn": dict(context=(-1, 0, 1), bn=False),
    "no_affine_bn": dict(context=(-2, -1, 0, 1, 2), bn_affine=False, momentum=0.5),
    "tanh": dict(context=(0,), activation="tanh"),
    "no_activation": dict(context=(0, 1), activation=None),
    "irregular": dict(context=(-2, 0, 1), bn_affine=False),
    "groups": dict(context=(0,), groups=2, use_bias=False),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(LAYERS))
def test_tdnn_layer_matches_jax(name, train):
    kw = dict(LAYERS[name])
    x, mask = _inputs(3)
    jm = jtdnn.ReluBatchNormTdnnLayer(16, **kw)
    v = _variables(jm, x, train=False)
    ctx = kw.pop("context")
    momentum = kw.pop("momentum", 0.1)
    port = ptdnn.ReluBatchNormTdnnLayer(F, 16, ctx, momentum, **kw)
    load_variables(port, v)
    port.train(train)
    got = port(_port_bct(x), torch.from_numpy(mask)).detach().transpose(1, 2).numpy()
    if train:
        ref, upd = jm.apply(v, jnp.asarray(x), train=True, mask=jnp.asarray(mask), mutable=["batch_stats"])
        if "bn" not in kw:
            got_stats = variables_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.array, upd["batch_stats"])})
            for key, want in got_stats.items():
                np.testing.assert_allclose(port.state_dict()[key].numpy(), want.numpy(), atol=1e-6, err_msg=key)
    else:
        ref = jm.apply(v, jnp.asarray(x), train=False, mask=jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ratio,inner", [(4, None), (2, 5)])
def test_se_block_matches_jax(ratio, inner, masked):
    x, mask = _inputs(4)
    m = mask if masked else None
    jm = jtdnn.SEBlock(ratio=ratio, inner_dim=inner)
    v = _variables(jm, x)
    port = ptdnn.SEBlock(F, ratio=ratio, inner_dim=inner)
    load_variables(port, v)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=None if m is None else jnp.asarray(m)))
    with torch.no_grad():
        got = port(_port_bct(x), None if m is None else torch.from_numpy(m)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("ctx,bypass", [(0, 0.0), (2, 0.0), (3, 0.66), (0, 0.66)])
def test_ftdnn_block_matches_jax(ctx, bypass, train):
    x, mask = _inputs(5)
    jm = jtdnn.FTdnnBlock(F, 8, context_size=ctx, bypass_scale=bypass)
    v = _variables(jm, x, train=False)
    port = ptdnn.FTdnnBlock(F, F, 8, context_size=ctx, bypass_scale=bypass)
    load_variables(port, v)
    port.train(train)
    got = port(_port_bct(x), torch.from_numpy(mask)).detach().transpose(1, 2).numpy()
    if train:
        ref, _ = jm.apply(v, jnp.asarray(x), train=True, mask=jnp.asarray(mask), mutable=["batch_stats"])
    else:
        ref = jm.apply(v, jnp.asarray(x), train=False, mask=jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
    assert port.factor1.conv.bias is None


# -- the semi-orthogonal update ----------------------------------------------

def _kernel(case, rng):
    """A JAX conv kernel [W, I, O] in f64."""
    if case == "near_orthogonal":
        q, _ = np.linalg.qr(rng.normal(size=(32, 8)))
        return (q.T.reshape(8, 2, 16).transpose(1, 2, 0) * 0.7 + rng.normal(size=(2, 16, 8)) * 1e-3)
    shape = {"square": (1, 16, 16), "wide": (2, 32, 8), "gapped": (2, 16, 8), "tall": (1, 8, 16)}[case]
    return rng.normal(size=shape) * 0.3


@pytest.mark.parametrize("case", ["square", "wide", "gapped", "tall", "near_orthogonal"])
def test_semi_orth_update_matches_jax_in_f64(case):
    """f64 at 1e-10; "gapped" is the [-3, 0] factor's 2-tap kernel, "tall"
    takes the transposed branch, "near_orthogonal" the full update speed."""
    k = _kernel(case, np.random.default_rng(7))
    weight = torch.from_numpy(k.transpose(2, 1, 0).copy())  # [O, I, W]
    with jax.enable_x64():
        want = np.asarray(jtdnn.semi_orth_update(jnp.asarray(k)))
        want_obj = float(jtdnn.semi_orth_objective(jnp.asarray(k)))
        want2 = np.asarray(jtdnn.semi_orth_update(jnp.asarray(want)))
    got = ptdnn.semi_orth_update(weight)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy().transpose(2, 1, 0), want, atol=1e-10, rtol=0)
    np.testing.assert_allclose(ptdnn.semi_orth_update(got).numpy().transpose(2, 1, 0), want2, atol=1e-10, rtol=0)
    np.testing.assert_allclose(float(ptdnn.semi_orth_objective(weight)), want_obj, rtol=1e-10)
    # the update moves the factor towards semi-orthogonality
    assert float(ptdnn.semi_orth_objective(got)) < float(ptdnn.semi_orth_objective(weight))


def test_semi_orth_matrix_is_the_jax_kernels():
    """weight.permute(0, 2, 1).reshape(O, W*I) is the JAX kernel's matrix; a
    plain reshape of [O, I, W] is another matrix (and converges all the same)."""
    k = np.random.default_rng(8).normal(size=(2, 6, 4))
    weight = torch.from_numpy(k.transpose(2, 1, 0).copy())
    want = k.reshape(12, 4).T
    np.testing.assert_array_equal(ptdnn._weight_to_matrix(weight).numpy(), want)
    assert not np.array_equal(weight.reshape(4, 12).numpy(), want)


def test_semi_orth_update_of_f32_runs_in_f32():
    w = torch.randn(8, 16, 2, generator=torch.Generator().manual_seed(0), dtype=torch.float32)
    assert ptdnn.semi_orth_update(w).dtype == torch.float32
    assert ptdnn.semi_orth_update(w.to(torch.bfloat16)).dtype == torch.bfloat16


def test_apply_semi_orth_constraint_over_an_ftdnn_tree():
    x, _ = _inputs(9)
    jm = jxv.FactoredXvector(width=0.0625, embd_dim=8)
    v = _variables(jm, x, train=False)
    with jax.enable_x64():
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v["params"])
        want = jax.tree_util.tree_map(np.asarray, jtdnn.apply_semi_orth_constraint(params64))
    state = {k: t.double() for k, t in variables_to_state_dict({"params": v["params"]}).items()}
    got = state_dict_to_variables(ptdnn.apply_semi_orth_constraint(state))["params"]
    changed = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        key = jax.tree_util.keystr(path)
        g = dict((jax.tree_util.keystr(p), a) for p, a in jax.tree_util.tree_leaves_with_path(got))[key]
        np.testing.assert_allclose(g, w, atol=1e-10, rtol=0, err_msg=key)
        orig = dict((jax.tree_util.keystr(p), a) for p, a in jax.tree_util.tree_leaves_with_path(v["params"]))[key]
        changed += not np.allclose(orig, w, atol=1e-12)
    assert changed == 8  # the eight factor1 kernels, nothing else


# -- the four x-vectors ---------------------------------------------------------

FAMILIES = {
    "xvector": (lambda: jxv.Xvector(num_frame_channels=16, embd_dim=8),
                lambda: pxv.Xvector(F, 16, 8, device="cpu")),
    "snowdar": (lambda: jxv.SnowdarXvector(num_frame_channels=16, embd_dim=8),
                lambda: pxv.SnowdarXvector(F, 16, 8, device="cpu")),
    "snowdar_skip_se": (lambda: jxv.SnowdarXvector(num_frame_channels=16, embd_dim=8, skip_connection=True,
                                                   se_block=True, bn_affine=True),
                        lambda: pxv.SnowdarXvector(F, 16, 8, skip_connection=True, se_block=True, bn_affine=True,
                                                   device="cpu")),
    "extended": (lambda: jxv.ExtendedXvector(num_frame_channels=16, embd_dim=8, se_block=True),
                 lambda: pxv.ExtendedXvector(F, 16, 8, se_block=True, device="cpu")),
    "factored": (lambda: jxv.FactoredXvector(width=0.0625, embd_dim=8),
                 lambda: pxv.FactoredXvector(F, 0.0625, 8, device="cpu")),
}


@pytest.fixture(scope="module")
def family_variables():
    x, _ = _inputs(10)
    return {name: _variables(make_jax(), x, seed=11, train=False) for name, (make_jax, _) in FAMILIES.items()}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("position", ["far", "near_affine", "near"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_xvector_family_matches_jax_in_eval(family_variables, family, position, masked):
    make_jax, make_port = FAMILIES[family]
    v = family_variables[family]
    x, mask = _inputs(12)
    m = mask if masked else None
    ref = np.asarray(make_jax().apply(v, jnp.asarray(x), mask=None if m is None else jnp.asarray(m), train=False,
                                      position=position))
    port = load_variables(make_port(), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if m is None else torch.from_numpy(m), position=position).numpy()
    assert got.shape == ref.shape == (B, 8)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_weights_round_trip_bit_for_bit(family_variables, family):
    v = family_variables[family]
    back = state_dict_to_variables(variables_to_state_dict(v))
    for coll in v:
        flat = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(back[coll])}
        for path, a in jax.tree_util.tree_leaves_with_path(v[coll]):
            assert np.array_equal(flat.pop(jax.tree_util.keystr(path)), a)
        assert not flat
    port = FAMILIES[family][1]()
    load_variables(port, v)  # every leaf consumed, no parameter unset
    if family in ("xvector", "snowdar", "extended"):  # the snowdar BNs have no affine
        assert not any(k.endswith("bn.scale") or k.endswith("_bn.bias") for k in port.state_dict())


def test_the_bn_defaults_are_the_jax_models():
    snow, ft = pxv.SnowdarXvector(F, 16, 8, device="cpu"), pxv.FactoredXvector(F, 0.0625, 8, device="cpu")
    assert snow.tdnn1.act_bn.bn.momentum == snow.tdnn6_bn.momentum == 0.5
    assert not snow.tdnn1.act_bn.bn.use_scale and not snow.tdnn7_bn.use_bias
    assert ft.layer02.bn.momentum == ft.embed1_bn.momentum == 0.1 and ft.layer02.bn.use_scale
    assert pxv.ExtendedXvector(F, 16, 8, device="cpu").ex_tdnn4.affine.conv.dilation == (4,)


def test_models_table_builds_the_family():
    for name, cls in (("xvector", pxv.Xvector), ("snowdar_xvector", pxv.SnowdarXvector),
                      ("extended_xvector", pxv.ExtendedXvector), ("factored_xvector", pxv.FactoredXvector)):
        model = MODELS[name](input_dim=F, device="cpu", **({"width": 0.0625} if "factored" in name else
                                                          {"num_frame_channels": 16}))
        assert type(model) is cls and model.embd_dim == 512
    from asv_subtools_tpu_torch.models import FDXvector, MultiTaskXvector

    for name, cls in (("multi_task_xvector", MultiTaskXvector), ("fd_xvector", FDXvector)):
        model = MODELS[name](input_dim=F, num_frame_channels=16, device="cpu")
        assert type(model) is cls and model.embd_dim == 512
        assert {"tdnn1", "tdnn4", "tdnn5", "tdnn7_bn"} <= set(dict(model.named_children()))


def test_fused_pooling_flag_serves_through_the_fused_path(family_variables, monkeypatch):
    """pooling_params={"fused_inference": True}: eval mode goes through the
    fused wrapper (its plain version on the CPU), train mode does not."""
    from asv_subtools_tpu_torch.nn import pooling as port_pooling

    calls = []
    real = port_pooling.fused_stats_pooling
    monkeypatch.setattr(port_pooling, "fused_stats_pooling", lambda *a, **k: calls.append(1) or real(*a, **k))
    port = load_variables(pxv.SnowdarXvector(F, 16, 8, pooling_params={"fused_inference": True}, device="cpu"),
                          family_variables["snowdar"])
    x, mask = _inputs(13)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    ref = np.asarray(FAMILIES["snowdar"][0]().apply(family_variables["snowdar"], jnp.asarray(x),
                                                      mask=jnp.asarray(mask), train=False))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert len(calls) == 1
    port.train()
    port(torch.from_numpy(x), torch.from_numpy(mask))
    assert len(calls) == 1


def test_dropout_draws_from_the_generator():
    port = pxv.SnowdarXvector(F, 16, 8, aug_dropout=0.2, tail_dropout=0.2, device="cpu").train()
    x = torch.from_numpy(_inputs(14)[0])
    a = port(x, generator=torch.Generator().manual_seed(1))
    b = port(x, generator=torch.Generator().manual_seed(1))
    c = port(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- the train step -------------------------------------------------------------

STEP_FAMILIES = {
    "xvector": (lambda: jxv.Xvector(num_frame_channels=16, embd_dim=16),
                lambda: pxv.Xvector(D, 16, 16, device="cpu")),
    "snowdar": (lambda: jxv.SnowdarXvector(num_frame_channels=16, embd_dim=16, skip_connection=True, se_block=True),
                lambda: pxv.SnowdarXvector(D, 16, 16, skip_connection=True, se_block=True, device="cpu")),
    "extended": (lambda: jxv.ExtendedXvector(num_frame_channels=16, embd_dim=16),
                 lambda: pxv.ExtendedXvector(D, 16, 16, device="cpu")),
    "factored": (lambda: jxv.FactoredXvector(width=0.0625, embd_dim=16),
                 lambda: pxv.FactoredXvector(D, 0.0625, 16, device="cpu")),
}


def _nets(family):
    make_jax, make_port = STEP_FAMILIES[family]
    return (JaxSpeakerNet(make_jax(), AM[0], AM[1], num_targets=C),
            SpeakerNet(make_port(), AM[0], AM[1], num_targets=C).to(torch.float64))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("family", list(STEP_FAMILIES))
def test_sgd_step_matches_jax_leaf_by_leaf(family, masked):
    jnet, pnet = _nets(family)
    variables = init_variables(jnet, seed=3)
    batches = [make_batch(20, masked), make_batch(21, masked)]
    momentum = 0.9 if family == "snowdar" else None  # snowdar_xvector.yaml's sgd
    jax_state, jax_m = run_jax(jnet, optax.sgd(LR, momentum=momentum), variables, batches,
                               JaxStepConfig(compute_dtype=jnp.float64))
    port_state, port_m = run_port(pnet, sgd(LR, momentum=momentum), variables, batches,
                                  TrainStepConfig(compute_dtype=torch.float64))
    for p, j in zip(port_m, jax_m):
        assert_metrics_close(p, j)
    assert_states_close(port_state, jax_state, 1e-6)


def test_ftdnn_semi_orth_steps_match_jax_leaf_by_leaf():
    """Four f64 steps with use_semi_orth: step 0 applies the constraint to
    the eight factor1 kernels, steps 1-3 do not."""
    jnet, pnet = _nets("factored")
    variables = init_variables(jnet, seed=4)
    batches = [make_batch(30 + i, True) for i in range(4)]
    jax_state, jax_m = run_jax(jnet, optax.sgd(LR), variables, batches,
                               JaxStepConfig(compute_dtype=jnp.float64, use_semi_orth=True))
    port_state, port_m = run_port(pnet, sgd(LR), variables, batches,
                                  TrainStepConfig(compute_dtype=torch.float64, use_semi_orth=True))
    for p, j in zip(port_m, jax_m):
        assert_metrics_close(p, j)
    assert_states_close(port_state, jax_state, 1e-6)
    assert int(port_state.step) == 4
    # without the constraint the factors end elsewhere
    plain_state, _ = run_port(pnet, sgd(LR), variables, batches[:1], TrainStepConfig(compute_dtype=torch.float64))
    once, _ = run_port(pnet, sgd(LR), variables, batches[:1],
                       TrainStepConfig(compute_dtype=torch.float64, use_semi_orth=True))
    key = "backbone.layer02.factor1.conv.weight"
    assert not torch.allclose(plain_state.params[key], once.params[key])
    assert torch.equal(plain_state.params["backbone.layer02.factor2.conv.weight"],
                       once.params["backbone.layer02.factor2.conv.weight"])


def test_semi_orth_step_is_chosen_on_the_device():
    """The step counter is read on the device: step 5 applies nothing, step 8 applies it."""
    _, pnet = _nets("factored")
    pnet = init_weights_(pnet, 1)
    from asv_subtools_tpu_torch.train import init_train_state, make_train_step

    x, y, mask = make_batch(40, False)
    batch = {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}
    key = "backbone.layer05.factor1.conv.weight"
    out = {}
    for start in (5, 8):
        for semi in (False, True):
            tx = sgd(0.0)
            state = init_train_state(pnet, tx, "cpu")
            state.step = torch.tensor(start, dtype=torch.int32)
            step = make_train_step(pnet, tx, config=TrainStepConfig(compute_dtype=torch.float64, use_semi_orth=semi))
            out[start, semi] = step(state, batch, torch.Generator().manual_seed(0))[0].params[key]
    assert torch.equal(out[5, False], out[5, True])
    assert not torch.allclose(out[8, False], out[8, True])
    np.testing.assert_allclose(out[8, True].numpy(), ptdnn.semi_orth_update(out[8, False]).numpy(), atol=1e-12)
