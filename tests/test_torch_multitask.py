"""The port's multi-task and FD-AL x-vectors, their train steps and the SAM
step against the JAX package, on the same weights (weights.py carries the
JAX trees across).

Forward: MultiTaskXvector (embedding at every position and the phone
features), FDXvector, DALRegularizer, fd_adversarial_loss and
phone_frame_loss (masked, and with labels outside [0, num_phones)), in
eval mode on seeded [3, 37, 24] inputs with randomised biases, BN
affines and running statistics: f32 within 1e-5, f64 within 1e-10.

Steps, all in float64 on features, leaf by leaf within 1e-6 of each
leaf's scale (the helpers of tests/test_torch_train_step.py):
* one MultiTaskNet step against JAX's make_train_step on dict targets;
* an FD run over one whole cycle (cycle 4, adv_steps 2: two adversary
  steps, two main steps) against make_fd_train_step, the max_change clip
  engaged in the main steps; after each step the set of leaves that moved
  is the same on both sides: the ``dal`` leaves alone in an adversary
  step, every leaf but them in a main step;
* a SAM step, plain and adaptive, against make_sam_train_step.
The optimizer's ``sam`` flag names the SAM step (the Launcher maps it
there; tests/test_torch_launcher_offline.py): three SAM steps on a
least-squares loss against optax.contrib.sam in opaque mode (sync period
2), the wrapper JAX's flag names, with the adversarial optimizer
chain(normalize(), sgd(rho)), within 1e-12 in f64. JAX's own
``get_optimizer(sam=True)`` passes ``rho=`` to optax.contrib.sam, which
takes no such keyword in optax 0.2.6: it raises TypeError; the port's
raises ValueError naming the SAM step (both held here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.models import multitask as jmt
from asv_subtools_tpu.models.framework import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.models.xvector import SnowdarXvector as JaxSnowdar
from asv_subtools_tpu.train import fd as jfd
from asv_subtools_tpu.train.optim import get_optimizer as jax_get_optimizer
from asv_subtools_tpu.train.sam import make_sam_train_step as jax_make_sam_train_step
from asv_subtools_tpu.train.trainer import TrainState as JaxTrainState
from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu.train.trainer import make_train_step as jax_make_train_step
from asv_subtools_tpu_torch.models import SpeakerNet, SnowdarXvector, multitask as pmt
from asv_subtools_tpu_torch.train import TrainStepConfig, get_optimizer, init_train_state, make_train_step, sgd
from asv_subtools_tpu_torch.train.fd import FDSpeakerNet, init_fd_state, is_adversary, make_fd_train_step
from asv_subtools_tpu_torch.train.sam import make_sam_train_step
from asv_subtools_tpu_torch.weights import load_variables, train_state_from_variables, train_state_to_variables
from test_torch_train_step import C, D, LR, assert_states_close, init_variables, make_batch, run_port
from test_torch_xvector import _inputs, _variables

torch.set_num_threads(2)

B, T, F = 3, 37, 24
NARROW = dict(num_frame_channels=16, embd_dim=8)
AM = ("margin_softmax", {"method": "am", "m": 0.2})
PHONES = 10
AUX = 3


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _forward_pair(kind, dtype):
    if kind == "multitask":
        return jmt.MultiTaskXvector(**NARROW, se_block=True), pmt.MultiTaskXvector(F, **NARROW, se_block=True,
                                                                                   device="cpu").to(dtype)
    return jmt.FDXvector(**NARROW, skip_connection=True), pmt.FDXvector(F, **NARROW, skip_connection=True,
                                                                       device="cpu").to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind,position", [("multitask", "far"), ("multitask", "near_affine"),
                                           ("multitask", "near"), ("fd", "near")])
def test_models_match_jax_in_eval(kind, position, masked, dtype):
    jnet, pnet = _forward_pair(kind, getattr(torch, dtype))
    x, mask = _inputs(12)
    v = _variables(jnet, x, seed=11, train=False)
    m = mask if masked else None
    tol = 1e-5 if dtype == "float32" else 1e-10
    with jax.enable_x64(dtype == "float64"):
        jd = getattr(jnp, dtype)
        vj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), v)
        ref = jnet.apply(vj, jnp.asarray(x, jd), mask=None if m is None else jnp.asarray(m), train=False,
                         position=position)
        ref = [np.asarray(r) for r in ref]
    load_variables(pnet, _f64(v) if dtype == "float64" else v)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x).to(getattr(torch, dtype)), None if m is None else torch.from_numpy(m),
                   position=position)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=tol, rtol=0)
    if kind == "multitask":
        assert got[1].shape == (B, T, 16)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dal_and_adversarial_loss_match_jax(dtype):
    rng = np.random.default_rng(3)
    spk, content = (rng.normal(size=(5, 8)).astype(dtype) for _ in range(2))
    dal = jmt.DALRegularizer()
    v = _f64(dal.init(jax.random.PRNGKey(0), jnp.asarray(content), jnp.asarray(spk)))
    tol = 1e-6 if dtype == "float32" else 1e-12
    with jax.enable_x64(dtype == "float64"):
        vj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), v)
        ref_dal = float(dal.apply(vj, jnp.asarray(content), jnp.asarray(spk)))
        ref_adv = float(jmt.fd_adversarial_loss(jnp.asarray(spk), jnp.asarray(content)))
    port = pmt.DALRegularizer(8).to(getattr(torch, dtype))
    load_variables(port, v)
    with torch.no_grad():
        got_dal = float(port(torch.from_numpy(content), torch.from_numpy(spk)))
    got_adv = float(pmt.fd_adversarial_loss(torch.from_numpy(spk), torch.from_numpy(content)))
    np.testing.assert_allclose([got_dal, got_adv], [ref_dal, ref_adv], rtol=tol, atol=tol)
    assert 0.0 <= got_adv <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["plain", "masked", "out_of_range"])
def test_phone_frame_loss_matches_jax(case, dtype):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 20, PHONES)).astype(dtype)
    targets = rng.integers(0, PHONES, size=(3, 20))
    if case == "out_of_range":
        targets[0, :5], targets[1, 3] = PHONES + 1, -2  # counted as phone 0
    mask = np.arange(20)[None] < np.array([20, 11, 4])[:, None] if case != "plain" else None
    with jax.enable_x64(dtype == "float64"):
        ref = float(jmt.phone_frame_loss(jnp.asarray(logits), jnp.asarray(targets),
                                         None if mask is None else jnp.asarray(mask), num_phones=PHONES))
    got = float(pmt.phone_frame_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                     None if mask is None else torch.from_numpy(mask), num_phones=PHONES))
    tol = 1e-6 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(got, ref, rtol=tol)
    assert np.isfinite(got)


# -- the steps, in float64 ------------------------------------------------------

def _randomized(tree, seed):
    from test_torch_train_step import _randomize

    tree = _f64(jax.device_get(tree))
    _randomize(tree, np.random.default_rng(seed))
    return tree


def _mt_nets():
    jnet = jmt.MultiTaskNet(jmt.MultiTaskXvector(**NARROW), num_targets=C, num_phones=PHONES, loss_name=AM[0],
                            loss_params=AM[1], mt_alpha=0.3)
    pnet = pmt.MultiTaskNet(pmt.MultiTaskXvector(D, **NARROW, device="cpu"), num_targets=C, num_phones=PHONES,
                            loss_name=AM[0], loss_params=AM[1], mt_alpha=0.3).to(torch.float64)
    return jnet, pnet


def _phones(seed, b=4, t=60):
    return np.random.default_rng(seed).integers(0, PHONES + 2, size=(b, t))  # a few out of range


def test_multitask_step_matches_jax_leaf_by_leaf():
    jnet, pnet = _mt_nets()
    x, y, mask = make_batch(40, True)
    phones = _phones(41)
    targets = {"spk": jnp.asarray(y, jnp.int32), "phone": jnp.asarray(phones, jnp.int32)}
    variables = _randomized(jnet.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x, jnp.float32), targets,
                                      mask=jnp.asarray(mask), train=False), 2)
    tx_j, tx_p = optax.sgd(LR), sgd(LR)
    with jax.enable_x64():
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                              opt_state=tx_j.init(params))
        step = jax.jit(jax_make_train_step(jnet, tx_j, config=JaxStepConfig(compute_dtype=jnp.float64)))
        batch = {"x": jnp.asarray(x), "y": targets, "mask": jnp.asarray(mask)}
        jax_state, jm = step(state, batch, jax.random.PRNGKey(0))
        jax_state, jm = jax.device_get((jax_state, jm))
    state = train_state_from_variables(pnet, {"step": 0, **variables, "opt_state": {"count": 0}}, device="cpu")
    state.opt_state = tx_p.init(state.params)
    pstep = make_train_step(pnet, tx_p, config=TrainStepConfig(compute_dtype=torch.float64))
    pbatch = {"x": torch.from_numpy(x), "y": {"spk": torch.from_numpy(y), "phone": torch.from_numpy(phones)},
              "mask": torch.from_numpy(mask)}
    port_state, pm = pstep(state, pbatch, torch.Generator().manual_seed(0))
    for key in ("loss", "grad_norm", "accuracy"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-6, atol=1e-12, err_msg=key)
    assert_states_close(port_state, jax_state, 1e-6)
    assert {"backbone", "loss_spk", "phone_affine"} == set(variables["params"])


def _fd_nets():
    jnet = jfd.FDSpeakerNet(jmt.FDXvector(**NARROW, se_block=True), num_targets=C, num_aux_targets=AUX,
                            loss_name=AM[0], loss_params=AM[1])
    pnet = FDSpeakerNet(pmt.FDXvector(D, **NARROW, se_block=True, device="cpu"), num_targets=C, num_aux_targets=AUX,
                        loss_name=AM[0], loss_params=AM[1]).to(torch.float64)
    return jnet, pnet


def _moved(before, after):
    return {k for k in after if not np.array_equal(np.asarray(before[k]), np.asarray(after[k]))}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
    return out


def test_fd_cycle_matches_jax_leaf_by_leaf():
    """cycle 4, adv_steps 2: steps 0-1 adversary, 2-3 main; sgd with
    momentum on the main side, adamW on the adversary, clip engaged."""
    jnet, pnet = _fd_nets()
    batches = [make_batch(50 + i, i % 2 == 1) for i in range(4)]
    aux = [np.random.default_rng(60 + i).integers(0, AUX, size=4) for i in range(4)]
    x0, y0, m0 = batches[0]
    variables = _randomized(jnet.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x0, jnp.float32),
                                      jnp.asarray(y0), jnp.asarray(aux[0]), train=False), 3)
    kw = dict(aux_weight=0.2, adv_weight=0.5, cycle=4, adv_steps=2)
    max_change = 0.5
    with jax.enable_x64():
        txm, txa = optax.sgd(LR, momentum=0.9), optax.adamw(1e-2, weight_decay=1e-2)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                              opt_state=(txm.init(params), txa.init(params)))
        step = jax.jit(jfd.make_fd_train_step(jnet, txm, txa, config=JaxStepConfig(
            max_change=max_change, compute_dtype=jnp.float64), **kw))
        jax_states, jax_m = [], []
        for (x, y, mask), a in zip(batches, aux):
            batch = {"x": jnp.asarray(x), "y": jnp.asarray(y, jnp.int32), "aux_y": jnp.asarray(a, jnp.int32)}
            if mask is not None:
                batch["mask"] = jnp.asarray(mask)
            state, m = step(state, batch, jax.random.PRNGKey(0))
            jax_states.append(jax.device_get(state))
            jax_m.append({k: float(v) for k, v in jax.device_get(m).items()})
    ptxm, ptxa = sgd(LR, momentum=0.9), get_optimizer("adamW", learning_rate=1e-2, weight_decay=1e-2)
    pstate = train_state_from_variables(pnet, {"step": 0, **variables, "opt_state": ({"count": 0}, {"count": 0})},
                                        device="cpu")
    fresh = init_fd_state(pnet, ptxm, ptxa, device="cpu")
    assert [set(o) for o in fresh.opt_state] == [{"count", "trace"}, {"count", "mu", "nu"}]
    pstate.opt_state = (ptxm.init(pstate.params), ptxa.init(pstate.params))
    pstep = make_fd_train_step(pnet, ptxm, ptxa, config=TrainStepConfig(max_change=max_change,
                                                                        compute_dtype=torch.float64), **kw)
    prev_j = prev_p = _flat(variables["params"])
    for i, ((x, y, mask), a) in enumerate(zip(batches, aux)):
        batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "aux_y": torch.from_numpy(a)}
        if mask is not None:
            batch["mask"] = torch.from_numpy(mask)
        pstate, pm = pstep(pstate, batch, step_index=i)
        assert pm["phase_adv"] == jax_m[i]["phase_adv"] == float(i < 2)
        for key in ("loss", "accuracy", "adversarial_cos", "skipped"):
            np.testing.assert_allclose(float(pm[key]), jax_m[i][key], rtol=1e-6, atol=1e-12, err_msg=key)
        assert_states_close(pstate, jax_states[i], 1e-6)
        now_j = _flat(jax_states[i].params)
        moved_j = _moved(prev_j, now_j)
        now_p = _flat(train_state_to_variables(pstate)["params"])
        moved_p = _moved(prev_p, now_p)
        assert moved_p == moved_j, (i, moved_p ^ moved_j)
        dal = {k for k in now_p if k.startswith("dal.")}
        assert dal == {"dal.w_noise.kernel", "dal.w_id.kernel"}
        assert {k for k in pstate.params if is_adversary(k)} == {"dal.w_noise.weight", "dal.w_id.weight"}
        assert moved_p == (dal if i < 2 else set(now_p) - dal), i
        prev_j, prev_p = now_j, now_p
    assert isinstance(pstate.opt_state, tuple) and int(pstate.step) == 4
    assert jax_m[2]["loss"] > 0 and jax_m[3]["skipped"] == 0.0


def _sam_nets():
    jnet = JaxSpeakerNet(JaxSnowdar(**NARROW), AM[0], AM[1], num_targets=C)
    pnet = SpeakerNet(SnowdarXvector(D, **NARROW, device="cpu"), AM[0], AM[1], num_targets=C).to(torch.float64)
    return jnet, pnet


@pytest.mark.parametrize("adaptive", [False, True])
def test_sam_step_matches_jax_leaf_by_leaf(adaptive):
    jnet, pnet = _sam_nets()
    variables = init_variables(jnet, seed=5)
    batches = [make_batch(70, True), make_batch(71, False)]
    with jax.enable_x64():
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        tx = optax.sgd(LR, momentum=0.9)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                              opt_state=tx.init(params))
        step = jax.jit(jax_make_sam_train_step(jnet, tx, rho=0.5, adaptive=adaptive,
                                               config=JaxStepConfig(compute_dtype=jnp.float64, max_change=2.0)))
        jax_m = []
        for x, y, mask in batches:
            batch = {"x": jnp.asarray(x), "y": jnp.asarray(y, jnp.int32)}
            if mask is not None:
                batch["mask"] = jnp.asarray(mask)
            state, m = step(state, batch, jax.random.PRNGKey(0))
            jax_m.append({k: float(v) for k, v in jax.device_get(m).items()})
        jax_state = jax.device_get(state)
    ptx = sgd(LR, momentum=0.9)
    pstate = train_state_from_variables(pnet, {"step": 0, **variables, "opt_state": {"count": 0}}, device="cpu")
    pstate.opt_state = ptx.init(pstate.params)
    pstep = make_sam_train_step(pnet, ptx, rho=0.5, adaptive=adaptive,
                                config=TrainStepConfig(compute_dtype=torch.float64, max_change=2.0))
    gen = torch.Generator().manual_seed(0)
    for (x, y, mask), jm in zip(batches, jax_m):
        batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        if mask is not None:
            batch["mask"] = torch.from_numpy(mask)
        pstate, pm = pstep(pstate, batch, gen)
        for key in ("loss", "sam_loss", "accuracy", "grad_norm", "skipped"):
            np.testing.assert_allclose(float(pm[key]), jm[key], rtol=1e-6, atol=1e-12, err_msg=key)
        assert float(pm["sam_loss"]) != float(pm["loss"])
    assert_states_close(pstate, jax_state, 1e-6)
    # the second pass's BN statistics are thrown away: a plain step from the
    # same state lands on the same running statistics after pass 1
    plain, _ = run_port(pnet, sgd(LR), variables, batches[:1], TrainStepConfig(compute_dtype=torch.float64))
    once = train_state_from_variables(pnet, {"step": 0, **variables, "opt_state": {"count": 0}}, device="cpu")
    once.opt_state = ptx.init(once.params)
    batch = {"x": torch.from_numpy(batches[0][0]), "y": torch.from_numpy(batches[0][1]),
             "mask": torch.from_numpy(batches[0][2])}
    once, _ = pstep(once, batch, torch.Generator().manual_seed(0))
    for k in once.batch_stats:
        assert torch.equal(once.batch_stats[k], plain.batch_stats[k]), k


def test_sam_step_takes_features_only():
    _, pnet = _sam_nets()
    with pytest.raises(ValueError):
        make_sam_train_step(pnet, sgd(LR), config=TrainStepConfig(wave_input=True))
    with pytest.raises(ValueError):
        make_sam_train_step(pnet, sgd(LR), config=TrainStepConfig(accum_grad=2))


def _adaptive_ascent(rho):
    """optax's adversarial optimizer for the element-adaptive ascent:
    -rho * p^2 * g / max(|p * g|, 1e-12) (sam opaque mode negates it)."""

    def update(g, state, params):
        norm = optax.global_norm(jax.tree_util.tree_map(lambda a, p: jnp.abs(p) * a, g, params))
        return jax.tree_util.tree_map(lambda a, p: -rho * p ** 2 * a / jnp.maximum(norm, 1e-12), g, params), state

    return optax.GradientTransformation(lambda p: optax.EmptyState(), update)


class _LeastSquares(torch.nn.Module):
    """``a @ w + c`` against ``b`` (x = a, y = b), with the train step's
    calling convention: (loss, logits, embedding)."""

    def __init__(self, p0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(p0["w"]))
        self.c = torch.nn.Parameter(torch.from_numpy(np.asarray(p0["c"])))

    def forward(self, x, y, mask=None, lambda_m=1.0, margin_offset=0.0, generator=None):
        pred = x @ self.w + self.c
        return ((pred - y) ** 2).sum(), pred[:, None], pred


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("base", ["sgd", "adamW"])
def test_sam_step_matches_optax_sam(base, adaptive):
    """Three SAM steps (rho 0.3; no clip) over a least-squares loss against
    optax.contrib.sam(base, chain(normalize(), sgd(rho)),
    opaque_mode=True) (the adversarial optimizer that gives the ascent its
    radius rho; with adaptive, the element-adaptive ascent of
    train/sam.py). get_optimizer(sam=True) raises on both sides: JAX's
    TypeError, the port's ValueError naming the SAM step."""
    with pytest.raises(TypeError, match="rho"):
        jax_get_optimizer("adamW", sam=True)
    with pytest.raises(ValueError, match="make_sam_train_step"):
        get_optimizer(base, sam=True)
    rng = np.random.default_rng(8)
    a, b = rng.normal(size=(6, 4)), rng.normal(size=6)
    p0 = {"w": rng.normal(size=4), "c": rng.normal(size=())}
    rho, lr = 0.3, 0.05

    def jloss(p):
        return jnp.sum((jnp.asarray(a) @ p["w"] + p["c"] - jnp.asarray(b)) ** 2)

    with jax.enable_x64():
        jbase = optax.sgd(lr, momentum=0.9) if base == "sgd" else optax.adamw(lr, weight_decay=1e-2)
        adv = _adaptive_ascent(rho) if adaptive else optax.chain(optax.contrib.normalize(), optax.sgd(rho))
        jtx = optax.contrib.sam(jbase, adv, opaque_mode=True)
        jp = jax.tree_util.tree_map(jnp.asarray, p0)
        js = jtx.init(jp)
        grad_fn = jax.grad(lambda p, _: jloss(p))
        for _ in range(3):
            u, js = jtx.update(jax.grad(jloss)(jp), js, jp, grad_fn=grad_fn)
            jp = optax.apply_updates(jp, u)
        jp = jax.device_get(jp)
    kw = dict(momentum=0.9, weight_decay=0.0) if base == "sgd" else dict(weight_decay=1e-2)
    ptx = get_optimizer(base, learning_rate=lr, **kw)
    net = _LeastSquares(p0)
    step = make_sam_train_step(net, ptx, rho=rho, adaptive=adaptive,
                               config=TrainStepConfig(max_change=1e12, compute_dtype=torch.float64))
    state = init_train_state(net, ptx, "cpu")
    batch = {"x": torch.from_numpy(a), "y": torch.from_numpy(b)}
    for _ in range(3):
        state, m = step(state, batch, torch.Generator().manual_seed(0))
        assert float(m["skipped"]) == 0.0
    for k in state.params:
        np.testing.assert_allclose(state.params[k].numpy(), np.asarray(jp[k]), rtol=1e-12, atol=1e-12, err_msg=k)


def test_fd_state_round_trips_through_the_checkpoint_and_the_jax_layout(tmp_path):
    """FD's optimizer state is the pair (main, adversary): save_checkpoint
    and load_checkpoint(restore_optimizer=True) keep it bit for bit, and
    train_state_to_variables / train_state_from_variables carry it as a
    pair of JAX-layout trees (loss2, dal and att_fc leaves included)."""
    from asv_subtools_tpu_torch.train import load_checkpoint, save_checkpoint

    _, pnet = _fd_nets()
    txm, txa = sgd(LR, momentum=0.9), get_optimizer("adamW", learning_rate=1e-2)
    state = init_fd_state(pnet, txm, txa, device="cpu")
    step = make_fd_train_step(pnet, txm, txa, config=TrainStepConfig(compute_dtype=torch.float64), **dict(
        cycle=4, adv_steps=2))
    x, y, mask = make_batch(80, True)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "mask": torch.from_numpy(mask)}
    for i in range(3):
        state, _ = step(state, batch, step_index=i)
    path = save_checkpoint(str(tmp_path), state, 1)
    fresh = init_fd_state(pnet, txm, txa, device="cpu")
    loaded = load_checkpoint(path, fresh, restore_optimizer=True)
    assert isinstance(loaded.opt_state, tuple) and int(loaded.step) == 3
    for new, old in zip(loaded.opt_state, state.opt_state):
        assert set(new) == set(old)
        for k in old:
            tree_new, tree_old = (new[k], old[k]) if isinstance(old[k], dict) else ({"": new[k]}, {"": old[k]})
            assert all(torch.equal(tree_new[n], tree_old[n]) for n in tree_old), k
    tree = train_state_to_variables(state)
    assert isinstance(tree["opt_state"], tuple) and {"loss", "loss2", "dal"} <= set(tree["params"])
    assert {"att_fc1", "att_fc2"} <= set(tree["params"]["backbone"])
    back = train_state_from_variables(pnet, tree, device="cpu")
    assert all(torch.equal(back.params[k], state.params[k]) for k in state.params)
    assert torch.equal(back.opt_state[1]["nu"]["dal.w_id.weight"], state.opt_state[1]["nu"]["dal.w_id.weight"])
