"""The mesh over processes on the CPU: gloo ranks held against one process
and against JAX's virtual CPU mesh.

Each world size (2 and 4) is spawned once, by a module fixture, on a free
port of 127.0.0.1; every check runs inside those ranks and returns its
tensors, which the tests compare here (a failing check returns its
traceback). The workers import no JAX: the references are computed in
this process.

* Global BatchNorm on each rank's rows against one BatchNorm over the
  whole batch, in f64 at 1e-12: output, running statistics and input
  gradient, with and without a mask (2 and 4 ranks).
* One f64 momentum-SGD step of a narrow ECAPA (clip engaged) in three
  placements on 4 ranks: data 4; data 2 x model 2 (the classifier's rows
  over "model"); data 4 with ZeRO-3 at ``min_size=64``. Each against the
  one-process port at 1e-10 of each leaf's scale, and against JAX's same
  placement (its Trainer on ``make_mesh(..., devices=jax.devices()[:4])``)
  at 1e-6, leaf by leaf.
* The SAM and FD steps at data 2 against one process at 1e-10, the
  F-TDNN's semi-orthogonal update on ZeRO-3 shards at 1e-10, and the
  heads whose loss couples the batch's rows (affinity, summed focal, the
  sub-centre head's batch-mean threshold and rectangle loss,
  CurricularFace) at 1e-10, or 1e-5 where the head computes in float32.
* The Launcher's stage 1 with ``fsdp: true, num_model: 2`` on 4 ranks:
  the first step's loss equals one process's at 1e-5, and its checkpoint
  loads into a one-process state.
* ``asnorm_device(mesh=...)`` against the unsharded call at rtol 1e-5 and
  against JAX's sharded call.
"""

import os
import pickle
import socket
import traceback

import numpy as np
import pytest
import torch

B, T, D, C = 8, 60, 24, 20
SMALL = dict(channels=32, mfa_conv=96, embd_dim=16)
LR, MOMENTUM, MAX_CHANGE = 0.05, 0.9, 10.0
PLACEMENTS = {"data4": (4, 1, None), "data2_model2": (2, 2, "classifier"), "data4_fsdp": (4, 1, "fsdp")}
ASNORM = dict(e=13, t=11, c=40, top_n=16)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _batch(seed=1, b=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, T, D))
    y = rng.integers(0, C, size=b)
    lengths = rng.integers(T // 3, T + 1, size=b)
    lengths[0] = T
    return x, y, np.arange(T)[None, :] < lengths[:, None]


def _port_net():
    from asv_subtools_tpu_torch.models import EcapaTdnn, SpeakerNet

    return SpeakerNet(EcapaTdnn(input_dim=D, device="cpu", **SMALL), "margin_softmax",
                      {"method": "aam", "m": 0.2}, num_targets=C).double()


def _port_batch(x, y, mask):
    return {"x": torch.as_tensor(x), "y": torch.as_tensor(y), "mask": torch.as_tensor(mask)}


def _cfg():
    from asv_subtools_tpu_torch.train import TrainStepConfig

    return TrainStepConfig(compute_dtype=torch.float64, max_change=MAX_CHANGE)


def _asnorm_inputs():
    rng = np.random.default_rng(5)
    a = ASNORM
    return (rng.normal(size=(a["e"], a["t"])), rng.normal(size=(a["e"], a["c"])),
            rng.normal(size=(a["t"], a["c"])))


# --------------------------------------------------------------------------
# the ranks' side (no JAX)
# --------------------------------------------------------------------------

def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def _check_bn(world, masked):
    from asv_subtools_tpu_torch.nn.norm import BatchNorm
    from asv_subtools_tpu_torch.parallel import comm, make_mesh
    from asv_subtools_tpu_torch.parallel.mesh import DATA_AXIS, mesh_axis

    axis = mesh_axis(make_mesh(world, 1), DATA_AXIS)
    x, w, mask = _bn_inputs()
    n = x.shape[0] // world
    rows = slice(axis.rank * n, (axis.rank + 1) * n)
    bn = BatchNorm(x.shape[1]).double().train()
    xl = x[rows].clone().requires_grad_()
    with comm.scope(axis, None, global_rows=x.shape[0], start=rows.start, local=n):
        y = bn(xl, mask[rows] if masked else None)
    (y * w[rows]).sum().backward()
    return {"y": y.detach().numpy(), "grad": xl.grad.numpy(), "mean": bn.mean.numpy(), "var": bn.var.numpy()}


def _bn_inputs():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 6, 10, generator=g, dtype=torch.float64) * 2.0 + 0.5
    w = torch.randn(8, 6, 10, generator=g, dtype=torch.float64)
    mask = torch.arange(10)[None, :] < torch.tensor([10, 4, 7, 10, 3, 9, 6, 8])[:, None]
    return x, w, mask


def _check_step(world, name, variables):
    from asv_subtools_tpu_torch.parallel import classifier_partition_rules, make_fsdp_rules, make_mesh
    from asv_subtools_tpu_torch.train import Trainer, sgd
    from asv_subtools_tpu_torch.weights import load_variables

    d, m, rules = PLACEMENTS[name]
    mesh = make_mesh(d, m)
    rules = {None: None, "classifier": classifier_partition_rules,
             "fsdp": make_fsdp_rules(mesh, min_size=64)}[rules]
    net = load_variables(_port_net(), variables)
    trainer = Trainer(net, sgd(LR, momentum=MOMENTUM), config=_cfg(), device="cpu", mesh=mesh,
                      partition_rules=rules)
    state = trainer.init_state()
    state, metrics = trainer._train_step(state, trainer._to_device(_port_batch(*_batch())),
                                         torch.Generator().manual_seed(0))
    full = trainer.full_state(state)
    return {"params": _to_numpy(full.params), "batch_stats": _to_numpy(full.batch_stats),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "specs": dict(trainer.placement.specs),
            "local": {k: tuple(v.shape) for k, v in state.params.items()},
            "trace": {k: tuple(v.shape) for k, v in state.opt_state["trace"].items()}}


def _sam_net():
    from asv_subtools_tpu_torch.weights import init_weights_

    return init_weights_(_port_net(), 1)


def _fd_net():
    from asv_subtools_tpu_torch.models import multitask as pmt
    from asv_subtools_tpu_torch.train.fd import FDSpeakerNet
    from asv_subtools_tpu_torch.weights import init_weights_

    net = FDSpeakerNet(pmt.FDXvector(D, num_frame_channels=16, embd_dim=8, se_block=True, device="cpu"),
                       num_targets=C, num_aux_targets=3, loss_name="margin_softmax",
                       loss_params={"method": "am", "m": 0.2})
    return init_weights_(net, 2).double()


def run_sam(placement=None):
    """One f64 SAM step of the narrow ECAPA (rho 0.5); ``placement`` makes
    it the mesh step on this rank's rows. Returns (full params, stats,
    metrics)."""
    from asv_subtools_tpu_torch.parallel import shard_batch
    from asv_subtools_tpu_torch.train import init_train_state, sgd
    from asv_subtools_tpu_torch.train.sam import make_sam_train_step

    net = _sam_net()
    tx = sgd(LR)
    state = init_train_state(net, tx, "cpu")
    step = make_sam_train_step(net, tx, rho=0.5, config=_cfg(), placement=placement)
    batch = _port_batch(*_batch(2))
    if placement is not None:
        batch = shard_batch(placement.mesh, batch)
    state, m = step(state, batch, torch.Generator().manual_seed(0))
    return _to_numpy(state.params), _to_numpy(state.batch_stats), {k: float(v) for k, v in m.items()}


def run_fd(placement=None, steps=(0, 30)):
    """Two f64 FD steps (an adversary step, then a main one) of a narrow
    FD x-vector; ``placement`` makes them the mesh step."""
    from asv_subtools_tpu_torch.parallel import shard_batch
    from asv_subtools_tpu_torch.train import sgd
    from asv_subtools_tpu_torch.train.fd import init_fd_state, make_fd_train_step

    net = _fd_net()
    txm, txa = sgd(LR), sgd(LR)
    state = init_fd_state(net, txm, txa, "cpu")
    step = make_fd_train_step(net, txm, txa, config=_cfg(), placement=placement)
    metrics = []
    for i, index in enumerate(steps):
        x, y, mask = _batch(3 + i)
        batch = dict(_port_batch(x, y, mask), aux_y=torch.as_tensor(y % 3))
        if placement is not None:
            batch = shard_batch(placement.mesh, batch)
        state, m = step(state, batch, step_index=index)
        metrics.append({k: float(v) for k, v in m.items()})
    return _to_numpy(state.params), _to_numpy(state.batch_stats), metrics


# heads whose loss couples the rows of a batch (parallel/comm.py), and
# the bound each is held to: the affinity loss and the sub-centre head
# compute in float32 whatever their input (their sums' order moves the
# f64 step's leaves by ~1e-7 of their scale), the other two in f64
COUPLED_HEADS = {
    "logistic_affinity": ("logistic_affinity", {}, 1e-5),
    "focal_sum": ("focal", {}, 1e-10),
    "v1_batch_mean": ("margin_softmax_v1", {"method": "aam", "sub_k": 2, "adapt_method": "batch_mean"}, 1e-5),
    "v1_rectangle": ("margin_softmax_v1", {"method": "am", "loss_type": "rectangle", "adapt_method": "topk",
                                           "topk": 3}, 1e-5),
    "curricular": ("margin_softmax", {"method": "aam", "curricular": True}, 1e-10),
}
# heads on the data 2 x model 2 mesh, the classifier's rows over "model"
MODEL_AXIS_HEADS = {
    "mhe_inter": ("margin_softmax", {"method": "am", "mhe_loss": True, "inter_loss": 0.1}, 1e-10),
    "v1_subcenter_topk": ("margin_softmax_v1", {"method": "aam", "sub_k": 2, "adapt_method": "topk", "topk": 3},
                          1e-5),
}


def run_head_step(name, mesh=None):
    """One f64 SGD step of the narrow ECAPA with the head ``name``; with
    ``mesh`` the mesh step on this rank's rows (the classifier's rows
    over "model" where the mesh has a model axis). Returns (params,
    batch_stats, metrics), whole."""
    from asv_subtools_tpu_torch.models import EcapaTdnn, SpeakerNet
    from asv_subtools_tpu_torch.parallel import classifier_partition_rules
    from asv_subtools_tpu_torch.train import Trainer, sgd
    from asv_subtools_tpu_torch.weights import init_weights_

    loss, params, _ = {**COUPLED_HEADS, **MODEL_AXIS_HEADS}[name]
    net = SpeakerNet(EcapaTdnn(input_dim=D, device="cpu", **SMALL), loss, params, num_targets=C)
    net = init_weights_(net, 3).double()
    rules = classifier_partition_rules if name in MODEL_AXIS_HEADS and mesh is not None else None
    trainer = Trainer(net, sgd(LR), config=_cfg(), device="cpu", mesh=mesh, partition_rules=rules)
    state = trainer.init_state()
    state, m = trainer._train_step(state, trainer._to_device(_port_batch(*_batch(4))),
                                   torch.Generator().manual_seed(0))
    full = trainer.full_state(state)
    return _to_numpy(full.params), _to_numpy(full.batch_stats), {k: float(v) for k, v in m.items()}


def run_semi_orth_step(mesh=None):
    """One f64 SGD step (step 0, where the semi-orthogonal update applies)
    of a narrow F-TDNN with ``use_semi_orth``; with ``mesh`` the ZeRO-3
    mesh step at ``min_size=64``, where the factor1 weights are flat
    shards gathered whole for the update."""
    from asv_subtools_tpu_torch.models import FactoredXvector, SpeakerNet
    from asv_subtools_tpu_torch.parallel import make_fsdp_rules
    from asv_subtools_tpu_torch.train import Trainer, TrainStepConfig, sgd
    from asv_subtools_tpu_torch.weights import init_weights_

    net = SpeakerNet(FactoredXvector(D, 0.0625, 8, device="cpu"), "margin_softmax", {"method": "am"}, num_targets=C)
    net = init_weights_(net, 4).double()
    config = TrainStepConfig(compute_dtype=torch.float64, max_change=MAX_CHANGE, use_semi_orth=True)
    trainer = Trainer(net, sgd(LR), config=config, device="cpu", mesh=mesh,
                      partition_rules=make_fsdp_rules(mesh, min_size=64) if mesh is not None else None)
    state = trainer.init_state()
    state, m = trainer._train_step(state, trainer._to_device(_port_batch(*_batch(6))),
                                   torch.Generator().manual_seed(0))
    full = trainer.full_state(state)
    sharded = [] if mesh is None else [k for k in trainer.placement.sharded if "factor1" in k]
    return _to_numpy(full.params), _to_numpy(full.batch_stats), {k: float(v) for k, v in m.items()}, sharded


def _placement(net, world):
    from asv_subtools_tpu_torch.parallel import make_mesh
    from asv_subtools_tpu_torch.train.trainer import make_placement

    return make_placement(net, make_mesh(world, 1))


def _check_launcher(workdir):
    from asv_subtools_tpu_torch.launcher import Launcher
    from asv_subtools_tpu_torch.train.reporter import read_report_csv

    params = _launcher_params(os.path.join(workdir, "corpus"), os.path.join(workdir, "exp4"))
    params["train"].update(fsdp=True, num_model=2)
    launcher = Launcher(params, device="cpu")
    egs = launcher.build_egs()
    launcher.build_model()
    launcher.train(egs)
    out = {"specs": dict(launcher.trainer.placement.specs), "data": launcher.trainer.placement.data.size,
           "model": launcher.trainer.placement.model.size}
    if torch.distributed.get_rank() == 0:
        out["losses"] = read_report_csv(os.path.join(params["exp_dir"], "log", "train.csv"))["loss"]
    return out


def _launcher_params(corpus, exp):
    return {
        "exp_dir": exp,
        "data": {"train_wav_scp": os.path.join(corpus, "train", "wav.scp"),
                 "train_utt2spk": os.path.join(corpus, "train", "utt2spk"),
                 "chunk_seconds": 1.0, "batch_size": 8, "shuffle_buffer": 16, "compute_feat": False,
                 "spec_aug": True, "num_bins": 24, "workers": 1},
        "model": {"name": "ecapa_tdnn", "params": dict(SMALL)},
        "loss": {"name": "margin_softmax", "params": {"method": "aam", "m": 0.2, "s": 30.0}},
        "train": {"epochs": 1, "optimizer": {"name": "adamW", "learning_rate": 1e-2, "weight_decay": 5e-5},
                  "lr_schedule": {"name": "constant", "base_lr": 1e-2}, "compute_dtype": "float32",
                  "report_interval": 1},
    }


def _check_asnorm(world):
    from asv_subtools_tpu_torch.backend.score_norm import asnorm_device
    from asv_subtools_tpu_torch.parallel import make_mesh

    return asnorm_device(*_asnorm_inputs(), top_n=ASNORM["top_n"], mesh=make_mesh(world, 1), device="cpu").numpy()


def _checks(world, workdir):
    from asv_subtools_tpu_torch.parallel import make_mesh

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    checks = {"bn": lambda: _check_bn(world, False), "bn_masked": lambda: _check_bn(world, True),
              "asnorm": lambda: _check_asnorm(world)}
    if world == 2:
        checks["sam"] = lambda: run_sam(_placement(_sam_net(), world))
        checks["fd"] = lambda: run_fd(_placement(_fd_net(), world))
        checks["semi_orth_fsdp"] = lambda: run_semi_orth_step(make_mesh(world, 1))
        for head in COUPLED_HEADS:
            checks[head] = lambda head=head: run_head_step(head, make_mesh(world, 1))
    else:
        for name in PLACEMENTS:
            checks[name] = lambda name=name: _check_step(world, name, inputs["variables"])
        checks["launcher"] = lambda: _check_launcher(workdir)
        for head in MODEL_AXIS_HEADS:
            checks[head] = lambda head=head: run_head_step(head, make_mesh(2, 2))
    out = {}
    for name, fn in checks.items():
        try:
            out[name] = fn()
        except Exception:  # the test reports it
            out[name] = {"error": traceback.format_exc()}
    return out


def _rank_main(rank, world, port, workdir):
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                         rank=rank)
    try:
        out = _checks(world, workdir)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}_of_{world}.pkl"), "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# this process's side
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from asv_subtools_tpu_torch.recipes.synthetic import write_corpus
    from test_torch_optimizer_states import port_variables

    root = tmp_path_factory.mktemp("torch_mesh")
    write_corpus(str(root / "corpus"), num_spks=4, train_per_spk=4)
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({"variables": port_variables(_port_net())}, f)
    return str(root)


def _spawn(world, workdir):
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(world, _free_port(), workdir), nprocs=world, join=True,
                       start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}_of_{world}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def ranks2(workdir):
    return _spawn(2, workdir)


@pytest.fixture(scope="module")
def ranks4(workdir):
    return _spawn(4, workdir)


def _result(ranks, name):
    for r, out in enumerate(ranks):
        got = out[name]
        if isinstance(got, dict) and "error" in got:
            pytest.fail(f"rank {r}, {name}:\n{got['error']}")
    return [out[name] for out in ranks]


def _close(got, want, tol, atol=1e-12):
    """Every leaf of ``got`` within ``tol`` of its scale (plus ``atol``)
    of ``want``; both dicts of arrays."""
    assert set(got) == set(want)
    bad = {}
    for k, v in want.items():
        v = np.asarray(v, np.float64)
        err = max(np.abs(np.asarray(got[k], np.float64) - v).max() - atol, 0.0) / max(np.abs(v).max(), 1e-300)
        if err > tol:
            bad[k] = err
    assert not bad, f"leaves off by more than {tol} of their scale: {bad}"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_global_batchnorm_equals_whole_batch_batchnorm(ranks2, ranks4, world, masked):
    from asv_subtools_tpu_torch.nn.norm import BatchNorm

    got = _result(ranks2 if world == 2 else ranks4, "bn_masked" if masked else "bn")
    x, w, mask = _bn_inputs()
    bn = BatchNorm(x.shape[1]).double().train()
    xg = x.clone().requires_grad_()
    y = bn(xg, mask if masked else None)
    (y * w).sum().backward()
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]), y.detach().numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([g["grad"] for g in got]), xg.grad.numpy(), rtol=0, atol=1e-12)
    for g in got:
        np.testing.assert_allclose(g["mean"], bn.mean.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(g["var"], bn.var.numpy(), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def single_step(workdir):
    """The one-process port step from the same variables."""
    from test_torch_train_step import run_port

    from asv_subtools_tpu_torch.train import sgd

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        variables = pickle.load(f)["variables"]
    state, metrics = run_port(_port_net(), sgd(LR, momentum=MOMENTUM), variables, [_batch()], _cfg())
    return variables, state, metrics[0]


def _jax_mesh_step(variables, d, m, rules):
    """JAX's Trainer step on a (d, m) virtual CPU mesh under ``rules``, in
    f64, from the same variables and batch."""
    import jax
    import jax.numpy as jnp
    import optax

    from asv_subtools_tpu.parallel import (classifier_partition_rules, make_fsdp_rules, make_mesh,
                                           opt_state_shardings, partition_params, replicate)
    from asv_subtools_tpu.parallel.mesh import replicated_sharding
    from asv_subtools_tpu.train.trainer import Trainer as JaxTrainer
    from asv_subtools_tpu.train.trainer import TrainState as JaxTrainState
    from asv_subtools_tpu.train.trainer import TrainStepConfig as JaxStepConfig
    from test_torch_train_step import jax_batch, jax_net

    x, y, mask = _batch()
    with jax.enable_x64():
        mesh = make_mesh(num_data=d, num_model=m, devices=jax.devices()[:d * m])
        rules = {None: None, "classifier": classifier_partition_rules,
                 "fsdp": make_fsdp_rules(mesh, min_size=64)}[rules]
        tx = optax.sgd(LR, momentum=MOMENTUM)
        trainer = JaxTrainer(jax_net(), tx, config=JaxStepConfig(compute_dtype=jnp.float64, max_change=MAX_CHANGE),
                             mesh=mesh, partition_rules=rules)
        batch = jax_batch(x, y, mask, jnp.float64)
        # JAX Trainer.init_state's placement (trainer.py:515-538) of the
        # given variables, without compiling the net's init
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                              batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))
        rep = replicated_sharding(mesh)
        if rules is None:
            state = replicate(mesh, state)
        else:
            p_sh = partition_params(mesh, state.params, rules)
            o_sh = opt_state_shardings(mesh, state.opt_state, state.params, p_sh)
            shardings = JaxTrainState(step=rep, params=p_sh, opt_state=o_sh,
                                      batch_stats=jax.tree_util.tree_map(lambda _: rep, state.batch_stats))
            trainer._build_jits(shardings)
            state = jax.tree_util.tree_map(jax.device_put, state, shardings)
        one = jnp.asarray(1.0, jnp.float32)
        state, metrics = trainer._train_step(state, batch, jax.random.PRNGKey(0), one, jnp.asarray(0.0, jnp.float32),
                                             one)
        return jax.device_get(state), {k: float(v) for k, v in jax.device_get(metrics).items()}


@pytest.mark.parametrize("name", list(PLACEMENTS))
def test_mesh_step_matches_one_process_and_jax(ranks4, single_step, name):
    from test_torch_train_step import leaf_errors

    from asv_subtools_tpu_torch.weights import state_dict_to_variables

    variables, state, metrics = single_step
    got = _result(ranks4, name)[0]
    for coll in ("params", "batch_stats"):
        _close(got[coll], _to_numpy(getattr(state, coll)), 1e-10)
    for k in ("loss", "accuracy", "grad_norm", "skipped"):
        np.testing.assert_allclose(got["metrics"][k], metrics[k], rtol=1e-6, atol=1e-12, err_msg=k)
    assert metrics["grad_norm"] > MAX_CHANGE  # the global-norm clip is engaged
    d, m, rules = PLACEMENTS[name]
    jstate, jm = _jax_mesh_step(variables, d, m, rules)
    ours = state_dict_to_variables({k: torch.from_numpy(v) for k, v in {**got["params"], **got["batch_stats"]}.items()})
    for coll, ref in (("params", jstate.params), ("batch_stats", jstate.batch_stats)):
        bad = {k: e for k, e in leaf_errors(ours[coll], ref).items() if e > 1e-6}
        assert not bad, f"{coll} leaves off JAX's {name} step: {bad}"
    np.testing.assert_allclose(got["metrics"]["grad_norm"], jm["grad_norm"], rtol=1e-6)
    np.testing.assert_allclose(got["metrics"]["loss"], jm["loss"], rtol=1e-6)


def test_placements_shard_as_their_rules_say(ranks4):
    """data4 replicates every leaf; data2_model2 holds the classifier's
    rows over "model"; data4_fsdp holds flat chunks of the large leaves,
    and the momentum follows its parameter's shard."""
    for name, (d, m, rules) in PLACEMENTS.items():
        for rank, got in enumerate(_result(ranks4, name)):
            specs, local, full = got["specs"], got["local"], {k: v.shape for k, v in got["params"].items()}
            assert got["trace"] == local
            for k, spec in specs.items():
                n = int(np.prod(full[k]))
                if spec is None:
                    assert local[k] == full[k], (name, k)
                elif spec == "model":
                    assert local[k] == (full[k][0] // m, *full[k][1:]), (name, k)
                else:
                    assert local[k] == (n // d,), (name, k)
            if rules is None:
                assert not any(specs.values())
            elif rules == "classifier":
                assert [k for k, s in specs.items() if s] == ["loss.weight"]
            else:
                assert sum(s == "data" for s in specs.values()) > 10


def test_sam_step_data_parallel_matches_one_process(ranks2):
    params, stats, metrics = run_sam()
    for got in _result(ranks2, "sam"):
        _close(got[0], params, 1e-10)
        _close(got[1], stats, 1e-10)
        for k in ("loss", "sam_loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(got[2][k], metrics[k], rtol=1e-6, err_msg=k)


def test_fd_step_data_parallel_matches_one_process(ranks2):
    params, stats, metrics = run_fd()
    for got in _result(ranks2, "fd"):
        _close(got[0], params, 1e-10)
        _close(got[1], stats, 1e-10)
        for gm, m in zip(got[2], metrics):
            for k in ("loss", "accuracy", "adversarial_cos", "phase_adv"):
                np.testing.assert_allclose(gm[k], m[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("head", list(COUPLED_HEADS))
def test_batch_coupled_heads_data_parallel_match_one_process(ranks2, head):
    params, stats, metrics = run_head_step(head)
    tol = COUPLED_HEADS[head][2]
    for got in _result(ranks2, head):
        _close(got[0], params, tol)
        _close(got[1], stats, tol)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[2][k], metrics[k], rtol=max(tol, 1e-6), err_msg=k)


@pytest.mark.parametrize("head", list(MODEL_AXIS_HEADS))
def test_model_axis_heads_match_one_process(ranks4, head):
    """The minimum-hyperspherical-energy and inter losses (every class
    row, gathered over "model") and the sub-centre top-k head (its
    sub-centre max and top-k over the gathered cosines)."""
    params, stats, metrics = run_head_step(head)
    tol = MODEL_AXIS_HEADS[head][2]
    for got in _result(ranks4, head):
        _close(got[0], params, tol)
        _close(got[1], stats, tol)
        for k in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(got[2][k], metrics[k], rtol=max(tol, 1e-6), err_msg=k)


def test_semi_orth_update_of_zero3_shards_matches_one_process(ranks2):
    params, stats, metrics, _ = run_semi_orth_step()
    for got in _result(ranks2, "semi_orth_fsdp"):
        assert got[3], "no factor1 weight was sharded"
        _close(got[0], params, 1e-10)
        _close(got[1], stats, 1e-10)
        np.testing.assert_allclose(got[2]["loss"], metrics["loss"], rtol=1e-6)


def test_launcher_fsdp_model_axis_on_four_ranks(ranks4, workdir, tmp_path):
    from asv_subtools_tpu_torch.launcher import Launcher
    from asv_subtools_tpu_torch.train import load_checkpoint
    from asv_subtools_tpu_torch.train.reporter import read_report_csv

    got = _result(ranks4, "launcher")
    assert (got[0]["data"], got[0]["model"]) == (2, 2)
    assert got[0]["specs"]["loss.weight"] == "model"
    params = _launcher_params(os.path.join(workdir, "corpus"), str(tmp_path / "exp1"))
    one = Launcher(params, device="cpu")
    egs = one.build_egs()
    one.build_model()
    one.train(egs)
    losses = read_report_csv(os.path.join(params["exp_dir"], "log", "train.csv"))["loss"]
    assert len(got[0]["losses"]) == len(losses) > 0
    np.testing.assert_allclose(got[0]["losses"][0], losses[0], rtol=1e-5)
    # the 4-rank checkpoint, gathered whole by rank 0, loads into one process's state
    state = load_checkpoint(os.path.join(workdir, "exp4", "checkpoints", "final.params"), one.state)
    assert all(state.params[k].shape == one.state.params[k].shape for k in one.state.params)
    assert all(torch.isfinite(v).all() for v in state.params.values())
    assert int(state.step) == int(one.state.step)


@pytest.mark.parametrize("world", [2, 4])
def test_asnorm_device_mesh_matches_unsharded_and_jax(ranks2, ranks4, world):
    import jax

    from asv_subtools_tpu.backend.score_norm import asnorm_device as jax_asnorm
    from asv_subtools_tpu.parallel import make_mesh
    from asv_subtools_tpu_torch.backend.score_norm import asnorm_device

    raw, ec, tc = _asnorm_inputs()
    want = asnorm_device(raw, ec, tc, top_n=ASNORM["top_n"], device="cpu").numpy()
    ref = np.asarray(jax_asnorm(raw, ec, tc, top_n=ASNORM["top_n"],
                                mesh=make_mesh(num_data=world, devices=jax.devices()[:world])))
    for got in _result(ranks2 if world == 2 else ranks4, "asnorm"):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
