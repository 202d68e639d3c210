"""NaN-batch forensics (asv_subtools_tpu_torch.train.debug, the Trainer's
nan_debug_dir) and the profiling helpers (utils/profiling.py, utils.Timer,
models.count_params) against the JAX package's.

One tiny x-vector SpeakerNet (Xvector 16/8, softmax head, 4 classes) is
initialised by JAX and carried to the port with weights.py. A batch made
with numpy from a seed goes through each package's step, is dumped and
replayed: the six flags of the two reports are equal, and the replayed
loss of a finite batch equals JAX's at 1e-5 (f32). flops_estimate of a
matrix product is 2·M·N·K exactly (JAX's test holds XLA's count to 10%,
tests/test_debug_profiling.py:71-76); param_count and count_params equal
JAX's on the carried net.
"""

import copy
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.models import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.models import Xvector as JaxXvector
from asv_subtools_tpu.models import count_params as jax_count_params
from asv_subtools_tpu.train import TrainStepConfig as JaxStepConfig
from asv_subtools_tpu.train import get_optimizer as jax_get_optimizer
from asv_subtools_tpu.train import init_train_state as jax_init_train_state
from asv_subtools_tpu.train import make_train_step as jax_make_train_step
from asv_subtools_tpu.train.debug import dump_nan_batch as jax_dump, replay_nan_batch as jax_replay
from asv_subtools_tpu.utils.profiling import param_count as jax_param_count
from asv_subtools_tpu_torch.models import SpeakerNet, Xvector, count_params
from asv_subtools_tpu_torch.train import Trainer, TrainStepConfig, get_optimizer, init_train_state, make_train_step
from asv_subtools_tpu_torch.train.debug import dump_nan_batch, load_nan_batch, replay_nan_batch
from asv_subtools_tpu_torch.utils import Timer
from asv_subtools_tpu_torch.utils.profiling import benchmark, flops_estimate, param_count, trace
from asv_subtools_tpu_torch.weights import load_variables, variables_to_state_dict

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
FLAGS = ("loss_finite", "logits_finite", "embedding_finite", "x_finite", "params_finite")


def _batch(seed=0, b=4, t=20, d=8):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, t, d)).astype(np.float32), "y": rng.integers(0, 4, b).astype(np.int32)}


def _jax_net():
    return JaxSpeakerNet(backbone=JaxXvector(num_frame_channels=16, embd_dim=8), loss_name="softmax",
                         loss_params={}, num_targets=4)


def _port_net():
    return SpeakerNet(Xvector(8, 16, 8, device="cpu"), "softmax", {}, num_targets=4)


@pytest.fixture(scope="module")
def carried():
    """(JAX net, its train state, port net carrying the same weights)."""
    jnet = _jax_net()
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    state = jax_init_train_state(jnet, KEY, batch, jax_get_optimizer("sgd", learning_rate=1e-2))
    pnet = _port_net()
    load_variables(pnet, jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                              "batch_stats": state.batch_stats}))
    return jnet, state, pnet


def _with_nan_param(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    first = np.array(leaves[0])
    first.flat[0] = np.nan
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(first)] + leaves[1:])


@pytest.mark.parametrize("case", ["nan_input", "nan_param", "finite"])
def test_replay_report_matches_jax(carried, tmp_path, case):
    jnet, jstate, pnet = carried
    batch = _batch(1)
    if case == "nan_input":
        batch["x"][0, 0, 0] = np.nan
    if case == "nan_param":
        jstate = jstate.replace(params=_with_nan_param(jstate.params))
    tx = get_optimizer("sgd", learning_rate=1e-2)
    pstate = init_train_state(pnet, tx, "cpu")
    pstate.params = {k: v.float() for k, v in variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jstate.params)}).items()}
    jax_step = jax.jit(jax_make_train_step(jnet, jax_get_optimizer("sgd", learning_rate=1e-2),
                                           config=JaxStepConfig(compute_dtype=jnp.float32)))
    _, jm = jax_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, KEY)
    port_batch = {"x": torch.from_numpy(batch["x"]), "y": torch.from_numpy(batch["y"]).long()}
    _, pm = make_train_step(pnet, tx, config=TrainStepConfig(compute_dtype=torch.float32))(
        pstate, port_batch, torch.Generator().manual_seed(0))
    assert float(pm["skipped"]) == float(jm["skipped"]) == (0.0 if case == "finite" else 1.0)

    ref = jax_replay(jax_dump(str(tmp_path / "jax"), jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jm),
                     jnet)
    path = dump_nan_batch(str(tmp_path / "port"), pstate, port_batch, pm, step=7)
    assert os.path.basename(path) == "nan_batch_step7.pkl"
    payload = load_nan_batch(path)
    assert sorted(payload) == ["batch", "batch_stats", "metrics", "params", "step"]
    assert set(payload["params"]) == set(pstate.params) and isinstance(payload["batch"]["x"], np.ndarray)
    got = replay_nan_batch(path, _port_net(), device="cpu")
    assert sorted(got) == sorted(ref) and {k: got[k] for k in FLAGS} == {k: ref[k] for k in FLAGS}
    assert got["x_finite"] == (case != "nan_input") and got["params_finite"] == (case != "nan_param")
    if case == "finite":
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    else:
        assert not np.isfinite(got["loss"]) and not np.isfinite(ref["loss"])


def test_trainer_dumps_each_skipped_step(tmp_path):
    """A NaN batch between two finite ones: one dump, named by the host's
    step count, holding the NaN batch; without nan_debug_dir nothing is
    written."""
    good, bad = _batch(2), _batch(3)
    bad["x"][:] = np.nan
    for where in (str(tmp_path / "nan"), None):
        trainer = Trainer(_port_net(), get_optimizer("sgd", learning_rate=1e-2),
                          config=TrainStepConfig(compute_dtype=torch.float32), report_interval=100, device="cpu",
                          nan_debug_dir=where)
        state = trainer.init_state()
        state, out = trainer.run_epoch(state, iter([good, bad, good]), torch.Generator().manual_seed(0))
        assert out["skipped"] == 1.0 and int(state.step) == 3
    assert os.listdir(tmp_path) == ["nan"] and os.listdir(tmp_path / "nan") == ["nan_batch_step2.pkl"]
    payload = load_nan_batch(str(tmp_path / "nan" / "nan_batch_step2.pkl"))
    assert np.isnan(payload["batch"]["x"]).all() and payload["metrics"]["skipped"] == 1.0


@pytest.mark.parametrize("m,k,n", [(64, 128, 256), (3, 5, 7)])
def test_flops_estimate_of_a_matmul(m, k, n):
    cost = flops_estimate(lambda x, y: x @ y, torch.ones(m, k), torch.ones(k, n))
    assert cost == {"flops": float(2 * m * n * k), "bytes_accessed": -1.0, "transcendentals": 0.0}


def test_flops_estimate_of_the_tiny_net_counts_its_products(carried):
    """The x-vector's five TDNN layers (each keeps the 20 frames) and two
    affines: 2·(in·context)·out FLOPs a frame or a row, exactly."""
    _, _, pnet = carried
    x = torch.zeros(2, 20, 8)
    backbone = copy.deepcopy(pnet.backbone).eval()
    got = flops_estimate(lambda: backbone(x))["flops"]
    widths = [(8 * 5, 16), (16 * 3, 16), (16 * 3, 16), (16, 16), (16, 1500)]
    want = sum(2 * 2 * 20 * i * o for i, o in widths) + 2 * 2 * (3000 * 8 + 8 * 8)
    assert got == want


def test_benchmark_and_trace(tmp_path):
    a = torch.ones(64, 64)
    stats = benchmark(lambda x: x @ x, a, iters=3, warmup=1)
    assert stats["seconds_per_call"] > 0 and stats["tflops_per_second"] > 0
    with trace(str(tmp_path / "tr")) as prof:
        a @ a
    assert prof is not None
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_param_count_and_count_params_equal_jax(carried):
    _, jstate, pnet = carried
    ref = jax_param_count(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert param_count(pnet) == ref and set(ref) == {"backbone", "loss", "total"}
    assert param_count(dict(pnet.named_parameters())) == ref
    assert count_params(pnet) == count_params(dict(pnet.named_parameters())) == jax_count_params(jstate.params)


def test_timer():
    t = Timer()
    with t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01 and t.elapse() >= t.elapsed
    t.reset()
    assert t.elapse() < t.elapsed + 1.0
