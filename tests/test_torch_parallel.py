"""The mesh's rules and helpers in one process (parallel/mesh.py, utils).

* ``make_fsdp_rules`` and ``classifier_partition_rules`` on ECAPA-TDNN
  C1024 with a 5,994-class head: the port's decisions on its state_dict
  against JAX's on the same weights in JAX's layout
  (weights.state_dict_to_variables), for data sizes 1, 2, 4 and 8 and
  model sizes 1 and 2: the same leaves sharded, over the same axis. The
  port's rules read only the mesh's sizes, so a stand-in with those sizes
  serves here (a DeviceMesh of 8 would need 8 processes).
* ``host_local_slice`` at world 1 equals JAX's; ``auto_scale_lr``.
* The raises: mesh sizes that do not multiply to the world size, a batch
  that does not divide by the data size, classifier rows that do not
  divide by the model size, a ZeRO-3 placement with an optimizer that
  reads a leaf's shape.
* At world 1 (a one-process gloo group from ``initialize_multihost``):
  ``make_mesh``, ``shard_batch``, ``replicate``, ``opt_state_shardings``
  and a Placement's round trip.
"""

import socket
import types

import jax
import numpy as np
import pytest
import torch

from asv_subtools_tpu import utils as jax_utils
from asv_subtools_tpu.parallel import classifier_partition_rules as jax_classifier_rules
from asv_subtools_tpu.parallel import host_local_slice as jax_host_local_slice
from asv_subtools_tpu.parallel import make_fsdp_rules as jax_make_fsdp_rules
from asv_subtools_tpu.parallel import make_mesh as jax_make_mesh
from asv_subtools_tpu_torch import parallel, utils
from asv_subtools_tpu_torch.models import EcapaTdnn, SpeakerNet
from asv_subtools_tpu_torch.parallel import mesh as pmesh
from asv_subtools_tpu_torch.weights import _to_jax


def stand_in_mesh(data: int, model: int):
    """The sizes a DeviceMesh reports, for the rules (no process group)."""
    return types.SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda i: (data, model)[i],
                                 get_group=lambda name: None, get_local_rank=lambda name: 0)


@pytest.fixture(scope="module")
def c1024():
    net = SpeakerNet(EcapaTdnn(input_dim=80, channels=1024, device="cpu"), "margin_softmax_v1",
                     {"method": "aam", "sub_k": 2, "topk": 5, "adapt_method": "topk"}, num_targets=5994)
    return dict(net.named_parameters())


def _jax_spec(spec) -> object:
    axes = [a for a in spec if a is not None]
    return axes[0] if axes else None


@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("kind", ["fsdp", "classifier"])
def test_rules_shard_the_same_leaves_as_jax(c1024, data, model, kind):
    mesh = jax_make_mesh(num_data=data, num_model=model, devices=jax.devices()[:data * model])
    if kind == "fsdp":
        jrules = jax_make_fsdp_rules(mesh)
        prules = parallel.make_fsdp_rules(stand_in_mesh(data, model))
    else:
        jrules, prules = jax_classifier_rules, parallel.classifier_partition_rules
    n_sharded = 0
    for name, p in c1024.items():
        collection, path, value = _to_jax(name, p.detach().numpy())
        assert collection == "params"
        jpath = tuple(jax.tree_util.DictKey(k) for k in path)
        want = _jax_spec(jrules(jpath, jax.ShapeDtypeStruct(value.shape, value.dtype)))
        assert prules(name, p) == want, (name, p.shape)
        n_sharded += want is not None
    # the classifier rule names the model axis whatever its size; ZeRO-3
    # rules replicate everything on a mesh of one
    assert n_sharded == 1 if kind == "classifier" else (n_sharded > 0) == (data * model > 1)


def test_partition_params_checks_the_model_axis(c1024):
    specs = parallel.partition_params(stand_in_mesh(1, 2), c1024, parallel.classifier_partition_rules)
    assert [k for k, s in specs.items() if s] == ["loss.weight"] and specs["loss.weight"] == "model"
    with pytest.raises(ValueError, match="num_targets"):
        parallel.partition_params(stand_in_mesh(1, 5), c1024, parallel.classifier_partition_rules)


def test_host_local_slice_matches_jax():
    for epoch in (0, 3):
        np.testing.assert_array_equal(parallel.host_local_slice(100, epoch=epoch, shuffle_seed=7),
                                      jax_host_local_slice(100, epoch=epoch, shuffle_seed=7))


@pytest.mark.parametrize("args", [(1e-3, 8), (0.2, 4, 2), (5e-4, 1)])
def test_auto_scale_lr(args):
    assert utils.auto_scale_lr(*args) == jax_utils.auto_scale_lr(*args)


def test_shard_batch_raises_on_an_indivisible_batch():
    mesh = stand_in_mesh(4, 1)
    with pytest.raises(ValueError, match="does not divide by the data size 4"):
        parallel.shard_batch(mesh, {"x": np.zeros((6, 3))})
    got = parallel.shard_batch(mesh, {"x": np.arange(8), "n": np.asarray(3.0)})
    np.testing.assert_array_equal(got["x"], [0, 1])
    assert float(got["n"]) == 3.0


def test_make_mesh_needs_a_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        parallel.make_mesh()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def world1():
    parallel.initialize_multihost(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0, backend="gloo")
    yield parallel.make_mesh()
    torch.distributed.destroy_process_group()


def test_make_mesh_sizes_must_multiply_to_the_world(world1):
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        parallel.make_mesh(2, 1)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        parallel.make_mesh(num_model=2)
    assert tuple(world1.mesh_dim_names) == ("data", "model") and world1.size() == 1


def test_world1_helpers(world1):
    x = torch.arange(6.0)
    assert torch.equal(parallel.shard_batch(world1, {"x": x})["x"], x)
    tree = parallel.replicate(world1, {"a": torch.ones(3), "b": (torch.zeros(2),)})
    assert torch.equal(tree["a"], torch.ones(3)) and torch.equal(tree["b"][0], torch.zeros(2))


def test_opt_state_shardings_follow_their_parameter(world1):
    from asv_subtools_tpu_torch.train import get_optimizer

    params = {"w": torch.zeros(64, 4), "b": torch.zeros(4)}
    specs = {"w": "data", "b": None}
    state = get_optimizer("adamW", lookahead=True).init(params)
    got = parallel.opt_state_shardings(world1, state, params, specs)
    assert got["inner"]["mu"] == specs and got["inner"]["nu"] == specs and got["slow"] == specs
    assert got["count"] is None and got["inner"]["count"] is None


def test_placement_round_trip_at_world1(world1):
    from asv_subtools_tpu_torch.train import get_optimizer
    from asv_subtools_tpu_torch.train.trainer import make_placement

    net = SpeakerNet(EcapaTdnn(input_dim=24, channels=32, mfa_conv=96, embd_dim=16, device="cpu"),
                     "margin_softmax", {}, num_targets=10)
    placement = make_placement(net, world1, pmesh.make_fsdp_rules(world1, min_size=64))
    assert not placement.sharded  # a data size of 1 replicates every leaf, as JAX's rules do
    params = {k: p.detach() for k, p in net.named_parameters()}
    full = placement.full_tree(placement.shard_params(params), placement.specs)
    assert all(torch.equal(full[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="element by element"):
        make_placement(net, stand_in_mesh(2, 1), pmesh.make_fsdp_rules(stand_in_mesh(2, 1), min_size=64),
                       get_optimizer("ralamb"))


@pytest.mark.parametrize("local_rank", [None, "1"])
def test_initialize_multihost_pins_the_card_resolve_device_returns(monkeypatch, local_rank):
    """JAX-style arguments on a host of several cards: the card that
    ``initialize_multihost`` makes current under NCCL is the one
    ``resolve_device()`` hands the Trainer, with and without torchrun's
    LOCAL_RANK (the CUDA calls and the group are stand-ins)."""
    from asv_subtools_tpu_torch.device import resolve_device

    pinned = []
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", pinned.append)
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda **kw: pinned.append(kw["rank"]))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    parallel.initialize_multihost("127.0.0.1:1234", 4, 3, backend="nccl")
    card = 3 if local_rank is None else 1
    assert pinned == [3, card]
    assert resolve_device() == torch.device("cuda", card)
