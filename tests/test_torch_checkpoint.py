"""The port's checkpoints (train/checkpoint.py) against the JAX package's
layout and semantics.

* save then load gives the state back bit for bit (torch.equal on every
  params, batch_stats and optimizer leaf; the step as an int);
* ``final.params`` points at the last epoch, as in the JAX layout;
* the JAX package's YAML reader takes the port's sidecar;
* ``load_transfer`` copies whole top-level subtrees: with
  ``exclude=["loss"]`` only the backbone changes;
* without a template and without a card, loading raises unless the
  caller asks for the CPU.
"""

import os

import numpy as np
import pytest
import torch

from asv_subtools_tpu.utils.params import load_yaml as jax_load_yaml
from asv_subtools_tpu_torch.models import EcapaTdnn, SpeakerNet
from asv_subtools_tpu_torch.train import (TrainStepConfig, get_optimizer, init_train_state, load_checkpoint,
                                          load_transfer, make_train_step, save_checkpoint)
from asv_subtools_tpu_torch.train.checkpoint import read_checkpoint_info
from asv_subtools_tpu_torch.weights import init_weights_

torch.set_num_threads(2)


def _net(seed=0, num_targets=6):
    net = SpeakerNet(EcapaTdnn(input_dim=16, channels=16, mfa_conv=48, embd_dim=8, device="cpu"),
                     "margin_softmax", {"method": "aam", "m": 0.2}, num_targets=num_targets)
    return init_weights_(net, seed)


def _trained_state(seed=0, steps=2):
    """A state two adamW steps in: moments and BN statistics are non-trivial."""
    net = _net(seed)
    tx = get_optimizer("adamW", 1e-2)
    state = init_train_state(net, tx, "cpu")
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.float32))
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        batch = {"x": torch.as_tensor(rng.normal(size=(4, 30, 16)), dtype=torch.float32),
                 "y": torch.as_tensor(rng.integers(0, 6, size=4))}
        state, _ = step(state, batch, gen)
    return net, tx, state


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for key in la:
        assert la[key].dtype == lb[key].dtype and torch.equal(la[key], lb[key]), key


@pytest.mark.parametrize("restore_optimizer", [False, True])
def test_round_trip_is_bit_exact(tmp_path, restore_optimizer):
    net, tx, state = _trained_state()
    path = save_checkpoint(str(tmp_path / "ckpt"), state, 3, info={"loss": 1.5})
    assert path == str(tmp_path / "ckpt" / "3.params")
    template = init_train_state(_net(seed=9), tx, "cpu")
    loaded = load_checkpoint(path, template, restore_optimizer=restore_optimizer)
    assert int(loaded.step) == int(state.step) == 2 and loaded.step.dtype == torch.int32
    _assert_equal(loaded.params, state.params)
    _assert_equal(loaded.batch_stats, state.batch_stats)
    if restore_optimizer:
        _assert_equal(loaded.opt_state, state.opt_state)
    else:  # the reference default: the optimizer starts afresh
        _assert_equal(loaded.opt_state, template.opt_state)
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"params", "batch_stats", "step", "opt_state"} and payload["step"] == 2


def test_final_points_at_the_last_epoch_and_jax_reads_the_sidecar(tmp_path):
    _, _, state = _trained_state(steps=1)
    directory = str(tmp_path / "ckpt")
    for epoch in (1, 2):
        save_checkpoint(directory, state, epoch, info={"loss": 0.25 * epoch, "accuracy": 0.5})
    final = os.path.join(directory, "final.params")
    assert os.path.islink(final) and os.readlink(final) == "2.params"
    info = jax_load_yaml(os.path.join(directory, "checkpoint_info", "2.yaml"))
    assert info == {"epoch": 2, "step": 1, "loss": 0.5, "accuracy": 0.5}
    assert read_checkpoint_info(final) == info


def test_load_transfer_excludes_the_head(tmp_path):
    _, tx, donor = _trained_state(seed=1)
    path = save_checkpoint(str(tmp_path / "donor"), donor, 1)
    target = init_train_state(_net(seed=2), tx, "cpu").params
    out = load_transfer(target, path, exclude=["loss"])
    for key, value in out.items():
        want = target[key] if key.startswith("loss.") else donor.params[key]
        assert torch.equal(value, want), key
    assert any(k.startswith("loss.") for k in out) and not torch.equal(out["loss.weight"], donor.params["loss.weight"])
    only_head = load_transfer(target, path, include=["loss"])
    assert torch.equal(only_head["loss.weight"], donor.params["loss.weight"])
    assert all(torch.equal(only_head[k], target[k]) for k in target if k.startswith("backbone."))


def test_load_transfer_rename_and_shape_check(tmp_path):
    _, tx, donor = _trained_state(seed=1)
    path = save_checkpoint(str(tmp_path / "donor"), donor, 1)
    target = init_train_state(_net(seed=2), tx, "cpu").params
    renamed = {k.replace("backbone.", "encoder.", 1): v for k, v in target.items()}
    out = load_transfer(renamed, path, rename={"backbone": "encoder"}, exclude=["loss"])
    assert all(torch.equal(out["encoder." + k[len("backbone."):]], v) for k, v in donor.params.items()
               if k.startswith("backbone."))
    wider = init_train_state(_net(seed=2, num_targets=9), tx, "cpu").params
    with pytest.raises(ValueError, match="shape"):
        load_transfer(wider, path)


def test_load_without_template_needs_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, state = _trained_state(steps=1)
    path = save_checkpoint(str(tmp_path / "c"), state, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(path)
    payload = load_checkpoint(path, device="cpu")
    _assert_equal(payload["params"], state.params)
