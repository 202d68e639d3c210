"""The port's Launcher on the host feature types mfcc, fbank_pitch and
mfcc_pitch (data.compute_feat=True) against the JAX Launcher, on a
synthetic corpus the test writes (recipes/synthetic.py).

* Stage 0: the first epoch's batches of both Launchers' egs carry the same
  keys and labels, and features within 1e-4 (the port's MFCC sits within
  5e-5 of JAX's numpy path, tests/test_torch_features_tail.py; the pitch
  columns are the same float64 numpy). With data.num_bins the mfcc types
  take MfccOptions(mel_opts=...): 13 cepstra, 16 columns with pitch.
* Stage 1: one epoch of mfcc_pitch from one JAX init (train.transfer on
  both sides), sgd at 1e-3 with the AM head, report_interval 1: the
  per-step losses within tests/test_torch_launcher.py's relative 1e-4.
"""

import os

import jax
import numpy as np
import pytest
import torch

from asv_subtools_tpu.launcher import Launcher as JaxLauncher
from asv_subtools_tpu.parallel import make_mesh
from asv_subtools_tpu.train import read_report_csv
from asv_subtools_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from asv_subtools_tpu_torch.launcher import Launcher
from asv_subtools_tpu_torch.recipes.synthetic import write_corpus
from asv_subtools_tpu_torch.weights import variables_to_state_dict

torch.set_num_threads(2)

LOSS_RTOL = 1e-4  # tests/test_torch_launcher.py
FEAT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("torch_launcher_feats_corpus")), num_spks=4, train_per_spk=8)


def _params(corpus, exp, feat_type):
    return {
        "exp_dir": exp,
        "data": {"train_wav_scp": os.path.join(corpus, "train", "wav.scp"),
                 "train_utt2spk": os.path.join(corpus, "train", "utt2spk"),
                 "chunk_seconds": 1.0, "batch_size": 8, "shuffle_buffer": 16, "compute_feat": True,
                 "feat_type": feat_type, "num_bins": 23, "speed_perturb": True, "workers": 2},
        "model": {"name": "ecapa_tdnn", "params": {"channels": 32, "mfa_conv": 96, "embd_dim": 16}},
        "loss": {"name": "margin_softmax", "params": {"method": "am", "m": 0.2, "s": 30.0}},
        "train": {"epochs": 1, "optimizer": {"name": "sgd", "learning_rate": 1e-3},
                  "lr_schedule": {"name": "constant", "base_lr": 1e-3}, "compute_dtype": "float32",
                  "report_interval": 1},
    }


def _jax_launcher(params):
    return JaxLauncher(params, mesh=make_mesh(devices=jax.devices()[:1]))


@pytest.mark.parametrize("feat_type,dim", [("mfcc", 13), ("fbank_pitch", 27), ("mfcc_pitch", 16)])
def test_egs_features_match_jax(corpus, tmp_path, feat_type, dim):
    params = _params(corpus, str(tmp_path / "exp"), feat_type)
    if feat_type == "fbank_pitch":
        params["data"]["num_bins"] = 24  # 24 fbank bins + 3 pitch columns
    port, ref = Launcher(params, device="cpu"), _jax_launcher(params)
    port_egs, ref_egs = port.build_egs(), ref.build_egs()
    assert port.feat_dim == dim and port.num_targets == ref.num_targets == 12
    assert type(port.feat_opts).__name__ == type(ref.feat_opts).__name__
    port_egs.set_epoch(0)
    ref_egs.set_epoch(0)
    got, want = list(port_egs), list(ref_egs)
    assert len(got) == len(want) == 4
    for bg, bw in zip(got, want):
        assert bg["keys"] == bw["keys"] and np.array_equal(bg["y"], bw["y"])
        assert bg["x"].shape == bw["x"].shape and bg["x"].shape[-1] == dim
        np.testing.assert_allclose(bg["x"], bw["x"], **FEAT_TOL)


def _init(params, tmp_path, feat_dim):
    """One JAX init written as a JAX checkpoint and as a port one."""
    launcher = _jax_launcher(dict(params, exp_dir=str(tmp_path / "init")))
    launcher.build_egs()
    net = launcher.build_model()
    x = jax.numpy.zeros((2, 98, feat_dim), jax.numpy.float32)
    variables = net.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(5)}, x,
                         jax.numpy.zeros((2,), jax.numpy.int32), train=False)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))

    class _Init:  # the fields save_checkpoint reads
        params, batch_stats, opt_state = variables["params"], variables.get("batch_stats", {}), {}
        step = np.zeros((), np.int32)

    jax_ckpt = str(tmp_path / "jax_init")
    jax_save_checkpoint(jax_ckpt, _Init, 0, save_optimizer=False)
    port_ckpt = str(tmp_path / "port_init.params")
    state_dict = variables_to_state_dict({"params": variables["params"]})
    torch.save({"params": {k: v.float() for k, v in state_dict.items()}, "step": 0}, port_ckpt)
    return os.path.join(jax_ckpt, "0.params"), port_ckpt


def test_mfcc_pitch_losses_match_jax(corpus, tmp_path):
    base = _params(corpus, "", "mfcc_pitch")
    jax_ckpt, port_ckpt = _init(base, tmp_path, 16)
    losses = {}
    for side, ckpt in (("jax", jax_ckpt), ("port", port_ckpt)):
        params = dict(base, exp_dir=str(tmp_path / side))
        params["train"] = dict(base["train"], transfer={"from": ckpt})
        launcher = _jax_launcher(params) if side == "jax" else Launcher(params, device="cpu")
        egs = launcher.build_egs()
        launcher.build_model()
        launcher.train(egs)
        losses[side] = np.asarray(read_report_csv(os.path.join(params["exp_dir"], "log", "train.csv"))["loss"])
    assert len(losses["jax"]) == len(losses["port"]) == 4 and np.isfinite(losses["port"]).all()
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOSS_RTOL)
