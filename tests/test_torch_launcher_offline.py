"""The port's Launcher on the offline chunk-egs route against the JAX
Launcher, on one egs dir.

The egs dir: a synthetic corpus (recipes/synthetic.py write_corpus, 4
speakers x 6 utterances) through the port's Kaldi-style host front end
(write_feature_datadir: 24-bin fbank with dither, energy VAD, sliding
CMVN, voiced frames), seeded phone alignments (10 phones) and auxiliary
labels (3 classes) (write_offline_labels), then prepare_egs_dir (chunk
100, 4 utterances held out, 2 validation chunks an utterance): 36
training chunks, 4 steps an epoch at B=8.

Each comparison starts both Launchers from the same weights (the JAX
net's init carried across by weights.py: train.transfer of a checkpoint
each, or for FD, whose JAX loop takes no transfer, resume_from) and runs
f32 sgd at lr 1e-3 (the terms of tests/test_torch_launcher.py: an f32
step of a narrow net with train-mode BN at B=8 is ill-conditioned, so a
small rate keeps the two sides' rounding from growing), on the same
batches (the chunk egs are equal bit for bit, specaugment included, once
the port's egs give up the one batch that the JAX Launcher draws to
initialise its net), and holds the per-step losses at rtol 1e-4:
* a narrow x-vector with validation and per-chunk SpecAugment, two
  epochs; the validation after epoch 1, and the port's validation of
  JAX's final state against JAX's after epoch 2;
* SAM (train.sam, rho 0.05) at lr 1e-4: the losses of both passes and
  the ascent's norm;
* the multi-task x-vector on the dual-label egs (multitask.yaml's softmax
  head, 10 phones), with validation on the dual-label valid egs;
* FD-AL (cycle 4, adv_steps 2) for two epochs through the port's
  Trainer: each epoch's last loss (the JAX loop reports no other), then
  extraction in feature mode, its embeddings against JAX's at 1e-4 of
  their scale;
* the optimizer's ``sam`` flag (port only; JAX's raises TypeError): the
  same run as ``train.sam``;
* find_lr: the same lrs, losses at rtol 1e-4 and the same suggestion.
The process pool (two spawn workers) runs on the port only: the arrival
order of the workers' batches is not fixed, so its steps are not held
against JAX's; it must take every batch of both workers' splits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from asv_subtools_tpu.io import read_vec_flt_scp as jax_read_vec_flt_scp
from asv_subtools_tpu.launcher import Launcher as JaxLauncher
from asv_subtools_tpu.parallel import make_mesh
from asv_subtools_tpu.train import read_report_csv
from asv_subtools_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from asv_subtools_tpu_torch.data import ChunkEgs, ChunkEgsMultiTask, MultiprocessLoader, prepare_egs_dir
from asv_subtools_tpu_torch.data.egs_offline import build_chunk_egs_from_dir
from asv_subtools_tpu_torch.io import read_vec_flt_scp
from asv_subtools_tpu_torch.launcher import Launcher
from asv_subtools_tpu_torch.recipes.synthetic import write_corpus, write_feature_datadir, write_offline_labels
from asv_subtools_tpu_torch.train import save_checkpoint
from asv_subtools_tpu_torch.weights import load_variables, train_state_from_variables, variables_to_state_dict

torch.set_num_threads(2)

LOSS_RTOL = 1e-4
BINS = 24


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("offline_route"))
    write_corpus(root, num_spks=4, train_per_spk=6)
    feats = os.path.join(root, "feats")
    write_feature_datadir(os.path.join(root, "train"), feats, num_bins=BINS)
    ali_scp, utt2aux = write_offline_labels(feats, num_phones=10, num_aux=3)
    egs = os.path.join(root, "egs")
    assert prepare_egs_dir(feats, egs, chunk_size=100, valid_num_utts=4, valid_chunk_num=2) == (BINS, 4)
    return {"root": root, "egs": egs, "ali_scp": ali_scp, "utt2aux": utt2aux}


def _params(offline, exp, **data):
    return {
        "exp_dir": exp,
        "data": {"egs_type": "offline", "egs_dir": offline["egs"], "batch_size": 8, "num_bins": BINS, **data},
        "model": {"name": "xvector", "params": {"num_frame_channels": 24, "embd_dim": 16}},
        "loss": {"name": "margin_softmax", "params": {"method": "am", "m": 0.1}},
        "train": {"epochs": 1, "optimizer": {"name": "sgd", "learning_rate": 1e-3},
                  "lr_schedule": {"name": "constant", "base_lr": 1e-3}, "compute_dtype": "float32",
                  "report_interval": 1},
        "extract": {"mode": "feature", "batch": 4, "workers": 1},
    }


def _jax_launcher(params):
    return JaxLauncher(params, mesh=make_mesh(devices=jax.devices()[:1]))


def _jax_variables(params):
    """The JAX Launcher's net initialised on its egs' first batch, as numpy trees."""
    launcher = _jax_launcher(params)
    egs = launcher.build_egs()
    net = launcher.build_model()
    batch = next(iter(egs))
    x, y = jnp.asarray(batch["x"]), jnp.asarray(batch["y"])
    key = {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(5)}
    if "phone_y" in batch:
        variables = net.init(key, x, {"spk": y, "phone": jnp.asarray(batch["phone_y"])}, train=False)
    elif params["model"]["name"] == "fd_xvector":
        variables = net.init(key, x, y, jnp.asarray(batch["aux_y"]), train=False)
    else:
        variables = net.init(key, x, y, train=False)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


class _JaxInit:
    def __init__(self, variables):
        self.params, self.batch_stats = variables["params"], variables.get("batch_stats", {})
        self.step, self.opt_state = np.zeros((), np.int32), {}


def _against_jax(base, tmp_path, resume=False):
    """Both Launchers from one JAX init over ``base``: (JAX launcher, port
    launcher, their exp dirs)."""
    variables = _jax_variables(dict(base, exp_dir=str(tmp_path / "init")))
    jax_save_checkpoint(str(tmp_path / "jax_init"), _JaxInit(variables), 0, save_optimizer=False)
    out = {}
    for side in ("jax", "port"):
        exp = str(tmp_path / side)
        params = dict(base, exp_dir=exp, train=dict(base["train"]))
        launcher = _jax_launcher(params) if side == "jax" else Launcher(params, device="cpu")
        egs = launcher.build_egs()
        launcher.build_model()
        if side == "port":
            # the JAX Launcher draws an example batch from the training egs
            # before its first epoch (launcher.py:478), which moves the egs'
            # augmentation generator on by one batch; the port needs none
            next(iter(egs))
        if side == "jax":
            ckpt = str(tmp_path / "jax_init" / "0.params")
        elif resume:
            tree = {"step": 0, "params": variables["params"], "batch_stats": variables.get("batch_stats", {}),
                    "opt_state": {"count": 0}}
            state = train_state_from_variables(launcher.net, tree, device="cpu")
            ckpt = save_checkpoint(str(tmp_path / "port_init"), state, 0, save_optimizer=False)
        else:
            ckpt = str(tmp_path / "port_init.params")
            sd = variables_to_state_dict({"params": variables["params"]})
            torch.save({"params": {k: v.float() for k, v in sd.items()}, "step": 0}, ckpt)
        if resume:
            launcher.train(egs, resume_from=ckpt)
        else:
            launcher.params["train"]["transfer"] = {"from": ckpt}
            launcher.train(egs)
        out[side] = (launcher, exp)
    return out


def _info(exp, epoch):
    """A checkpoint's sidecar (YAML from JAX; JSON, which YAML reads, from the port)."""
    with open(os.path.join(exp, "checkpoints", "checkpoint_info", f"{epoch}.yaml")) as f:
        return yaml.safe_load(f)


def _losses(exp, key="loss"):
    return np.asarray(read_report_csv(os.path.join(exp, "log", "train.csv"))[key])


def test_offline_training_with_validation_matches_jax(offline, tmp_path):
    base = _params(offline, "", aug="specaugment", aug_params={"frequency": 0.2, "frame": 0.1, "cols": 1})
    base["train"]["epochs"] = 2
    runs = _against_jax(base, tmp_path)
    (jl, jexp), (pl, pexp) = runs["jax"], runs["port"]
    assert isinstance(pl.valid_egs, ChunkEgs) and pl.num_targets == 4 and pl.feat_dim == BINS
    ref, got = _losses(jexp), _losses(pexp)
    assert len(ref) == len(got) == 8 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    # the validation after epoch 1; after epoch 2 the f32 drift of eight
    # steps moves the margin head's logits (s = 30) by 3e-4 of the loss, so
    # the port validates JAX's own final state there
    pm, jm = pl.epoch_stats[0]["metrics"], _info(jexp, 1)
    np.testing.assert_allclose([pm["valid_loss"], pm["valid_accuracy"]], [jm["valid_loss"], jm["valid_accuracy"]],
                               rtol=LOSS_RTOL)
    final = jax.tree_util.tree_map(np.asarray, jax.device_get({"params": jl.state.params,
                                                               "batch_stats": jl.state.batch_stats}))
    state = train_state_from_variables(pl.net, {"step": 8, **final, "opt_state": {"count": 0}}, device="cpu")
    got_valid = pl.trainer.validate(state, iter(pl.valid_egs))
    jm = _info(jexp, 2)
    np.testing.assert_allclose([got_valid["loss"], got_valid["accuracy"]], [jm["valid_loss"], jm["valid_accuracy"]],
                               rtol=LOSS_RTOL)
    assert sorted(os.listdir(os.path.join(pexp, "checkpoints"))) == ["1.params", "2.params", "checkpoint_info",
                                                                     "final.params"]


def test_offline_sam_matches_jax(offline, tmp_path):
    base = _params(offline, "")
    base["train"]["sam"] = {"rho": 0.05}
    # two passes a step double the f32 rounding that a step amplifies: at
    # lr 1e-3 the third loss sits 1.04e-4 from JAX's (the f64 SAM step is
    # held leaf by leaf in tests/test_torch_multitask.py)
    base["train"]["optimizer"] = {"name": "sgd", "learning_rate": 1e-4}
    base["train"]["lr_schedule"] = {"name": "constant", "base_lr": 1e-4}
    runs = _against_jax(base, tmp_path)
    for key in ("loss", "sam_loss", "grad_norm"):
        ref, got = _losses(runs["jax"][1], key), _losses(runs["port"][1], key)
        assert len(ref) == len(got) == 4
        np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, err_msg=key)
    assert np.all(_losses(runs["port"][1], "sam_loss") != _losses(runs["port"][1], "loss"))


def test_optimizer_sam_flag_runs_the_sam_step(offline, tmp_path):
    """optimizer {sam, sam_rho, sam_adaptive} gives the run of train.sam
    {rho, adaptive}, loss for loss and leaf for leaf."""
    runs = {}
    for how in ("train", "optimizer"):
        params = _params(offline, str(tmp_path / how))
        if how == "train":
            params["train"]["sam"] = {"rho": 0.1, "adaptive": True}
        else:
            params["train"]["optimizer"].update(sam=True, sam_rho=0.1, sam_adaptive=True)
        launcher = Launcher(params, device="cpu")
        egs = launcher.build_egs()
        launcher.build_model()
        runs[how] = (launcher.train(egs), _losses(str(tmp_path / how), "sam_loss"))
    (ts, tl), (os_, ol) = runs["train"], runs["optimizer"]
    assert len(tl) == 4 and np.isfinite(tl).all()
    np.testing.assert_array_equal(ol, tl)
    assert all(torch.equal(os_.params[k], ts.params[k]) for k in ts.params)


def test_offline_multitask_matches_jax(offline, tmp_path):
    base = _params(offline, "", ali_scp=offline["ali_scp"])
    base["model"] = {"name": "multi_task_xvector",
                     "params": {"num_frame_channels": 24, "embd_dim": 16, "num_phones": 10, "mt_alpha": 0.3}}
    base["loss"] = {"name": "softmax", "params": {}}  # multitask.yaml's head
    runs = _against_jax(base, tmp_path)
    pl = runs["port"][0]
    assert type(pl.net).__name__ == "MultiTaskNet" and isinstance(pl.valid_egs, ChunkEgsMultiTask)
    ref, got = _losses(runs["jax"][1]), _losses(runs["port"][1])
    assert len(ref) == len(got) == 4
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    jm = _info(runs["jax"][1], 1)
    np.testing.assert_allclose(pl.epoch_stats[0]["metrics"]["valid_loss"], jm["valid_loss"], rtol=LOSS_RTOL)


def test_offline_fd_matches_jax_and_extracts(offline, tmp_path):
    base = _params(offline, "", aux_utt2label=offline["utt2aux"])
    base["model"] = {"name": "fd_xvector", "params": {"num_frame_channels": 24, "embd_dim": 16,
                                                      "num_aux_targets": 3}}
    base["loss"] = {"name": "softmax", "params": {}}
    base["train"]["epochs"] = 2
    base["train"]["fd"] = {"cycle": 4, "adv_steps": 2, "aux_weight": 0.2, "adv_weight": 0.1,
                           "adv_optimizer": {"name": "sgd", "learning_rate": 1e-3}}
    runs = _against_jax(base, tmp_path, resume=True)
    (jl, jexp), (pl, pexp) = runs["jax"], runs["port"]
    # the port's Trainer reports every step (the phases 1, 1, 0, 0 of each
    # cycle); its checkpoint holds the epoch's mean loss
    rows = read_report_csv(os.path.join(pexp, "log", "train.csv"))
    assert rows["phase_adv"] == [1.0, 1.0, 0.0, 0.0] * 2
    for epoch in (1, 2):
        jm, pm = _info(jexp, epoch), _info(pexp, epoch)
        assert pm["step"] == jm["step"] == 4 * epoch and pm["phase_adv"] == jm["phase_adv"] == 0.0
        last = 4 * epoch - 1
        np.testing.assert_allclose(rows["loss"][last], jm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(pm["loss"], np.mean(rows["loss"][last - 3:last + 1]), rtol=1e-6)
        # the squared cosine of nearly orthogonal parts (about 3e-5): held
        # absolutely, at 1e-7
        np.testing.assert_allclose(rows["adversarial_cos"][last], jm["adversarial_cos"], rtol=0, atol=1e-7)
    assert isinstance(pl.state.opt_state, tuple) and pl.epoch_stats[1]["steps"] == 4
    wav_scp = os.path.join(offline["root"], "eval", "wav.scp")
    jl.extract(wav_scp, str(tmp_path / "jax_xv"))
    stats = pl.extract(wav_scp, str(tmp_path / "port_xv"))
    assert stats["utts"] == 8
    ref, got = dict(jax_read_vec_flt_scp(str(tmp_path / "jax_xv.scp"))), dict(read_vec_flt_scp(
        str(tmp_path / "port_xv.scp")))
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert got[k].shape == (16,)
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4 * np.abs(ref[k]).max())


def test_find_lr_matches_jax(offline, tmp_path):
    base = _params(offline, str(tmp_path / "exp"))
    base["train"]["optimizer"] = {"name": "sgd", "learning_rate": 1e-3, "momentum": 0.9}
    jl = _jax_launcher(base)
    jegs = jl.build_egs()
    jl.build_model()
    ref = jl.find_lr(jegs, start_lr=1e-5, end_lr=1e-2, num_steps=4)
    pl = Launcher(dict(base, exp_dir=str(tmp_path / "port")), device="cpu")
    pegs = pl.build_egs()
    pl.build_model()
    # the JAX finder starts from its init on the egs' first batch at PRNGKey(seed)
    batch = next(iter(jegs))
    key = jax.random.PRNGKey(base.get("seed", 1024))
    variables = jl.net.init({"params": key, "dropout": key}, jnp.asarray(batch["x"]), jnp.asarray(batch["y"]),
                            train=False)
    load_variables(pl.net, jax.tree_util.tree_map(np.asarray, jax.device_get(variables)))
    got = pl.find_lr(pegs, start_lr=1e-5, end_lr=1e-2, num_steps=4)
    np.testing.assert_allclose(got["lrs"], ref["lrs"], rtol=1e-12)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    assert len(got["lrs"]) == 4 and got["suggested_lr"] is None is ref["suggested_lr"]


def test_find_lr_suggests_a_rate(offline, tmp_path):
    """Ten steps over two epochs' worth of batches: a suggestion inside the sweep."""
    pl = Launcher(_params(offline, str(tmp_path)), device="cpu")
    egs = pl.build_egs()
    pl.build_model()
    batches = list(egs) + list(egs) + list(egs)
    out = pl.find_lr(batches, start_lr=1e-6, end_lr=1.0, num_steps=10)
    assert len(out["lrs"]) > 5 and np.isfinite(out["losses"]).all()
    assert 1e-6 <= out["suggested_lr"] <= 1.0


def test_offline_process_pool_takes_every_batch(offline, tmp_path):
    params = _params(offline, str(tmp_path), num_workers=2)
    launcher = Launcher(params, device="cpu")
    egs = launcher.build_egs()
    assert isinstance(egs, MultiprocessLoader)
    launcher.build_model()
    state = launcher.train(egs)
    cfg = dict(train_csv=os.path.join(offline["egs"], "train.egs.csv"), batch_size=8, seed=1024)
    expected = sum(len(build_chunk_egs_from_dir(cfg, worker_id=w, num_workers=2)) for w in range(2))
    assert int(state.step) == launcher.epoch_stats[0]["steps"] == expected > 0
    assert np.isfinite(launcher.epoch_stats[0]["metrics"]["loss"])
    reports = egs.worker_reports
    assert len(reports) == 2 and all(r["cuda_visible_devices"] == "" for r in reports)
