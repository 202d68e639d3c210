"""The port's Launcher (launcher.py) and recipe module on the CPU, on a
synthetic corpus the test writes (recipes/synthetic.py: sinusoid-mixture
speakers, as in tests/test_launcher.py).

* A narrow ECAPA (channels 32) trains in f32 in wave mode through the
  Launcher: the per-step losses fall from the first epoch to the second,
  a checkpoint is written each epoch, a resume from 1.params starts at the
  saved step, and extraction in wave mode writes an ark/scp that the JAX
  package's reader takes, whose cosine EER beats 0.35 (the bound of
  tests/test_launcher.py).
* The port's Launcher against the JAX Launcher: both start from the same
  weights (train.transfer of a checkpoint each, from one JAX init) and run
  one epoch on the same corpus (speed perturbation on, SpecAugment off, so
  the steps draw nothing at random), sgd at lr 1e-3, the recipe's
  sub-centre top-k AAM head and margin warm-up. The data planes give
  identical batches; the front ends differ (JAX's fused fbank in interpret
  mode against the port's plain version, both f32), so the four per-step
  losses are held to a relative LOSS_RTOL of 1e-4; measured: 1.5e-5 at
  the first step, under 7e-6 after it.
* Options that are not ported raise NotImplementedError naming their
  ROADMAP item; without a card and without device="cpu" the Launcher raises.
  The offline chunk egs, SAM, the multi-task and FD-AL models and find_lr
  are held against JAX's Launcher in tests/test_torch_launcher_offline.py.
  Stage 3 (scoring) is tested in tests/test_torch_scoring.py.
"""

import os
import socket

import jax
import numpy as np
import pytest
import torch

from asv_subtools_tpu.io import read_vec_flt_scp as jax_read_vec_flt_scp
from asv_subtools_tpu.launcher import Launcher as JaxLauncher
from asv_subtools_tpu.parallel import make_mesh
from asv_subtools_tpu.train import read_report_csv
from asv_subtools_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from asv_subtools_tpu_torch.backend import compute_eer
from asv_subtools_tpu_torch.launcher import Launcher
from asv_subtools_tpu_torch.recipes import voxceleb
from asv_subtools_tpu_torch.recipes.synthetic import write_corpus
from asv_subtools_tpu_torch.weights import variables_to_state_dict

torch.set_num_threads(2)

LOSS_RTOL = 1e-4
NARROW = {"channels": 32, "mfa_conv": 96, "embd_dim": 16}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("torch_launcher_corpus")), num_spks=4, train_per_spk=8)


def _params(corpus, exp, **train):
    return {
        "exp_dir": exp,
        "data": {"train_wav_scp": os.path.join(corpus, "train", "wav.scp"),
                 "train_utt2spk": os.path.join(corpus, "train", "utt2spk"),
                 "chunk_seconds": 1.0, "batch_size": 8, "shuffle_buffer": 16, "compute_feat": False,
                 "spec_aug": True, "speed_perturb": True, "num_bins": 24, "workers": 2},
        "model": {"name": "ecapa_tdnn", "params": dict(NARROW)},
        "loss": {"name": "margin_softmax", "params": {"method": "aam", "m": 0.2, "s": 30.0}},
        "train": {"epochs": 2, "optimizer": {"name": "adamW", "learning_rate": 1e-2, "weight_decay": 5e-5},
                  "lr_schedule": {"name": "constant", "base_lr": 1e-2}, "compute_dtype": "float32",
                  "report_interval": 1, **train},
        "extract": {"mode": "wave", "batch": 8, "workers": 2},
    }


def _step_losses(exp):
    return read_report_csv(os.path.join(exp, "log", "train.csv"))["loss"]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    exp = str(tmp_path_factory.mktemp("torch_launcher_exp"))
    launcher = Launcher(_params(corpus, exp), device="cpu")
    egs = launcher.build_egs()
    launcher.build_model()
    launcher.train(egs)
    return launcher, exp


def test_trains_and_checkpoints(trained):
    launcher, exp = trained
    assert launcher.num_targets == 12 and launcher.feat_dim == 24  # speed perturbation triples the classes
    stats = launcher.epoch_stats
    assert [s["epoch"] for s in stats] == [1, 2] and [s["first_step"] for s in stats] == [0, 4]
    assert all(np.isfinite(s["metrics"]["loss"]) for s in stats)
    losses = _step_losses(exp)
    assert len(losses) == 8 and np.mean(losses[4:]) < np.mean(losses[:4])
    assert stats[1]["metrics"]["loss"] < stats[0]["metrics"]["loss"]
    ckpt = os.path.join(exp, "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["1.params", "2.params", "checkpoint_info", "final.params"]
    assert int(launcher.state.step) == 8


def test_resume_starts_at_the_saved_step(trained, corpus, tmp_path):
    """Resumed with two spawn loader workers (MultiprocessLoader)."""
    _, exp = trained
    params = _params(corpus, str(tmp_path / "resumed"))
    params["data"]["num_workers"] = 2
    launcher = Launcher(params, device="cpu")
    egs = launcher.build_egs()
    launcher.build_model()
    launcher.train(egs, resume_from=os.path.join(exp, "checkpoints", "1.params"))
    assert [(s["epoch"], s["first_step"], s["steps"]) for s in launcher.epoch_stats] == [(2, 4, 4)]
    assert int(launcher.state.step) == 8
    assert os.listdir(str(tmp_path / "resumed" / "checkpoints" / "checkpoint_info")) == ["2.yaml"]


def test_extracts_to_an_ark_jax_reads(trained, corpus, tmp_path):
    launcher, _ = trained
    prefix = str(tmp_path / "xvector_eval")
    stats = launcher.extract(os.path.join(corpus, "eval", "wav.scp"), prefix)
    assert stats["utts"] == 8 and stats["batches"] == 2  # 1.2-2.2 s: the 2 s and 4 s buckets
    embs = dict(jax_read_vec_flt_scp(prefix + ".scp"))
    keys = sorted(embs)
    assert len(keys) == 8 and all(embs[k].shape == (16,) and np.isfinite(embs[k]).all() for k in keys)
    mat = np.stack([embs[k] for k in keys])
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    scores = mat @ mat.T
    iu = np.triu_indices(len(keys), 1)
    spks = [k.split("-")[0] for k in keys]
    labels = np.asarray([[int(a == b) for b in spks] for a in spks])[iu]
    eer, _ = compute_eer(scores[iu], labels)
    assert eer < 0.35, f"end-to-end EER too high: {eer}"


def test_feature_mode_extraction(trained, corpus, tmp_path):
    """extract.mode="feature": host features in buckets of 128 and 256
    frames. Each embedding equals the trained backbone applied to that
    utterance's host features alone (zero-padded to its bucket, masked),
    within 1e-5 of its norm (measured: 1.8e-7)."""
    from asv_subtools_tpu_torch.data import WavEgsXvector

    launcher, _ = trained
    launcher.params["extract"] = dict(launcher.params["extract"], mode="feature", buckets=[128, 256])
    scp, prefix = os.path.join(corpus, "eval", "wav.scp"), str(tmp_path / "f")
    stats = launcher.extract(scp, prefix)
    got = dict(jax_read_vec_flt_scp(prefix + ".scp"))
    assert stats["utts"] == 8 and sorted(got) == sorted(k for k, _ in WavEgsXvector(scp))
    state, backbone = launcher.state, launcher.net.backbone.eval()
    tensors = {k[len("backbone."):]: v for k, v in {**state.params, **state.batch_stats}.items()
               if k.startswith("backbone.")}
    for key, feats in WavEgsXvector(scp, feat_opts=launcher.feat_opts):
        bucket = 128 if len(feats) <= 128 else 256
        x = torch.zeros((1, bucket, feats.shape[1]))
        x[0, : len(feats)] = torch.from_numpy(feats)
        mask = torch.arange(bucket)[None, :] < len(feats)
        with torch.no_grad():
            want = torch.func.functional_call(backbone, tensors, (x, mask))[0].numpy()
        assert np.abs(got[key] - want).max() <= 1e-5 * np.linalg.norm(want), key


def test_plateau_and_lambda_annealing_through_the_launcher(corpus, tmp_path):
    """reduceP driven by the held-out utterances' loss after each epoch,
    and LambdaMAnneal in place of the margin warm-up."""
    params = _params(corpus, str(tmp_path / "exp"), epochs=3,
                     lambda_m_anneal={"lambda_b": 10.0, "alpha": 1.0, "gamma": 0.5})
    params["data"]["valid_utts"] = 6
    params["train"]["lr_schedule"] = {"name": "reduceP", "base_lr": 1e-2, "factor": 0.5, "patience": 0,
                                      "threshold": 0.5}
    launcher = Launcher(params, device="cpu")
    egs = launcher.build_egs()
    launcher.build_model()
    launcher.train(egs)
    metrics = [s["metrics"] for s in launcher.epoch_stats]
    assert all(np.isfinite(m["valid_loss"]) and 0.0 <= m["valid_accuracy"] <= 1.0 for m in metrics)
    # the first validation sets the best loss; a second that does not halve it cuts the scale
    assert [m["lr"] for m in metrics[:2]] == [1e-2, 1e-2] and metrics[2]["lr"] == pytest.approx(5e-3)
    assert launcher.trainer.plateau.scale <= 0.5
    assert [s["first_step"] for s in launcher.epoch_stats] == [0, 3, 6]  # 26 utterances: three batches of 8


def _jax_init_variables(params):
    """Weights of the JAX Launcher's net for ``params``, as numpy trees."""
    launcher = JaxLauncher(params, mesh=make_mesh(devices=jax.devices()[:1]))
    launcher.build_egs()
    net = launcher.build_model()
    x = jax.numpy.zeros((2, 98, params["data"]["num_bins"]), jax.numpy.float32)
    variables = net.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(5)}, x,
                         jax.numpy.zeros((2,), jax.numpy.int32), train=False)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _losses_against_jax(base, tmp_path):
    """The four per-step losses of one epoch of ``base`` through the JAX
    Launcher and through the port's, both from one JAX init."""
    variables = _jax_init_variables(dict(base, exp_dir=str(tmp_path / "init")))
    jax_ckpt = str(tmp_path / "jax_init")

    class _Init:  # the fields save_checkpoint reads
        params, batch_stats, opt_state = variables["params"], variables.get("batch_stats", {}), {}
        step = np.zeros((), np.int32)

    jax_save_checkpoint(jax_ckpt, _Init, 0, save_optimizer=False)
    port_ckpt = str(tmp_path / "port_init.params")
    state_dict = variables_to_state_dict({"params": variables["params"]})
    torch.save({"params": {k: v.float() for k, v in state_dict.items()}, "step": 0}, port_ckpt)

    losses = {}
    for side in ("jax", "port"):
        exp = str(tmp_path / side)
        params = dict(base, exp_dir=exp)
        params["train"] = dict(base["train"], transfer={"from": os.path.join(jax_ckpt, "0.params")
                                                        if side == "jax" else port_ckpt})
        if side == "jax":
            launcher = JaxLauncher(params, mesh=make_mesh(devices=jax.devices()[:1]))
        else:
            launcher = Launcher(params, device="cpu")
        egs = launcher.build_egs()
        launcher.build_model()
        launcher.train(egs)
        losses[side] = np.asarray(_step_losses(exp))
    return losses


def test_launcher_against_jax_launcher(corpus, tmp_path):
    base = _params(corpus, "", epochs=1)
    base["data"]["spec_aug"] = False
    # sgd at a small rate: an f32 step of a narrow net with train-mode
    # BatchNorm at B=8 is ill-conditioned (the two sides' rounding grows
    # about 20-fold a step at lr 0.05); at 1e-3 the weights move little and
    # the losses compare the batches, margins and schedules step by step
    base["train"]["optimizer"] = {"name": "sgd", "learning_rate": 1e-3}
    base["train"]["lr_schedule"] = {"name": "constant", "base_lr": 1e-3}
    base["loss"] = {"name": "margin_softmax_v1", "params": {"method": "aam", "m": 0.2, "s": 30.0, "sub_k": 2,
                                                            "adapt_method": "topk", "topk": 5}}
    base["train"]["margin_warm"] = {"start_epoch": 1, "end_epoch": 2, "offset_margin": -0.2, "init_lambda": 0.0,
                                    "epoch_iter": 4}
    losses = _losses_against_jax(base, tmp_path)
    assert len(losses["jax"]) == len(losses["port"]) == 4
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOSS_RTOL)


def test_repvgg_launcher_against_jax_launcher(corpus, tmp_path):
    """repvgg.yaml's head and optimizer (AAM m=0.2 through
    margin_softmax_v1, sgd on warmR) with a narrow RepSPK trunk (blocks
    1-1-1-1, base 4), four steps, on the terms of the test above."""
    base = _params(corpus, "", epochs=1)
    base["data"]["spec_aug"] = False
    base["model"] = {"name": "repvgg_xvector", "params": {"base_channels": 4, "num_blocks": [1, 1, 1, 1],
                                                          "embd_dim": 16}}
    base["loss"] = {"name": "margin_softmax_v1", "params": {"method": "aam", "m": 0.2}}
    base["train"]["optimizer"] = {"name": "sgd", "learning_rate": 1e-3}
    base["train"]["lr_schedule"] = {"name": "warmR", "base_lr": 1e-3, "t_0": 20000}
    losses = _losses_against_jax(base, tmp_path)
    assert len(losses["jax"]) == len(losses["port"]) == 4
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOSS_RTOL)


# the four presets of this family: the preset's model at full width, and a
# narrow copy of it (its head, optimizer and schedule as they are) trained
PRESETS = {
    "repvgg": ({"base_channels": 4, "num_blocks": [1, 1, 1, 1], "embd_dim": 16}, "RepVggXvector", 256),
    "ecapa_lawlict": ({"channels": 32, "embd_dim": 16}, "EcapaLawlict", 192),
    "ecapa_roadmap": ({"channels": 32, "mfa_conv": 48, "embd_dim": 16}, "EcapaTdnn", 192),
    "ecapa_roadmap_lm": ({"channels": 32, "mfa_conv": 48, "embd_dim": 16}, "EcapaTdnn", 192),
}


def _preset(corpus, exp, name):
    from asv_subtools_tpu_torch.utils import load_yaml

    params = load_yaml(os.path.join("recipes", "configs", f"{name}.yaml"))
    data = _params(corpus, exp)["data"]
    params["data"] = dict(params.get("data", {}), **{k: data[k] for k in ("train_wav_scp", "train_utt2spk",
                                                                         "num_bins", "workers", "shuffle_buffer")},
                          batch_size=8, chunk_seconds=1.0, num_workers=1)
    params["exp_dir"] = exp
    params["train"] = dict(params["train"], epochs=1, compute_dtype="float32", report_interval=1, transfer=None)
    return params


@pytest.mark.parametrize("name", list(PRESETS))
def test_presets_build_and_train_through_the_launcher(corpus, tmp_path, name):
    narrow, cls, embd = PRESETS[name]
    params = _preset(corpus, str(tmp_path / "exp"), name)
    launcher = Launcher(params, device="cpu")
    launcher.build_egs()
    net = launcher.build_model()  # the preset's width
    assert type(net.backbone).__name__ == cls and net.backbone.embd_dim == embd
    if name.startswith("ecapa_roadmap"):
        assert net.backbone.bn_stats.mean.shape == (6144,)  # mqmha, 2 queries x 1536
        assert type(net.loss).__name__ == "MarginSoftmaxLossV1" and net.loss.sub_k == 2
    if name == "repvgg":
        assert net.backbone.repvgg.block == "spk" and net.backbone.repvgg.output_dim(80) == 6400
    params["model"]["params"] = dict(params["model"]["params"], **narrow)
    launcher = Launcher(params, device="cpu")
    egs = launcher.build_egs()
    launcher.build_model()
    launcher.train(egs)
    losses = _step_losses(str(tmp_path / "exp"))
    assert len(losses) >= 3 and all(np.isfinite(losses))


def test_roadmap_two_phase_run_with_transfer(corpus, tmp_path):
    """ecapa_roadmap then ecapa_roadmap_lm, as JAX's
    test_two_phase_roadmap_end_to_end runs them (tests/test_launcher.py):
    phase 1 trains the MQMHA ECAPA with the sub-centre top-k AAM head and
    the margin warm-up; phase 2 takes everything but the classifier from
    phase 1's checkpoint (exclude: [loss]) and fine-tunes with the larger
    margin and longer chunks at lr 2e-5; then extraction on the MQMHA path."""
    from asv_subtools_tpu_torch.utils import load_yaml

    base = load_yaml("recipes/configs/ecapa_roadmap.yaml")
    lm = load_yaml("recipes/configs/ecapa_roadmap_lm.yaml")
    tiny = {"name": "ecapa_tdnn", "params": dict(base["model"]["params"], channels=32, embd_dim=16, mfa_conv=48)}
    data = {k: v for k, v in _params(corpus, "")["data"].items() if k != "spec_aug"}
    data.update(batch_size=8, shuffle_buffer=8, chunk_seconds=0.6)
    p1 = {"exp_dir": str(tmp_path / "exp_roadmap"), "data": data, "model": tiny,
          "loss": {"name": base["loss"]["name"], "params": dict(base["loss"]["params"], topk=3)},
          "train": {"epochs": 2, "optimizer": {"name": "adamW", "learning_rate": 2e-3},
                    "lr_schedule": {"name": "1cycle", "max_lr": 2e-3, "total_steps": 24},
                    "margin_warm": dict(base["train"]["margin_warm"], epoch_iter=3), "compute_dtype": "float32",
                    "report_interval": 100},
          "extract": {"mode": "wave", "batch": 8, "workers": 2}}
    l1 = Launcher(p1, device="cpu")
    egs1 = l1.build_egs()
    l1.build_model()
    assert l1.params["loss"]["params"]["sub_k"] == 2 and l1.params["loss"]["params"]["adapt_method"] == "topk"
    state1 = l1.train(egs1)
    ckpt = os.path.join(p1["exp_dir"], "checkpoints", "2.params")
    assert os.path.exists(ckpt)

    p2 = {"exp_dir": str(tmp_path / "exp_roadmap_lm"), "data": dict(data, chunk_seconds=1.0), "model": tiny,
          "loss": {"name": lm["loss"]["name"], "params": dict(lm["loss"]["params"], topk=3)},
          "train": {"epochs": 1, "optimizer": {"name": "adamW", "learning_rate": 2e-5},
                    "lr_schedule": {"name": "constant", "base_lr": 2e-5}, "compute_dtype": "float32",
                    "transfer": {"from": ckpt, "exclude": ["loss"]}, "report_interval": 100},
          "extract": p1["extract"]}
    l2 = Launcher(p2, device="cpu")
    egs2 = l2.build_egs()
    l2.build_model()
    assert l2.params["loss"]["params"]["m"] == 0.5
    state2 = l2.train(egs2)
    # the transfer carried phase 1's backbone: at lr 2e-5 phase 2 stays
    # near it, where a fresh init would differ at O(0.1); the classifier
    # was not carried
    keys = [k for k in state1.params if k.startswith("backbone.")]
    drift = max(float((state1.params[k] - state2.params[k]).abs().max()) for k in keys)
    assert drift < 5e-3, drift
    assert not torch.allclose(state1.params["loss.weight"], state2.params["loss.weight"])
    stats = l2.extract(os.path.join(corpus, "eval", "wav.scp"), str(tmp_path / "xv_lm"))
    assert stats["utts"] == 8
    embs = dict(jax_read_vec_flt_scp(str(tmp_path / "xv_lm.scp")))
    assert len(embs) == 8 and all(v.shape == (16,) and np.isfinite(v).all() for v in embs.values())


@pytest.mark.parametrize("change,item", [
    ({"data": {"feat_backend": "native"}}, 10),
    ({"train": {"fsdp": True}}, 5),
])
def test_formerly_unported_options_match_jax(tmp_path, change, item):
    """The options that raised before ROADMAP items 5 and 10 were ported
    now train through stage 1 as JAX's Launcher does, from one JAX init
    (train.transfer on both sides), on fbank host features: the native
    front end (JAX's side computes with its C++ library where it is built
    and with numpy where not: features within 2e-3, so the losses within
    2e-3), and ZeRO-3 on a mesh of one (a one-process gloo group; JAX's
    one-device mesh): rules that replicate every leaf, so the losses
    within the one-device tolerance."""
    from test_torch_launcher_feats import _init, _jax_launcher
    from test_torch_launcher_feats import _params as _feat_params

    from asv_subtools_tpu_torch import parallel

    corpus = write_corpus(str(tmp_path / "corpus"), num_spks=4, train_per_spk=8)
    base = _feat_params(corpus, "", "fbank")
    for section, values in change.items():
        base[section] = dict(base[section], **values)
    jax_ckpt, port_ckpt = _init(base, tmp_path, 23)
    grouped = item == 5
    if grouped:
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        parallel.initialize_multihost(f"127.0.0.1:{port}", num_processes=1, process_id=0, backend="gloo")
    try:
        losses = {}
        for side, ckpt in (("jax", jax_ckpt), ("port", port_ckpt)):
            params = dict(base, exp_dir=str(tmp_path / side))
            params["train"] = dict(base["train"], transfer={"from": ckpt})
            launcher = _jax_launcher(params) if side == "jax" else Launcher(params, device="cpu")
            egs = launcher.build_egs()
            launcher.build_model()
            launcher.train(egs)
            losses[side] = np.asarray(read_report_csv(os.path.join(params["exp_dir"], "log", "train.csv"))["loss"])
        if grouped:
            assert launcher.mesh is not None and not launcher.trainer.placement.sharded
    finally:
        if grouped:
            torch.distributed.destroy_process_group()
    assert len(losses["port"]) == len(losses["jax"]) == 4 and np.isfinite(losses["port"]).all()
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=2e-3 if item == 10 else 1e-4)


def test_sam_needs_feature_input(corpus, tmp_path):
    """train.sam on wave-input egs raises, as in JAX (launcher.py:418-420);
    the offline route's SAM run is tests/test_torch_launcher_offline.py's."""
    params = _params(corpus, str(tmp_path / "exp"), sam={"rho": 0.05})
    launcher = Launcher(params, device="cpu")
    egs = launcher.build_egs()
    launcher.build_model()
    with pytest.raises(ValueError, match="feature-input"):
        launcher.train(egs)


def test_model_sharding_needs_a_process_group(corpus, tmp_path):
    """num_model > 1 builds a (data, model) mesh over the process group
    (the 4-rank run is tests/test_torch_distributed.py's); one process
    without a group has no mesh to build and says so."""
    params = _params(corpus, str(tmp_path / "exp"))
    params["train"]["num_model"] = 2
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        Launcher(params, device="cpu")


def test_launcher_needs_a_device_without_a_card(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Launcher(_params(corpus, str(tmp_path / "exp")))


def test_recipe_stages_0_to_2(corpus, tmp_path):
    """python -m asv_subtools_tpu_torch.recipes.voxceleb at a narrow width on
    the CPU: one epoch, then the train and eval lists extracted."""
    exp = str(tmp_path / "recipe")
    voxceleb.main(["--data", corpus, "--exp", exp, "--channels", "16", "--batch-size", "8", "--epochs", "1",
                   "--max-lr", "1e-2", "--step-size-up", "4", "--stop-stage", "2", "--device", "cpu"])
    for subset in ("train", "eval"):
        embs = dict(jax_read_vec_flt_scp(os.path.join(exp, f"xvector_{subset}.scp")))
        assert len(embs) == (32 if subset == "train" else 8)
        assert all(v.shape == (192,) and np.isfinite(v).all() for v in embs.values())
    assert os.path.islink(os.path.join(exp, "checkpoints", "final.params"))


def test_recipe_scoring_stage_raises(corpus, tmp_path):
    """Stage 3 alone scores stage 2's ark/scp: without them it raises."""
    with pytest.raises(FileNotFoundError, match="xvector_train.scp"):
        voxceleb.main(["--data", corpus, "--exp", str(tmp_path / "r"), "--trials", "trials", "--stage", "3",
                       "--channels", "16", "--device", "cpu"])


def test_apply_preset_replaces_the_factories():
    base = {"model": {"name": "ecapa_tdnn", "params": {"channels": 1024}},
            "train": {"optimizer": {"name": "adamW"}, "lr_schedule": {"name": "cyclic", "max_lr": 1e-3},
                      "epochs": 6}}
    out = voxceleb.apply_preset(base, {"model": {"name": "resnet_xvector", "params": {}},
                                       "train": {"lr_schedule": {"name": "noam"}, "epochs": 3}})
    assert out["model"] == {"name": "resnet_xvector", "params": {}}
    assert out["train"]["lr_schedule"] == {"name": "noam"} and out["train"]["epochs"] == 3
