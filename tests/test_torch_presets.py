"""Every preset in recipes/configs/ through the port's Launcher (ROADMAP
Queue 1 item 4's "done when"), reconformer.yaml's ReConformer included.

Each preset builds at its own width (the backbone class and embedding
width checked), then a narrow copy of it (the preset's head, optimizer,
schedule and training options as they are; widths and depths cut, f32,
one epoch, B=8 on 1 s chunks, no speech augmentation files, no transfer
source) trains one epoch: every per-step loss finite. multitask.yaml
trains on the offline chunk egs with phone alignments (a synthetic
corpus through the host front end, as in
tests/test_torch_launcher_offline.py); the others on the online wave egs
of a synthetic corpus (4 speakers x 4 utterances). The narrow copies'
losses are not held against JAX here: the preset families are
(tests/test_torch_launcher.py, test_torch_olr.py,
test_torch_launcher_offline.py and the model tests).
"""

import os

import numpy as np
import pytest
import torch

from asv_subtools_tpu.train import read_report_csv
from asv_subtools_tpu_torch.data import prepare_egs_dir
from asv_subtools_tpu_torch.launcher import Launcher
from asv_subtools_tpu_torch.recipes.synthetic import write_corpus, write_feature_datadir, write_offline_labels
from asv_subtools_tpu_torch.utils import load_yaml

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "recipes", "configs")
BINS = 24
# model name -> (the backbone class at the preset's width, the narrow copy's widths)
NARROW = {
    "ecapa_tdnn": ("EcapaTdnn", {"channels": 32, "mfa_conv": 48, "embd_dim": 16}),
    "ecapa_lawlict": ("EcapaLawlict", {"channels": 32, "embd_dim": 16}),
    "resnet_xvector": ("ResNetXvector", {"base_planes": 4, "layers": [1, 1, 1, 1], "embd_dim": 16}),
    "repvgg_xvector": ("RepVggXvector", {"base_channels": 4, "num_blocks": [1, 1, 1, 1], "embd_dim": 16}),
    "conformer_xvector": ("ConformerXvector", {"attention_dim": 32, "attention_heads": 2, "num_blocks": 1,
                                               "linear_units": 64, "embd_dim": 16}),
    "snowdar_xvector": ("SnowdarXvector", {"num_frame_channels": 16, "embd_dim": 16}),
    "extended_xvector": ("ExtendedXvector", {"num_frame_channels": 16, "embd_dim": 16}),
    "factored_xvector": ("FactoredXvector", {"width": 0.0625, "embd_dim": 16}),
    "multi_task_xvector": ("MultiTaskXvector", {"num_frame_channels": 16, "embd_dim": 16}),
}
PRESETS = sorted(f[:-len(".yaml")] for f in os.listdir(CONFIGS) if f.endswith(".yaml"))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("preset_corpus"))
    write_corpus(root, num_spks=4, train_per_spk=4, eval_per_spk=1)
    feats = os.path.join(root, "feats")
    write_feature_datadir(os.path.join(root, "train"), feats, num_bins=BINS)
    ali_scp, _ = write_offline_labels(feats, num_phones=128, num_aux=9)
    egs = os.path.join(root, "egs")
    prepare_egs_dir(feats, egs, chunk_size=100)
    return {"root": root, "egs": egs, "ali_scp": ali_scp}


def _params(corpora, exp, name):
    params = load_yaml(os.path.join(CONFIGS, f"{name}.yaml"))
    data = dict(params.get("data", {}), batch_size=8, chunk_seconds=1.0, num_workers=1, workers=1,
                shuffle_buffer=16, num_bins=BINS, speech_aug=None)
    if params["model"]["name"] == "multi_task_xvector":
        data.update(egs_type="offline", egs_dir=corpora["egs"], ali_scp=corpora["ali_scp"])
    else:
        data.update(train_wav_scp=os.path.join(corpora["root"], "train", "wav.scp"),
                    train_utt2spk=os.path.join(corpora["root"], "train", "utt2spk"))
    params["data"] = data
    params["exp_dir"] = exp
    params["train"] = dict(params["train"], epochs=1, compute_dtype="float32", report_interval=1, transfer=None)
    return params


def test_every_preset_is_swept():
    assert len(PRESETS) == 16 and "multitask" in PRESETS and "reconformer" in PRESETS


@pytest.mark.parametrize("name", PRESETS)
def test_preset_builds_and_a_narrow_copy_trains(corpora, tmp_path, name):
    params = _params(corpora, str(tmp_path / "exp"), name)
    model = params["model"]["name"]
    cls, narrow = NARROW[model]
    launcher = Launcher(params, device="cpu")
    launcher.build_egs()
    net = launcher.build_model()  # the preset's width
    assert type(net.backbone).__name__ == cls
    assert net.backbone.embd_dim == params["model"]["params"].get("embd_dim", net.backbone.embd_dim)
    del net, launcher
    params["model"]["params"] = dict(params["model"]["params"], **narrow)
    launcher = Launcher(params, device="cpu")
    egs = launcher.build_egs()
    launcher.build_model()
    launcher.train(egs)
    losses = read_report_csv(os.path.join(str(tmp_path / "exp"), "log", "train.csv"))["loss"]
    assert len(losses) >= 1 and np.isfinite(losses).all()
    assert int(launcher.state.step) == len(losses)
