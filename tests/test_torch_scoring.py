"""Stage 3 of the recipe through the port on the CPU: ``Launcher.score``,
``Launcher.gather_results_from_epochs`` and
``python -m asv_subtools_tpu_torch.recipes.voxceleb --trials``.

The recipe runs once, stages 0-3, on a synthetic corpus
(recipes/synthetic.py: 4 speakers, 4 train and 4 eval utterances each; its
eval/trials holds the 24 target pairs and 24 nontarget pairs) with an
ECAPA of 16 channels for two steps. Its ark/scp are then scored by the
port's Launcher and by the JAX Launcher, and by JAX's ScoreSets with the
recipe's configuration. The cosine matrices differ between the two sides
by the rounding of their f32 products, so EER and minDCF are held within
one target trial (1/24) of JAX's; in practice they are equal. The PLDA
configurations are f64 numpy on both sides and held to equality.
"""

import ast
import contextlib
import io
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from asv_subtools_tpu.backend import ScoreConfig as JaxScoreConfig
from asv_subtools_tpu.backend import ScoreSets as JaxScoreSets
from asv_subtools_tpu.backend import Trials as JaxTrials
from asv_subtools_tpu.io import read_vec_flt_scp as jax_read_vec_flt_scp
from asv_subtools_tpu.launcher import Launcher as JaxLauncher
from asv_subtools_tpu.parallel import make_mesh
from asv_subtools_tpu_torch.io import ArkScpWriter, read_vec_flt_scp
from asv_subtools_tpu_torch.launcher import Launcher
from asv_subtools_tpu_torch.recipes import voxceleb
from asv_subtools_tpu_torch.recipes.synthetic import write_corpus

torch.set_num_threads(2)

N_TARGET = 24


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """The PLDA cases invert 192 x 192 matrices, where OpenBLAS goes
    multi-threaded; beside the other test workers its spinning threads
    took a minute a case. Both sides run under the same limit."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """(corpus, exp, printed metrics) of the recipe's stages 0-3."""
    corpus = write_corpus(str(tmp_path_factory.mktemp("scoring_corpus")), num_spks=4, train_per_spk=4,
                          eval_per_spk=4)
    exp = str(tmp_path_factory.mktemp("scoring_exp"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        voxceleb.main(["--data", corpus, "--exp", exp, "--channels", "16", "--batch-size", "8", "--epochs", "1",
                       "--max-lr", "1e-2", "--step-size-up", "4", "--trials", os.path.join(corpus, "eval", "trials"),
                       "--device", "cpu"])
    return corpus, exp, out.getvalue()


def _paths(recipe):
    corpus, exp, _ = recipe
    return (os.path.join(exp, "xvector_train.scp"), os.path.join(corpus, "train", "utt2spk"),
            os.path.join(exp, "xvector_eval.scp"), os.path.join(corpus, "eval", "trials"))


def _within_one_target(a, b):
    assert a["num_trials"] == b["num_trials"] == 2 * N_TARGET
    for k in ("eer", "min_dcf"):
        assert abs(a[k] - b[k]) <= 1.0 / N_TARGET, (k, a[k], b[k])


def test_synthetic_trials(recipe):
    corpus, _, _ = recipe
    trials = JaxTrials.read(os.path.join(corpus, "eval", "trials"))
    assert int(trials.labels.sum()) == N_TARGET and len(trials.labels) == 2 * N_TARGET
    pairs = list(zip(trials.enroll_keys, trials.test_keys))
    assert len(set(pairs)) == len(pairs)
    assert all((e.split("-")[0] == t.split("-")[0]) == bool(l) for (e, t), l in zip(pairs, trials.labels))
    # the same seed gives the same list
    again = write_corpus(os.path.join(os.path.dirname(corpus), "again"), num_spks=4, train_per_spk=4,
                         eval_per_spk=4, dur=(0.2, 0.3))
    assert open(os.path.join(again, "eval", "trials")).read() == open(os.path.join(corpus, "eval", "trials")).read()


def test_recipe_stage_3_prints_the_metrics(recipe):
    """The printed dict equals JAX's ScoreSets with run.py's configuration
    (submean-norm, cosine, AS-norm top 300, cohort = the first 3,000 sorted
    train vectors) on the port's own ark/scp."""
    _, _, printed = recipe
    line = [ln for ln in printed.splitlines() if ln.startswith("{")][-1]
    got = ast.literal_eval(line)
    assert {"eer", "eer_threshold", "min_dcf", "num_trials"} <= set(got)
    assert all(np.isfinite(v) for v in got.values())
    train_scp, u2s_path, eval_scp, trials = _paths(recipe)
    train = dict(jax_read_vec_flt_scp(train_scp))
    keys = sorted(train)
    u2s = dict(line.split()[:2] for line in open(u2s_path))
    spk_ids = np.asarray([sorted(set(u2s.values())).index(u2s[k]) for k in keys])
    x = np.stack([train[k] for k in keys])
    pipe = JaxScoreSets(JaxScoreConfig(process="submean-norm", classifier="cosine", score_norm="asnorm",
                                       top_n=300)).fit(x, spk_ids)
    evals = dict(jax_read_vec_flt_scp(eval_scp))
    want = pipe.run(evals, evals, JaxTrials.read(trials), cohort=x[:3000])
    _within_one_target(got, want)


@pytest.mark.parametrize("kw", [
    {"score_norm": "asnorm", "top_n": 300},
    {"score_norm": "asnorm", "top_n": 5, "cohort_size": 12},
    {"score_norm": "snorm"},
    {},
    {"process": "", "classifier": "cosine"},
    {"process": "submean-norm", "classifier": "plda"},
    {"process": "submean-norm", "classifier": "plda", "score_norm": "asnorm", "top_n": 8},
], ids=["asnorm300", "asnorm5-cohort12", "snorm", "cosine", "raw-cosine", "plda", "plda-asnorm"])
def test_launcher_score_against_jax(recipe, tmp_path, kw):
    paths = _paths(recipe)
    train_scp, u2s, eval_scp, trials = paths
    port = Launcher({"exp_dir": str(tmp_path / "port")}, device="cpu")
    got = port.score(train_scp, u2s, eval_scp, eval_scp, trials, **kw)
    want = JaxLauncher({"exp_dir": str(tmp_path / "jax")}, mesh=make_mesh(devices=jax.devices()[:1])).score(
        train_scp, u2s, eval_scp, eval_scp, trials, **kw)
    assert port.score_sets.device.type == "cpu"
    if kw.get("classifier") == "plda":
        assert got == want and port.score_sets.device_fetches == 0
    else:
        _within_one_target(got, want)
        assert port.score_sets.device_fetches == (3 if kw.get("score_norm") else 1)


def test_gather_results_from_epochs_against_jax(recipe, tmp_path):
    """Two epochs of eval vectors ({epoch} in the eval path): epoch 1 is the
    recipe's extraction, epoch 2 the same vectors plus noise drawn from a
    seed, written by the port's ArkScpWriter."""
    train_scp, u2s, eval_scp, trials = _paths(recipe)
    shutil.copy(eval_scp, str(tmp_path / "xvector_eval_1.scp"))
    rng = np.random.default_rng(3)
    with ArkScpWriter(str(tmp_path / "e2.ark"), str(tmp_path / "xvector_eval_2.scp")) as w:
        for k, v in read_vec_flt_scp(eval_scp):
            w.write(k, v + rng.normal(size=v.shape).astype(np.float32) * np.abs(v).mean())
    fmt = str(tmp_path / "xvector_eval_{epoch}.scp")
    kw = {"score_norm": "asnorm", "top_n": 10}
    got = Launcher({"exp_dir": str(tmp_path / "port")}, device="cpu").gather_results_from_epochs(
        [1, 2], train_scp, u2s, fmt, fmt, trials, **kw)
    want = JaxLauncher({"exp_dir": str(tmp_path / "jax")}, mesh=make_mesh(devices=jax.devices()[:1])) \
        .gather_results_from_epochs([1, 2], train_scp, u2s, fmt, fmt, trials, **kw)
    assert sorted(got) == sorted(want) == [1, 2]
    for epoch in (1, 2):
        _within_one_target(got[epoch], want[epoch])
    assert got[1] != got[2]
    # epoch 1 is the plain score of the recipe's extraction
    _within_one_target(got[1], Launcher({"exp_dir": str(tmp_path / "p2")}, device="cpu").score(
        train_scp, u2s, eval_scp, eval_scp, trials, **kw))
