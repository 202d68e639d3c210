"""The OLR language-identification recipe (asv_subtools_tpu_torch/recipes/olr.py)
and the x-vector recipe configurations through the port's Launcher, on the CPU.

The corpus: recipes/synthetic.py with 4 speakers of 8 training and 4
evaluation utterances, one language a speaker (utt2lang).

* Stages 0-3 of ``python -m asv_subtools_tpu_torch.recipes.olr`` at width
  16, B = 8, 1.0 s chunks, one epoch: the ark/scp of both lists read back,
  and the printed Cavg and EER% are the JAX back end's
  (train_logistic_regression, compute_cavg, compute_eer) on the same
  vectors, to the printed rounding.
* The egs: the port's Launcher and the JAX Launcher, built from the
  recipe's params, give the same batches (keys, labels, masks equal; the
  host fbank within atol 2e-5, rtol 1e-5, as tests/test_torch_data.py
  holds it).
* Stages 1-3 through both Launchers from one JAX init (train.transfer), in
  f32 at sgd 1e-3: the per-step losses within rtol 1e-4 (the bound of
  tests/test_torch_launcher.py), the extracted embeddings at cosine
  >= 0.9999, and Cavg through the port's stage 3 against JAX's stage 3 on
  JAX's vectors within 0.02 (a threshold metric: vectors 1e-5 apart may
  move a trial across a bin).
* The lbfgs solver of stage 3 (for machines without sklearn) reaches an
  objective no higher than sklearn's and the same decisions.
* recipes/configs/{snowdar,extended,factored}_xvector.yaml and
  xi_vector.yaml train one epoch through the voxceleb recipe's Launcher
  at their full widths (B = 8, f32), every loss finite.
"""

import ast
import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from asv_subtools_tpu.backend import compute_cavg as jax_compute_cavg
from asv_subtools_tpu.backend import compute_eer as jax_compute_eer
from asv_subtools_tpu.backend import train_logistic_regression as jax_train_lr
from asv_subtools_tpu.io import read_vec_flt_scp as jax_read_vec_flt_scp
from asv_subtools_tpu.launcher import Launcher as JaxLauncher
from asv_subtools_tpu.parallel import make_mesh
from asv_subtools_tpu.train import read_report_csv
from asv_subtools_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from asv_subtools_tpu_torch.backend import train_logistic_regression
from asv_subtools_tpu_torch.io import read_vec_flt_scp
from asv_subtools_tpu_torch.launcher import Launcher
from asv_subtools_tpu_torch.recipes import olr, voxceleb
from asv_subtools_tpu_torch.recipes.synthetic import write_corpus
from asv_subtools_tpu_torch.utils.params import load_yaml
from asv_subtools_tpu_torch.weights import variables_to_state_dict

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "recipes", "configs")
SMALL = dict(epochs=1, batch_size=8, chunk_seconds=1.0, width=16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("olr_corpus")), num_spks=4, train_per_spk=8, eval_per_spk=4)


def _jax_stage3(data, exp):
    """recipes/olr/run.py:79-107 with the JAX back end -> (Cavg, EER)."""
    train = dict(jax_read_vec_flt_scp(os.path.join(exp, "xvector_train.scp")))
    evals = dict(jax_read_vec_flt_scp(os.path.join(exp, "xvector_eval.scp")))
    u2l_train = dict(line.split()[:2] for line in open(os.path.join(data, "train", "utt2lang")))
    u2l_eval = dict(line.split()[:2] for line in open(os.path.join(data, "eval", "utt2lang")))
    langs = sorted(set(u2l_train.values()))
    l2i = {lang: i for i, lang in enumerate(langs)}
    xk, ek = sorted(train), sorted(evals)
    clf = jax_train_lr(np.stack([train[k] for k in xk]), np.asarray([l2i[u2l_train[k]] for k in xk]))
    scores = clf.scores(np.stack([evals[k] for k in ek]))
    pairs = [(j, l2i.get(u2l_eval.get(k, ""), -1), float(scores[i, j])) for i, k in enumerate(ek)
             for j in range(len(langs))]
    _, cavg = jax_compute_cavg(pairs, len(langs))
    eer, _ = jax_compute_eer(np.asarray([p[2] for p in pairs]), np.asarray([int(p[0] == p[1]) for p in pairs]))
    return cavg, eer


def test_synthetic_corpus_serves_as_a_language_set(tmp_path):
    root = write_corpus(str(tmp_path), num_spks=6, train_per_spk=2, eval_per_spk=1, num_langs=3)
    for subset, n in (("train", 12), ("eval", 6)):
        u2l = dict(line.split() for line in open(os.path.join(root, subset, "utt2lang")))
        u2s = dict(line.split() for line in open(os.path.join(root, subset, "utt2spk")))
        assert len(u2l) == n and set(u2l) == set(u2s)
        assert all(u2l[k] == f"lang{int(u2s[k][3:]) % 3:02d}" for k in u2l)


@pytest.fixture(scope="module")
def recipe(corpus, tmp_path_factory):
    exp = str(tmp_path_factory.mktemp("olr_exp"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        olr.main(["--data", corpus, "--exp", exp, "--epochs", "1", "--batch-size", "8", "--chunk-seconds", "1.0",
                  "--width", "16", "--device", "cpu"])
    return exp, ast.literal_eval(out.getvalue().strip().splitlines()[-1])


def test_recipe_stages_0_to_3(corpus, recipe):
    exp, printed = recipe
    for subset, n in (("train", 32), ("eval", 16)):
        embs = dict(read_vec_flt_scp(os.path.join(exp, f"xvector_{subset}.scp")))
        assert len(embs) == n and all(v.shape == (16,) and np.isfinite(v).all() for v in embs.values())
    assert set(printed) == {"Cavg", "EER%"} and all(np.isfinite(v) for v in printed.values())
    cavg, eer = _jax_stage3(corpus, exp)
    assert printed == {"Cavg": round(cavg, 4), "EER%": round(100 * eer, 2)}
    assert os.path.exists(os.path.join(exp, "checkpoints", "1.params"))


def test_recipe_params_are_the_jax_recipes(corpus):
    p = olr.recipe_params(corpus, "exp")
    assert p["data"]["train_utt2spk"].endswith(os.path.join("train", "utt2lang"))
    assert (p["data"]["chunk_seconds"], p["data"]["batch_size"]) == (3.0, 256)
    assert p["model"] == {"name": "extended_xvector", "params": {"num_frame_channels": 512, "embd_dim": 512}}
    assert p["loss"] == {"name": "margin_softmax", "params": {"method": "am", "m": 0.2}}
    assert p["train"]["optimizer"] == {"name": "sgd", "learning_rate": 1e-2}
    assert p["train"]["lr_schedule"] == {"name": "warmR", "base_lr": 1e-2, "t_0": 20000}
    launcher = Launcher(p, device="cpu")
    assert launcher.params["data"]["compute_feat"] and launcher.params["extract"]["mode"] == "feature"


def _params(corpus, exp):
    p = olr.recipe_params(corpus, exp, **SMALL)
    p["train"]["optimizer"]["learning_rate"] = 1e-3
    p["train"]["lr_schedule"]["base_lr"] = 1e-3
    p["train"]["compute_dtype"] = "float32"
    p["train"]["report_interval"] = 1
    return p


def test_egs_match_the_jax_launcher(corpus, tmp_path):
    port = Launcher(_params(corpus, str(tmp_path / "p")), device="cpu").build_egs()
    ref = JaxLauncher(_params(corpus, str(tmp_path / "j")), mesh=make_mesh(devices=jax.devices()[:1])).build_egs()
    n = 0
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for bp, bj in zip(port, ref, strict=True):
            assert bp["keys"] == bj["keys"]
            assert np.array_equal(bp["y"], bj["y"]) and np.array_equal(bp["mask"], bj["mask"])
            np.testing.assert_allclose(bp["x"], bj["x"], atol=2e-5, rtol=1e-5)
            n += 1
    assert n == 8  # 32 utterances, B = 8, two epochs


def test_stages_1_to_3_against_the_jax_launcher(corpus, tmp_path):
    base = _params(corpus, "")
    jl = JaxLauncher(dict(base, exp_dir=str(tmp_path / "init")), mesh=make_mesh(devices=jax.devices()[:1]))
    egs = jl.build_egs()
    net = jl.build_model()
    egs.set_epoch(0)
    feat_dim = next(iter(egs))["x"].shape[-1]  # 23 host fbank bins
    variables = net.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(5)},
                         jax.numpy.zeros((2, 98, feat_dim), jax.numpy.float32), jax.numpy.zeros((2,), jax.numpy.int32),
                         train=False)
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))

    class _Init:  # the fields save_checkpoint reads
        params, batch_stats, opt_state = variables["params"], variables["batch_stats"], {}
        step = np.zeros((), np.int32)

    jax_ckpt = str(tmp_path / "jax_init")
    jax_save_checkpoint(jax_ckpt, _Init, 0, save_optimizer=False)
    port_ckpt = str(tmp_path / "port_init.params")
    state_dict = variables_to_state_dict({"params": variables["params"]})
    torch.save({"params": {k: v.float() for k, v in state_dict.items()}, "step": 0}, port_ckpt)

    losses, embs = {}, {}
    for side in ("jax", "port"):
        exp = str(tmp_path / side)
        params = dict(base, exp_dir=exp)
        params["train"] = dict(base["train"], transfer={
            "from": os.path.join(jax_ckpt, "0.params") if side == "jax" else port_ckpt})
        launcher = (JaxLauncher(params, mesh=make_mesh(devices=jax.devices()[:1])) if side == "jax"
                    else Launcher(params, device="cpu"))
        egs = launcher.build_egs()
        launcher.build_model()
        launcher.train(egs)
        for subset in ("train", "eval"):
            launcher.extract(os.path.join(corpus, subset, "wav.scp"), os.path.join(exp, f"xvector_{subset}"))
        losses[side] = np.asarray(read_report_csv(os.path.join(exp, "log", "train.csv"))["loss"])
        embs[side] = dict(jax_read_vec_flt_scp(os.path.join(exp, "xvector_eval.scp")))
    assert len(losses["port"]) == len(losses["jax"]) == 4
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)
    assert set(embs["port"]) == set(embs["jax"])
    for k, a in embs["port"].items():
        b = embs["jax"][k]
        assert float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)) >= 0.9999, k
    port_out = olr.score_languages(corpus, str(tmp_path / "port"))
    cavg, eer = _jax_stage3(corpus, str(tmp_path / "jax"))
    assert abs(port_out["Cavg"] - cavg) <= 0.02 and np.isfinite(port_out["EER%"])


def test_lbfgs_solver_matches_sklearns_objective():
    rng = np.random.default_rng(3)
    for n_class in (4, 2):
        centers = rng.normal(size=(n_class, 12))
        y = np.repeat(np.arange(n_class), 25)
        x = centers[y] + rng.normal(size=(len(y), 12))
        ref, got = train_logistic_regression(x, y), train_logistic_regression(x, y, solver="lbfgs")

        def objective(clf):
            z = x @ clf.weight.T + clf.bias
            if z.shape[1] == 1:
                loss = np.logaddexp(0.0, -(2.0 * y - 1.0) * z[:, 0]).sum()
            else:
                loss = (np.logaddexp.reduce(z, axis=1) - z[np.arange(len(y)), y]).sum()
            return loss + 0.5 * (clf.weight ** 2).sum()

        assert objective(got) <= objective(ref) + 1e-9
        assert np.array_equal(got.predict(x), ref.predict(x)) and np.array_equal(got.classes, ref.classes)
        np.testing.assert_allclose(got.scores(x), ref.scores(x), atol=0.05 * np.abs(ref.scores(x)).max())
    with pytest.raises(ValueError):
        train_logistic_regression(x, y, solver="newton")


@pytest.mark.parametrize("config", ["snowdar_xvector", "extended_xvector", "factored_xvector", "xi_vector"])
def test_xvector_configs_train_through_the_launcher(corpus, tmp_path, config):
    preset = load_yaml(os.path.join(CONFIGS, f"{config}.yaml"))
    params = voxceleb.apply_preset(voxceleb.recipe_params(corpus, str(tmp_path), epochs=1, batch_size=8), preset)
    params["train"]["epochs"] = 1
    params["train"]["compute_dtype"] = "float32"
    params["train"]["report_interval"] = 1
    params["data"]["speed_perturb"] = False
    launcher = Launcher(params, device="cpu")
    egs = launcher.build_egs()
    launcher.build_model()
    assert type(launcher.net.backbone).__name__ == {"snowdar_xvector": "SnowdarXvector", "xi_vector": "SnowdarXvector",
                                                   "extended_xvector": "ExtendedXvector",
                                                   "factored_xvector": "FactoredXvector"}[config]
    state = launcher.train(egs)
    assert launcher.trainer.config.use_semi_orth == (config == "factored_xvector")
    losses = read_report_csv(os.path.join(str(tmp_path), "log", "train.csv"))["loss"]
    assert len(losses) == 4 and np.isfinite(losses).all() and int(state.step) == 4
