"""The port's EER gates (asv_subtools_tpu_torch/recipes) against the JAX
package's gate scripts (recipes/*.py, tools/make_synth_datadir.py).

* Corpus: the port's synthesizers, the gates' batches and evaluation sets,
  and the files synth_datadir writes equal the JAX scripts' bit for bit
  (the same numpy draws in the same order), serially and through the
  render pool.
* The paired quality gate's logic: the four cases of
  tests/test_quality_gate.py against the port's run_gate_multi; its
  calibration and bands equal JAX's.
* Steps: three f32 steps of each ECAPA gate's loop from the JAX gate's
  initial weights (PRNGKey(0), carried over by weights.load_variables) on
  the same batches as the JAX loop (its fused fbank in interpret mode), at
  a narrow width. Tolerances are those of the f32 wave-input step
  (tests/test_torch_train_wave.py): loss within 1e-3 relative, grad_norm
  within 1e-2.
* Scoring tails on fixed embeddings: the cosine EER, the CM EER and min
  t-DCF, the adaptation table and the demo's EER, minDCF and AS-norm EER
  equal the JAX lines'.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "recipes"))

import adaptation_gate as jax_adapt  # noqa: E402
import antispoof_gate as jax_spoof  # noqa: E402
import demo_synthetic as jax_demo  # noqa: E402
import quality_gate as jax_quality  # noqa: E402

from asv_subtools_tpu import backend as jax_backend  # noqa: E402
from asv_subtools_tpu.features import FbankOptions as JaxFbankOptions  # noqa: E402
from asv_subtools_tpu.features import MelOptions as JaxMelOptions  # noqa: E402
from asv_subtools_tpu.models import EcapaTdnn as JaxEcapa  # noqa: E402
from asv_subtools_tpu.models import SpeakerNet as JaxSpeakerNet  # noqa: E402
from asv_subtools_tpu.nn.loss import MarginWarm as JaxMarginWarm  # noqa: E402
from asv_subtools_tpu.train import TrainStepConfig as JaxStepConfig  # noqa: E402
from asv_subtools_tpu.train import get_lr_schedule as jax_schedule  # noqa: E402
from asv_subtools_tpu.train import get_optimizer as jax_optimizer  # noqa: E402
from asv_subtools_tpu.train import init_train_state as jax_init_state  # noqa: E402
from asv_subtools_tpu.train import make_train_step as jax_make_step  # noqa: E402
from asv_subtools_tpu_torch.recipes import _gate, gate_corpus  # noqa: E402
from asv_subtools_tpu_torch.recipes import adaptation_gate, antispoof_gate, demo_synthetic  # noqa: E402
from asv_subtools_tpu_torch.recipes import quality_gate, roadmap_gate, synth_datadir  # noqa: E402
from asv_subtools_tpu_torch.train import init_train_state  # noqa: E402
from asv_subtools_tpu_torch.weights import load_variables  # noqa: E402

SEEDS = (0, 7, 11)


# -- corpus, bit for bit -------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_synthesizers_match_jax(seed):
    r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):
        s_jax, s_port = jax_quality.make_speaker(r_jax), gate_corpus.make_speaker(r_port)
        for key in s_jax:
            np.testing.assert_array_equal(s_port[key], s_jax[key])
        w_jax, w_port = jax_quality.synth_utt(s_jax, 0.7, r_jax), gate_corpus.synth_utt(s_port, 0.7, r_port)
        assert w_port.dtype == np.float32
        np.testing.assert_array_equal(w_port, w_jax)
        for attack in range(3):
            np.testing.assert_array_equal(gate_corpus.spoof_utt(w_port, attack, r_port),
                                          jax_spoof.spoof_utt(w_jax, attack, r_jax))
        np.testing.assert_array_equal(gate_corpus.to_target_domain(w_port, r_port),
                                      jax_adapt.to_target_domain(w_jax, r_jax))
        d_jax, d_port = jax_demo.make_speaker(r_jax), gate_corpus.make_demo_speaker(r_port)
        np.testing.assert_array_equal(np.hstack([d_port[0], d_port[1], d_port[2]]),
                                      np.hstack([d_jax[0], d_jax[1], d_jax[2]]))
        np.testing.assert_array_equal(gate_corpus.synth_demo_utt(d_port, 0.6, r_port),
                                      jax_demo.synth_utt(d_jax, 0.6, r_jax))
    assert r_port.bit_generator.state == r_jax.bit_generator.state


@pytest.mark.parametrize("seed", SEEDS)
def test_advance_functions_take_the_renderers_draws(seed):
    """Each job's advance function leaves the generator where rendering it does."""
    rng = np.random.default_rng(seed)
    spk, demo_spk = gate_corpus.make_speaker(rng), gate_corpus.make_demo_speaker(rng)
    for kind, args in (("synth", (spk, 0.6)), ("demo", (demo_spk, 0.4)), ("spoof_pair", (spk, 0.5)),
                       ("target", (spk, 0.45)), ("spoofed", (spk, 0.5, 0)), ("spoofed", (spk, 0.5, 1)),
                       ("spoofed", (spk, 0.5, 2))):
        render, advance = gate_corpus.JOBS[kind]
        a, b = (np.random.default_rng(rng.integers(1 << 30)) for _ in range(2))
        b.bit_generator.state = a.bit_generator.state
        render(*args, a)
        advance(*args, b)
        assert a.bit_generator.state == b.bit_generator.state, kind


def _jax_batches(rng, speakers, k, b, chunk, synth):
    out = []
    for _ in range(k):
        ys = rng.integers(0, len(speakers), b)
        out.append((np.stack([synth(speakers[y], chunk, rng) for y in ys]), ys))
    return out


def _jax_eval(rng, speakers, per_spk, tag="s", post=None):
    items, labels = [], []
    for s, spk in enumerate(speakers):
        for u in range(per_spk):
            synth = jax_demo.synth_utt if post == "demo" else jax_quality.synth_utt
            wav = synth(spk, rng.uniform(2.5, 4.0), rng)
            if post == "target":
                wav = jax_adapt.to_target_domain(wav, rng)
            items.append((f"{tag}{s}u{u}", wav))
            labels.append(s)
    return items, np.asarray(labels)


def _assert_batches(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gx, wx)


def _assert_items(got, labels, want, want_labels):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, wait), (_, wav) in zip(got, want):
        np.testing.assert_array_equal(wait(), wav)
    np.testing.assert_array_equal(labels, want_labels)


def _port_batches(rng, speakers, k, render, b, chunk, kind="synth"):
    return list(_gate.speaker_batches(rng, speakers, k, render, b, chunk, kind))


@pytest.mark.parametrize("workers", [0, 2])
def test_quality_gate_batches_and_eval_set_match_jax(workers):
    """Speakers, then per step the labels and waves, then the evaluation
    set from the same generator (quality_gate.py:160-193); the render pool
    gives the same waves."""
    seed, n_spk = 7, 5
    r_jax = np.random.default_rng(seed)
    speakers = [jax_quality.make_speaker(r_jax) for _ in range(n_spk)]
    want = _jax_batches(r_jax, speakers, 3, 6, 0.5, jax_quality.synth_utt)
    want_items, want_labels = _jax_eval(r_jax, speakers, 2)
    with gate_corpus.Renderer(workers) as render:
        rng, port_speakers = quality_gate.corpus(seed, n_spk)
        got = _port_batches(rng, port_speakers, 3, render, 6, 0.5)
        items, labels = _gate.eval_items(rng, port_speakers, 2, render)
        _assert_batches(got, want)
        _assert_items(items, labels, want_items, want_labels)
    assert rng.bit_generator.state == r_jax.bit_generator.state


def test_adaptation_gate_sets_match_jax():
    """Three speaker sets, the training batches, then the source, adapt
    and eval sets, the last two through the target channel
    (adaptation_gate.py:94-166)."""
    seed = 11
    r_jax = np.random.default_rng(seed)
    sets = [[jax_quality.make_speaker(r_jax) for _ in range(n)] for n in (4, 2, 2)]
    want = _jax_batches(r_jax, sets[0], 2, 4, 0.5, jax_quality.synth_utt)
    want_sets = [_jax_eval(r_jax, sets[0], 2, "b"), _jax_eval(r_jax, sets[1], 1, "a", "target"),
                 _jax_eval(r_jax, sets[2], 1, "e", "target")]
    render = gate_corpus.Renderer(0)
    rng, train_spk, adapt_spk, eval_spk = adaptation_gate.corpus(seed, 4, 2, 2)
    _assert_batches(_port_batches(rng, train_spk, 2, render, 4, 0.5), want)
    for (tag, spk, per, kind), (w_items, w_labels) in zip(
            (("b", train_spk, 2, "synth"), ("a", adapt_spk, 1, "target"), ("e", eval_spk, 1, "target")), want_sets):
        items, labels = _gate.eval_items(rng, spk, per, render, tag=tag, kind=kind)
        _assert_items(items, labels, w_items, w_labels)


def test_antispoof_gate_pool_batches_and_eval_set_match_jax():
    """The pre-drawn pool (speaker, bona fide, attack, spoof per pair), the
    per-step resample, then the evaluation set (antispoof_gate.py:118-160)."""
    seed, n_spk, pairs = 11, 3, 5
    r_jax = np.random.default_rng(seed)
    speakers = [jax_quality.make_speaker(r_jax) for _ in range(n_spk)]
    pool_x, pool_y = [], []
    for _ in range(pairs):
        w = jax_quality.synth_utt(speakers[r_jax.integers(0, n_spk)], 0.5, r_jax)
        pool_x += [w, jax_spoof.spoof_utt(w, int(r_jax.integers(0, 3)), r_jax)]
        pool_y += [1, 0]
    pool_x, pool_y = np.stack(pool_x), np.asarray(pool_y, np.int32)
    want = []
    for _ in range(3):
        idx = r_jax.integers(0, len(pool_x), 4)
        want.append((pool_x[idx], pool_y[idx]))
    want_items, want_labels = [], []
    for s in range(n_spk):
        for u in range(8):
            w = jax_quality.synth_utt(speakers[s], r_jax.uniform(2.5, 3.5), r_jax)
            want_items.append((f"s{s}u{u}b", w) if u % 2 == 0 else (f"s{s}u{u}a", jax_spoof.spoof_utt(w, u % 3, r_jax)))
            want_labels.append(1 if u % 2 == 0 else 0)
    render = gate_corpus.Renderer(0)
    rng, port_speakers, px, py = antispoof_gate.corpus(seed, n_spk, render, chunk_s=0.5, pairs=pairs)
    np.testing.assert_array_equal(px, pool_x)
    np.testing.assert_array_equal(py, pool_y)
    _assert_batches(list(antispoof_gate.pool_batches(rng, px, py, 3, 4)), want)
    items, labels = antispoof_gate.eval_items(rng, port_speakers, render)
    _assert_items(items, labels, want_items, np.asarray(want_labels))


def test_roadmap_and_demo_draws_match_jax():
    """The roadmap's configs draw batches from default_rng(seed) (4 s chunks
    for the LM finetune at seed + 10) and evaluate from default_rng(seed + 1);
    the demo draws its voices, batches, evaluation set and cohort from one
    generator (demo_synthetic.py:54-130)."""
    seed, n_spk = 7, 4
    r = np.random.default_rng(seed)
    speakers = [jax_quality.make_speaker(r) for _ in range(n_spk)]
    render = gate_corpus.Renderer(0)
    for s, chunk in ((seed, 0.5), (seed + 10, 4.0)):
        want = _jax_batches(np.random.default_rng(s), speakers, 2, 3, chunk, jax_quality.synth_utt)
        _assert_batches(_port_batches(np.random.default_rng(s), speakers, 2, render, 3, chunk), want)
    items, labels = _gate.eval_items(np.random.default_rng(seed + 1), speakers, 1, render)
    _assert_items(items, labels, *_jax_eval(np.random.default_rng(seed + 1), speakers, 1))

    r_jax = np.random.default_rng(seed)
    d_speakers = [jax_demo.make_speaker(r_jax) for _ in range(n_spk)]
    want = _jax_batches(r_jax, d_speakers, 2, 4, 0.5, jax_demo.synth_utt)
    want_items, want_labels = _jax_eval(r_jax, d_speakers, 2, post="demo")
    want_cohort = [(f"c{i}", jax_demo.synth_utt(jax_demo.make_speaker(r_jax), 3.0, r_jax)) for i in range(3)]
    rng, port_speakers = demo_synthetic.corpus(seed, n_spk)
    _assert_batches(_port_batches(rng, port_speakers, 2, render, 4, 0.5, "demo"), want)
    items, labels = _gate.eval_items(rng, port_speakers, 2, render, kind="demo")
    _assert_items(items, labels, want_items, want_labels)
    cohort = demo_synthetic.cohort_items(rng, render, 3)
    _assert_items(cohort, np.zeros(3), want_cohort, np.zeros(3))


def test_synth_datadir_writes_the_jax_tools_files(tmp_path):
    args = ["--spk", "2", "--train-utts", "2", "--eval-utts", "2", "--dur", "0.5", "--seed", "3"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, str(REPO / "tools" / "make_synth_datadir.py"), "--out",
                          str(tmp_path / "jax"), *args], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert synth_datadir.main(["--out", str(tmp_path / "port"), *args]) == 0
    jax_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert port_files == jax_files and len(jax_files) == 8 + 4 + 1
    for rel in jax_files:
        want = (tmp_path / "jax" / rel).read_bytes().replace(str(tmp_path / "jax").encode(), b"OUT")
        got = (tmp_path / "port" / rel).read_bytes().replace(str(tmp_path / "port").encode(), b"OUT")
        assert got == want, rel


# -- the paired quality gate ---------------------------------------------------

def test_calibration_and_bands_equal_jax():
    assert quality_gate.CALIBRATION == jax_quality.CALIBRATION
    assert quality_gate.MULTI_SEEDS == jax_quality.MULTI_SEEDS
    assert quality_gate.DELTA_BAND == jax_quality.DELTA_BAND
    assert quality_gate.MULTI_BAND == jax_quality.MULTI_BAND
    assert quality_gate.SINGLE_BAND == jax_quality.SINGLE_BAND


def _fake_run_gate(shift):
    def run_gate(steps=400, n_spk=48, channels=128, band=None, seed=7, **kw):
        return {"eer_percent": quality_gate.CALIBRATION[seed] + shift(seed), "pass": True}

    return run_gate


def test_paired_gate_passes_under_chaos_noise(monkeypatch):
    """Per-seed chaos (about +-0.4, zero-mean) does not trip the gate."""
    rng = np.random.default_rng(0)
    noise = {s: float(rng.normal(0, 0.3)) for s in quality_gate.MULTI_SEEDS}
    monkeypatch.setattr(quality_gate, "run_gate", _fake_run_gate(lambda s: noise[s]))
    out = quality_gate.run_gate_multi()
    assert out["pass"], out
    assert abs(out["mean_delta_vs_calibration"]) <= quality_gate.DELTA_BAND


def test_paired_gate_catches_small_uniform_regression(monkeypatch):
    """A +0.6 pt common shift trips the paired gate; the absolute band
    alone would let it through."""
    monkeypatch.setattr(quality_gate, "run_gate", _fake_run_gate(lambda s: 0.6))
    out = quality_gate.run_gate_multi()
    assert not out["pass"], out
    assert quality_gate.MULTI_BAND[0] <= out["eer_percent_mean"] <= quality_gate.MULTI_BAND[1]


def test_absolute_sanity_band_catches_broken_runs(monkeypatch):
    monkeypatch.setattr(quality_gate, "run_gate", _fake_run_gate(lambda s: 50.0 - quality_gate.CALIBRATION[s]))
    assert not quality_gate.run_gate_multi()["pass"]


def test_improvements_are_in_band(monkeypatch):
    monkeypatch.setattr(quality_gate, "run_gate", _fake_run_gate(lambda s: -0.3))
    assert quality_gate.run_gate_multi()["pass"]


# -- three f32 steps of each ECAPA gate's loop ----------------------------------

CHANNELS, N_SPK, B, CHUNK, STEPS = 16, 4, 8, 0.5, 3
AAM = ("margin_softmax", {"method": "aam", "m": 0.2, "s": 30.0})
TOPK = ("margin_softmax_v1", roadmap_gate.topk_head(N_SPK))
MQMHA = {"pooling": "mqmha", "pooling_params": roadmap_gate.MQMHA}
OCS = ("ocsoftmax", antispoof_gate.OCSOFTMAX)


def _freeze(d):
    return tuple(sorted((k, _freeze(v) if isinstance(v, dict) else v) for k, v in d.items()))


@functools.lru_cache(maxsize=None)
def _jax_gate(loss, n_targets, pooling, warmup):
    """The JAX gate's net, its PRNGKey(0) initial state as numpy and its
    jitted f32 step (quality_gate.py:141-166)."""
    loss_name, loss_params = loss[0], dict(loss[1])
    opts = JaxFbankOptions(mel_opts=JaxMelOptions(num_bins=40))
    kw = dict(channels=CHANNELS, embd_dim=64, mfa_conv=int(CHANNELS * 1.5))
    if pooling:
        kw.update(pooling=pooling[0], pooling_params=dict(pooling[1]))
    net = JaxSpeakerNet(backbone=JaxEcapa(**kw), loss_name=loss_name, loss_params=loss_params,
                        num_targets=n_targets)
    schedule = jax_schedule("warmR", base_lr=2e-3, t_0=STEPS, warmup_steps=warmup)
    tx = jax_optimizer("adamW", learning_rate=schedule, weight_decay=1e-4)
    step = jax.jit(jax_make_step(net, tx, config=JaxStepConfig(wave_input=True, fbank_opts=opts,
                                                               compute_dtype=jnp.float32)))
    n_frames = opts.frame_opts.num_frames(int(CHUNK * 16000))
    state = jax_init_state(net, jax.random.PRNGKey(0), {"x": jnp.zeros((B, n_frames, 40)),
                                                        "y": jnp.zeros(B, jnp.int32)}, tx)
    return step, state


def _run_jax(loss, n_targets, batches, pooling=None, warm=False, warmup=20, backbone=None):
    step, state = _jax_gate((loss[0], _freeze(loss[1])), n_targets,
                            None if pooling is None else (pooling["pooling"], _freeze(pooling["pooling_params"])),
                            warmup)
    if backbone is not None:
        params = dict(state.params)
        params["backbone"] = backbone
        state = state.replace(params=params)
    init = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    mw = JaxMarginWarm(1, 2, offset_margin=-loss[1].get("m", 0.2), init_lambda=0.0,
                       epoch_iter=max(1, STEPS // 4)) if warm else None
    rng, losses, norms = jax.random.PRNGKey(0), [], []
    for i, (xs, ys) in enumerate(batches):
        rng, sub = jax.random.split(rng)
        batch = {"x": jnp.asarray(xs), "y": jnp.asarray(ys)}
        if mw is not None:
            moff, lam = mw.step(i)
            state, m = step(state, batch, sub, jnp.asarray(max(1e-3, lam), jnp.float32),
                            jnp.asarray(moff, jnp.float32))
        else:
            state, m = step(state, batch, sub)
        m = jax.device_get(m)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, jax.device_get(state.params), losses, norms


def _run_port(loss, n_targets, init, batches, pooling=None, warm=False, warmup=20):
    net = _gate.gate_net(n_targets, CHANNELS, loss[0], loss[1], device="cpu", **(pooling or {}))
    load_variables(net, init)
    tx, step = _gate.make_step(net, STEPS, warmup_steps=warmup, compute_dtype=torch.float32)
    state = init_train_state(net, tx, "cpu")
    mw = roadmap_gate.margin_warm(STEPS, loss[1].get("m", 0.2)) if warm else None
    _, run = _gate.train_loop(step, state, batches, torch.Generator().manual_seed(0), margin_warm=mw)
    return run


def _hold(run, losses, norms):
    np.testing.assert_allclose(run["loss"], losses, rtol=1e-3)
    np.testing.assert_allclose(run["grad_norm"], norms, rtol=1e-2)


def _speaker_batches(seed):
    rng, speakers = quality_gate.corpus(seed, N_SPK)
    return list(_gate.speaker_batches(rng, speakers, STEPS, gate_corpus.Renderer(0), B, CHUNK))


@pytest.mark.parametrize("gate", ["quality", "adaptation", "demo"])
def test_aam_gate_steps_match_jax(gate):
    if gate == "quality":
        batches = _speaker_batches(7)
    elif gate == "adaptation":
        rng, train_spk, _, _ = adaptation_gate.corpus(11, N_SPK, 2, 2)
        batches = list(_gate.speaker_batches(rng, train_spk, STEPS, gate_corpus.Renderer(0), B, CHUNK))
    else:
        rng, speakers = demo_synthetic.corpus(7, N_SPK)
        batches = list(_gate.speaker_batches(rng, speakers, STEPS, gate_corpus.Renderer(0), B, CHUNK, "demo"))
    init, _, losses, norms = _run_jax(AAM, N_SPK, batches)
    _hold(_run_port(AAM, N_SPK, init, batches), losses, norms)


@pytest.mark.parametrize("config", ["topk_subcenter", "mqmha"])
def test_roadmap_gate_steps_match_jax(config):
    """The sub-centre top-k AAM head with MarginWarm feeding the margin
    (lambda floored at 1e-3), with the attentive and the MQMHA pooling."""
    pooling = MQMHA if config == "mqmha" else None
    batches = _speaker_batches(7)
    warmup = min(20, STEPS // 4)
    init, _, losses, norms = _run_jax(TOPK, N_SPK, batches, pooling, warm=True, warmup=warmup)
    _hold(_run_port(TOPK, N_SPK, init, batches, pooling, warm=True, warmup=warmup), losses, norms)


def test_roadmap_lm_finetune_transfers_the_backbone_only():
    """The LM phase starts from the MQMHA phase's backbone with a fresh head
    and fresh running statistics (roadmap_gate.py:90-95), on its own batches."""
    batches = _speaker_batches(7)
    _, mq_params, _, _ = _run_jax(TOPK, N_SPK, batches, MQMHA, warm=True, warmup=0)
    lm = ("margin_softmax_v1", roadmap_gate.topk_head(N_SPK, m=0.5))
    lm_batches = _speaker_batches(17)
    _, _, losses, norms = _run_jax(lm, N_SPK, lm_batches, MQMHA, backbone=mq_params["backbone"])

    fresh = _jax_gate((lm[0], _freeze(lm[1])), N_SPK, ("mqmha", _freeze(roadmap_gate.MQMHA)), 20)[1]
    fresh = jax.device_get({"params": fresh.params, "batch_stats": fresh.batch_stats})

    def port(variables):
        net = load_variables(_gate.gate_net(N_SPK, CHANNELS, lm[0], lm[1], device="cpu", **MQMHA), variables)
        tx, step = _gate.make_step(net, STEPS, compute_dtype=torch.float32)
        return step, init_train_state(net, tx, "cpu")

    _, mq_state = port({"params": mq_params, "batch_stats": fresh["batch_stats"]})
    step, state = port(fresh)
    head = {k: v.clone() for k, v in state.params.items() if not k.startswith("backbone.")}
    roadmap_gate.transfer_backbone(state, mq_state)
    for k, v in state.params.items():
        assert torch.equal(v, mq_state.params[k] if k.startswith("backbone.") else head[k]), k
    assert any(not torch.equal(v, mq_state.params[k]) for k, v in head.items())
    _, run = _gate.train_loop(step, state, lm_batches, torch.Generator().manual_seed(0))
    _hold(run, losses, norms)


def test_antispoof_gate_steps_match_jax():
    render = gate_corpus.Renderer(0)
    rng, _, pool_x, pool_y = antispoof_gate.corpus(11, 3, render, chunk_s=CHUNK, pairs=6)
    batches = list(antispoof_gate.pool_batches(rng, pool_x, pool_y, STEPS, B))
    init, _, losses, norms = _run_jax(OCS, 2, batches)
    _hold(_run_port(OCS, 2, init, batches), losses, norms)


@pytest.mark.parametrize("loss", [AAM, TOPK], ids=["margin_softmax", "margin_softmax_v1"])
def test_seeded_weights_draw_the_margin_head_at_flax_scale(loss):
    """weights.init_weights_ draws the margin heads' classifier as flax's
    normal(0.01) does (JAX nn/loss.py:133, 250), not at the kernels'
    1/sqrt(fan_in): at 1/sqrt(64) the port's quality gate missed its
    paired band on the H100 (mean delta +1.92 against 0.45)."""
    _, state = _jax_gate((loss[0], _freeze(loss[1])), 48, None, 20)
    jax_w = np.asarray(state.params["loss"]["weight"])
    port_w = _gate.gate_net(48, CHANNELS, loss[0], loss[1], device="cpu").loss.weight.detach().numpy()
    assert port_w.shape == jax_w.shape
    for w in (jax_w, port_w):
        assert 0.009 < float(w.std()) < 0.011 and abs(float(w.mean())) < 1e-3


# -- scoring tails on fixed embeddings ------------------------------------------

def _embeddings(seed, n_spk, per_spk, dim=16, shift=0.0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(n_spk, dim)) * 2.0
    x = np.repeat(centres, per_spk, axis=0) + rng.normal(size=(n_spk * per_spk, dim)) + shift
    return x.astype(np.float32), np.repeat(np.arange(n_spk), per_spk)


def _jax_cosine_eer(mat, labels):
    mat = mat - mat.mean(axis=0)
    scores = np.asarray(jax_backend.cosine_score_matrix(mat, mat))
    iu = np.triu_indices(len(mat), 1)
    same = (labels[:, None] == labels[None, :])[iu].astype(int)
    return 100.0 * jax_backend.compute_eer(scores[iu], same)[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_cosine_eer_equals_jax(seed):
    mat, labels = _embeddings(seed, 12, 4)
    assert _gate.cosine_eer(mat, labels) == _jax_cosine_eer(mat, labels)


def test_antispoof_tail_equals_jax():
    rng = np.random.default_rng(3)
    labels = np.tile([1, 0], 48)
    mat = (rng.normal(size=(96, 64)) + labels[:, None] * 0.4).astype(np.float32)
    center = rng.normal(size=64).astype(np.float32)
    scores = antispoof_gate.cm_scores(mat, center)
    eer = antispoof_gate.compute_eer(scores, labels)[0]
    tdcf = antispoof_gate.tandem_min_tdcf(scores, labels)

    m, c = mat.copy(), center.copy()
    m /= np.linalg.norm(m, axis=-1, keepdims=True) + 1e-9
    c /= np.linalg.norm(c) + 1e-9
    want = m @ c
    g = np.random.default_rng(0)
    asv = np.concatenate([g.normal(2.0, 1.0, 2000), g.normal(-2.0, 1.0, 2000), g.normal(0.5, 1.5, 2000)])
    asv_labels = np.concatenate([np.ones(2000, np.int64), np.zeros(2000, np.int64), -np.ones(2000, np.int64)])
    np.testing.assert_array_equal(scores, want)
    assert eer == jax_backend.compute_eer(want, labels)[0]
    assert tdcf == float(jax_backend.compute_min_tdcf(asv, asv_labels, want, labels))


def test_adaptation_table_equals_jax():
    """Source, adapt and eval sets of 16-d embeddings, the last two shifted:
    every EER of the table, the best adaptation and the verdict
    (adaptation_gate.py:170-212)."""
    x_src, y_src = _embeddings(0, 24, 8)
    x_adapt, y_adapt = _embeddings(1, 12, 6, shift=1.5)
    x_eval, y_eval = _embeddings(2, 12, 6, shift=1.5)
    results, best, ok = adaptation_gate.score_table(x_src, y_src, x_adapt, y_adapt, x_eval, y_eval)

    jb = jax_backend
    src_mean = x_src.mean(axis=0)
    ln = lambda v: jb.length_norm(v - src_mean)
    xs, xa, xe = ln(x_src), ln(x_adapt), ln(x_eval)
    plda = jb.estimate_plda(jb.PldaStats.from_vectors(xs, y_src), 10)
    iu = np.triu_indices(len(xe), 1)
    same = (y_eval[:, None] == y_eval[None, :])[iu].astype(int)
    eer_of = lambda s: 100.0 * jb.compute_eer(np.asarray(s)[iu], same)[0]
    score = lambda p: eer_of(jb.plda_score_trials(p, xe, xe))
    two_out = jb.TwoCovPlda.from_scoring_form(plda)
    plda_in = jb.estimate_plda(jb.PldaStats.from_vectors(xa, y_adapt), 10)
    two_in = jb.TwoCovPlda.from_scoring_form(plda_in)
    want = {
        "cosine": eer_of(xe @ xe.T),
        "plda_source": score(plda),
        "plda_aplda": score(jb.adapt_plda_unsupervised(plda, xa)),
        "plda_coral": score(jb.adapt_plda_coral(two_out, xa).to_scoring_form()),
        "plda_coral_plus": score(jb.adapt_plda_coral_plus(two_out, xa).to_scoring_form()),
        "plda_indomain_only": score(plda_in),
        "plda_lip_reg": score(jb.adapt_plda_lip_reg(two_out, two_in).to_scoring_form()),
        "plda_cip_reg": score(jb.adapt_plda_cip_reg(two_out, two_in, xa).to_scoring_form()),
    }
    assert list(results) == list(want)
    assert results == want
    adapted = {k: v for k, v in want.items() if k not in ("cosine", "plda_source", "plda_indomain_only")}
    assert best == min(adapted, key=adapted.get)
    assert ok == (adapted[best] < want["plda_source"])


def test_demo_tail_equals_jax():
    mat, labels = _embeddings(4, 16, 4)
    cohort, _ = _embeddings(5, 32, 1)
    got = demo_synthetic.demo_scores(mat, labels, cohort)

    jb = jax_backend
    m = mat - mat.mean(axis=0)
    scores = np.asarray(jb.cosine_score_matrix(m, m))
    iu = np.triu_indices(len(m), 1)
    same = (labels[:, None] == labels[None, :])[iu].astype(int)
    eer, _ = jb.compute_eer(scores[iu], same)
    dcf, _ = jb.compute_min_dcf(scores[iu], same, p_target=0.05)
    coh = np.asarray(jb.cosine_score_matrix(m, cohort - m.mean(axis=0)))
    eer_as, _ = jb.compute_eer(jb.asnorm(scores, coh, coh, top_n=40)[iu], same)
    assert got == (eer, dcf, eer_as)


# -- the entry points: JSON keys and exit codes -----------------------------------

def _jax_key_sets(script):
    """The key sets of the dict literals that the JAX script prints: those
    assigned to ``out`` or ``row`` or handed to json.dumps."""
    import ast

    sets = []
    for node in ast.walk(ast.parse((REPO / "recipes" / script).read_text())):
        d = None
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") in ("out", "row") for t in node.targets)):
            d = node.value
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps" and node.args
              and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
        if d is not None and d.keys and all(isinstance(k, ast.Constant) and isinstance(k.value, str) for k in d.keys):
            sets.append(frozenset(k.value for k in d.keys))
    return set(sets)


def _printed_key_sets(capsys):
    import json

    return {frozenset(json.loads(line)) for line in capsys.readouterr().out.splitlines() if line.startswith("{")}


def test_gates_print_the_jax_gates_json_keys(capsys, monkeypatch, tmp_path):
    """Each gate, run for a step or two at a narrow width on the CPU, prints
    the key sets of its JAX counterpart's JSON lines (the RepVGG gate adds
    its training's wall time to the last)."""
    tiny = dict(channels=8, device="cpu", workers=0)
    quality_gate.run_gate_multi(seeds=(7,), steps=2, n_spk=4, **tiny)
    assert _printed_key_sets(capsys) == _jax_key_sets("quality_gate.py")

    roadmap_gate.run(steps=2, lm_steps=1, n_spk=4, **tiny)
    assert _printed_key_sets(capsys) == _jax_key_sets("roadmap_gate.py")

    antispoof_gate.run_gate(steps=2, n_spk=2, pairs=4, **tiny)
    assert _printed_key_sets(capsys) == _jax_key_sets("antispoof_gate.py")

    # the PLDA table needs more vectors than a tiny run gives (its keys:
    # test_adaptation_table_equals_jax)
    table = {k: 0.0 for k in ("cosine", "plda_source", "plda_aplda", "plda_coral", "plda_coral_plus",
                              "plda_indomain_only", "plda_lip_reg", "plda_cip_reg")}
    monkeypatch.setattr(adaptation_gate, "score_table", lambda *a: (table, "plda_coral", True))
    adaptation_gate.run_gate(steps=2, n_train_spk=3, n_adapt_spk=1, n_eval_spk=1, **tiny)
    assert _printed_key_sets(capsys) == _jax_key_sets("adaptation_gate.py")

    demo_synthetic.run(n_spk=4, steps=2, cohort_size=40, **tiny)
    assert _printed_key_sets(capsys) == _jax_key_sets("demo_synthetic.py")

    synth_datadir.write_datadir(str(tmp_path / "data"), spk=12, train_utts=12, eval_utts=2, dur=2.5)
    from asv_subtools_tpu_torch.recipes import repvgg_deploy_gate

    out = repvgg_deploy_gate.run_gate(str(tmp_path / "data"), str(tmp_path / "exp"), epochs=1, device="cpu")
    want = _jax_key_sets("repvgg_deploy_gate.py")
    cmp_keys = frozenset({"deploy_vs_train_mean_cosine", "eer_train", "eer_deploy"})
    assert _printed_key_sets(capsys) == (want - {cmp_keys}) | {cmp_keys | {"train_seconds"}}
    assert out["deploy_vs_train_mean_cosine"] > repvgg_deploy_gate.MIN_COSINE
    repvgg_deploy_gate.check(out)


@pytest.mark.parametrize("module, argv, key, field", [
    (quality_gate, ["--cpu", "--steps", "3", "--spk", "5", "--channels", "16", "--seed", "9"], "run_gate", "pass"),
    (quality_gate, ["--cpu", "--multi", "--band", "1", "2"], "run_gate_multi", "pass"),
    (antispoof_gate, ["--cpu", "--steps", "3"], "run_gate", "pass"),
    (adaptation_gate, ["--cpu", "--steps", "3"], "run_gate", "improves"),
])
@pytest.mark.parametrize("verdict", [True, False])
def test_gate_exit_codes(monkeypatch, module, argv, key, field, verdict):
    """0 on a pass, 1 on a fail, as the JAX scripts exit; the flags reach
    the run function and --cpu picks the CPU."""
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {field: verdict}

    monkeypatch.setattr(module, key, fake)
    assert module.main(argv) == (0 if verdict else 1)
    assert seen["device"] == "cpu"
    if "--steps" in argv:
        assert seen["steps"] == 3
    if "--band" in argv:
        assert seen["band"] == (1.0, 2.0)
