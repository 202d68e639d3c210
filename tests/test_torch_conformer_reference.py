"""The Conformer x-vector against the benchmark's plain reference
(``benchmark/reference/conformer.py``) on the CPU at a narrow size, the
float8 control, the FLOP count's T'^2 terms, the attention's counted
work, the encoder's spans under ``profiling.tracing()``, and the four
``conformer.*`` per-layer metrics' readers.
"""

from pathlib import Path

import pytest
import torch

from asv_subtools_tpu_torch.models.conformer import ConformerXvector
from asv_subtools_tpu_torch.utils import profiling
from benchmark import harness, reference, tracing
from benchmark.counts import conformer as counts, kernels, model_flops, peaks
from benchmark.reference import fbank
from benchmark.reference.ops import fp8_round
from benchmark.weights import seeded_tensors

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
WIDTHS = {"input_dim": 80, "attention_dim": 32, "attention_heads": 4, "linear_units": 64, "num_blocks": 2,
          "input_layer": "conv2d2", "pos_enc_type": "rel_pos", "transformer_type": "conformer",
          "combiner_type": "norm", "out_dim": 48, "pooling": "ecpa-attentive", "embd_dim": 16}
NARROW = {"reference": "conformer", "model": WIDTHS}
FULL = {"reference": "conformer",
        "model": dict(WIDTHS, attention_dim=256, linear_units=2048, num_blocks=6, out_dim=1536, embd_dim=256)}
SPANS = ("conformer.subsample", "conformer.attention", "conformer.conv_module", "conformer.pooling")
# 1-3 s waves, padded to 3 s
VALID = [48000, 30000, 16000, 40000]


def _model(widths=WIDTHS, seed=5):
    fam = reference.family("conformer")
    p = seeded_tensors(fam.param_specs({"model": widths}), seed, "cpu", torch.float32)
    model = ConformerXvector(**widths, device="cpu")
    model.load_state_dict(p)
    return model, p


def _features(seed=1):
    g = torch.Generator().manual_seed(seed)
    wave = torch.round(torch.randn(len(VALID), max(VALID), generator=g) * 3000)
    valid = torch.as_tensor(VALID)
    wave = wave * (torch.arange(wave.shape[1])[None] < valid[:, None])
    return fbank.features(wave, valid, 80)


def _gap(got, want):
    return float((torch.linalg.vector_norm(got - want, dim=-1) / torch.linalg.vector_norm(want, dim=-1)).max())


# both sides in float32 on the same features and weights, but in other
# orders of summation (the fused qkv against its slices, the softmax's
# -1e9 fill, the pooling's one-pass variance against the central moment):
# float32 rounding over two blocks and the pooling reads about 1e-6
TOLERANCE = 1e-4


def test_the_program_matches_the_reference():
    model, p = _model()
    feats, fmask = _features()
    assert not bool(fmask.all())  # padded rows
    with torch.no_grad():
        got = model(feats, fmask)
        want = reference.family("conformer").forward(p, feats, fmask)
    assert got.shape == (len(VALID), 16)
    assert _gap(got, want) < TOLERANCE


def test_the_float8_control_is_farther_than_the_tolerance():
    _, p = _model()
    feats, fmask = _features()
    fam = reference.family("conformer")
    with torch.no_grad():
        want = fam.forward(p, feats, fmask)
        low = fam.forward(p, feats, fmask, q=fp8_round)
    assert _gap(low, want) > 100 * TOLERANCE


@pytest.mark.parametrize("cfg", [NARROW, FULL], ids=["narrow", "6l256d"])
def test_param_specs_cover_the_state_dict(cfg):
    specs = reference.family("conformer").param_specs(cfg)
    with torch.device("meta"):
        model = ConformerXvector(**cfg["model"], device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {name: shape for name, shape, _, _ in specs} == want
    assert len(specs) == len(want)
    if cfg is FULL:  # the published configuration as the port builds it
        assert sum(v.numel() for v in model.state_dict().values()) == 22_973_568


def test_the_reference_refuses_other_options_and_training():
    fam = reference.family("conformer")
    with pytest.raises(ValueError, match="input_layer"):
        fam.param_specs({"model": dict(WIDTHS, input_layer="conv2d")})
    _, p = _model()
    feats, fmask = _features()
    with pytest.raises(NotImplementedError):
        fam.forward(p, feats, fmask, train=True)


def test_network_flops_hold_the_quadratic_terms():
    # T = 2 T' + 5 frames subsample to exactly T'; everything but the three
    # [T', T'] products a head is affine in T', so the second difference at
    # a step of s in T' is theirs alone: 2 s^2 x blocks x 3 x 2 x D x B
    d, blocks, batch, s = WIDTHS["attention_dim"], WIDTHS["num_blocks"], 3, 40
    t1 = 60
    f = [model_flops.network_flops(NARROW, 2 * (t1 + i * s) + 5, batch) for i in range(3)]
    assert [reference.family("conformer").subsampled_frames(2 * (t1 + i * s) + 5) for i in range(3)] == \
        [t1, t1 + s, t1 + 2 * s]
    quadratic = 2 * s * s * blocks * 6 * d
    assert f[0] - 2 * f[1] + f[2] == pytest.approx(quadratic * batch, rel=1e-9)
    # the affine count of ``per_utterance`` from the first two lengths misses them at the third
    affine = model_flops.per_utterance(NARROW, 2 * t1 + 5, 2 * (t1 + s) + 5)
    t3 = 2 * (t1 + 2 * s) + 5
    assert model_flops.network_flops(NARROW, t3) - affine(t3) == pytest.approx(quadratic, rel=1e-6)


def test_attention_work_is_the_layers_products():
    # one layer at B=128, T'=1596 (the 32 s bucket), D=256, 4 heads
    flops, nbytes = counts.attention_layer(128, 1596, 256, 4)
    assert flops == pytest.approx(2 * 128 * 1596 * 256 * 1024 + 2 * 1596 * 256 * 256
                                  + 6 * 128 * 1596 ** 2 * 256, rel=1e-12)
    assert nbytes == pytest.approx(2 * (2 * 128 * 1596 * 256 + 5 * 256 * 256 + 6 * 256), rel=1e-12)
    # it agrees with the reference's own count of the same products
    full = model_flops.network_flops(FULL, 3198, 2)
    without = model_flops.network_flops(dict(FULL, model=dict(FULL["model"], num_blocks=5)), 3198, 2)
    layer = counts.attention_layer(2, 1596, 256, 4)[0]
    assert layer < full - without  # a block is more than its attention
    work = list(counts.attention_work(FULL, [(128, 512000), (64, 128000)]))
    assert len(work) == 12 and work[0] == counts.attention_layer(128, 1596, 256, 4)
    assert work[6] == counts.attention_layer(64, 396, 256, 4)


def test_spans_record_under_tracing_only(monkeypatch):
    entered = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function", lambda name: entered.append(name) or real(name))
    widths = dict(WIDTHS, num_blocks=6)
    model, _ = _model(widths)
    feats, fmask = _features()
    profiling.reset()
    with torch.no_grad():
        off = model(feats, fmask)
    assert entered == [] and profiling.totals() == {}
    with profiling.tracing(), torch.no_grad():
        on = model(feats, fmask)
        t = profiling.totals()
    assert torch.equal(on, off)
    assert {k: t[k][0] for k in SPANS} == {"conformer.subsample": 1, "conformer.attention": 6,
                                           "conformer.conv_module": 6, "conformer.pooling": 1}
    assert all(t[k][1] > 0 and t[k][2] is None for k in SPANS)  # CPU tensors: host seconds only
    assert sorted(set(entered)) == sorted(SPANS)


def _result(trace, config=FULL):
    return harness.Result(setup_s=0, window_s=1, end_to_end={}, counters={}, compared={}, attempted=1, failed=0,
                          memory_peak_bytes=0, trace=trace, config=config)


SEEDED = {"conformer.subsample": (8, 0.01, 0.25), "conformer.attention": (48, 0.05, 1.2),
          "conformer.conv_module": (48, 0.03, 0.1), "conformer.pooling": (8, 0.01, 0.02)}
WORK = [(128, 512000)] * 2 + [(128, 128000)] * 6


def _want(metric):
    if metric == "conformer.attention_share":
        return 100 * 1.2 / 1.6
    if metric == "conformer.subsample_share":
        return 100 * 0.25 / 1.6
    need = sum(peaks.bound_s(*counts.attention_layer(b, counts.subsampled_frames(fbank.num_frames(s)), 256, 4))
               for b, s in WORK) * 6
    return 100 * need / 1.2


@pytest.mark.parametrize("metric", ["conformer.attention_share", "conformer.subsample_share",
                                    "conformer.attention_roofline"])
def test_span_metric_readers(metric, monkeypatch):
    reader = harness.load_module(REPO / "benchmark" / "layer_metrics" / f"{metric}.py")
    stub = tracing.TraceSummary(window_s=2.0, busy_s=1.6, kernel_s={}, idle_gaps=[], work=WORK)
    monkeypatch.setattr(profiling, "totals", lambda: dict(SEEDED))
    assert reader.read(_result(None)) is None
    assert reader.read(_result(stub)) == pytest.approx(_want(metric), rel=1e-9)
    monkeypatch.setattr(profiling, "totals", lambda: {"conformer.attention": (6, 0.1, None),
                                                      "conformer.subsample": (1, 0.1, None)})
    assert reader.read(_result(stub)) is None  # spans without the card's time
    monkeypatch.setattr(profiling, "totals", lambda: {})
    assert reader.read(_result(stub)) is None
    monkeypatch.delattr(profiling, "totals")  # a program without spans
    assert reader.read(_result(stub)) is None


def test_mfu_reader_counts_padded_shapes_once_each(monkeypatch):
    reader = harness.load_module(REPO / "benchmark" / "layer_metrics" / "conformer.mfu.py")
    assert reader.read(_result(None, NARROW)) is None
    calls = []
    real = model_flops.network_flops
    monkeypatch.setattr(model_flops, "network_flops", lambda cfg, frames, batch=1: calls.append((frames, batch))
                        or real(cfg, frames, batch))
    work = [(4, 48000), (4, 32000), (4, 48000)]
    stub = tracing.TraceSummary(window_s=0.5, busy_s=0.4, kernel_s={}, idle_gaps=[], work=work)
    got = reader.read(_result(stub, NARROW))
    assert sorted(calls) == [(198, 4), (298, 4)]
    want = sum(real(NARROW, fbank.num_frames(s), b) + kernels.k1(b, s, 80)[0] for b, s in work)
    assert got == pytest.approx(100 * want / (0.5 * peaks.BF16_FLOPS), rel=1e-12)
