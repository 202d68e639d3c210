"""The port's spans (utils/profiling.py ``span``, ``add``, ``totals``) on
the CPU: off they record nothing and enter no ``record_function``; under
a torch profiler the Extractor's five host spans and its three counters,
and the train step's four phases, record once where their code runs; a
second profiled session starts the registry afresh; and each per-layer
metric that reads them (``benchmark/layer_metrics``) reads None without
a trace or without the program's spans, and its number from seeded
totals.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from asv_subtools_tpu_torch.extract import ExtractConfig, Extractor
from asv_subtools_tpu_torch.features import FbankOptions, MelOptions
from asv_subtools_tpu_torch.models import SpeakerNet, Xvector
from asv_subtools_tpu_torch.train import TrainStepConfig, init_train_state, make_train_step, sgd
from asv_subtools_tpu_torch.utils import profiling
from benchmark import harness, tracing

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
EXTRACT_SPANS = ("extract.input", "extract.assemble", "extract.copy_in", "extract.launch", "extract.copy_out")
TRAIN_SPANS = ("train.front_end", "train.forward", "train.backward", "train.optimizer")
# two buckets of batch 4: 8 utterances fill the first twice, 4 the second once
LENGTHS = (300, 500, 700, 900, 1000, 400, 600, 800, 1200, 1500, 1800, 2000)
CONFIG = ExtractConfig(buckets=(1000, 2000), default_batch=4, max_chunk=2000)


def _embed(wave, mask):
    """[B, S] -> [B, 2]: the masked mean and the valid count."""
    m = mask.to(wave.dtype)
    return torch.stack([(wave * m).sum(1) / m.sum(1), m.sum(1)], 1)


def _items(n=len(LENGTHS)):
    rng = np.random.default_rng(0)
    return [(f"u{i}", rng.standard_normal(LENGTHS[i]).astype(np.float32)) for i in range(n)]


def _batches(items):
    """The (rows, bucket) of each batch CONFIG makes of ``items``."""
    by_bucket = {}
    for _, w in items:
        b = next(b for b in CONFIG.buckets if len(w) <= b)
        by_bucket[b] = by_bucket.get(b, 0) + 1
    out = []
    for b, n in by_bucket.items():
        out += [(CONFIG.default_batch, b)] * (n // CONFIG.default_batch)
        out += [(n % CONFIG.default_batch, b)] if n % CONFIG.default_batch else []
    return out


def _profiled_extract(items):
    ex = Extractor(_embed, CONFIG, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = dict(ex.extract_iter(items))
    return ex, got, prof, profiling.totals()


def test_off_spans_record_nothing_and_enter_no_range(monkeypatch):
    entered = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function", lambda name: entered.append(name) or real(name))
    profiling.reset()
    ex = Extractor(_embed, CONFIG, device="cpu")
    got = dict(ex.extract_iter(_items()))
    with profiling.span("x", device=torch.zeros(1)):
        profiling.add("n", 3)
    assert len(got) == len(LENGTHS) and ex._stats["batches"] == len(_batches(_items()))
    assert entered == [] and profiling.totals() == {}
    assert isinstance(profiling.span("x"), type(profiling._OFF))
    with profiling.tracing():
        with profiling.span("x"):
            pass
    assert entered == ["x"] and profiling.totals()["x"][0] == 1


def test_extractor_spans_under_the_profiler():
    items = _items()
    batches = _batches(items)
    ex, got, prof, t = _profiled_extract(items)
    assert len(got) == len(items) and ex._stats["batches"] == len(batches) == 3
    counts = {k: t[k][0] for k in EXTRACT_SPANS}
    # input: one a next, the last finds the end; assemble: one an item, two a batch
    assert counts == {"extract.input": len(items) + 1, "extract.assemble": len(items) + 2 * len(batches),
                      "extract.copy_in": len(batches), "extract.launch": len(batches),
                      "extract.copy_out": len(batches)}
    assert all(t[k][1] > 0 and t[k][2] is None for k in EXTRACT_SPANS)
    names = {e.name for e in prof.events()}
    assert set(EXTRACT_SPANS) <= names
    # the device path's three spans fill device_s but for the few lines of
    # Python between them
    inside = sum(t[k][1] for k in ("extract.copy_in", "extract.launch", "extract.copy_out"))
    assert 0 <= ex._stats["device_s"] - inside < 2e-4 * len(batches)
    # the padded waves and the int64 lengths; the mask is built on the device
    assert t["extract.copy_in_bytes"] == sum(n * b * 4 + n * 8 for n, b in batches)
    # on the CPU a batch is done when its call returns: no batch finds the one before it running
    assert t["extract.overlap_batches"] == 0
    # the slab pair is allocated at the first batch and grown at the first of the larger bucket
    assert t["extract.staging_allocs"] == 2


def test_a_second_profiled_session_starts_afresh():
    _profiled_extract(_items())
    ex = Extractor(_embed, CONFIG, device="cpu")
    dict(ex.extract_iter(_items()))  # off: nothing added
    assert profiling.totals()["extract.copy_in"][0] == 3
    ex, _, _, t = _profiled_extract(_items(3))
    assert t["extract.copy_in"][0] == 1 and t["extract.input"][0] == 4
    assert t["extract.copy_in_bytes"] == 3 * 1000 * 4 + 3 * 8


def test_train_step_spans_once_a_step():
    torch.manual_seed(0)
    net = SpeakerNet(Xvector(8, 16, 8, device="cpu"), "softmax", {}, num_targets=4)
    tx = sgd(0.01)
    step = make_train_step(net, tx, config=TrainStepConfig(
        compute_dtype=torch.float32, wave_input=True, fbank_opts=FbankOptions(mel_opts=MelOptions(num_bins=8))))
    state = init_train_state(net, tx, "cpu")
    batch = {"x": torch.randn(4, 4000) * 1000, "y": torch.tensor([0, 1, 2, 3])}
    gen = torch.Generator().manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, metrics = step(state, batch, gen)
    t = profiling.totals()
    assert {k: t[k][0] for k in TRAIN_SPANS} == dict.fromkeys(TRAIN_SPANS, 2)
    assert all(t[k][1] > 0 and t[k][2] is None for k in TRAIN_SPANS)
    assert set(TRAIN_SPANS) <= {e.name for e in prof.events()}
    assert math.isfinite(float(metrics["loss"])) and int(state.step) == 2


SEEDED = {"extract.input": (13, 0.01, None), "extract.assemble": (20, 0.3, None),
          "extract.copy_in": (4, 0.2, None), "extract.launch": (4, 0.05, None),
          "extract.copy_out": (4, 0.4, None), "extract.copy_in_bytes": 1.0e9,
          "train.front_end": (8, 0.02, 0.008), "train.forward": (8, 0.5, 0.32),
          "train.backward": (8, 0.1, 0.64), "train.optimizer": (8, 0.3, 0.024)}
WANT = {"extract.input_share": 0.5, "extract.assemble_share": 15.0, "extract.copy_in_share": 10.0,
        "extract.launch_share": 2.5, "extract.copy_out_share": 20.0, "extract.copy_in_gbps": 5.0,
        "train.front_end_device_ms": 1.0, "train.forward_device_ms": 40.0, "train.backward_device_ms": 80.0,
        "train.optimizer_device_ms": 3.0}


def _result(trace):
    return harness.Result(setup_s=0, window_s=1, end_to_end={}, counters={}, compared={}, attempted=1, failed=0,
                          memory_peak_bytes=0, trace=trace)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_span_metric_readers(metric, monkeypatch):
    reader = harness.load_module(REPO / "benchmark" / "layer_metrics" / f"{metric}.py")
    stub = tracing.TraceSummary(window_s=2.0, busy_s=1.0, kernel_s={}, idle_gaps=[], work=[(128, 32240)] * 8)
    monkeypatch.setattr(profiling, "totals", lambda: dict(SEEDED))
    assert reader.read(_result(None)) is None
    assert reader.read(_result(stub)) == pytest.approx(WANT[metric])
    monkeypatch.setattr(profiling, "totals", lambda: {})
    assert reader.read(_result(stub)) is None
    monkeypatch.delattr(profiling, "totals")  # a program without spans
    assert reader.read(_result(stub)) is None


@pytest.mark.cuda
def test_device_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.randn(256, 256, device="cuda")
    with profiling.tracing():
        for _ in range(profiling._FOLD_AT + 100):
            with profiling.span("card.mm", device=a):
                a = torch.tanh(a @ a)
        with profiling.span("card.host"):
            pass
        assert len(profiling._pending) <= profiling._FOLD_AT + 1  # resolved pairs were folded in
        t = profiling.totals()
    assert not profiling._pending
    count, host_s, device_s = t["card.mm"]
    assert count == profiling._FOLD_AT + 100 and host_s > 0 and device_s > 0
    assert t["card.host"][2] is None
