"""The harness on the CPU: files found by name, the traffic generator,
the per-layer arithmetic, the result line, and the runs that must fail.

    python -m pytest benchmark/ -q
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness, tracing, traffic_gen

REPO = Path(__file__).resolve().parent.parent
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in SPEC[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        on_disk = json.loads((REPO / c["file"]).read_text())
        assert on_disk["reduced"] == c["reduced"] == []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]} and UNIT.match(m["unit"])


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_is_found_by_name(workload):
    cell = harness.resolve(SPEC, workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert callable(cell.driver.run) and all(callable(r.read) for _, r in cell.per_layer)
    assert cell.limits, "every cell has its correctness limits"


def test_added_files_are_taken_with_no_edit(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    config = json.loads((bench / "configs/ecapa_c1024.json").read_text())
    config["model"]["channels"] = 512
    (bench / "configs/ecapa_c512.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic/vox1_extract.json").read_text())
    (bench / "traffic/short_extract.json").write_text(json.dumps(dict(mix, batch=32)))
    (bench / "layer_metrics/extract.batches.py").write_text("def read(result):\n    return 7.0\n")
    (bench / "limits/ecapa_c512.short_extract.json").write_text(json.dumps({"emb_gap": 0.1}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ecapa_c512", "source": "https://arxiv.org/abs/2005.07143",
                            "file": "benchmark/configs/ecapa_c512.json", "reduced": [], "why": "narrower"})
    spec["workloads"].append({"name": "ecapa_c512.short_extract", "config": "ecapa_c512",
                              "traffic": "short_extract", "chips": 1, "why": "a test cell"})
    spec["end_to_end"][0]["workloads"].append("ecapa_c512.short_extract")
    spec["per_layer"].append({"name": "extract.batches", "unit": "count", "better": "lower",
                              "source": "program_counter", "layer": "Extractor bucketing and batching",
                              "moves": "extract_audio_s_per_s", "workloads": ["ecapa_c512.short_extract"]})
    cell = harness.resolve(spec, "ecapa_c512.short_extract", repo=tmp_path)
    assert cell.config["model"]["channels"] == 512 and cell.traffic["batch"] == 32
    assert cell.limits == {"emb_gap": 0.1}
    assert [m["name"] for m, _ in cell.per_layer] == ["extract.batches"]
    assert cell.per_layer[0][1].read(None) == 7.0
    assert Path(cell.driver.__file__) == bench / "drivers/extract.py"
    assert all(p.read_bytes() == data for p, data in before.items()), "no file that was there changed"


def test_lengths_keep_voxceleb1s_minimum_cap_and_mean():
    mix = json.loads((REPO / "benchmark/traffic/vox1_extract.json").read_text())
    rate = mix["sample_rate"]
    pool = traffic_gen.length_pool(mix)
    assert pool.min() >= 4.0 * rate and pool.max() == 32.0 * rate
    assert pool.mean() / rate == pytest.approx(4.0 + 4.2 * (1 - np.exp(-28 / 4.2)), abs=0.01)
    seed = 2 ** 31 + 12345
    draw = lambda s: [(n, off) for _, n, off in _take(traffic_gen.UtteranceStream(mix, s), len(pool))]
    a, b, c = draw(seed), draw(seed), draw(seed + 1)
    assert a == b and a != c
    assert sorted(n for n, _ in a) == sorted(n for n, _ in c) == sorted(pool.tolist())
    assert all(0 <= off and off + n <= mix["noise_s"] * rate for n, off in a)


def _take(stream, n):
    out = []
    for item in stream:
        out.append(item)
        if len(out) == n:
            return out


def test_pad_share_from_a_known_length_list():
    buckets = [32000, 64000, 128000, 256000, 512000]
    lengths = [70000, 100000, 128000, 130000, 300000]
    sent = sum(traffic_gen.bucket_of(n, buckets) for n in lengths)
    result = harness.Result(setup_s=0, window_s=1, end_to_end={}, compared={}, attempted=5, failed=0,
                            memory_peak_bytes=0, counters={"valid_samples": float(sum(lengths)),
                                                           "sent_samples": float(sent), "window_s": 1.0})
    reader = harness.load_module(REPO / "benchmark/layer_metrics/extract.pad_share.py")
    want = 100.0 * (1 - sum(lengths) / (128000 * 3 + 256000 + 512000))
    assert reader.read(result) == pytest.approx(want)


def _summary():
    events = [("bench.embed", False, 0.0, 100.0), ("aten::copy_", False, 10.0, 30.0),
              ("fbank_mma_kernel(float const*)", True, 20.0, 40.0), ("res2_mma_kernel<8>", True, 35.0, 60.0),
              ("Memcpy HtoD", True, 80.0, 90.0)]
    return tracing.reduce(events, [(128, 128000)])


def test_the_trace_reduces_to_busy_time_kernels_and_gaps():
    t = _summary()
    assert t.window_s == pytest.approx(100e-6) and t.busy_s == pytest.approx(50e-6)
    assert t.time_of(("fbank_mma_kernel",)) == pytest.approx(20e-6) and t.time_of(("fbank_kernel",)) == 0
    assert dict(t.idle_gaps) == pytest.approx({"aten::copy_": 20e-6, "bench.embed": 30e-6})
    assert tracing.reduce([("x", False, 0.0, 1.0)], []) is None


def test_the_last_line_has_the_contracts_keys():
    cell = harness.resolve(SPEC, "ecapa_c1024.extract_vox1")
    result = harness.Result(setup_s=12.5, window_s=10.0, end_to_end={"extract_audio_s_per_s": 9000.0},
                            counters={"window_s": 10.0, "valid_samples": 6.8e9, "sent_samples": 1e10,
                                      "extractor_span_s": 6.0, "window_flops": 2e17},
                            compared={"emb_gap": 0.001}, attempted=100, failed=0, memory_peak_bytes=1,
                            trace=_summary(), config=cell.config)
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 1}
    line = harness.result_line(cell, result, device, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["correct"] is True and set(line["metrics"]) == {"extract_audio_s_per_s", "setup_s"}
    traced = harness.result_line(cell, result, device, trace=True)
    assert list(traced)[-1] == "compared" and "breakdown" in traced
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert traced["metrics"]["extract.pad_share"]["value"] == pytest.approx(32.0)
    assert traced["metrics"]["extract.k1_roofline"]["unit"] == "%"
    assert traced["metrics"]["extract.mfu"]["value"] == pytest.approx(100 * 2e17 / (10.0 * 989e12))
    assert "extract.k2_roofline" not in traced["metrics"]  # its kernels did not run: no reading, not 0
    assert harness.result_line(cell, dataclass_replace(result, compared={"emb_gap": 1.0}), device, False)[
        "correct"] is False


def dataclass_replace(result, **kw):
    import dataclasses

    return dataclasses.replace(result, **kw)


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ecapa_c1024.extract_vox1",
                           "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = _run(REPO, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_run_with_only_the_benchmarks_files_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
