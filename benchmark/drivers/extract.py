"""Entry kind ``extract``: the port's ``Extractor`` in wave mode, as the
Launcher's ``extract.mode: wave`` drives it, over a closed loop of one
stream of utterances.

Set-up: seeded weights (in the served type) loaded into the program's
model, ``make_wave_embed_fn`` (the fused fbank K1, masked CMVN, the
model), the Extractor with the mix's buckets and batch, and one full
batch through each bucket the mix fills. The window feeds utterances
until ``seconds`` have passed; the embeddings yielded by then are the
window's work (audio counted at the utterances' own lengths). The
buckets still partly filled are flushed after the window, not counted.
Once the window is over (and after the traced stretch, with ``--trace
1``) the program is freed and the reference embeds a seeded sample of
the window's answers, padded to their buckets as the program padded
them, in float32.
"""

from __future__ import annotations

import gc
import itertools
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import checks, program, reference, tracing, traffic_gen, weights
from benchmark.counts import kernels, model_flops
from benchmark.harness import Result
from benchmark.reference.ops import fp8_round


def _plant(out: torch.Tensor, faults) -> torch.Tensor:
    """Faults of the served path, planted in the program's answers (tests
    and calibration only)."""
    out = out.clone()
    b = out.shape[0]
    if "half_batch" in faults:  # the second half of a batch left out, given the first half's answers
        out[b - b // 2:] = out[: b // 2]
    if "answer_altered" in faults:  # one answer of every batch altered where it is produced
        out[0] = -out[0]
    return out


def run(ctx) -> Result:
    from asv_subtools_tpu_torch.extract import ExtractConfig, Extractor, make_wave_embed_fn

    cfg, mix = ctx.cell.config, ctx.cell.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    dtype = getattr(torch, cfg["dtype"])
    rate, buckets = mix["sample_rate"], tuple(mix["buckets"])
    fam = reference.family(cfg["reference"])
    w = weights.seeded_tensors(fam.param_specs(cfg), traffic_gen.derived_seed(ctx.seed, 0), dev, dtype)
    model = program.build(cfg, dev, w).to(dtype).eval()
    embed = make_wave_embed_fn(lambda x, m: model(x, m), program.fbank_options(cfg), dtype=dtype)
    calls: List[tuple] = []

    def recorded(wave, mask):
        out = embed(wave, mask)
        calls.append(tuple(wave.shape))
        return _plant(out, ctx.faults) if ctx.faults else out

    t_built = time.perf_counter()
    ex = Extractor(recorded, ExtractConfig(buckets=buckets, default_batch=mix["batch"], max_chunk=buckets[-1]),
                   device=dev)
    noise = traffic_gen.noise(mix, ctx.seed)
    for b in sorted({traffic_gen.bucket_of(int(n), buckets) for n in traffic_gen.length_pool(mix)}):
        for _ in ex.extract_iter((f"warm{i}", noise[:b]) for i in range(mix["batch"])):
            pass
    if cuda:
        torch.cuda.synchronize(dev)
    t_warm = time.perf_counter()

    stream = iter(traffic_gen.UtteranceStream(mix, ctx.seed))
    lengths: Dict[int, int] = {}
    offsets: Dict[int, int] = {}
    mark: dict = {"closed": False}

    def items():
        mark.update(t0=time.perf_counter(), stats0=dict(ex._stats), calls0=len(calls))
        deadline = mark["t0"] + ctx.seconds
        for idx, n, off in stream:
            if time.perf_counter() >= deadline:
                mark.update(closed=True, t_end=time.perf_counter(), stats1=dict(ex._stats), calls1=len(calls))
                return
            lengths[idx], offsets[idx] = n, off
            yield idx, noise[off:off + n]

    got: Dict[int, np.ndarray] = {}
    late = 0
    for key, emb in ex.extract_iter(items()):
        if mark["closed"]:
            late += 1
        else:
            got[key] = emb
    window_s = mark["t_end"] - mark["t0"]
    s0, s1 = mark["stats0"], mark["stats1"]
    audio_s = sum(lengths[k] for k in got) / rate
    counters = {
        "window_s": window_s,
        "valid_samples": float(s1["frames"] - s0["frames"]),
        "sent_samples": float(sum(b * s for b, s in calls[mark["calls0"]:mark["calls1"]])),
        "extractor_span_s": s1["device_s"] - s0["device_s"],
    }

    summary = None
    if ctx.trace:
        def stretch(work):
            n0 = len(calls)
            part = itertools.islice(stream, mix["trace_items"])
            for _ in ex.extract_iter((idx, noise[off:off + n]) for idx, n, off in part):
                pass
            work.extend(calls[n0:])

        summary = tracing.profile(torch, stretch)
        per_utt = model_flops.per_utterance(cfg)
        k1_frame = kernels.k1_frame_flops(cfg["model"]["input_dim"])
        frames = [_frames(lengths[k]) for k in got]
        counters["window_flops"] = float(sum(per_utt(t) + k1_frame * t for t in frames))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    del model, ex, embed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference on a seeded sample of the window's answers
    by_bucket: Dict[int, List[int]] = {}
    for k in got:
        by_bucket.setdefault(traffic_gen.bucket_of(lengths[k], buckets), []).append(k)
    rng = np.random.default_rng(traffic_gen.derived_seed(ctx.seed, 3))
    keys = checks.sample_answers(by_bucket, max(got, key=lengths.get), mix["check_sample"], rng) if got else []
    p32 = {k: v.float() for k, v in w.items()}
    gaps, control_gaps = [], []
    for b in sorted(by_bucket):
        mine = [k for k in keys if traffic_gen.bucket_of(lengths[k], buckets) == b]
        for i in range(0, len(mine), mix["check_block"]):
            block = mine[i:i + mix["check_block"]]
            wave = torch.zeros((len(block), b), dtype=torch.float32)
            for r, k in enumerate(block):
                wave[r, :lengths[k]] = torch.from_numpy(noise[offsets[k]:offsets[k] + lengths[k]])
            wave = wave.to(dev)
            valid = torch.as_tensor([lengths[k] for k in block], device=dev)
            ref = reference.embed(fam, p32, wave, valid, cfg["model"]["input_dim"])
            served = torch.from_numpy(np.stack([got[k] for k in block])).to(dev)
            gaps.append(checks.embedding_gaps(served, ref))
            if ctx.control:
                low = reference.embed(fam, p32, wave, valid, cfg["model"]["input_dim"], q=fp8_round)
                control_gaps.append(checks.embedding_gaps(low, ref))
    compared = {"emb_gap": float(torch.cat(gaps).max()) if gaps else float("nan")}
    return Result(
        setup_s=mark["t0"] - ctx.t_start, window_s=window_s,
        end_to_end={"extract_audio_s_per_s": audio_s / window_s}, counters=counters, compared=compared,
        attempted=len(lengths), failed=len(lengths) - len(got) - late, memory_peak_bytes=int(peak),
        trace=summary,
        control={"emb_gap": float(torch.cat(control_gaps).max())} if control_gaps else None,
        notes=[f"set-up: to the model built {t_built - ctx.t_start:.3f} s, warm-up {t_warm - t_built:.3f} s, "
               f"to the window {mark['t0'] - t_warm:.3f} s",
               f"window: {audio_s:.1f} audio-s of {len(got)} utterances in {window_s:.3f} s, "
               f"{mark['calls1'] - mark['calls0']} batches, the Extractor's span {counters['extractor_span_s']:.3f} s"])


def _frames(samples: int) -> int:
    """Valid frames of an utterance of ``samples`` samples."""
    return max(reference.fbank.num_frames(samples), 1)
