"""Embedding-extraction service: batched whole-utterance x-vectors.

Counterpart: asv_subtools_tpu/extract.py:34-203. Utterances are
length-bucketed and zero-padded to a few static shapes, so the card sees
large masked batches. Utterances longer than ``max_chunk`` (frames, or
samples in waveform mode) are split into equal chunks whose embeddings are
averaged with frame weights. Batches run eagerly under
``torch.inference_mode()`` on the extractor's device, one batch in flight:
the host pads the next batch while the card runs the last.

Output: an in-memory dict and/or a Kaldi vector ark/scp.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .features.config import FbankOptions
from .features.fused_fbank import wave_features
from .io.kaldi import ArkScpWriter
from .utils.profiling import add, span


@dataclasses.dataclass
class ExtractConfig:
    buckets: Sequence[int] = (200, 400, 800, 1600, 3200, 6400, 10000)
    batch_sizes: Optional[Dict[int, int]] = None  # a bucket's batch size; default_batch elsewhere
    max_chunk: int = 10000
    default_batch: int = 32


# waveform-mode buckets (samples @16 kHz): 2 s .. 100 s
WAVE_BUCKETS = (32000, 64000, 128000, 256000, 512000, 1024000, 1600000)


def make_wave_embed_fn(model_apply: Callable, fbank_opts: Optional[FbankOptions] = None,
                       dtype: Optional[torch.dtype] = None) -> Callable:
    """Build embed_fn(wave [B, S], mask [B, S]) -> [B, E]: fused fbank
    kernel (bf16 DFT, no energy) + masked CMVN + model, on the tensors'
    device. Padded frames are zeroed after CMVN, as in feature mode."""
    opts = fbank_opts or FbankOptions()

    def embed(wave: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        feats, fmask = wave_features(wave, mask, opts, torch.bfloat16)
        if dtype is not None:
            feats = feats.to(dtype)
        return model_apply(feats, fmask)

    return embed


def _bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def _chunk(feats: np.ndarray, max_chunk: int) -> Tuple[List[np.ndarray], List[float]]:
    """Equal-chunk split + frame weights (reference framework.py:27-52)."""
    t = feats.shape[0]
    if t <= max_chunk:
        return [feats], [1.0]
    num_split = -(-t // max_chunk)
    length = t // num_split
    chunks = [feats[i * length : (i + 1) * length] for i in range(num_split)]
    weights = [float(length)] * num_split
    remainder = t - num_split * length
    if remainder > 0:
        chunks.append(feats[t - length :])
        weights.append(float(remainder))
    s = sum(weights)
    return chunks, [w / s for w in weights]


_END = object()


class _Staging:
    """Two host slabs that batches are written into in turn, page-locked
    where a card reads them, grown together to the largest batch seen."""

    def __init__(self, pin: bool):
        self.pin, self.slabs, self.turn = pin, [], 0

    def take(self, nbytes: int) -> torch.Tensor:
        grow = not self.slabs or self.slabs[0].numel() < nbytes
        if grow:
            self.slabs = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin) for _ in range(2)]
        add("extract.staging_allocs", int(grow))
        self.turn ^= 1
        return self.slabs[self.turn]


class Extractor:
    """Batched bucketed embedding extractor.

    embed_fn(x [B, T, D] or wave [B, S], mask) -> [B, embd], e.g.
    ``make_wave_embed_fn(lambda x, m: model(x, m))``. Runs on ``device``:
    the CUDA card unless ``device="cpu"``; raises without a card.

    One batch is in flight. A batch is padded into the next of two reused
    host slabs (page-locked on a card), its lengths behind it; the slab is
    copied in asynchronously, the mask is built on the device from the
    lengths, and the answers are copied into pinned memory behind a CUDA
    event. Only then is the batch before it waited for and its keys
    yielded, so the host pads batch n+1 while the card runs batch n. On
    the CPU the same order runs synchronously.

    ``_stats`` counts, over the extractor's life: ``utts`` (embeddings
    yielded), ``frames`` (valid frames sent, samples in wave mode),
    ``batches`` (embed calls) and ``device_s`` (host seconds of each
    batch's copy-in, embed call and wait for its answers). The host path's
    stretches are spans (utils/profiling.py), which record only while
    profiled.
    """

    def __init__(self, embed_fn: Callable, config: ExtractConfig = ExtractConfig(),
                 device: Any = None):
        self.config = config
        self.device = resolve_device(device)
        self._embed = embed_fn
        self._stats = {"utts": 0, "frames": 0, "batches": 0, "device_s": 0.0}
        self._staging: List[_Staging] = []  # free slab pairs; each running extract_iter holds one

    def extract_iter(self, items: Iterable[Tuple[str, np.ndarray]]) -> Iterator[Tuple[str, np.ndarray]]:
        """items: (key, feats [T, D] or wave [S]). Yields (key, embedding)
        in completion order (bucketed batches flush when full; the tail
        flushes at the end), a batch's keys once the next batch is
        launched."""
        cfg = self.config
        pending: Dict[int, List] = {b: [] for b in cfg.buckets}
        acc: Dict[str, List] = {}
        expected: Dict[str, int] = {}
        cuda = self.device.type == "cuda"
        staging = self._staging.pop() if self._staging else _Staging(pin=cuda)
        inflight = None  # (batch, answers, event) of the launched batch not yet finished

        def launch(bucket: int, batch: List) -> tuple:
            """Pad the batch into a slab; enqueue its copy-in, the embed call
            and the copy of its answers."""
            with span("extract.assemble"):
                add("extract.overlap_batches", int(cuda and inflight is not None and not inflight[2].query()))
                n, tail = len(batch), batch[0][1].shape[1:]
                xbytes = n * bucket * int(np.prod(tail)) * 4
                at = -(-xbytes // 8) * 8  # the lengths, int64, behind the padded batch
                slab = staging.take(at + 8 * n)
                host = slab.numpy()
                x = host[:xbytes].view(np.float32).reshape((n, bucket) + tail)
                lens = host[at:at + 8 * n].view(np.int64)
                for i, (_, f, _) in enumerate(batch):
                    x[i, : f.shape[0]] = f
                    x[i, f.shape[0]:] = 0
                    lens[i] = f.shape[0]
            with torch.inference_mode():
                t0 = time.perf_counter()
                with span("extract.copy_in"):
                    sent = slab[:at + 8 * n].to(self.device, non_blocking=True)  # on the CPU the slab itself
                    wave = sent[:xbytes].view(torch.float32).view(x.shape)
                    valid = torch.arange(bucket, device=self.device) < sent[at:].view(torch.int64)[:, None]
                with span("extract.launch"):
                    embs = self._embed(wave, valid).float()
                    # copied on the CPU too, where the answers may be a view of the slab
                    out = torch.empty(embs.shape, dtype=torch.float32, pin_memory=cuda)
                    out.copy_(embs, non_blocking=True)
                    done = None
                    if cuda:
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(self.device))
                # host seconds of copy-in, embed and the wait for the answers, spans on or off: the
                # benchmark's untraced window reads it
                self._stats["device_s"] += time.perf_counter() - t0
            add("extract.copy_in_bytes", x.nbytes + lens.nbytes)
            self._stats["batches"] += 1
            self._stats["frames"] += int(lens.sum())
            return batch, out, done

        def finish(flight: tuple) -> List[Tuple[str, np.ndarray]]:
            """Wait for a launched batch's answers; the keys it completes."""
            batch, out, done = flight
            t0 = time.perf_counter()
            with span("extract.copy_out"):
                if done is not None:
                    done.synchronize()
                embs = out.numpy()
            self._stats["device_s"] += time.perf_counter() - t0
            res = []
            with span("extract.assemble"):
                for (key, _, w), e in zip(batch, embs):
                    acc.setdefault(key, []).append(w * e)
                    if len(acc[key]) == expected[key]:
                        res.append((key, np.sum(acc.pop(key), axis=0)))
                        expected.pop(key)
                        self._stats["utts"] += 1
            return res

        def flush(bucket: int, batch: List) -> List[Tuple[str, np.ndarray]]:
            """Launch a batch, then finish the one before it."""
            nonlocal inflight
            prev, inflight = inflight, launch(bucket, batch)
            return finish(prev) if prev is not None else []

        batch_sizes = cfg.batch_sizes or {}
        items = iter(items)
        try:
            while True:
                with span("extract.input"):
                    item = next(items, _END)
                if item is _END:
                    break
                key, feats = item
                full = []
                with span("extract.assemble"):
                    chunks, weights = _chunk(np.asarray(feats, np.float32), cfg.max_chunk)
                    expected[key] = len(chunks)
                    for c, w in zip(chunks, weights):
                        b = _bucket_for(c.shape[0], cfg.buckets)
                        pending[b].append((key, c, w))
                        if len(pending[b]) >= batch_sizes.get(b, cfg.default_batch):
                            full.append((b, pending[b]))
                            pending[b] = []
                for b, batch in full:
                    yield from flush(b, batch)
            for b in cfg.buckets:
                if pending[b]:
                    yield from flush(b, pending[b])
            if inflight is not None:
                last, inflight = inflight, None
                yield from finish(last)
        finally:
            if cuda and inflight is not None:
                inflight[2].synchronize()  # left early: its slab is free once the card has read it
            self._staging.append(staging)

    def extract_to_ark(self, items: Iterable[Tuple[str, np.ndarray]], ark_path: str,
                       scp_path: Optional[str] = None) -> Dict:
        """Extract all and write a Kaldi vector ark/scp; returns stats."""
        t0 = time.perf_counter()
        with ArkScpWriter(ark_path, scp_path) as w:
            for key, emb in self.extract_iter(items):
                w.write(key, emb)
        s = dict(self._stats)
        s["wall_s"] = time.perf_counter() - t0
        return s

    def extract_all(self, items) -> Dict[str, np.ndarray]:
        return dict(self.extract_iter(items))
