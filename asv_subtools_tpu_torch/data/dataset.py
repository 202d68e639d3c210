"""Dataset assembly + distributed sharding + background prefetch (the
port's own numpy copy).

Counterpart: asv_subtools_tpu/data/dataset.py, behaviour unchanged
(parity: pytorch/libs/egs/egs_online.py: WavEgs pipeline assembly
:153-237, DistributedSampler rank/worker modulo split :67-117, set_epoch
reshuffle :125-128; and libs/support/prefetch_generator.py).

The pipeline runs on host threads or worker processes; a wave pipeline
imports no torch (only the host feature stage does, on the CPU). The
Prefetcher can hand batches over in pinned memory, so the train loop
copies them to the card without waiting.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .augment import SpeechAug
from . import processor as P


class DistributedShardList:
    """Deterministic per-host split of a source list with per-epoch
    reshuffle (egs_online.py:67-128)."""

    def __init__(
        self,
        items: Sequence,
        shuffle: bool = True,
        seed: int = 1024,
        rank: int = 0,
        world_size: int = 1,
    ):
        self.items = list(items)
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        idx = np.arange(len(self.items))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(idx)
        for i in idx[self.rank :: self.world_size]:
            item = self.items[int(i)]
            # pipeline stages mutate samples in place (parse_raw decodes
            # into s["wav"], speed_perturb_stage offsets s["label"], ...);
            # hand each epoch a fresh copy or the mutations accumulate
            # across iterations (a second pass re-offsets already-offset
            # labels beyond num_targets)
            yield dict(item) if isinstance(item, dict) else item


class WavEgs:
    """Training egs: wav source -> aug -> chunk -> batch pipeline.

    Assembly parity: WavEgs (egs_online.py:153-237). Returns batches
    {"x": [B, T] waveforms or [B, T, D] feats, "y", "mask"}.
    """

    def __init__(
        self,
        wav_scp: str,
        utt2spk: str,
        spk2int: Optional[Dict] = None,
        *,
        chunk_seconds: float = 2.015,
        batch_size: int = 64,
        speed_perturb: bool = False,
        num_spks: int = 0,
        aug: Optional[SpeechAug] = None,
        compute_feat: bool = False,
        feat_opts=None,
        feat_type: str = "fbank",
        feat_backend: str = "numpy",
        spec_aug: bool = False,
        shuffle_buffer: int = 1000,
        seed: int = 1024,
        aug_seed: Optional[int] = None,
        rank: int = 0,
        world_size: int = 1,
        drop_last: bool = True,
        workers: int = 1,
    ):
        entries = list(P.wav_scp_source(wav_scp, utt2spk, spk2int))
        self.workers = int(workers)
        # the SHARD permutation must use the common base seed in every
        # worker (so idx[rank::world_size] partitions the dataset), but the
        # stochastic stages (speed-perturb draw, chunk offset, speech aug,
        # shuffle buffer) take a per-worker aug_seed — the reference seeds
        # DataLoader workers base_seed + worker_id the same way
        # (egs_online.py worker_init_fn semantics)
        self.shards = DistributedShardList(
            entries, seed=seed, rank=rank, world_size=world_size
        )
        sseed = seed if aug_seed is None else int(aug_seed)
        self.epoch_state = P.EpochState()
        ep = self.epoch_state
        stages: List[Callable] = [P.parse_raw, P.resample()]
        if speed_perturb:
            stages.append(
                P.speed_perturb_stage(
                    expand_labels=True, num_spks=num_spks, seed=sseed, epoch=ep
                )
            )
        stages.append(P.random_chunk(chunk_seconds, seed=sseed, epoch=ep))
        if aug is not None:
            stages.append(P.speech_aug_stage(aug, seed=sseed, epoch=ep))
        key = "wav"
        if compute_feat:
            # feat_type: fbank | mfcc | fbank_pitch | mfcc_pitch
            # (makeFeatures.sh family selection)
            stages.append(P.compute_feats(feat_opts, feat_type=feat_type,
                                          backend=feat_backend))
            key = "feat"
            if spec_aug:
                stages.append(P.spec_aug_stage(seed=sseed, epoch=ep))
        # per-sample stages (decode/aug/feats — numpy/scipy, GIL-releasing)
        # can fan out over a thread pool; batching stays serial
        self.sample_stages = stages
        self.batch_stages = [
            P.shuffle(shuffle_buffer, seed=sseed, epoch=ep),
            P.static_batch(batch_size, drop_last=drop_last),
            P.pad_batch(key=key),
        ]
        self.stages = stages + self.batch_stages

    def set_epoch(self, epoch: int) -> None:
        self.shards.set_epoch(epoch)
        self.epoch_state.epoch = epoch

    def _process_one(self, entry):
        # a stage may emit 0 (skip) or >1 samples; return the list
        return list(P.Pipeline([entry], self.sample_stages)) or None

    def __iter__(self):
        if self.workers > 1:
            # map each entry through the per-sample chain in parallel
            # (ordered, so epoch determinism is preserved), then batch
            mapped = ParallelMapper(
                self._process_one, self.shards, workers=self.workers
            )
            it = (s for group in mapped for s in group)
            for stage in self.batch_stages:
                it = stage(it)
            return it
        return iter(P.Pipeline(self.shards, self.stages))


class WavEgsXvector:
    """Extraction egs: per-utterance whole features, no chunking/aug
    (egs_online.py:239-260). With workers>1 the decode+feature work runs
    in an ordered thread pool (ParallelMapper) so the host keeps the card
    fed during batched extraction."""

    def __init__(
        self,
        wav_scp: str,
        *,
        de_silence: bool = False,
        feat_opts=None,
        feat_type: str = "fbank",
        feat_backend: str = "numpy",
        workers: int = 1,
    ):
        self.entries = list(P.wav_scp_source(wav_scp))
        self.workers = workers
        stages: List[Callable] = [P.parse_raw, P.resample()]
        if de_silence:
            stages.append(P.de_sil())
        stages.append(P.compute_feats(feat_opts, feat_type=feat_type,
                                      backend=feat_backend))
        self.stages = stages

    def _process_one(self, entry):
        out = list(P.Pipeline([entry], self.stages))
        if not out:
            return None
        s = out[0]
        return s["key"], s["feat"]

    def __iter__(self):
        if self.workers > 1:
            yield from ParallelMapper(
                self._process_one, self.entries, workers=self.workers
            )
            return
        for s in P.Pipeline(self.entries, self.stages):
            yield s["key"], s["feat"]


class ParallelMapper:
    """Ordered parallel map over an iterable using a thread pool.

    For the host-side hot stages (wav decode, resample, feature compute —
    numpy/scipy, which release the GIL): this keeps utterance order while
    keeping `workers` items in flight.
    """

    def __init__(self, fn: Callable, iterable: Iterable, workers: int = 8,
                 prefetch: int = 32):
        self.fn = fn
        self.iterable = iterable
        self.workers = workers
        self.prefetch = prefetch

    def __iter__(self):
        import concurrent.futures as cf
        from collections import deque

        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending: deque = deque()
            it = iter(self.iterable)
            try:
                for _ in range(self.prefetch):
                    pending.append(pool.submit(self.fn, next(it)))
            except StopIteration:
                pass
            while pending:
                result = pending.popleft().result()
                try:
                    pending.append(pool.submit(self.fn, next(it)))
                except StopIteration:
                    pass
                if result is not None:
                    yield result


def _build_train_egs(cfg: Dict, worker_id: int = 0, num_workers: int = 1,
                     probe: bool = False):
    """Module-level WavEgs factory (picklable for spawn workers).

    cfg holds primitives only; the SpeechAug chain is built INSIDE the
    worker from its config dict (augment.speech_aug_from_config), so
    nothing heavier than numpy crosses the process boundary. Composes the
    (worker, pool-size) split into WavEgs's (rank, world_size) exactly
    like the reference's DistributedSampler modulo split
    (egs_online.py:101-117)."""
    from .augment import speech_aug_from_config

    return WavEgs(
        cfg["train_scp"],
        cfg["train_u2s"],
        cfg["spk2int"],
        chunk_seconds=cfg["chunk_seconds"],
        batch_size=cfg["batch_size"],
        speed_perturb=cfg.get("speed_perturb", False),
        num_spks=len(cfg["spk2int"]),
        aug=speech_aug_from_config(cfg.get("speech_aug")),
        compute_feat=cfg.get("compute_feat", True),
        feat_opts=cfg.get("feat_opts"),
        feat_type=cfg.get("feat_type", "fbank"),
        feat_backend=cfg.get("feat_backend", "numpy"),
        spec_aug=cfg.get("spec_aug", False),
        shuffle_buffer=1 if probe else cfg["shuffle_buffer"],
        seed=cfg.get("seed", 1024),
        # decorrelate aug/shuffle RNG streams across pool workers (the
        # reference seeds workers base_seed + worker_id); the shard split
        # itself stays on the common base seed
        aug_seed=cfg.get("seed", 1024) + worker_id,
        rank=worker_id,
        world_size=num_workers,
        workers=1 if probe else (
            cfg.get("workers", 1) if num_workers == 1 else 1
        ),
    )


def _mp_worker_loop(make_egs, num_workers, worker_id, task_q, data_q):
    """MultiprocessLoader worker entry. Module-level so it pickles under
    the spawn start method. Builds the pipeline once (persistent worker),
    then serves one epoch per task-queue message. Every item shipped back
    carries the dispatch's generation id so the parent can discard batches
    from an abandoned iteration (see MultiprocessLoader.__iter__). Each
    epoch's end carries the worker's report (_worker_report).

    The card is hidden from the worker before anything is built: CUDA
    reads CUDA_VISIBLE_DEVICES when it is first initialised, which a spawn
    child does lazily, so a worker that reaches CUDA raises instead of
    claiming the card."""
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    egs = None
    while True:
        task = task_q.get()
        if task is None:
            break
        epoch, gen = task
        try:
            if egs is None:
                egs = make_egs(worker_id=worker_id, num_workers=num_workers)
            if hasattr(egs, "set_epoch"):
                egs.set_epoch(epoch)
            for batch in egs:
                data_q.put((MultiprocessLoader._BATCH, gen, batch))
        except BaseException as e:  # surface in the parent
            import traceback

            # uniform wire format (tag, gen, payload): the parent can then
            # tell an error in the CURRENT dispatch from one surfacing out
            # of an abandoned one (either way the pool is a worker short —
            # the loop below exits — so both are fatal, but the message
            # should say which epoch actually failed)
            data_q.put((MultiprocessLoader._ERR, gen,
                        f"worker {worker_id}: {e!r}\n"
                        f"{traceback.format_exc()}"))
            break
        # wire format (tag, gen, payload) — gen ALWAYS at index 1 so the
        # parent's staleness check reads one slot for every tag
        data_q.put((MultiprocessLoader._END, gen, (worker_id, _worker_report())))


def _worker_report() -> Dict:
    """What a worker process saw: its pid, its CUDA_VISIBLE_DEVICES,
    whether torch was imported and, where it was, whether CUDA was
    initialised."""
    import os
    import sys

    torch = sys.modules.get("torch")
    return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "torch_imported": torch is not None,
            "cuda_initialized": bool(torch is not None and torch.cuda.is_initialized())}


class MultiprocessLoader:
    """Process-parallel egs loading (parity: the reference feeds DDP with
    DataLoader(num_workers=...) worker PROCESSES, egs_online.py:300-346 +
    the rank/worker modulo split :101-117).

    Threads cannot scale the per-sample chain (python dispatch + partially
    GIL-holding scipy stages — measured flat in tools/egs_bench.py), so
    this starts a PERSISTENT pool of `num_workers` processes (torch
    persistent_workers=True semantics); worker w builds the pipeline once
    via `make_egs(worker_id=w, num_workers=K)` — the factory composes
    (host_rank, w) into DistributedShardList's (rank, world_size) exactly
    like the reference's sampler — then per epoch iterates its shard and
    ships finished batches through a bounded queue. Batch arrival order
    interleaves across workers (same as the reference's multi-worker
    loader under shuffle). Call close() (or let GC) to stop the pool.

    Start method: "spawn" by default — the parent is a torch process with
    CUDA and BLAS threads, and forking a threaded process (or one that
    holds a CUDA context) is unsafe. Spawn requires `make_egs` to be
    picklable: a module-level function or functools.partial over one (the
    Launcher builds partial(_build_train_egs, cfg)). context="fork"
    remains available for numpy-only parents (cheaper startup, closures
    allowed).

    Workers never touch the card: each sets CUDA_VISIBLE_DEVICES="" in its
    own environment before it builds its pipeline, so a worker that reaches
    CUDA by mistake raises instead of claiming the card. A wave pipeline
    imports no torch at all; the host feature stage
    (processor.compute_feats) uses torch on the CPU. ``worker_reports``
    gathers each worker's report (_worker_report) at the end of each epoch
    it served.
    """

    def __init__(self, make_egs: Callable, num_workers: int = 4,
                 prefetch: int = 8, context: str = "spawn"):
        self.make_egs = make_egs
        self.num_workers = int(num_workers)
        self.prefetch = int(prefetch)
        self.context = context
        self.epoch = 0
        self._gen = 0  # dispatch generation; stale items are discarded
        self._procs = None
        self._task_qs = None
        self._data_q = None
        self.worker_reports: List[Dict] = []

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    _BATCH = "__batch__"
    _END = "__epoch_end__"
    _ERR = "__worker_error__"

    def example_batch(self):
        """One batch for model init / shape probing, WITHOUT dispatching an
        epoch to the worker pool. `next(iter(loader))` on a pool loader
        abandons a dispatch mid-flight (every later epoch then consumes the
        stale stream — off-by-one shuffles, double/missing samples); this
        builds a throwaway single-worker pipeline in-process instead."""
        try:
            # factories that understand probe=True build a cheap pipeline
            # (shuffle buffer 1, no thread fan-out) — without it the probe
            # prefills the full shuffle buffer on one core before the
            # first batch appears
            egs = self.make_egs(worker_id=0, num_workers=1, probe=True)
        except TypeError:
            egs = self.make_egs(worker_id=0, num_workers=1)
        if hasattr(egs, "set_epoch"):
            egs.set_epoch(self.epoch)
        return next(iter(egs))

    def _ensure_pool(self):
        if self._procs is not None:
            return
        import multiprocessing as mp

        ctx = mp.get_context(self.context)
        self._task_qs = [ctx.Queue() for _ in range(self.num_workers)]
        self._data_q = ctx.Queue(maxsize=self.prefetch)
        self._procs = [
            ctx.Process(
                target=_mp_worker_loop,
                args=(self.make_egs, self.num_workers, w,
                      self._task_qs[w], self._data_q),
                daemon=True,
            )
            for w in range(self.num_workers)
        ]
        for p in self._procs:
            p.start()

    @property
    def worker_pids(self) -> List[int]:
        """The pids of the running pool (empty before the first epoch and after close)."""
        return [p.pid for p in self._procs] if self._procs is not None else []

    def close(self) -> None:
        """Stop the persistent worker pool. Drains the data queue while
        joining so workers blocked on a full queue can observe the stop
        sentinel instead of hitting the join timeout."""
        if self._procs is None:
            return
        for q in self._task_qs:
            try:
                q.put(None)
            except Exception:
                pass
        import time

        deadline = time.monotonic() + 10.0
        while any(p.is_alive() for p in self._procs) and \
                time.monotonic() < deadline:
            try:
                while True:  # unblock producers
                    self._data_q.get_nowait()
            except Exception:
                pass
            time.sleep(0.05)
        for p in self._procs:
            p.join(timeout=1)
            if p.is_alive():
                p.terminate()
        self._procs = None

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        if self.num_workers <= 1:
            egs = self.make_egs(worker_id=0, num_workers=1)
            if hasattr(egs, "set_epoch"):
                egs.set_epoch(self.epoch)
            yield from egs
            return

        self._ensure_pool()
        self._gen += 1
        gen = self._gen
        for q in self._task_qs:
            q.put((self.epoch, gen))
        ends = 0
        while ends < self.num_workers:
            item = self._data_q.get()
            tag = item[0]
            if tag == self._ERR:
                # fatal either way: the failed worker exited its loop, so
                # the pool can never complete another epoch
                stale = " (from an abandoned dispatch)" if item[1] != gen \
                    else ""
                self.close()
                raise RuntimeError(f"egs worker failed{stale}:\n{item[2]}")
            if item[1] != gen:
                # leftover from an abandoned dispatch — drain and discard
                # (the workers' stale epoch finishes flushing through here)
                continue
            if tag == self._END:
                ends += 1
                self.worker_reports.append(item[2][1])
            else:
                yield item[2]


class Prefetcher:
    """Background-thread prefetch (parity: prefetch_generator.py:42,
    DataLoaderFast egs.py:218-227): overlaps host pipeline work with
    device compute.

    pin_memory=True turns each batch's numpy arrays into torch tensors in
    page-locked memory, in the thread: a copy to the card from there with
    ``non_blocking=True`` does not wait (one from pageable memory would).
    Pinning needs CUDA; torch is imported only then."""

    def __init__(self, iterable: Iterable, max_prefetch: int = 4, pin_memory: bool = False):
        self.iterable = iterable
        self.max_prefetch = max_prefetch
        self.pin_memory = pin_memory

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.max_prefetch)
        sentinel = object()
        error: List[BaseException] = []
        pin = _pin_batch if self.pin_memory else (lambda b: b)

        def worker():
            try:
                for item in self.iterable:
                    q.put(pin(item))
            except BaseException as e:  # propagate into the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if error:
            raise error[0]


def _pin_batch(batch: Dict) -> Dict:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def build_spk2int(utt2spk_path: str) -> Dict[str, int]:
    """Speaker -> class-id map, sorted for determinism."""
    spks = set()
    with open(utt2spk_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                spks.add(parts[1])
    return {s: i for i, s in enumerate(sorted(spks))}
