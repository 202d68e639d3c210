"""The loop the ECAPA gates and the synthetic demo share (counterpart: the
loop that recipes/quality_gate.py:118-205, roadmap_gate.py:37-146,
antispoof_gate.py:67-185, adaptation_gate.py:60-157 and
demo_synthetic.py:43-125 each write out).

Three parts, so that each can be driven alone:

* corpus: ``speaker_batches`` draws each step's labels and then its waves
  from one numpy generator, as the JAX loops do; ``eval_items`` draws an
  evaluation set (a duration in [2.5, 4.0) s, then the wave, per
  utterance). Waves render through a :class:`~.gate_corpus.Renderer`, so
  the next batch renders while the card runs the step;
* training: ``gate_net`` (SpeakerNet(EcapaTdnn(channels, embd_dim=64,
  mfa_conv=1.5 channels), head), weights drawn from seed 0 as JAX draws
  them from PRNGKey(0)), ``make_step`` (adamW wd 1e-4 on warmR, the
  wave-input step with 40 bins, bf16 compute) and ``train_loop`` (the
  step's randomness from an explicit ``torch.Generator``; a progress line
  every ``report_every`` steps);
* evaluation: ``extract`` (``make_wave_embed_fn`` and ``Extractor`` with
  one 64,000-sample bucket of 64) and ``cosine_eer`` (submean cosine EER).
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import compute_eer, cosine_score_matrix
from ..device import resolve_device
from ..extract import ExtractConfig, Extractor, make_wave_embed_fn
from ..features import FbankOptions, MelOptions
from ..models import EcapaTdnn, SpeakerNet
from ..train import TrainState, TrainStepConfig, get_lr_schedule, get_optimizer, make_train_step
from ..weights import init_weights_
from .gate_corpus import Renderer

NUM_BINS = 40
CHUNK_S = 2.0
BATCH = 64
AAM = {"method": "aam", "m": 0.2, "s": 30.0}


def device_label(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def fbank_opts() -> FbankOptions:
    return FbankOptions(mel_opts=MelOptions(num_bins=NUM_BINS))


# -- corpus -------------------------------------------------------------------

def speaker_batches(rng, speakers: Sequence, steps: int, render: Renderer, batch_size: int = BATCH,
                    chunk_s: float = CHUNK_S, kind: str = "synth") -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``steps`` batches (waves [B, S] f32, labels [B] int64): per step the
    labels ``rng.integers(0, len(speakers), B)``, then one wave per label.
    Batch i + 1 is drawn and handed to the renderer before batch i is
    returned, so it renders while the caller runs its step."""

    def submit():
        ys = rng.integers(0, len(speakers), batch_size)
        return ys, [render.submit(rng, kind, speakers[y], chunk_s) for y in ys]

    pending = submit() if steps > 0 else None
    for i in range(steps):
        ys, waits = pending
        pending = submit() if i + 1 < steps else None
        yield np.stack([w() for w in waits]), ys


def eval_items(rng, speakers: Sequence, utts_per_spk: int, render: Renderer, tag: str = "s",
               kind: str = "synth") -> Tuple[List[Tuple[str, Callable]], np.ndarray]:
    """The evaluation set: for each speaker s and utterance u, key
    f"{tag}{s}u{u}", a duration ``rng.uniform(2.5, 4.0)``, then the wave.
    -> ([(key, wait for the wave)], labels)."""
    items, labels = [], []
    for s, spk in enumerate(speakers):
        for u in range(utts_per_spk):
            items.append((f"{tag}{s}u{u}", render.submit(rng, kind, spk, rng.uniform(2.5, 4.0))))
            labels.append(s)
    return items, np.asarray(labels)


# -- training -----------------------------------------------------------------

def gate_net(num_targets: int, channels: int = 128, loss_name: str = "margin_softmax",
             loss_params: Optional[dict] = None, pooling: Optional[str] = None,
             pooling_params: Optional[dict] = None, device: Any = None) -> SpeakerNet:
    """The gates' SpeakerNet on ``device``, its weights drawn from seed 0
    (the JAX gates draw theirs from PRNGKey(0))."""
    kw = dict(input_dim=NUM_BINS, channels=channels, embd_dim=64, mfa_conv=int(channels * 1.5))
    if pooling:
        kw.update(pooling=pooling, pooling_params=pooling_params or {})
    net = SpeakerNet(EcapaTdnn(**kw, device=resolve_device(device)), loss_name,
                     AAM if loss_params is None else loss_params, num_targets=num_targets)
    return init_weights_(net, 0)


def make_step(net: SpeakerNet, steps: int, lr: float = 2e-3, warmup_steps: int = 20,
              compute_dtype: torch.dtype = torch.bfloat16) -> Tuple[Any, Callable]:
    """(tx, step): adamW (wd 1e-4) on warmR (t_0 = steps) and the wave-input
    step with the gates' 40-bin fbank."""
    schedule = get_lr_schedule("warmR", base_lr=lr, t_0=steps, warmup_steps=warmup_steps)
    tx = get_optimizer("adamW", learning_rate=schedule, weight_decay=1e-4)
    cfg = TrainStepConfig(wave_input=True, fbank_opts=fbank_opts(), compute_dtype=compute_dtype)
    return tx, make_train_step(net, tx, config=cfg)


def progress_line(fmt: str, stream=None) -> Callable[[int, Dict[str, float]], None]:
    """A progress printer: ``fmt`` formatted with step=, loss=, accuracy=."""

    def show(step: int, m: Dict[str, float]) -> None:
        print(fmt.format(step=step, **m), file=stream if stream is not None else sys.stderr, flush=True)

    return show


def train_loop(step: Callable, state: TrainState, batches: Iterable[Tuple[np.ndarray, np.ndarray]],
               generator: torch.Generator, margin_warm=None, report_every: int = 100,
               progress: Optional[Callable[[int, Dict[str, float]], None]] = None
               ) -> Tuple[TrainState, Dict[str, Any]]:
    """Run one step per batch on the state's device. ``margin_warm`` (a
    ``MarginWarm``) gives each step (margin_offset, lambda_m), lambda floored
    at 1e-3 (roadmap_gate.py:102-103); without it (0.0, 1.0). Every
    ``report_every`` steps the metrics are fetched and shown.

    -> (state, {"last": the metrics of the last report point (empty if
    none), "loss", "accuracy", "grad_norm": one value a step (fetched once,
    at the end), "seconds": the loop's wall time})."""
    dev = state.step.device
    t0 = time.time()
    last: Dict[str, float] = {}
    history: List[torch.Tensor] = []
    for i, (xs, ys) in enumerate(batches):
        moff, lam = margin_warm.step(i) if margin_warm is not None else (0.0, 1.0)
        if margin_warm is not None:
            lam = max(1e-3, lam)
        batch = {"x": torch.from_numpy(np.ascontiguousarray(xs, np.float32)).to(dev, non_blocking=True),
                 "y": torch.from_numpy(np.asarray(ys, np.int64)).to(dev, non_blocking=True)}
        state, m = step(state, batch, generator, float(lam), float(moff))
        history.append(torch.stack([m["loss"], m["accuracy"], m["grad_norm"]]))
        if (i + 1) % report_every == 0:
            last = dict(zip(("loss", "accuracy"), history[-1][:2].tolist()))
            if progress is not None:
                progress(i + 1, last)
    seconds = time.time() - t0
    values = torch.stack(history).double().cpu().numpy() if history else np.zeros((0, 3))
    return state, {"last": last, "loss": values[:, 0].tolist(), "accuracy": values[:, 1].tolist(),
                   "grad_norm": values[:, 2].tolist(), "seconds": seconds}


# -- evaluation ---------------------------------------------------------------

def backbone_apply(net: SpeakerNet, state: TrainState) -> Callable:
    """model_apply(x, mask) of the state's backbone weights and running
    statistics, in eval mode."""
    backbone = net.backbone
    tensors = {k[len("backbone."):]: v for k, v in {**state.params, **state.batch_stats}.items()
               if k.startswith("backbone.")}

    def model_apply(x, mask):
        backbone.eval()
        return torch.func.functional_call(backbone, tensors, (x, mask))

    return model_apply


def extract(net: SpeakerNet, state: TrainState, items: Sequence[Tuple[str, Callable]]) -> np.ndarray:
    """Embeddings [N, E] of ``items`` (key, wait for the wave), in order,
    through the wave front end and one 64,000-sample bucket of 64."""
    embed = make_wave_embed_fn(backbone_apply(net, state), fbank_opts())
    ex = Extractor(embed, ExtractConfig(buckets=(64000,), default_batch=64, max_chunk=10**9),
                   device=state.step.device)
    embs = ex.extract_all((k, wait()) for k, wait in items)
    return np.stack([embs[k] for k, _ in items])


def trial_pairs(labels: np.ndarray) -> Tuple[Tuple[np.ndarray, np.ndarray], np.ndarray]:
    """Every pair i < j and whether it is a target pair."""
    iu = np.triu_indices(len(labels), 1)
    return iu, (labels[:, None] == labels[None, :])[iu].astype(int)


def cosine_eer(mat: np.ndarray, labels: np.ndarray) -> float:
    """The submean cosine EER in percent over every pair of ``mat``'s rows."""
    mat = mat - mat.mean(axis=0)
    scores = cosine_score_matrix(torch.from_numpy(mat), torch.from_numpy(mat)).numpy()
    iu, same = trial_pairs(labels)
    eer, _ = compute_eer(scores[iu], same)
    return 100.0 * eer
