"""The train step and the epoch loop (counterpart:
asv_subtools_tpu/train/trainer.py:56-376 and :379-678).

One call of the step runs the whole optimisation step on the state's
device: (in wave mode) the fused fbank kernel and utterance CMVN, the
forward in the compute type, the loss, the backward, the global-norm clip
(``max_change``), the optimizer and the BatchNorm running statistics.

* The state is functional. ``TrainState`` holds the f32 master weights
  and the BN buffers as dicts keyed by the net's state_dict names; the
  step runs the net through ``torch.func.functional_call`` on weights cast
  to the compute type (so their gradients land on the f32 masters), hands
  in a copy of the BN buffers and takes the buffers the net assigned back
  out. The net's own parameters are never read or written.
* ``accum_grad`` microbatches run one after another; the BN running
  statistics chain from one to the next, gradients, loss and accuracy
  are averaged.
* ``use_semi_orth`` keeps the F-TDNN's ``factor1`` weights
  semi-orthogonal: the update of nn/tdnn.py on every fourth step (the
  step counter on the device picks it).
* A non-finite loss or gradient norm keeps the old weights, optimizer
  state and BN statistics through ``torch.where`` on the device; the step
  counter advances all the same. No metric leaves the device: the step
  never syncs with the host.
* ``Trainer`` runs epochs of steps. The host waits on the card only
  where the JAX Trainer fetches: the step counter once an epoch, the
  metrics at each report point, the validation's sums, and the epoch
  means at its end.
* With a mesh (parallel/mesh.py; one process a device) the step runs on
  this rank's rows of the global batch and carries its collectives
  itself, since the functional step never reads the module's parameters
  (so DDP's and FSDP's hooks have nothing to act on): the gradients'
  mean over ``"data"`` in one flat bucket, global BatchNorm statistics
  and a row-sharded margin head inside the forward (parallel/comm.py),
  and loss, accuracy and the squared gradient norm in one all-reduce, so
  the clip and the non-finite choice see global values and every rank
  takes the same branch. Under ZeRO-3 partition rules the masters and
  their moments are sharded at rest, gathered whole in the compute type
  once a step (JAX's ``param_gather_fn``), and the gradients are
  reduce-scattered back to the shards. Per-row random draws are made at
  the global batch's shape and cut to the rank's rows, so the step's
  value does not depend on the placement; ``accum_grad`` splits each
  rank's rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..features.config import FbankOptions
from ..features.fused_fbank import wave_features
from ..nn.loss import MarginWarm, cross_entropy
from ..nn.loss import accuracy as compute_accuracy
from ..nn import tdnn
from ..nn.tdnn import is_semi_orth_weight, semi_orth_update
from ..parallel import comm
from ..utils.profiling import span
from .optim import GradientTransformation

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # int32, 0-dim
    params: Tensors  # master weights, f32 (f64 in float64 runs)
    batch_stats: Tensors  # BatchNorm running statistics
    opt_state: dict


@dataclasses.dataclass
class TrainStepConfig:
    max_change: float = 10.0  # clip by global norm
    accum_grad: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    skip_nonfinite: bool = True
    # wave mode: batch["x"] is raw audio [B, S] (and "mask" a sample mask);
    # the fused fbank and CMVN run in the step, the DFT in the compute type
    # (float32 or bfloat16: the fbank has no float64 mode)
    wave_input: bool = False
    fbank_opts: Optional[FbankOptions] = None
    # SpecAugment on the CMVN'd features ({"num_t_mask", "num_f_mask",
    # "max_t", "max_f"}), drawn from the step's generator
    spec_aug: bool = False
    spec_aug_params: Optional[dict] = None
    # > 0: the net gets warmup = step / model_warmup_steps (a device
    # tensor), which the Conformer's blocks blend by (JAX trainer.py:87-90)
    model_warmup_steps: int = 0
    # the F-TDNN's semi-orthogonal step on every factor1 weight of the
    # masters, after the update, on the steps where step % 4 == 0 (JAX
    # trainer.py:340-347); chosen on the device, the step never waits
    use_semi_orth: bool = False
    # > 0: batch mixup of the (CMVN'd, SpecAugmented) features, lam ~
    # Beta(alpha, alpha) and the partner permutation drawn from the step's
    # generator; loss = lam * L(y) + (1 - lam) * L(y[perm]) (JAX
    # trainer.py:209-229)
    mixup_alpha: float = 0.0
    # recomputation of the forward in the backward: None (store every
    # activation), "full" (store the net's inputs only), "dots" (store the
    # outputs of products without batch dims, mm and addmm),
    # "dots_batch" (store every product and convolution); JAX
    # trainer.py:75-86, 246-258
    remat: Optional[str] = None


def device_spec_augment(feats: torch.Tensor, generator: torch.Generator, num_t_mask: int = 1,
                        num_f_mask: int = 1, max_t: int = 50, max_f: int = 10) -> torch.Tensor:
    """SpecAugment of [B, T, D] features per row: zero ``num_*_mask`` bands
    of width U[1, max] at a uniform start, a band skipped when its width
    reaches the axis size (JAX trainer.py:93-125). In a mesh step the
    draws are the global batch's, cut to this rank's rows."""
    b, t, d = feats.shape
    dev = feats.device

    def band_mask(nmask: int, size: int, max_w: int) -> torch.Tensor:
        w = comm.draw_rows(lambda s: torch.randint(1, max_w + 1, s, generator=generator, device=dev), (b, nmask))
        start = (comm.draw_rows(lambda s: torch.rand(s, generator=generator, device=dev), (b, nmask))
                 * torch.clamp_min(size - w, 1).to(torch.float32)).to(torch.int64)
        idx = torch.arange(size, device=dev)[None, :, None]
        hit = (idx >= start[:, None, :]) & (idx < (start + w)[:, None, :]) & (w < size)[:, None, :]
        return hit.any(-1)

    tmask = band_mask(num_t_mask, t, max_t)
    fmask = band_mask(num_f_mask, d, max_f)
    keep = (~tmask)[:, :, None] & (~fmask)[:, None, :]
    return feats * keep.to(feats.dtype)


def init_train_state(net: nn.Module, tx: GradientTransformation, device: Any = None) -> TrainState:
    """The state of step 0 from the net's weights and buffers, on ``device``
    (the CUDA card unless ``device="cpu"``; raises without a card). The net
    is moved there too, since the step runs it."""
    dev = resolve_device(device)
    net.to(dev)
    params = {k: p.detach().clone() for k, p in net.named_parameters()}
    batch_stats = {k: b.detach().clone() for k, b in net.named_buffers()}
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev), params=params,
                      batch_stats=batch_stats, opt_state=tx.init(params))


def _keep(finite: torch.Tensor, new: Any, old: Any) -> Any:
    """new where finite, else old, over nested dicts and tuples of tensors
    (a chained optimizer's state is a tuple)."""
    if isinstance(new, dict):
        return {k: _keep(finite, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return tuple(_keep(finite, n, o) for n, o in zip(new, old))
    return torch.where(finite, new, old)


def speaker_targets(y: Any) -> torch.Tensor:
    """The speaker labels of a batch's targets: multi-task batches carry
    ``{"spk": [B], "phone": [B, T]}`` (JAX trainer.py:163-166)."""
    return y["spk"] if isinstance(y, dict) else y


def _rows(y: Any, part: Any) -> Any:
    return {k: v[part] for k, v in y.items()} if isinstance(y, dict) else y[part]


_SAVED_OPS = {
    # jax.checkpoint_policies.dots_with_no_batch_dims_saveable: products
    # without batch dims; bmm, baddbmm and the convolutions are recomputed
    "dots": ("mm", "addmm"),
    # jax.checkpoint_policies.dots_saveable: every product and convolution
    "dots_batch": ("mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution"),
}


def _checkpoint_context(policy: str) -> Callable:
    """``context_fn`` of torch.utils.checkpoint for a selective policy:
    the listed aten ops' outputs are saved, everything else recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = {getattr(torch.ops.aten, name).default for name in _SAVED_OPS[policy]}

    def policy_fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: create_selective_checkpoint_contexts(policy_fn)


def _mixup(x: torch.Tensor, y: Any, generator: torch.Generator, alpha: float) -> Tuple[torch.Tensor, Any, Any]:
    """(mixed x, lam, the partners' targets). In a mesh step the
    permutation is the global batch's: the partner rows come from every
    data rank (features and targets all-gathered, no gradient)."""
    s = comm.current()
    if s is None or s.data is None or s.global_rows == s.local:
        x, lam, perm = tdnn.mixup(x, generator, alpha)
        return x, lam, _rows(y, perm)
    dtype = torch.promote_types(x.dtype, torch.float32)
    lam, perm = tdnn.mixup_draw(s.global_rows, alpha, generator, x.device, dtype)
    mine = perm[s.start:s.start + s.local]
    x_all = comm.all_gather_rows(x, s.data)
    y_all = ({k: comm.all_gather_rows(v, s.data) for k, v in y.items()} if isinstance(y, dict)
             else comm.all_gather_rows(y, s.data))
    mixed = (lam * x.to(dtype) + (1.0 - lam) * x_all[mine].to(dtype)).to(x.dtype)
    return mixed, lam, _rows(y_all, mine)


def make_loss_and_grads(net: nn.Module, config: TrainStepConfig) -> Callable:
    """``fn(params, batch_stats, x, y, mask, generator, lambda_m,
    margin_offset, warmup) -> (loss, accuracy, new batch_stats, grads)``:
    one forward and backward of ``net`` in the compute type on the f32
    masters (in wave mode after the fused fbank, CMVN and SpecAugment);
    the grads in ``params``' order. The train step and the SAM step share
    it.

    With ``mixup_alpha`` the features are mixed (nn/tdnn.py ``mixup``) and
    the net runs twice, on y and on y[perm], as JAX's step does: the same
    dropout masks (the generator's state is restored before the second
    pass), the batch statistics and logits of the first; accuracy against
    the unpermuted targets. With ``remat`` the forward (the net and its
    loss; the front end runs before it without gradients) runs under
    torch.utils.checkpoint, and its recomputation in the backward replays
    the generator from the state it had before the forward: the recompute
    draws the dropout masks of the forward (checkpoint's own
    ``preserve_rng_state`` restores only the global generators). The
    running statistics the BatchNorms assign in the recompute go to a
    dict of that call that is thrown away; the step keeps the forward's."""
    opts = config.fbank_opts or FbankOptions()
    dtype = config.compute_dtype
    net_takes_warmup = "warmup" in inspect.signature(type(net).forward).parameters
    if config.remat not in (None, "full", *_SAVED_OPS):
        raise ValueError(f"unknown remat policy {config.remat!r}")
    context_fn = _checkpoint_context(config.remat) if config.remat in _SAVED_OPS else None

    def loss_and_grads(params: Tensors, batch_stats: Tensors, x, y, mask, generator, lambda_m, margin_offset,
                       warmup):
        if config.wave_input:
            # the wave is data: the front end needs no gradient
            with torch.no_grad(), span("train.front_end", device=x):
                x, mask = wave_features(x, mask, opts, dtype)
                if config.spec_aug:
                    x = device_spec_augment(x, generator, **(config.spec_aug_params or {}))
        x = x.to(dtype)
        if config.mixup_alpha > 0:
            # the mix stays in the compute type; JAX's multiplies bf16
            # features by an f32 lam, which promotes its forward to f32
            x, lam, partner = _mixup(x, y, generator, config.mixup_alpha)
        replay = generator is not None and (config.mixup_alpha > 0 or config.remat is not None)
        start = generator.get_state() if replay else None
        names = list(params)
        kwargs = dict(mask=mask, lambda_m=lambda_m, margin_offset=margin_offset, generator=generator)
        if net_takes_warmup:
            kwargs["warmup"] = warmup

        def forward(*leaves):
            tensors = {k: p.to(dtype) if p.dtype == torch.float32 else p for k, p in zip(names, leaves)}

            def run(targets, stats):
                if replay:
                    generator.set_state(start)
                call = {**tensors, **stats}
                loss, logits, _ = torch.func.functional_call(net, call, (x, targets), kwargs)
                # the buffers the BatchNorms assigned in train mode
                return loss, logits, [call[k] for k in batch_stats]

            loss, logits, new_stats = run(y, batch_stats)
            if config.mixup_alpha > 0:
                loss_b = run(partner, dict(batch_stats))[0]
                loss = lam * loss + (1.0 - lam) * loss_b
            return (loss.float(), logits, *new_stats)

        leaves = [params[k].detach().requires_grad_() for k in names]
        with span("train.forward", device=x):
            if config.remat is None:
                loss, logits, *new_stats = forward(*leaves)
            else:
                loss, logits, *new_stats = checkpoint(forward, *leaves, use_reentrant=False,
                                                      preserve_rng_state=False,
                                                      **({"context_fn": context_fn} if context_fn else {}))
        with span("train.backward", device=x):
            grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), compute_accuracy(logits.detach(), speaker_targets(y)),
                dict(zip(batch_stats, new_stats)), list(grads))

    return loss_and_grads


def _compute_type(config: TrainStepConfig, master: torch.Tensor) -> torch.dtype:
    """The type the forward runs a master in (f32 masters in the compute
    type, others in their own)."""
    return config.compute_dtype if master.dtype == torch.float32 else master.dtype


def _is_semi_orth(placement, name: str, value: torch.Tensor) -> bool:
    shape = placement.shapes[name] if placement is not None else value.shape
    return is_semi_orth_weight(name, torch.empty(shape, device="meta"))


def _semi_orth(placement, name: str, value: torch.Tensor) -> torch.Tensor:
    """The semi-orthogonal update; a ZeRO-3 shard is gathered whole first
    and cut back after."""
    if placement is None or name not in placement.sharded:
        return semi_orth_update(value)
    return placement.local_chunk(name, semi_orth_update(placement.gather_leaf(name, value)))


def _microbatch_scope(placement, rows: int) -> Any:
    """The collectives' scope for a microbatch of ``rows`` rows on this
    rank (a null context without a placement). A mesh dim of one process
    is left out: the layers run their single-device code on it."""
    if placement is None:
        return contextlib.nullcontext()
    d, m = placement.data, placement.model
    return comm.scope(d if d.size > 1 else None, m if m.size > 1 else None, global_rows=rows * d.size,
                      start=d.rank * rows, local=rows)


def _global_metrics(placement, names, grads, loss, acc) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, accuracy, global gradient norm): the means over the global
    batch and the norm over every element once, in one all-reduce over the
    mesh; without a placement or on one process, this process's values."""
    if placement is None or placement.world == 1:
        return loss, acc, torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    w = placement.world
    sq = placement.sq_norm_parts(names, grads)
    tot = placement.world_sum(torch.stack([loss.double() / w, torch.as_tensor(acc).double() / w, sq.double()]))
    return tot[0].to(loss.dtype), tot[1].float(), torch.sqrt(tot[2]).to(sq.dtype)


def make_train_step(net: nn.Module, tx: GradientTransformation, lr_schedule: Optional[Callable] = None,
                    config: TrainStepConfig = TrainStepConfig(), placement=None) -> Callable:
    """Build ``step(state, batch, generator, lambda_m=1.0, margin_offset=0.0,
    lr_scale=1.0) -> (state, metrics)``.

    batch = {"x": [B, T, D] features or [B, S] waves, "y": [B] (or a
    multi-task net's {"spk": [B], "phone": [B, T]}), optional "mask":
    [B, T] frames or [B, S] samples}; with ``accum_grad`` > 1, B
    must be a multiple of it. ``generator`` (on the state's device) draws
    SpecAugment and dropout. ``lambda_m`` and ``margin_offset`` feed the
    margin loss, ``lr_scale`` (ReduceOnPlateau's scale) scales the updates,
    not the gradients. A net whose ``forward`` takes ``warmup`` gets it:
    ``step / model_warmup_steps`` in float32 on the device, or 1.0 when
    ``model_warmup_steps`` is 0. metrics: loss, accuracy, grad_norm,
    skipped (1.0 on a kept state) and, given ``lr_schedule``, lr at the
    state's step times lr_scale; all 0-dim tensors on the device.

    ``placement`` (parallel/mesh.py ``Placement``): the mesh step. batch
    holds this rank's rows of the global batch (``shard_batch``), the
    state this rank's shards; the metrics are the global ones.
    """
    loss_and_grads = make_loss_and_grads(net, config)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
             lambda_m: Any = 1.0, margin_offset: Any = 0.0, lr_scale: Any = 1.0) -> Tuple[TrainState, dict]:
        net.train()
        x, y, mask = batch["x"], batch["y"], batch.get("mask")
        a = config.accum_grad
        if x.shape[0] % a:
            raise ValueError(f"batch {x.shape[0]} not divisible by accum_grad {a}")
        mb = x.shape[0] // a
        # the division stays on the device: the step never waits on the card
        warmup = (state.step.to(torch.float32) / config.model_warmup_steps
                  if config.model_warmup_steps > 0 else 1.0)
        names = list(state.params)
        params = state.params
        if placement is not None and placement.sharded:
            params = placement.gather_params(params, _compute_type(config, params[placement.sharded[0]]))
        grads, stats, loss, acc = None, state.batch_stats, 0.0, 0.0
        for i in range(a):
            part = slice(i * mb, (i + 1) * mb)
            with _microbatch_scope(placement, mb):
                loss_i, acc_i, stats, grads_i = loss_and_grads(
                    params, stats, x[part], _rows(y, part), None if mask is None else mask[part], generator,
                    lambda_m, margin_offset, warmup)
            grads = grads_i if grads is None else torch._foreach_add(grads, grads_i)
            loss, acc = loss + loss_i, acc + acc_i
        if a > 1:
            grads = torch._foreach_div(grads, float(a))
            loss, acc = loss / a, acc / a
        if placement is not None:
            # gathered leaves took their gradients in the compute type
            grads = placement.mean_grads(names, [g.to(state.params[k].dtype) for g, k in zip(grads, names)])

        with span("train.optimizer", device=state.step):
            loss, acc, gnorm = _global_metrics(placement, names, grads, loss, acc)
            finite = torch.isfinite(gnorm) & torch.isfinite(loss)
            # the denominator (gnorm + 1e-6) is torch clip_grad_norm_'s
            grads = torch._foreach_mul(grads, torch.clamp_max(config.max_change / (gnorm + 1e-6), 1.0))
            updates, opt_state = tx.update(dict(zip(names, grads)), state.opt_state, state.params)
            new_params = dict(zip(names, torch._foreach_add([state.params[k] for k in names],
                                                             torch._foreach_mul([updates[k] for k in names],
                                                                                lr_scale))))
            if config.use_semi_orth:
                on = state.step % 4 == 0
                new_params = {k: torch.where(on, _semi_orth(placement, k, v), v)
                              if _is_semi_orth(placement, k, v) else v for k, v in new_params.items()}
            if config.skip_nonfinite:
                new_params = _keep(finite, new_params, state.params)
                opt_state = _keep(finite, opt_state, state.opt_state)
                stats = _keep(finite, stats, state.batch_stats)
        metrics = {"loss": loss, "accuracy": acc, "grad_norm": gnorm, "skipped": 1.0 - finite.to(torch.float32)}
        if lr_schedule is not None:
            metrics["lr"] = lr_schedule(state.step) * lr_scale
        return TrainState(step=state.step + 1, params=new_params, batch_stats=stats, opt_state=opt_state), metrics

    return step


def make_eval_step(net: nn.Module, placement=None) -> Callable:
    """Build ``step(state, batch) -> {"loss_sum", "acc_sum", "n"}``, 0-dim
    tensors on the state's device (JAX trainer.py:379-417).

    The net runs in eval mode on the master weights, in their type, under
    ``torch.no_grad``. batch = {"x", "y", optional "mask", optional
    "weight" [B]}: a row of weight 0 contributes nothing; without weights
    every row counts once. The loss is the per-row cross entropy of the
    head's logits (no margin in eval mode); a multi-task batch is scored
    on its speaker labels. With ``placement`` the batch is this rank's
    rows, ZeRO-3 shards are gathered whole, and the sums are the global
    batch's (one all-reduce over "data")."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        net.eval()
        x, targets = batch["x"], batch["y"]
        y = speaker_targets(targets)
        dtype = next(p.dtype for p in state.params.values() if p.is_floating_point())
        params = state.params
        if placement is not None and placement.sharded:
            params = placement.gather_params(params, dtype)
        with torch.no_grad(), _microbatch_scope(placement, x.shape[0]):
            _, logits, _ = torch.func.functional_call(net, {**params, **state.batch_stats},
                                                      (x.to(dtype), targets), {"mask": batch.get("mask")})
            w = batch.get("weight")
            if w is None:
                w = torch.ones(y.shape[0], dtype=torch.float32, device=y.device)
            correct = (logits.argmax(-1) == y).to(w.dtype)
            per_row = cross_entropy(logits, y, reduction="none")
            sums = {"loss_sum": (per_row * w).sum(), "acc_sum": (correct * w).sum(), "n": w.sum()}
            if placement is None or placement.data.size == 1:
                return sums
            flat = torch.stack([v.to(per_row.dtype) for v in sums.values()])
            torch.distributed.all_reduce(flat, group=placement.data.group)
            return dict(zip(sums, flat))

    return step


def _fetch(values: Dict[str, Any]) -> Dict[str, float]:
    """Device scalars (and Python numbers) -> host floats, the tensors in
    one copy: one wait on the card."""
    out = {k: float(v) for k, v in values.items() if not isinstance(v, torch.Tensor)}
    tensors = {k: v for k, v in values.items() if isinstance(v, torch.Tensor)}
    if tensors:
        out.update(zip(tensors, torch.stack([v.detach().to(torch.float64).reshape(()) for v in tensors.values()])
                       .tolist()))
    return {k: out[k] for k in values}


def batch_to_device(batch: Dict, device: torch.device,
                    keys: Tuple[str, ...] = ("x", "y", "mask", "phone_y", "aux_y", "weight")) -> Dict[str, Any]:
    """A host batch's ``keys`` on ``device`` (``non_blocking``: from pinned
    memory the copies are queued), labels as int64. A dual-label batch
    (``phone_y``, the multi-task chunk egs) gets the multi-task net's
    targets ``{"spk": y, "phone": phone_y}`` (JAX trainer.py:606-610)."""
    out = {}
    for k in keys:
        if k in batch:
            v = batch[k]
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            out[k] = v.to(device, non_blocking=True)
    for k in ("y", "phone_y", "aux_y"):
        if k in out:
            out[k] = out[k].long()
    if "phone_y" in out:
        out["y"] = {"spk": out["y"], "phone": out.pop("phone_y")}
    return out


def make_placement(net: nn.Module, mesh, partition_rules=None, tx: Optional[GradientTransformation] = None):
    """The Placement of ``net``'s parameters on ``mesh`` under
    ``partition_rules`` (None: every leaf replicated). ZeRO-3 shards are
    flat chunks, so an optimizer that reads a leaf's shape or norm (gc,
    ralamb, novograd, eve, the ``decay_kernels_only`` mask) cannot update
    them: with ``tx`` such a pairing raises."""
    from ..parallel.mesh import Placement, partition_params

    params = dict(net.named_parameters())
    placement = Placement(mesh, partition_params(mesh, params, partition_rules),
                          {k: p.shape for k, p in params.items()})
    if placement.sharded and tx is not None and not tx.elementwise:
        raise ValueError("ZeRO-3 shards are flat chunks: the optimizer must update element by element (sgd, "
                         "sgdw, adam, adamW or adamod, without decay_kernels_only or gc; lookahead around one)")
    return placement


class Trainer:
    """Epoch loop: host batches -> train steps -> report, validate (JAX
    trainer.py:472-678).

    ``device`` is the CUDA card unless ``device="cpu"``; the state lives
    there. Batches may hold numpy arrays or (pinned) CPU tensors: each goes
    to the device with ``non_blocking=True``, labels as int64. The margin
    warm-up (``MarginWarm`` or ``LambdaMAnneal``) and the plateau scale
    reach the step as Python floats, read from the host step counter.
    ``epoch_stats`` describes the last epoch: its first step, its steps,
    its wall time, the host's wait for each batch, the host's time from
    each batch's arrival to the end of its step's turn (the copy, the
    queued step and, at a report point, the fetch) and, on a CUDA device,
    each step's time between two CUDA events. ``step_fn`` takes the place
    of the train step (train/sam.py's, with the same signature; a step_fn
    that takes ``step_index``, as train/fd.py's does, gets the host step
    count there). A batch with ``phone_y`` trains and validates a
    multi-task net on the targets ``{"spk": y, "phone": phone_y}``.
    ``nan_debug_dir`` set: each skipped step's batch, weights and metrics
    are dumped there (train/debug.py), which reads each step's ``skipped``
    back from the device: one wait on the card a step. Unset (the
    default), no step waits.

    ``mesh`` (parallel/mesh.py ``make_mesh``) and ``partition_rules``
    (``classifier_partition_rules``, ``make_fsdp_rules``; None replicates
    every leaf) run the mesh step as JAX's Trainer does: every rank feeds
    the same global batches and keeps its rows, the state holds this
    rank's shards (``full_state`` gathers it whole, ``shard_state`` cuts a
    whole one), validation pads a batch to the data size with rows of
    weight 0. Without a mesh it is the one-device loop."""

    def __init__(self, net: nn.Module, tx: GradientTransformation, lr_schedule: Optional[Callable] = None,
                 config: TrainStepConfig = TrainStepConfig(), margin_warm=None, plateau=None,
                 report_interval: int = 100, reporter=None, device: Any = None, step_fn: Optional[Callable] = None,
                 nan_debug_dir: Optional[str] = None, mesh=None, partition_rules: Optional[Callable] = None):
        self.net = net
        self.tx = tx
        self.lr_schedule = lr_schedule
        self.config = config
        self.margin_warm = margin_warm
        self.plateau = plateau
        self.report_interval = report_interval
        self.reporter = reporter
        self.device = resolve_device(device)
        self.nan_debug_dir = nan_debug_dir
        self.epoch_stats: Dict[str, Any] = {}
        self.mesh = mesh
        self.placement = make_placement(net, mesh, partition_rules, tx) if mesh is not None else None
        self._train_step = (step_fn if step_fn is not None
                            else make_train_step(net, tx, lr_schedule, config, placement=self.placement))
        self._takes_step_index = "step_index" in inspect.signature(self._train_step).parameters
        self._eval_step = make_eval_step(net, self.placement)

    def init_state(self) -> TrainState:
        """Step 0 from the net's weights, on the trainer's device; on a
        mesh, rank 0's weights on every rank, cut to this rank's shards."""
        if self.placement is None:
            return init_train_state(self.net, self.tx, self.device)
        from ..parallel.mesh import replicate

        self.net.to(self.device)
        params = replicate(self.mesh, {k: p.detach().clone() for k, p in self.net.named_parameters()})
        stats = replicate(self.mesh, {k: b.detach().clone() for k, b in self.net.named_buffers()})
        params = self.placement.shard_params(params)
        return TrainState(step=torch.zeros((), dtype=torch.int32, device=self.device), params=params,
                          batch_stats=stats, opt_state=self.tx.init(params))

    def _opt_specs(self, state: TrainState, full_params: Dict[str, torch.Tensor]) -> Any:
        from ..parallel.mesh import opt_state_shardings

        return opt_state_shardings(self.mesh, state.opt_state, full_params, self.placement.specs)

    def full_state(self, state: TrainState) -> TrainState:
        """The whole state from every rank's shards (a collective: every
        rank calls it); the state itself without a mesh."""
        if self.placement is None:
            return state
        full = self.placement.full_tree(state.params, self.placement.specs)
        # the moments' specs come from the shards' shapes on this rank
        specs = self._opt_specs(state, state.params)
        return dataclasses.replace(state, params=full, opt_state=self.placement.full_tree(state.opt_state, specs))

    def shard_state(self, state: TrainState) -> TrainState:
        """This rank's shards of a whole state (a loaded checkpoint)."""
        if self.placement is None:
            return state
        specs = self._opt_specs(state, state.params)
        return dataclasses.replace(state, params=self.placement.shard_params(state.params),
                                   opt_state=self.placement.shard_tree(state.opt_state, specs))

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A host batch on the device; on a mesh, this rank's rows of it."""
        if self.mesh is not None:
            from ..parallel.mesh import shard_batch

            batch = shard_batch(self.mesh, {k: v for k, v in batch.items() if k != "keys"})
        return batch_to_device(batch, self.device)

    def run_epoch(self, state: TrainState, data_iter: Iterable[Dict], generator: torch.Generator, epoch: int = 0,
                  valid_iter: Optional[Callable] = None) -> Tuple[TrainState, Dict]:
        """One epoch over ``data_iter`` of host batches; returns the final
        state and the EPOCH-MEAN metrics (skipped = total skipped steps;
        the other keys from the last step). The sums stay on the device
        and are fetched once at the end. ``generator`` (on the device)
        draws SpecAugment and dropout."""
        sums: Dict[str, Any] = {}
        metrics: Dict[str, torch.Tensor] = {}
        n = 0
        waits, turns, events = [], [], []
        t0 = epoch_t0 = time.perf_counter()
        # the step counter on the host, read once: reading the state's
        # each step would wait on the previous step
        host_step = int(state.step)
        it = iter(data_iter)
        while True:
            w0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            w1 = time.perf_counter()
            waits.append(w1 - w0)
            if self.margin_warm is not None:
                moff, lam = self.margin_warm.step(host_step + n)
                if isinstance(self.margin_warm, MarginWarm):
                    # step_iter clamps the warm lambda (reference
                    # ecapa_tdnn_xvector.py:526: max(1e-3, lambda_m)); the
                    # "m" annealing (LambdaMAnneal) does not
                    lam = max(1e-3, lam)
            else:
                moff, lam = 0.0, 1.0
            lr_scale = self.plateau.scale if self.plateau is not None else 1.0
            batch = self._to_device(batch)
            if self.device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            kwargs = {"step_index": host_step + n} if self._takes_step_index else {}
            state, metrics = self._train_step(state, batch, generator, float(lam), float(moff), float(lr_scale),
                                              **kwargs)
            if self.device.type == "cuda":
                end.record()
                events.append((start, end))
            n += 1
            for k in ("loss", "accuracy", "skipped"):
                sums[k] = metrics[k] if k not in sums else sums[k] + metrics[k]
            if self.nan_debug_dir is not None and float(metrics["skipped"]) > 0:
                # the forensic dump (JAX trainer.py:623-630): reading
                # "skipped" waits on the card, so only when asked for
                from .debug import dump_nan_batch

                dump_nan_batch(self.nan_debug_dir, state, batch, metrics, step=host_step + n)
            if n % self.report_interval == 0:
                m = _fetch(metrics)
                rate = self.report_interval / (time.perf_counter() - t0)
                t0 = time.perf_counter()
                if self.reporter is not None:
                    self.reporter.update(epoch=epoch, iteration=n, steps_per_sec=rate, **m)
                if valid_iter is not None and self.plateau is not None:
                    self.plateau.update(self.validate(state, valid_iter())["loss"])
            turns.append(time.perf_counter() - w1)
        self.epoch_stats = {"first_step": host_step, "steps": n, "wall_s": time.perf_counter() - epoch_t0,
                            "data_wait_s": waits, "turn_s": turns}
        if not n:
            return state, {}
        out = _fetch({**metrics, **{f"sum_{k}": v for k, v in sums.items()}})
        for k in ("loss", "accuracy"):
            out[k] = out.pop(f"sum_{k}") / n
        out["skipped"] = out.pop("sum_skipped")  # TOTAL skipped steps
        if events:
            self.epoch_stats["step_ms"] = [s.elapsed_time(e) for s, e in events]
        return state, out

    def validate(self, state: TrainState, valid_iter: Iterable[Dict]) -> Dict[str, float]:
        """Weighted loss and accuracy over ``valid_iter``'s batches (every
        row weight 1); the sums are fetched once at the end."""
        sums: Dict[str, Any] = {"loss_sum": 0.0, "acc_sum": 0.0, "n": 0.0}
        for batch in valid_iter:
            rows = len(batch["y"])
            pad = (-rows) % (self.placement.data.size if self.placement is not None else 1)
            weight = np.concatenate([np.ones(rows), np.zeros(pad)]).astype(np.float32)
            if pad:
                # JAX's padding (trainer.py:656-668): copies of the first row
                batch = {k: np.concatenate([np.asarray(v)] + [np.asarray(v[:1])] * pad)
                         for k, v in batch.items() if k in ("x", "y", "mask", "phone_y", "aux_y")}
            batch = self._to_device(dict(batch, weight=weight))
            m = self._eval_step(state, batch)
            sums = {k: sums[k] + m[k] for k in sums}
        got = _fetch(sums)
        count = max(got["n"], 1.0)
        return {"loss": got["loss_sum"] / count, "accuracy": got["acc_sum"] / count}
