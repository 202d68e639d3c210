"""Entry kind ``train``: the port's train step (``make_train_step`` on
``init_train_state``) on whole chunks of wave, the fused fbank K1 and
CMVN inside the step, the configuration's head and optimiser.

Set-up builds the one step object and its state from the seeded f32
masters, makes a pool of ``pool_batches`` seeded batches on the device,
and drives the step through its first three steps on the pool's first
three batches (keeping the losses, the SGD momentum trace after step 1
and the parameters after step 3 for the check) and a fourth. The window then
runs the same step on the same state, batch after batch from the pool,
until ``seconds`` have passed, and ends after a synchronize: every step
it queued is complete. With ``--trace 1`` a stretch of ``trace_steps``
steps runs under the profiler after the window, then ``enqueue_steps``
steps, each from an idle card, time the host's queueing of a step.
Once the program is freed, the reference takes the same three steps
from the same masters on the same batches, in float32.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict

import numpy as np
import torch

from benchmark import checks, program, reference, tracing, traffic_gen, weights
from benchmark.counts import kernels, model_flops
from benchmark.harness import Result
from benchmark.reference.ops import fp8_round

CHECK_STEPS = 3


def _specs(cfg: dict, fam):
    head = [("loss.weight", (cfg["head"]["num_targets"], fam.embd_dim(cfg)), "class_weight", 0)]
    return [("backbone." + n, s, k, f) for n, s, k, f in fam.param_specs(cfg)] + head


def _planted(step, faults):
    """Faults of the training path, planted around the program's step
    (tests and calibration only)."""
    def faulty(state, batch, gen):
        if "half_batch" in faults:  # half of the batch left out, the mean over the rest
            half = batch["x"].shape[0] // 2
            batch = {"x": batch["x"][:half], "y": batch["y"][:half]}
        new, metrics = step(state, batch, gen)
        if "state_unchanged" in faults:
            new = dataclasses.replace(state, step=new.step)
        if "answer_altered" in faults:  # the largest leaf's update doubled where it is produced
            k = max(new.params, key=lambda n: new.params[n].numel())
            new.params[k] = 2 * new.params[k] - state.params[k]
        return new, metrics
    return faulty


def _reference_steps(fam, cfg, w, buffers, waves, labels, q=None) -> dict:
    params = {k: v.float() for k, v in w.items() if k not in buffers}
    state, losses, grad1, stats1 = {}, [], None, {}
    for i in range(CHECK_STEPS):
        params, clipped, state, loss = reference.train_step(fam, params, buffers, waves[i], labels[i], cfg, state, q,
                                                            batch_stats=stats1 if i == 0 else None)
        losses.append(float(loss))
        grad1 = clipped if grad1 is None else grad1
    return {"losses": losses, "grad1": grad1, "params3": params, "stats1": stats1}


def _running(batch_stats: dict, buffers: dict, cfg: dict, fam) -> dict:
    """The running variances a step would leave from a reference's batch
    statistics (the control, in the program's place)."""
    out = {}
    for name, (_, var) in batch_stats.items():
        m = fam.bn_momentum(name, cfg)
        out[f"backbone.{name}.var"] = (1 - m) * buffers[f"backbone.{name}.var"] + m * var
    return out


def _compare(prog: dict, ref: dict, w: dict, buffers: dict, cfg: dict, fam, notes=None) -> Dict[str, float]:
    params0 = {k: v for k, v in w.items() if k not in buffers}
    head = [f"backbone.{n}" for n in fam.head_leaves(cfg)] + ["loss.weight"]
    out = checks.train_gaps(prog, ref, params0, notes, head)
    bn = checks.bn_var_gaps(prog["stats1"], buffers, lambda name: fam.bn_momentum(name, cfg), ref["stats1"])
    out["bn_var_gap"] = max(bn.values())
    if notes is not None:
        worst = sorted(bn, key=bn.get)[-3:]
        notes.append("bn_var worst layers: " + ", ".join(f"{k} {bn[k]:.4g}" for k in reversed(worst)))
    return out


def run(ctx) -> Result:
    from asv_subtools_tpu_torch.train import (TrainStepConfig, get_lr_schedule, get_optimizer, init_train_state,
                                              make_train_step)

    cfg, mix = ctx.cell.config, ctx.cell.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    opt, fam = cfg["optimizer"], reference.family(cfg["reference"])
    w = weights.seeded_tensors(_specs(cfg, fam), traffic_gen.derived_seed(ctx.seed, 0), dev, torch.float32)
    net = program.build(cfg, dev, w, with_head=True)
    tx = get_optimizer(opt["name"], learning_rate=get_lr_schedule(**cfg["lr_schedule"]),
                       **{k: v for k, v in opt.items() if k not in ("name", "max_change")})
    state0 = init_train_state(net, tx, dev)
    step = make_train_step(net, tx, config=TrainStepConfig(
        max_change=opt["max_change"], compute_dtype=getattr(torch, cfg["dtype"]), wave_input=True,
        fbank_opts=program.fbank_options(cfg)))
    if ctx.faults:
        step = _planted(step, ctx.faults)
    gen = torch.Generator(device=dev).manual_seed(traffic_gen.derived_seed(ctx.seed, 1))
    n_pool, b, s = mix["pool_batches"], mix["batch"], traffic_gen.chunk_samples(mix)
    waves = traffic_gen.device_waves(mix, (n_pool, b, s), gen, dev)
    labels = torch.randint(0, cfg["head"]["num_targets"], (n_pool, b), generator=gen, device=dev)
    batch = lambda i: {"x": waves[i % n_pool], "y": labels[i % n_pool]}

    t_built = time.perf_counter()
    state, losses = state0, []
    for i in range(CHECK_STEPS + 1):
        state, metrics = step(state, batch(i), gen)
        losses.append(metrics["loss"])
        if i == 0:
            trace1, stats1 = state.opt_state["trace"], state.batch_stats
        if i == CHECK_STEPS - 1:
            params3 = state.params
    del state0
    if cuda:
        torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    deadline, n, i = t0 + ctx.seconds, 0, CHECK_STEPS + 1
    skipped = torch.zeros((), device=dev)
    while time.perf_counter() < deadline:
        state, metrics = step(state, batch(i), gen)
        skipped = skipped + metrics["skipped"]
        i, n = i + 1, n + 1
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    failed = int(round(float(skipped)))
    chunk_s = s / mix["sample_rate"]
    counters: Dict[str, float] = {"window_s": window_s, "steps": float(n)}

    summary = None
    if ctx.trace:
        def stretch(work):
            nonlocal state, i
            for _ in range(mix["trace_steps"]):
                state, _ = step(state, batch(i), gen)
                work.append((b, s))
                i += 1

        summary = tracing.profile(torch, stretch)
        enqueue = []
        for _ in range(mix["enqueue_steps"]):
            if cuda:
                torch.cuda.synchronize(dev)
            t = time.perf_counter()
            state, _ = step(state, batch(i), gen)
            enqueue.append(time.perf_counter() - t)
            i += 1
        counters["host_enqueue_s"] = float(np.mean(enqueue))
        t = reference.fbank.num_frames(s)
        counters["window_flops"] = n * (model_flops.network_flops(cfg, t, b, train=True)
                                        + kernels.k1_frame_flops(cfg["model"]["input_dim"]) * b * t)
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # SGD's first trace is the clipped gradient plus the weight decay's term
    grad1 = {k: v - opt["weight_decay"] * w[k] for k, v in trace1.items()}
    prog = {"losses": [float(x) for x in losses[:CHECK_STEPS]], "grad1": grad1, "params3": params3,
            "stats1": stats1}
    del state, step, net, metrics
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    buffers = {k: v for k, v in w.items() if k.endswith((".mean", ".var"))}
    ref = _reference_steps(fam, cfg, w, buffers, waves, labels)
    notes = [f"set-up: to the step built and the pool drawn {t_built - ctx.t_start:.3f} s, "
             f"the first {CHECK_STEPS + 1} steps {t0 - t_built:.3f} s"]
    compared = _compare(prog, ref, w, buffers, cfg, fam, notes)
    control = None
    if ctx.control:
        low = _reference_steps(fam, cfg, w, buffers, waves, labels, q=fp8_round)
        low["stats1"] = _running(low["stats1"], buffers, cfg, fam)
        control = _compare(low, ref, w, buffers, cfg, fam)
    return Result(setup_s=t0 - ctx.t_start, window_s=window_s,
                  end_to_end={"train_audio_s_per_s": n * b * chunk_s / window_s if window_s > 0 else 0.0},
                  counters=counters, compared=compared, attempted=n + CHECK_STEPS + 1, failed=failed,
                  memory_peak_bytes=int(peak), trace=summary, control=control, notes=notes)
