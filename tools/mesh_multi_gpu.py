"""The mesh train step across the cards of one host, against one card.

Run from the repository root on a machine with N cards (N = 2 or 4):

    python -m torch.distributed.run --nproc_per_node=N tools/mesh_multi_gpu.py

Each process drives one card (NCCL). For each placement on the
``("data", "model")`` mesh -- data N; data N/2 x model 2 (the margin
head's rows over "model"); data N with ZeRO-3 rules (``make_fsdp_rules``
at its default ``min_size``) -- one train step of ECAPA-TDNN C1024 with
the sub-centre top-k AAM head over 5,994 classes (chip_smoke phase 8's:
B=128 x 32,000 samples of raw waves, K1 in the step, adamW 1e-3) from
one seeded state, batch and generator, held on rank 0 against the
one-card step from the same state. In f32 (TF32 off), where two orders
of summation differ in the last bits, at the bars of JAX's
tests/test_multichip_production.py:15-34: loss 1e-5 and grad_norm 1e-4
relative, the BN running statistics at rtol 1e-3 / atol 1e-6, every
leaf within 2.5 lr. In bf16 on f32 masters (the bench's step) the same
deviations are printed, not held: a card picks its kernels by shape, so
a shard of 128 / N rows rounds its bf16 activations otherwise than the
whole batch. Rank 0 shows that cause on its card first: the eval-mode
embeddings of 128 rows of features (rows do not interact in eval mode)
computed at once and as N slices of 128 / N rows, in f32 and in bf16,
beside the gap between the f32 and bf16 embeddings of the whole batch.
Then, per placement, the bf16 step's ms (CUDA events around
10 steps queued back to back, the median of 3 runs) beside the one-card
step's, its peak memory per card and its collective audit (two steps
under torch.profiler); last, asnorm_device with the mesh at
VoxCeleb1-E/H's shape (600 x 970 trials, a cohort of 5,994, top 300)
against the one-card call at rtol 1e-5, and its ms. Prints one line per
result from rank 0 and exits 1 if a held bar is missed.
"""

from __future__ import annotations

import copy
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from asv_subtools_tpu_torch.backend import asnorm_device  # noqa: E402
from asv_subtools_tpu_torch.parallel import (classifier_partition_rules, initialize_multihost,  # noqa: E402
                                             make_fsdp_rules, make_mesh)
from asv_subtools_tpu_torch.parallel.audit import audit_train_step  # noqa: E402
from asv_subtools_tpu_torch.train import (Trainer, TrainStepConfig, get_optimizer, init_train_state,  # noqa: E402
                                          make_train_step)
from asv_subtools_tpu_torch.train.step_check import NUM_TARGETS, OPTS, SUBCENTER_TOPK, ecapa_net  # noqa: E402

BATCH, SAMPLES, LR, SEED = 128, 32000, 1e-3, 0


def step_ms(step, runs: int = 3, n: int = 10) -> float:
    """ms a step: events around ``n`` steps queued back to back, the median
    of ``runs`` after two warm-up steps."""
    step()
    step()
    out = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            step()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / n)
    return float(np.median(out))


def slice_gap(net, dev, parts: int) -> dict:
    """Largest |whole - slices| / max |whole| of the eval-mode embeddings of
    BATCH rows of random features computed at once and in ``parts`` slices,
    per type; "bf16 vs f32" is the whole batch's gap between the types."""
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    feats = torch.randn((BATCH, SAMPLES // 160 - 2, 80), generator=g, device=dev)
    out, whole = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        m = copy.deepcopy(net.backbone).to(dev, dtype).eval()
        with torch.no_grad():
            x = feats.to(dtype)
            whole[dtype] = m(x).float()
            sliced = torch.cat([m(p).float() for p in x.chunk(parts)])
        out[str(dtype)[6:]] = float((whole[dtype] - sliced).abs().max() / whole[dtype].abs().max())
        del m
    f32 = whole[torch.float32]
    out["bf16 vs f32"] = float((whole[torch.bfloat16] - f32).abs().max() / f32.abs().max())
    return out


def _deviations(metrics, full, ref_m, ref) -> dict:
    """Rank 0's deviations of a mesh step from the one-card step."""
    rel = lambda k: abs(float(metrics[k]) - float(ref_m[k])) / abs(float(ref_m[k]))  # noqa: E731
    bn = all(torch.allclose(full.batch_stats[k].float(), v.float(), rtol=1e-3, atol=1e-6)
             for k, v in ref.batch_stats.items() if v.is_floating_point())
    leaf = max(float((full.params[k] - v).abs().max()) for k, v in ref.params.items())
    return {"loss": rel("loss"), "grad_norm": rel("grad_norm"), "bn": bn, "leaf": leaf}


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    label = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    batch = {"x": torch.randn((BATCH, SAMPLES), generator=gen, device=dev) * 1000.0,
             "y": torch.randint(0, NUM_TARGETS, (BATCH,), generator=gen, device=dev)}
    configs = {dtype: TrainStepConfig(compute_dtype=dtype, wave_input=True, fbank_opts=OPTS)
               for dtype in (torch.float32, torch.bfloat16)}
    net = ecapa_net(SUBCENTER_TOPK, SEED + 21, channels=1024)
    tx = get_optimizer("adamW", LR)
    seeded = lambda: torch.Generator(device=dev).manual_seed(SEED + 22)  # noqa: E731
    ok = True

    refs = {}
    if rank == 0:
        for dtype, config in configs.items():
            plain = make_train_step(net, tx, config=config)
            state0 = init_train_state(net, tx, dev)
            refs[dtype] = plain(state0, batch, seeded())
        torch.cuda.reset_peak_memory_stats(dev)
        one_ms = step_ms(lambda: plain(state0, batch, seeded()))
        one_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"one card, bf16: {one_ms:.2f} ms/step, peak {one_peak:.2f} GiB on {label}", flush=True)
        gap = slice_gap(net, dev, world)
        print(f"eval-mode embeddings of {BATCH} rows at once against {world} slices of {BATCH // world} rows, "
              f"largest deviation over the largest value: f32 {gap['float32']:.2e}, bf16 {gap['bfloat16']:.2e}; "
              f"the whole batch's bf16 against its f32 {gap['bf16 vs f32']:.2e} ({label})", flush=True)
        del state0
    dist.barrier()

    placements = [(f"data {world}", world, 1, None)]
    if world % 2 == 0:
        placements.append((f"data {world // 2} x model 2", world // 2, 2, classifier_partition_rules))
    placements.append((f"data {world} ZeRO-3", world, 1, "fsdp"))
    for name, d, m, rules in placements:
        mesh = make_mesh(d, m)
        rules = make_fsdp_rules(mesh) if rules == "fsdp" else rules
        dev_by_dtype = {}
        for dtype, config in configs.items():
            trainer = Trainer(net, tx, config=config, device=dev, mesh=mesh, partition_rules=rules)
            state = trainer.init_state()
            local = trainer._to_device(batch)
            run = lambda: trainer._train_step(state, local, seeded())  # noqa: E731
            new, metrics = run()
            full = trainer.full_state(new)
            if rank == 0:
                dev_by_dtype[dtype] = _deviations(metrics, full, *reversed(refs[dtype]))
            if dtype == torch.bfloat16:
                torch.cuda.reset_peak_memory_stats(dev)
                ms = step_ms(run)
                peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                audit = audit_train_step(run, steps=2)
                sharded = sum(s is not None for s in trainer.placement.specs.values())
            del trainer, state, new, full
            torch.cuda.empty_cache()
        if rank == 0:
            f32, b16 = dev_by_dtype[torch.float32], dev_by_dtype[torch.bfloat16]
            passed = f32["loss"] <= 1e-5 and f32["grad_norm"] <= 1e-4 and f32["bn"] and f32["leaf"] <= 2.5 * LR
            ok = ok and passed
            print(f"{name} on {world} cards ({sharded} leaves sharded): f32 loss rel {f32['loss']:.2e}, grad_norm rel "
                  f"{f32['grad_norm']:.2e}, BN statistics within rtol 1e-3 / atol 1e-6 {f32['bn']}, leaves "
                  f"{f32['leaf']:.2e} (bars 1e-5, 1e-4, -, {2.5 * LR:.1e}): {'held' if passed else 'MISSED'}; bf16 "
                  f"(not held) loss rel {b16['loss']:.2e}, grad_norm rel {b16['grad_norm']:.2e}, BN {b16['bn']}, "
                  f"leaves {b16['leaf']:.2e}; bf16 {ms:.2f} ms/step, peak {peak:.2f} GiB on rank 0 ({label})\n"
                  f"{audit.table()}", flush=True)
        dist.barrier()

    mesh = make_mesh(world, 1)
    g = torch.Generator(device=dev).manual_seed(SEED + 143)
    raw = torch.rand((600, 970), generator=g, device=dev) * 2 - 1
    ec = torch.rand((600, 5994), generator=g, device=dev) * 2 - 1
    tc = torch.rand((970, 5994), generator=g, device=dev) * 2 - 1
    got = asnorm_device(raw, ec, tc, top_n=300, mesh=mesh)
    t0 = time.perf_counter()
    for _ in range(10):
        asnorm_device(raw, ec, tc, top_n=300, mesh=mesh)
    torch.cuda.synchronize()
    mesh_ms = (time.perf_counter() - t0) * 100
    if rank == 0:
        want = asnorm_device(raw, ec, tc, top_n=300)
        t0 = time.perf_counter()
        for _ in range(10):
            asnorm_device(raw, ec, tc, top_n=300)
        torch.cuda.synchronize()
        one = (time.perf_counter() - t0) * 100
        err = float((got - want).abs().max())
        held = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))
        ok = ok and held
        print(f"asnorm_device over {world} cards: max abs err {err:.3e} against one card (rtol 1e-5: "
              f"{'held' if held else 'MISSED'}); {mesh_ms:.3f} ms a call beside one card's {one:.3f} (host clock "
              f"around 10 calls)", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
