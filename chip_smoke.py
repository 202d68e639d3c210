"""Chip smoke test of asv_subtools_tpu_torch on one NVIDIA GPU (written for the H100).

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device and build: the card's name and power limit; the four CUDA
     kernels built from asv_subtools_tpu_torch/csrc with nvcc, one process
     per source, all started together.
  2. K1 fused fbank against its plain version on the card: the f32 DFT (the
     CUDA-core kernel) and the bf16 DFT (the tensor-core kernel) at
     [128, 160000] with 80 bins, a ragged [3, 20480] batch with 23 bins and
     the log-energy through both, a bf16 batch whose length is not a
     multiple of 4 samples, and a frame shift the tensor-core kernel hands
     to the CUDA-core one; kernel and plain times.
  3. K2 fused attentive pooling against its plain version and the unfused
     module at x [128, 998, 1536] (bf16 and f32, lengths 200..998; x as
     the model hands it over, a [B, T, C] view of [B, C, T] memory, and
     once as contiguous [B, T, C]), and a case whose logits exceed 80
     against the unfused path; times on the model's layout beside the
     plain version and the unfused module, the kernels' split by launch,
     and once the old reading on contiguous x (the wrapper's copy in it).
  4. K3 fused Res2Net chain against its plain version and the unfused
     Res2NetBlock at x [128, 998, 1024] for dilation 2, 3, 4 (bf16 and
     f32), a ragged case (T = 197, h = 16, B = 3) and a case that shows
     frames past T do not leak into valid ones; times.
  5. K4 fused statistics pooling against its plain version and the unfused
     StatisticsPooling at [128, 125, 2560] and [64, 1000, 1536] (bf16 and
     f32, lengths T/7..T, and without a mask), and a mask that is not a
     prefix, whose frame 0 is masked and holds inf; times of the ring kernel,
     the direct kernel, the plain version and torch.std_mean on three
     clocks (see "Clocks" below).
  6. the served path at full width: ECAPA-TDNN C1024 (seeded random
     weights, bf16) behind make_wave_embed_fn on one [128, 160000] batch,
     timed, and its embeddings held against the same model fed by the plain
     front end (bf16) and an f32 model fed by the f32 plain front end; then
     an Extractor over 48 seeded utterances of 1.5-25 s writing a vector
     ark/scp, cosine scoring and EER; and one C1024 pooling through
     EcapaAttentiveStatsPool(fused_inference=True) on the model's MFA
     output; then the same batch with the three Res2NetBlocks switched to
     the fused chain, and with every flag on (the chains and the attentive
     pooling fused), each held against the unfused bf16 model and the f32
     model and timed in turns with the flags-off batch; the batch with
     every flag on profiled.
  7. the ResNet34 x-vector served at full width and depth (base32, layers
     3-4-6-3, embedding 512, seeded random weights, bf16) behind
     make_wave_embed_fn on one [128, 160000] batch with the fused
     statistics pooling on, held against the same model with the flag off
     fed by the plain front end and against an f32 model on the f32 plain
     front end; timed with the flag on and off; one batch profiled; then the Extractor run as in 6.
     The launch counters are zeroed just before each of the nineteen
     main paths (6 to 24) drives the port and read just after; every
     kernel of a path must have been launched in it.
  8. the train step of ECAPA-TDNN C1024 (SpeakerNet with the sub-centre
     top-k AAM head over 5994 classes, seeded random weights, bf16
     compute on f32 masters) on raw waves at B=128 x 2 s, K1 inside the
     step: K1 at the training shape [128, 32000] against its plain version
     and timed beside its bound; 30 adamW steps on one fixed batch, queued
     back to back, the median ms/step of 20 of them, audio-s/s, the host's
     time to queue a step, K1's launches per step and the peak memory, one
     step profiled, and every loss finite and the last below the first;
     five steps of the recipe's optimizer (adamW, cyclic triangular2,
     MarginWarm feeding the margin, accum_grad 2) on a masked batch of
     1.0-2.0 s. Every one of these steps runs under
     torch.cuda.set_sync_debug_mode("error"): a step that waits on the
     card fails the run. Then one f32 SGD step of an ECAPA C256 at B=8 on
     the card and on the CPU, loss and grad_norm against each other and
     each leaf against the f64 step, and the f64 step on the card against
     the CPU leaf by leaf. The counters are zeroed just before the first
     step and read just after.
  9. the train step of the ResNet34 x-vector (bench.py:75-81: base32,
     layers 3-4-6-3, embedding 512, AAM m=0.2 over 5994 classes) on the
     same terms as 8 (B=128 x 2 s, bf16 on f32 masters, adamW 1e-3, K1 in
     the step): 30 steps on one fixed batch under the sync check, 20 of
     them timed, one profiled, the last loss under half the first; then a
     narrow ResNet's f32 and f64 steps, card against CPU, with 8's bounds
     (the stem BN's running mean, the mean of a zero-mean map, measured
     against its std: train/step_check.py worst_stat).
 10. the Conformer x-vector served at full width and depth (6L-256D-4H,
     conv2d subsampling, embedding 256, bf16) behind make_wave_embed_fn on
     one [128, 160000] batch, held against the same model fed by the
     plain front end and against an f32 model on the f32 plain front end
     (0.999: the bf16 model's own rounding moves it by about 4e-4 under
     input changes of K1's size), and K1 through the f32 model (its
     features against the plain bf16 front end's, 0.9999); timed; one
     batch profiled; then the Extractor run as in 6.
 11. the train step of the Conformer x-vector (bench.py:82-90, dropout 0.1
     drawn from the step's generator) as in 9, but for the last loss,
     held below the first (as in 8) rather than under half; then five steps of the
     recipe's configuration (recipes/configs/conformer.yaml: AM m=0.2,
     model_warmup_steps 1000, adamW on the noam schedule) on a masked
     batch of 1.0-2.0 s, where warmup < 1 blends every block; then a
     narrow Conformer's card-against-CPU steps as in 9.
 12. the recipe's stages 0-3 through the port's Launcher
     (recipes/voxceleb/run.py:80-130 as asv_subtools_tpu_torch.recipes.voxceleb
     builds them: ECAPA-TDNN C1024, embedding 192, the sub-centre top-k
     AAM head, adamW 1e-3 wd 5e-5 on the cyclic schedule, MarginWarm over
     epochs 1-3, bf16, 80 bins, wave input with SpecAugment and speed
     perturbation, 2.015 s chunks, B=128, 64 utterances held out for
     validation, two spawn loader workers; the shuffle buffer cut from
     1,000 to 256 with the corpus) on a synthetic corpus written to a
     temporary directory (64 sinusoid speakers, 40 training utterances of
     2.5-4.0 s each and 2 evaluation utterances of 1.5-12 s): first K1
     against its plain version at the recipe's shapes (a train batch of
     128 corpus waves at 32,240 samples, and an extraction batch at its
     bucket), outside the counted window; then two epochs, a resume from
     checkpoints/2.params for a third, the training and evaluation lists
     extracted to ark/scp in wave mode, and stage 3: Launcher.score on
     those ark/scp with the recipe's configuration (submean + length-norm
     cosine, AS-norm top 300 over the first 3,000 sorted training vectors,
     enroll = test = the evaluation list) against the corpus's eval/trials
     (every target pair and as many nontarget pairs), the cosine matrices
     on the card. Per epoch: steps, median ms/step (CUDA
     events), the host's wait for each batch and its turn per step, loss,
     accuracy, validation loss, and the same from the third step on (the
     steady pace, after the pool's start and the shuffle buffers' fill);
     then the extractions' stats, and stage 3's EER and minDCF (not gated),
     its seconds and its copies of a cosine matrix to the host (three:
     raw, enroll-cohort, test-cohort). Checks: every loss finite; K1 launched once a step and once
     an extraction batch; the host waits in an epoch (counted under
     set_sync_debug_mode("warn")) are exactly the Trainer's fetches: the
     step counter at the start, each report point and the end; every
     loader worker reports, at the end of each epoch it served, an empty
     CUDA_VISIBLE_DEVICES and no CUDA initialised; the checkpoint reloads
     bit for bit and the resumed epoch starts at its step; the ark/scp
     reads back; the first 8 evaluation embeddings against the same model
     through the plain front end at cosine 0.9999; stage 3 scored every
     trial on the card with three copies and finite metrics. Last, outside the
     counted window, the resumed Trainer runs four more epochs in turns:
     from batches held in pinned memory (no loader, no Prefetcher thread),
     from the live loader through the Prefetcher, the live loader, memory;
     their steady ms/step and host turn per step are printed side by side.
 13. the scoring back end at scale (backend/, TF32 off), on
     speaker-structured embeddings drawn from the seed: asnorm_device at
     the shape of tests/test_backend_scale.py (600 x 970 trials, a cohort
     of 5,994, D=256, top 300; the cosine matrices from
     cosine_score_matrix on the card) against the f64 host asnorm at rtol
     2e-3, atol 2e-4; llr_matrix_device at 600 x 970, D=256, from a PLDA
     fitted on 200 speakers x 8 (5 EM iterations) against the f64
     Plda.llr_matrix on the whole matrix at rtol 2e-3, atol 2e-3; card
     times from CUDA events, host times beside them. Then ScoreSets end to
     end at VoxCeleb1-O scale (4,874 evaluation vectors of D=192, 37,720
     trials, half target; fit on 5,994 speakers x 8): the recipe's cosine
     AS-norm configuration (cohort 3,000) and mean-lda-submean-whiten-norm
     + PLDA (LDA to 128, 10 EM iterations), each with its fit and scoring
     seconds and its EER and minDCF (not gated), and the card time of the
     three cosine matrices. Fails on a missed tolerance, a result that is
     not finite, or a device result off the card. No kernel runs here (the
     counters are read to show it).
 14. the TDNN x-vectors served at full width (recipes/configs/
     snowdar_xvector.yaml: SnowdarXvector 512/512, 1500-channel pooling;
     factored_xvector.yaml: FactoredXvector width 1.0, 2048 channels;
     seeded random weights, bf16) behind make_wave_embed_fn on one
     [128, 160000] batch, the statistics pooling fused (K4) and unfused,
     each held against the unfused bf16 model on the plain front end
     (0.9999) and an f32 model on the f32 plain front end (0.999), and
     each fused model through the Extractor as in 6; after the counted
     window, ms/batch fused and unfused in turns, one batch profiled, and
     K4 on each model's own pooling input (a [B, T, D] view of [B, D, T]
     memory): its route, against its plain version (phase 5's tolerance),
     its time beside its bound, the wrapper's copy of x alone, the kernel
     on a packed copy, torch.std_mean and the plain version.
 15. the train steps of the same two models on their configurations (AM
     m=0.2 over 5994 classes, SGD 1e-2 on warmR, momentum 0.9 for the
     snowdar one, use_semi_orth for the F-TDNN), as in 9 (B=128 x 2 s,
     bf16 on f32 masters, K1 in the step, 30 steps under the sync check,
     the last loss below the first), the F-TDNN's semi-orthogonal
     objective of layer02's factor1 after steps 0, 4, 8, ... (it must
     fall at step 0); then a narrow F-TDNN's (width 0.125) f32 and f64
     steps with use_semi_orth over step 0, card against CPU, with 8's
     bounds.
 16. the OLR language-identification recipe's stages 0-3 through
     asv_subtools_tpu_torch.recipes.olr (extended_xvector width 512, AM
     m=0.2, SGD 1e-2 on warmR, 3.0 s chunks, B=256, host fbank) on a
     synthetic corpus of 10 languages (128 training utterances of
     2.5-4.0 s each, 8 evaluation ones), two epochs; stage 3's logistic
     regression by the lbfgs solver (scipy: the script needs no sklearn). Per
     epoch ms/step, the host's wait, loss and accuracy; the extraction;
     Cavg and EER% (not gated). Checks: finite losses, the ark/scp read
     back, a finite Cavg, and no kernel launched (the counters read).
 17. RepVggXvector served at full width and depth (repvgg.yaml: RepSPK
     blocks 2-4-14-1, base 32, width (1, 1, 1, 2.5), embedding 256;
     seeded random weights, running statistics away from (0, 1)) behind
     make_wave_embed_fn on one [128, 160000] batch in bf16: the train
     shape with K4 fused and unfused, and the deployed model
     (deploy_repvgg_xvector, K4 fused), each held against the unfused
     bf16 train shape on the plain front end (0.9999; the deployed bf16
     model 0.999: its trunk rounds at other places) and the f32 train
     shape on the f32 plain front end (0.999); the deployed f32 model
     against the f32 train shape per utterance at 0.99999; the Extractor
     run with each shape. After the counted window: ms/batch in turns and
     which shape is the faster, one batch of each shape profiled, and K4
     on the model's own pooling input [128, 125, 6400] as in 14.
 18. ECAPA-TDNN C1024 with MQMHA pooling (ecapa_roadmap.yaml) served with
     its three Res2 chains unfused and fused (K3), held as in 6, the
     Extractor run, timed in turns, one batch profiled.
 19. the lawlict ECAPA-TDNN C512 (ecapa_lawlict.yaml) served as in 6 (K1
     its only kernel), the Extractor run, timed, one batch profiled.
 20. the train steps of the three models on their presets, as in 9 (B=128
     x 2 s, bf16 on f32 masters, K1 in the step, 30 steps under the sync
     check, the last loss below the first): RepVGG with AAM m=0.2 through
     margin_softmax_v1, sgd 1e-2 on warmR; the MQMHA ECAPA with the
     sub-centre top-k AAM head, adamW on 1cycle and MarginWarm; lawlict
     with AM m=0.2, adamW on cyclic triangular2; then a narrow RepVGG's
     f32 and f64 steps, card against CPU, with 8's bounds.
 21. the repo's EER gates through the port's own functions
     (asv_subtools_tpu_torch/recipes: the counterparts of recipes/
     quality_gate.py, roadmap_gate.py, antispoof_gate.py,
     adaptation_gate.py, demo_synthetic.py and repvgg_deploy_gate.py) at a
     cut: the quality gate (seed 7, 48 speakers, ECAPA C128, B=64 x 2 s,
     bf16, K1 in the step), the anti-spoof gate (OCSoftmax, its pool of
     480 pairs), the adaptation gate (48 + 24 + 24 speakers) and the demo
     (64 harmonic voices, AS-norm) at GATE_STEPS steps each; the roadmap
     gate's MQMHA config at GATE_STEPS steps and its LM finetune at
     GATE_LM_STEPS; the RepVGG deploy gate on a synth_datadir corpus of
     24 speakers x 8 + 4 utterances for one epoch. The gates' synthesis
     renders in worker processes. Checks: every loss finite and the last
     below the first (the roadmap's MarginWarm config: below the loss of
     the step from which the margin is full; the LM finetune's 10 steps at
     lr under 5e-5 and RepVGG's one epoch loss: finite),
     each gate's JSON line holding its JAX counterpart's keys, the RepVGG
     fold's mean cosine above 0.999, and K1 launched in the phase. The
     EERs are printed, not gated, at this cut.
 22. the offline chunk-egs route through the port's Launcher. Host
     preparation (not on the card): a synthetic corpus of 64 speakers x 24
     utterances of 2.5-4.0 s (2 evaluation ones of 1.5-12 s) through the
     Kaldi-style host front end (recipes/synthetic.py
     write_feature_datadir: 80-bin fbank with dither 1.0 from a seeded
     numpy generator, energy VAD with VadOptions(), sliding CMVN, the
     voiced frames) to a feature ark/scp with utt2num_frames, seeded
     128-phone alignments and 9 auxiliary classes, prepare_egs_dir (chunk
     200, 64 utterances held out); K1 against its plain version at
     find_lr's shape (the recipe's 2.015 s chunk), outside the counted
     window. Then: multitask.yaml at full width (MultiTaskXvector 512,
     tdnn5 1500, embedding 512, phonetic branch 3x512, the softmax head,
     sgd on warmR, bf16) on the offline egs at B=128 x 200 frames x 80
     with two spawn workers for one epoch: ms/step by CUDA events, the
     host's data wait, the losses every 4 steps (they must be finite and
     fall), speaker accuracy, the phone loss and accuracy on a validation
     batch, and host waits exactly the Trainer's fetches; fd_xvector at
     full width (9 aux classes, cycle 4, 2 adversary steps) for one epoch
     through the Launcher's Trainer (losses finite and falling, host
     waits the Trainer's), then a cycle on the card under the sync check
     where an adversary step moves the DAL projections alone and a main
     step every other leaf; snowdar_xvector.yaml with train.sam rho 0.05
     for one epoch (losses finite and falling, host waits the Trainer's)
     and a SAM step against the plain step on one batch under the sync
     check; Launcher.find_lr on the voxceleb recipe's Launcher (ECAPA
     C1024, adamW, wave input, K1 in the step) for 20 steps: K1 once a step,
     one host wait a step, the raw losses finite and the smoothed curve
     their debiased running mean; the multi-task and FD x-vectors served at
     full width behind make_wave_embed_fn on one [128, 160000] batch with
     K4 fused and unfused, held against the unfused bf16 model on the
     plain front end (0.9999) and an f32 model (0.999); Launcher.extract
     of the evaluation list in wave mode (K1) and feature mode (host
     features, ExtractConfig.batch_sizes). K1 and K4 must launch in that
     window. After it: K4 against its plain version on the served
     models' pooling inputs, and extract_embedding_chunked on the
     utterances longer than 400 frames against their chunks embedded one
     at a time (cosine 0.99999).
 23. the step options, the reference's own optimizers and the ReConformer
     at full width (B=128 x 2 s of raw waves, bf16 on f32 masters, K1 in
     the step, 5994 classes, every step under the sync check): ECAPA-TDNN
     C1024 with mixup (alpha 1.0, the sub-centre head, adamW) for 30 steps
     on one batch as in 8, and its ms/step beside the plain step in four
     turns of five steps; the four remat policies (None, dots, dots_batch,
     full) on ECAPA C1024: ms/step, peak memory and K1 launches a step, and
     one SGD step of each from one state, batch and generator seed against
     the no-remat step, on ECAPA and on the bench's Conformer with dropout
     0.1 (loss and BN statistics to 1e-5, grad_norm to 1e-3, the whole
     update to 1e-2; the no-remat step run twice printed beside them);
     ralamb, adamod, novograd, eve, adamW with gc and sgd with lookahead
     (k 5, alpha 0.5), 10 steps each beside adamW's, every loss finite and
     the count at 10; the ReConformer of recipes/configs/reconformer.yaml
     (6L-256D-4H, re_conv2d, embedding 256) served behind
     make_wave_embed_fn on one [128, 160000] batch, held against the same
     model on the plain front end, the f32 model on the plain bf16-DFT
     front end and K1 through the f32 model (phase 10's bars), timed, one
     batch profiled; trained on its AM head with adamW on noam and the
     model warm-up (1000 steps) for 30 steps as in 8 (finite, no fall
     required: noam's lr at step 30 is 4.7e-7); then a narrow
     ReConformer's f32 and f64 steps, card against CPU, with 8's bounds.
 24. the rest of the Conformer family at full width (B=128, bf16 on f32
     masters, K1 in every served batch and train step, AM m=0.2 over 5994
     classes, adamW 1e-3, seeded random weights): (a) the Transformer
     x-vector (transformer_type "transformer", 6L-256D-4H, linear units
     2048, conv2d, embedding 256) and (b) a Conformer that runs the new
     attention modules (6L-256D-4H, conv2d2, GAU with 512 units and key 64,
     RoPE, softmax_plus, the T5 bias, layer drop 0.1 and dynamic chunks
     with left chunks in training; a union of options, not a published
     configuration). Each is served behind make_wave_embed_fn on one
     [128, 160000] batch and held against the same model on the plain
     front end, the f32 model on the f32 plain front end and K1 through
     the f32 model (phase 10's bars), timed, one batch profiled, and run
     through the Extractor as in 6; trained for 30 steps on one batch as in
     8 (the last loss under the first); and a narrow copy of each takes
     one f32 and one f64 step, card against CPU, with 8's bounds. Then
     every other option of the family, narrow (2 blocks, d = 64), one f32
     eval forward each on features, card against CPU at 1e-5 of the
     output's scale.
 25. ASV-Subtools checkpoints and the serving path. Built here from a
     seed: an ASV-Subtools ECAPA-TDNN C1024 state_dict (the reference's
     keys and shapes, 80 bins, MFA 1536, embedding 192, masked full-width
     Res2 kernels, num_batches_tracked, a [5994, 192, 1] loss.weight) and
     a ResNet34 (base 32). (a) Each converted on the host (timed), loaded
     onto the card and served behind make_wave_embed_fn on one
     [128, 160000] bf16 batch, ECAPA with every flag on (K1, K2, K3) at
     cosine 0.999 against the same model with the flags off on the plain
     front end and 0.999 against the f32 model on the f32 plain front
     end, ResNet34 with K4 at 0.9999 and 0.999; timed. (b) The served
     ECAPA's weights exported back (reverse_convert): equal to the input
     bit for bit at every covered position, the uncovered ones exactly
     the masked taps and the num_batches_tracked. (c) The converted ECAPA
     with int8_inference (7 int8 GEMMs a batch) at cosine 0.999 against
     the bf16 batch, ms/batch beside bf16; the int8 product at the MFA's
     shape card against CPU, int32 exact; quantize_params of the weights
     (error < 1%, size < 1/3.5, the dequantized model at cosine 0.999).
     (d) export_embed_fn at b1_t400 and b32_t1600 (K2 and K3 on), saved,
     loaded and run on the card at cosine 0.99999 against eager, one K2
     and three K3 launches a call (counters and profiler), ms a call.
     (e) EmbeddingServer on the card: 4 client threads x 32 requests of
     200-2000 frames through embed_request, each reply within 0.99999 of
     server.embed, a bad magic answered with E = 0; requests/s, p50/p99
     latency and launches a request.
 26. a "kernels" JSON line, then the device JSON as the last line.

Clocks. A kernel's time ("ms", "plain_ms", "library_ms" of the kernels
line) is device time over many launches back to back: one CUDA event, N
calls, one event, divided by N; the median of five such runs after
warm-up, in plain / kernel / kernel / plain turns. The inputs are larger
than the 50 MB L2 (K1's wave and K4's x at [128, 125, 2560] are 82 MB, K4's
x at [64, 1000, 1536] 197 MB, K2's and K3's x 392 and 262 MB), so calls
that follow each other still read from device memory. Back to back is not
enough where the host takes longer to enqueue a call than the card takes
to run it: for K4 and torch.std_mean (tens of microseconds) the kernels'
own durations are also read from torch.profiler, summed per call; that is
the kernels line's time for K4, and the per-call time (events around one
call on an idle card: what a lone caller waits) is printed beside it. A
profiler reading is refused, and the back-to-back time taken instead,
where the trace holds fewer kernels with a device duration than the host
launched (a trace that lost kernels reads short).

f32 comparisons run in true f32: this script sets
torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
to False (PyTorch's default for cuDNN convolutions is TF32).
"""

from __future__ import annotations

import contextlib
import copy
import json
import re
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

SEED = 0
BATCH, SAMPLES = 128, 160000  # bench.py:196-198: B=128 x 10 s at 16 kHz
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # H100 SXM dense; f32 outside the tensor cores
# the __global__ functions of asv_subtools_tpu_torch/csrc, as the profiler's kernel names hold them
OWN_KERNELS = ("fbank_kernel", "fbank_mma_kernel", "stats_kernel", "stats_ring_kernel", "combine_kernel",
               "res2_kernel", "res2_mma_kernel", "glob_kernel", "attend_kernel", "attend_mma_kernel",
               "att_stats_kernel")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def median_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median of per-call CUDA-event times after warm-up: what one caller
    waits on an idle card, the host's enqueue included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(torch, fn, n: int, warmup: int = 3, runs: int = 5) -> float:
    """ms per call over n calls back to back between two CUDA events: the
    median of `runs` such runs after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def turns_ms(torch, run_plain, run_kernel, n: int):
    """(plain, kernel) back-to-back device times, the best of two turns in
    the order plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (device_ms(torch, f, n) for f in (run_plain, run_kernel, run_kernel, run_plain))
    return min(p1, p2), min(k1, k2)


def _profile(torch, fn, n: int):
    """({kernel name: ms per call}, kernels with a device duration, kernel
    launches the host made) over n calls under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split, kernels, launched = {}, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            split[e.name] = split.get(e.name, 0.0) + e.device_time_total / 1e3 / n
            kernels += not e.name.startswith(("Memcpy", "Memset"))
        elif "LaunchKernel" in e.name:  # cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel(Ex)
            launched += 1
    return split, kernels, launched


def profiled_split(torch, fn, n: int = 20) -> dict:
    """{kernel name: ms per call} of the kernels' own device durations over
    n calls under torch.profiler; empty if the profiler saw no device time."""
    return _profile(torch, fn, n)[0]


def profiled_ms(torch, fn, n: int = 20):
    """(ms per call of the kernels' own device durations, summed over n
    calls under torch.profiler, or None; what the profiler saw). The
    reading is refused (None) where the profiler saw no device time, or
    fewer kernels with a device duration than the host launched: a trace
    that lost kernels reads short."""
    split, kernels, launched = _profile(torch, fn, n)
    seen = f"{kernels} kernels with a device duration for {launched} launches over {n} calls"
    return (sum(split.values()) if split and kernels >= launched else None), seen


def print_split(what: str, split: dict) -> None:
    """One line: each kernel's device ms per call, longest first."""
    if not split:
        print(f"{what} split by kernel: the profiler recorded no device time (not measured)", flush=True)
        return
    parts = ", ".join(f"{name[:60]} {ms:.4f}" for name, ms in sorted(split.items(), key=lambda kv: -kv[1]))
    print(f"{what} split by kernel (device ms per call, sum {sum(split.values()):.4f}): {parts}", flush=True)


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(torch, a, b, atol: float, rtol: float) -> bool:
    return bool(torch.allclose(a.float(), b.float(), atol=atol, rtol=rtol))


def bound_ms(nbytes: float, flops: float, peak: str = "bf16"):
    """The least time for the work, and which of the two times sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak]
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def cosine(a, b):
    a, b = a.float(), b.float()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} | nvidia-smi: {smi}", flush=True)
    from asv_subtools_tpu_torch.kernels import _build

    secs = _build.build()
    print(f"build: {secs:.1f} s for {', '.join(_build.SOURCES)}", flush=True)
    return name, smi


def phase_fbank(torch):
    from asv_subtools_tpu_torch.features import (FbankOptions, FrameOptions, MelOptions, fused_fbank,
                                                 fused_fbank_plain)
    from asv_subtools_tpu_torch.features.fused_fbank import folded_dft, mel_bands

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    opts80 = FbankOptions(mel_opts=MelOptions(num_bins=80))
    wave = torch.randn((BATCH, SAMPLES), generator=gen, device=dev) * 1000.0
    # tolerance: both sides multiply the same f32 (or bf16-rounded) values
    # and sum in f32, in another order (the tensor cores also align the
    # products of a k-step before adding them); log-mel values move by ~1e-5
    tol = 1e-3
    routes = {"f32": "cuda_core", "bf16": "tensor_core"}
    dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))
    errs = {}
    for label, dt in dtypes:
        k, _ = fused_fbank(wave, opts80, dft_dtype=dt, with_energy=False)
        check(fused_fbank.last_route == routes[label], f"K1 {label} ran the {fused_fbank.last_route} kernel")
        p, _ = fused_fbank_plain(wave, opts80, dft_dtype=dt, with_energy=False)
        torch.cuda.synchronize()
        check(k.shape == (BATCH, 998, 80), f"fbank shape {tuple(k.shape)}")
        errs[label] = max_abs(k, p)
        print(f"K1 fbank {label} ({routes[label]}) [128,160000]x80: max abs err {errs[label]:.3e} (tol {tol})",
              flush=True)
        check(errs[label] <= tol, f"K1 {label} disagrees with its plain version")
    # ragged: T = 126 (a tile edge inside a row, the last tile of 62 frames),
    # 23 bins, with the log-energy, through both kernels; then a length that
    # is not a multiple of 4 samples, and a frame shift of 124 samples, which
    # the tensor-core kernel hands to the CUDA-core one
    ragged = torch.randn((3, 20480), generator=gen, device=dev) * 1000.0
    t_ragged = FbankOptions().frame_opts.num_frames(20480)
    for label, dt in dtypes:
        k, ke = fused_fbank(ragged, FbankOptions(), dft_dtype=dt, with_energy=True)
        check(fused_fbank.last_route == routes[label], f"K1 ragged {label} ran the {fused_fbank.last_route} kernel")
        p, pe = fused_fbank_plain(ragged, FbankOptions(), dft_dtype=dt, with_energy=True)
        e1, e2 = max_abs(k, p), max_abs(ke, pe)
        print(f"K1 fbank {label} [3,20480]x23 ({t_ragged} frames): max abs err {e1:.3e}, log-energy {e2:.3e} "
              f"(tol {tol})", flush=True)
        check(k.shape == (3, t_ragged, 23) and e1 <= tol and e2 <= tol, f"K1 ragged {label} case disagrees")
    odd = torch.randn((2, 48077), generator=gen, device=dev) * 1000.0
    shift124 = FbankOptions(frame_opts=FrameOptions(frame_shift_ms=7.75), mel_opts=MelOptions(num_bins=40))
    for what, w, o, route in (("[2,48077]x80", odd, opts80, "tensor_core"),
                              ("[3,20480]x40 shift 124", ragged, shift124, "cuda_core")):
        k, _ = fused_fbank(w, o, dft_dtype=torch.bfloat16, with_energy=False)
        check(fused_fbank.last_route == route, f"K1 bf16 {what} ran the {fused_fbank.last_route} kernel")
        p, _ = fused_fbank_plain(w, o, dft_dtype=torch.bfloat16, with_energy=False)
        e = max_abs(k, p)
        print(f"K1 fbank bf16 {what} ({route}): max abs err {e:.3e} (tol {tol})", flush=True)
        check(k.shape == p.shape and e <= tol, f"K1 bf16 {what} disagrees")

    run_k = lambda: fused_fbank(wave, opts80, dft_dtype=torch.bfloat16, with_energy=False)
    run_p = lambda: fused_fbank_plain(wave, opts80, dft_dtype=torch.bfloat16, with_energy=False)
    ms_p, ms_k = turns_ms(torch, run_p, run_k, n=10)
    ms_f32 = device_ms(torch, lambda: fused_fbank(wave, opts80, dft_dtype=torch.float32, with_energy=False), n=5)
    fo = opts80.frame_opts
    t = fo.num_frames(SAMPLES)
    nnz = mel_bands(opts80)[1].size
    flops = 2.0 * BATCH * t * (fo.window_size * 2 * (fo.padded_window_size // 2) + nnz)
    nbytes = 4 * wave.numel() + 4 * BATCH * t * 80 + 2 * folded_dft(opts80).size
    bound, by = bound_ms(nbytes, flops)
    print(f"K1 bf16 times (ms, 10 launches back to back): tensor-core kernel {ms_k:.4f} plain {ms_p:.4f}; "
          f"the f32 CUDA-core kernel {ms_f32:.4f}; bound {bound:.4f} by {by} ({flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return {
        "name": "fused_fbank", "route": "cuda",
        "source": "asv_subtools_tpu_torch/csrc/fbank.cu",
        "replaces": "asv_subtools_tpu/features/pallas_fbank.py:228",
        "max_abs_err": errs["bf16"], "ms": ms_k, "plain_ms": ms_p,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }


def _pool_module(torch, channels, dtype, seed):
    from asv_subtools_tpu_torch.models import EcapaAttentiveStatsPool
    from asv_subtools_tpu_torch.weights import init_ecapa_weights_

    mod = EcapaAttentiveStatsPool(channels)
    init_ecapa_weights_(mod, seed)
    gen = torch.Generator().manual_seed(seed)
    mod.att_bn.mean.copy_(torch.randn(mod.att_bn.mean.shape, generator=gen) * 0.1)
    mod.att_bn.var.copy_(torch.rand(mod.att_bn.var.shape, generator=gen) * 1.5 + 0.5)
    mod.att1.bias.data.copy_(torch.randn(mod.att1.bias.shape, generator=gen) * 0.1)
    return mod.to(device="cuda", dtype=dtype).eval()


def _pool_args(mod, x):
    d = x.shape[-1]
    k = mod.att1.kernel[0]
    s, t = mod.att_bn.folded()
    return (x, k[:d], k[d:2 * d], k[2 * d:], mod.att1.bias, s, t,
            mod.att2.weight[..., 0].t().contiguous(), mod.att2.bias)


def phase_att_pooling(torch):
    from asv_subtools_tpu_torch.nn import fused_attentive_stats_pool, fused_attentive_stats_pool_plain

    dev = torch.device("cuda")
    b, t, c = BATCH, 998, 1536
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x_ct32 = torch.randn((b, c, t), generator=gen, device=dev)  # the model's [B, C, T] memory
    x32 = x_ct32.transpose(1, 2)  # [B, T, C] view, as the model hands it over
    lengths = torch.linspace(200, t, b, device=dev).round().long()
    mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    # tolerance: f32 sums in another order (2e-4, the JAX tests' bound);
    # with bf16 inputs both sides round the hidden h to bf16, and another
    # summation order can move a value across a rounding boundary
    tols = {"f32": 2e-4, "bf16": 2e-2}
    errs = {}
    with torch.inference_mode():
        for label, dt, layout in (("f32", torch.float32, "view"), ("bf16", torch.bfloat16, "view"),
                                  ("bf16", torch.bfloat16, "contiguous")):
            mod = _pool_module(torch, c, dt, SEED)
            x = x32.to(dt) if layout == "view" else x32.to(dt).contiguous()
            args = _pool_args(mod, x)
            k = fused_attentive_stats_pool(*args, mask=mask)
            route = fused_attentive_stats_pool.last_route
            check(route == ("tensor_core" if label == "bf16" else "cuda_core"),
                  f"K2 {label} ran the {route} kernel")
            p = fused_attentive_stats_pool_plain(*args, mask=mask)
            u = mod(x, mask)  # unfused module path
            torch.cuda.synchronize()
            e = max_abs(k, p)
            errs[label] = max(errs.get(label, 0.0), e)
            eu = max_abs(k, u)
            print(f"K2 att pooling {label} ({route}) [128,998,1536] ({layout} x) lengths 200..998: max abs err vs plain "
                  f"{e:.3e} (tol {tols[label]}), vs unfused module {eu:.3e}", flush=True)
            check(e <= tols[label], f"K2 {label} ({layout} x) disagrees with its plain version")
            close = (eu <= tols["f32"] if label == "f32"
                     else torch.allclose(k.float(), u.float(), atol=0.05, rtol=0.05))
            check(close, f"K2 {label} ({layout} x) disagrees with the unfused path")
        mod = _pool_module(torch, c, torch.float32, SEED)
        mod.att2.weight.mul_(400.0)
        args = _pool_args(mod, x32)
        h = torch.tanh(torch.relu(x32[:2] @ args[1] + args[4]))
        peak = float((h @ args[7]).abs().max())
        mod.fused_inference = True
        k = mod(x32, mask)
        mod.fused_inference = False
        u = mod(x32, mask)
        e_big = max_abs(k, u)
        # tolerance: logits of several hundred carry their f32 rounding
        # (~1e-4) into the softmax weights
        print(f"K2 large-logit case (|logit| up to ~{peak:.0f}): max abs err vs unfused {e_big:.3e} "
              f"(tol 1e-3)", flush=True)
        check(peak > 80 and e_big <= 1e-3, "K2 large-logit case disagrees with the unfused path")

        # times on the model's layout: x a [B, T, C] view of [B, C, T] memory
        mod = _pool_module(torch, c, torch.bfloat16, SEED)
        xb = x32.to(torch.bfloat16)
        full = torch.ones((b, t), dtype=torch.bool, device=dev)
        args = _pool_args(mod, xb)
        run_k = lambda: fused_attentive_stats_pool(*args, mask=full)
        run_p = lambda: fused_attentive_stats_pool_plain(*args, mask=full)
        ms_p, ms_k = turns_ms(torch, run_p, run_k, n=5)
        ms_u = device_ms(torch, lambda: mod(xb, full), n=5)  # the unfused module, flag off
        split = profiled_split(torch, run_k, n=10)
        # the old reading, once: contiguous [B, T, C] x, which the wrapper
        # first copies into [B, C, T] memory
        args_c = (xb.contiguous(),) + args[1:]
        ms_c = device_ms(torch, lambda: fused_attentive_stats_pool(*args_c, mask=full), n=5)
    kk = args[1].shape[1]
    flops = 2.0 * 2 * b * t * c * kk
    nbytes = 2 * xb.numel() + 2 * 4 * c * kk + b * t + 4 * 2 * b * c  # x, 4 weights, mask, f32 out
    bound, by = bound_ms(nbytes, flops)
    print(f"K2 bf16 times on the model's layout (ms, 5 launches back to back): kernel (tensor_core) {ms_k:.4f} "
          f"plain {ms_p:.4f} "
          f"unfused EcapaAttentiveStatsPool {ms_u:.4f}; kernel on contiguous [B, T, C] x (the wrapper's copy "
          f"included) {ms_c:.4f}; bound {bound:.4f} by {by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
          f"two reads of x (the design's floor) {2 * 2 * xb.numel() / HBM_BYTES_PER_S * 1e3:.4f}", flush=True)
    print_split("K2 bf16 kernel", split)
    return {
        "name": "fused_attentive_stats_pool", "route": "cuda",
        "source": "asv_subtools_tpu_torch/csrc/att_pooling.cu",
        "replaces": "asv_subtools_tpu/nn/pallas_att_pooling.py:132",
        "max_abs_err": errs["bf16"], "ms": ms_k, "plain_ms": ms_p,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }


def _res2_block(torch, dilation, dtype, seed):
    """A C1024 Res2NetBlock with seeded weights and non-trivial BN statistics."""
    from asv_subtools_tpu_torch.models import Res2NetBlock
    from asv_subtools_tpu_torch.weights import init_weights_

    block = init_weights_(Res2NetBlock(1024, dilation=dilation), seed)
    gen = torch.Generator().manual_seed(seed)
    r = lambda n, scale: torch.randn(n, generator=gen) * scale
    for stage in block.blocks:
        bn, conv = stage.act_bn.bn, stage.affine.conv
        bn.mean.copy_(r(128, 0.1))
        bn.var.copy_(torch.rand(128, generator=gen) * 1.5 + 0.5)
        bn.scale.data.copy_(1.0 + r(128, 0.1))
        bn.bias.data.copy_(r(128, 0.1))
        conv.bias.data.copy_(r(128, 0.1))
    return block.to(device="cuda", dtype=dtype).eval()


def phase_res2(torch):
    from asv_subtools_tpu_torch.nn import fused_res2_chain, fused_res2_chain_plain

    dev = torch.device("cuda")
    b, t, c, h, n = BATCH, 998, 1024, 128, 7
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x_ct32 = torch.randn((b, c, t), generator=gen, device=dev)  # the model's [B, C, T] memory
    # tolerance: f32, the same products summed in another order; bf16, one
    # bf16 ulp where such a sum crosses a rounding boundary, carried on by
    # the later stages (atol = rtol)
    tols = {"f32": 1e-4, "bf16": 2e-2}
    errs = {"f32": 0.0, "bf16": 0.0}
    times = {}
    with torch.inference_mode():
        for d in (2, 3, 4):
            for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                block = _res2_block(torch, d, dt, SEED + d)
                x_ct = x_ct32.to(dt)
                x = x_ct.transpose(1, 2)  # [B, T, C] view, as the model hands it over
                args = block.chain_args()
                k = fused_res2_chain(x, *args, dilation=d)
                route = fused_res2_chain.last_route
                check(route == ("tensor_core" if label == "bf16" else "cuda_core"),
                      f"K3 {label} dilation {d} ran the {route} kernel")
                p = fused_res2_chain_plain(x, *args, dilation=d)
                u = block(x_ct).transpose(1, 2)  # the unfused module: one conv per stage
                torch.cuda.synchronize()
                e, eu = max_abs(k, p), max_abs(k, u)
                errs[label] = max(errs[label], e)
                print(f"K3 res2 chain {label} [128,998,1024] dilation {d}: max abs err vs plain {e:.3e} "
                      f"(atol = rtol = {tols[label]}), vs unfused module {eu:.3e}", flush=True)
                check(tuple(k.shape) == (b, t, c) and k.dtype == dt, "K3 output shape or type")
                check(close(torch, k, p, tols[label], tols[label]), f"K3 {label} dilation {d} disagrees with its plain version")
                # the unfused bf16 module rounds each conv's output to bf16:
                # the JAX kernel test's scale, 0.06
                tol_u = 1e-3 if label == "f32" else 0.06
                check(close(torch, k, u, tol_u, tol_u), f"K3 {label} dilation {d} disagrees with the unfused module")
            # bf16 times at this dilation: block, x_ct, x, args are the bf16 ones
            run_k = lambda: fused_res2_chain(x, *args, dilation=d)
            run_p = lambda: fused_res2_chain_plain(x, *args, dilation=d)
            ms_p, ms_k = turns_ms(torch, run_p, run_k, n=5)
            ms_u = device_ms(torch, lambda: block(x_ct), n=5)
            block.fused_inference = True
            ms_m = device_ms(torch, lambda: block(x_ct), n=5)
            times[d] = (ms_k, ms_p, ms_u, ms_m)
            print(f"K3 bf16 dilation {d} times (ms, 5 launches back to back): kernel ({route}) {ms_k:.4f} "
                  f"plain {ms_p:.4f} unfused Res2NetBlock {ms_u:.4f} Res2NetBlock with the flag on {ms_m:.4f}",
                  flush=True)
            print_split(f"K3 bf16 dilation {d} kernel", profiled_split(torch, run_k, n=5))
        w_numel = args[0].numel()

        # ragged: T = 197 (two tiles), h = 16 (half a warp of channels), B = 3
        r = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale
        ragged = (r(3, 197, 128), r(n, 3, 16, 16, scale=48 ** -0.5), r(n, 16, scale=0.1),
                  1.0 + r(n, 16, scale=0.1), r(n, 16, scale=0.1))
        e = max_abs(fused_res2_chain(*ragged, dilation=4), fused_res2_chain_plain(*ragged, dilation=4))
        print(f"K3 res2 chain f32 [3,197,128] h=16 dilation 4: max abs err {e:.3e} (tol 1e-4)", flush=True)
        check(e <= 1e-4, "K3 ragged case disagrees")
        # frames past T read as zero at every stage: 16 more frames leave the head unchanged
        args4 = _res2_block(torch, 4, torch.float32, SEED).chain_args()
        x1 = r(1, 197, 1024)
        full = fused_res2_chain(x1, *args4, dilation=4)
        full2 = fused_res2_chain(torch.cat([x1, r(1, 16, 1024)], dim=1), *args4, dilation=4)
        e = max_abs(full[:, :150], full2[:, :150])
        print(f"K3 isolation: frames 0..149 with 16 frames appended, max abs diff {e:.3e} (tol 1e-6)", flush=True)
        check(e <= 1e-6, "K3 leaks frames past T into valid frames")

    flops = 2.0 * b * t * n * 3 * h * h
    nbytes = 2 * 2 * b * t * c + 2 * w_numel + 3 * 4 * n * h  # x in and out, weights, the three f32 vectors
    bound, by = bound_ms(nbytes, flops)
    mean = lambda i: float(np.mean([times[d][i] for d in (2, 3, 4)]))
    print(f"K3 bf16 mean over dilations (ms): kernel {mean(0):.3f} plain {mean(1):.3f} unfused module {mean(2):.3f}; "
          f"bound {bound:.4f} by {by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)", flush=True)
    return {
        "name": "fused_res2_chain", "route": "cuda",
        "source": "asv_subtools_tpu_torch/csrc/res2_chain.cu",
        "replaces": "asv_subtools_tpu/nn/pallas_res2.py:80",
        "max_abs_err": errs["bf16"], "ms": mean(0), "plain_ms": mean(1),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }


def phase_stats_pooling(torch):
    from asv_subtools_tpu_torch.nn import StatisticsPooling, fused_stats_pooling, fused_stats_pooling_plain
    from asv_subtools_tpu_torch.nn.fused_stats_pooling import _launch_kernel

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    pool = StatisticsPooling()
    # tolerance: both sides read the same values and sum in f32, in another
    # order. The unfused module works in x's type: in bf16 it rounds every
    # step, hence 0.05 (the bf16 bound of the attentive pooling)
    rtol, atol = 1e-4, 1e-5
    err_main = None
    results = {}
    with torch.inference_mode():
        for b, t, d in ((BATCH, 125, 2560), (64, 1000, 1536)):
            x32 = torch.randn((b, t, d), generator=gen, device=dev) + 0.5
            lengths = torch.linspace(t / 7, t, b, device=dev).round().long()
            mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
            for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                x = x32.to(dt)
                for m, what in ((mask, f"lengths {int(lengths[0])}..{t}"), (None, "no mask")):
                    k = fused_stats_pooling(x, m)
                    check(fused_stats_pooling.last_route == "ring", "K4 left the ring kernel at a served shape")
                    p = fused_stats_pooling_plain(x, m)
                    u = pool(x, m)
                    torch.cuda.synchronize()
                    e, eu = max_abs(k, p), max_abs(k, u)
                    print(f"K4 stats pooling {label} [{b},{t},{d}] {what}: max abs err vs plain {e:.3e} "
                          f"(rtol {rtol}, atol {atol}), vs unfused module {eu:.3e}", flush=True)
                    check(tuple(k.shape) == (b, 2 * d) and k.dtype == torch.float32, "K4 output shape or type")
                    check(close(torch, k, p, atol, rtol), f"K4 {label} disagrees with its plain version")
                    ok = close(torch, k, u, atol, rtol) if label == "f32" else close(torch, k, u, 0.05, 0.05)
                    check(ok, f"K4 {label} disagrees with the unfused module")
                    if (b, label) == (BATCH, "bf16") and m is not None:
                        err_main = e
            # a mask that is not a prefix; frame 0 is masked and, like every
            # masked frame, holds inf (x is the bf16 one)
            holes = torch.rand((b, t), generator=gen, device=dev) > 0.4
            holes[:, 0] = False
            xi = torch.where(holes[..., None], x, float("inf"))
            p = fused_stats_pooling_plain(xi, holes)
            for route in ("ring", "direct"):
                k = _launch_kernel(xi, holes, 1e-10, route=route)
                e = max_abs(k, p)
                print(f"K4 {route} kernel bf16 [{b},{t},{d}], mask with holes, masked frames inf: "
                      f"max abs err vs plain {e:.3e}", flush=True)
                check(bool(torch.isfinite(k).all()) and close(torch, k, p, atol, rtol),
                      f"K4 {route} kernel disagrees on a mask with holes")

            # bf16 times with a full bool mask; torch.std_mean and the eps
            # floor compute the same function there. Three clocks each.
            full = torch.ones((b, t), dtype=torch.bool, device=dev)

            def run_lib():
                std, mean = torch.std_mean(x, dim=1, correction=0)
                return mean, torch.clamp_min(std, 1e-5)

            runs = {"kernel": lambda: fused_stats_pooling(x, full),
                    "direct": lambda: _launch_kernel(x, full, 1e-10, route="direct"),
                    "plain": lambda: fused_stats_pooling_plain(x, full),
                    "library": run_lib}
            ms_p, ms_k = turns_ms(torch, runs["plain"], runs["kernel"], n=50)
            back = {"kernel": ms_k, "plain": ms_p, "direct": device_ms(torch, runs["direct"], n=50),
                    "library": device_ms(torch, runs["library"], n=50)}
            lone = {name: median_ms(torch, fn) for name, fn in runs.items()}
            prof, seen = {}, {}
            for name, fn in runs.items():
                prof[name], seen[name] = profiled_ms(torch, fn)
            nbytes = x.element_size() * x.numel() + b * t + 4 * 2 * b * d  # x, mask, f32 out
            bound, by = bound_ms(nbytes, 4.0 * b * t * d, peak="f32")
            fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
            for name, what in (("kernel", "ring kernel"), ("direct", "direct kernel"),
                               ("library", "torch.std_mean"), ("plain", "plain version")):
                print(f"K4 bf16 [{b},{t},{d}] {what} (ms): kernels' device durations {fmt(prof[name])} "
                      f"({seen[name]}), 50 launches back to back {back[name]:.4f}, one call on an idle card "
                      f"{lone[name]:.4f}", flush=True)
            print(f"K4 bf16 [{b},{t},{d}] bound {bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB)", flush=True)
            # the kernel's time is its device duration; back to back where
            # the profiler's reading was refused
            results[(b, t, d)] = {name: prof[name] if prof[name] is not None else back[name] for name in runs}
            results[(b, t, d)].update(bound=bound, by=by)
    r = results[(BATCH, 125, 2560)]
    return {
        "name": "fused_stats_pooling", "route": "cuda",
        "source": "asv_subtools_tpu_torch/csrc/stats_pooling.cu",
        "replaces": "asv_subtools_tpu/nn/pallas_pooling.py:52",
        "max_abs_err": err_main, "ms": r["kernel"], "plain_ms": r["plain"],
        "bound_ms": r["bound"], "bound_by": r["by"], "library_ms": r["library"],
    }


def profile_served_batch(torch, run, top: int = 12, what: str = "one served batch") -> None:
    """One served batch (or train step) under torch.profiler: device time
    by kernel (the `top` longest and every kernel of the port), and the
    device's idle share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    kernels = {}  # device-side kernel events only: the aten ops that launch them are not counted again
    runtime = {}  # the host's calls into the CUDA runtime and driver
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.device_time_total / 1e3, n + 1)
        elif e.name.startswith("cu"):
            ms, n = runtime.get(e.name, (0.0, 0))
            runtime[e.name] = (ms + e.cpu_time_total / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in kernels.values())
    if busy_ms == 0:
        print("profile: the profiler recorded no device time (not measured)", flush=True)
        return
    print(f"profile of {what}: wall {wall_ms:.2f} ms (profiled), kernels {busy_ms:.2f} ms "
          f"in {sum(n for _, n in kernels.values())} launches, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}",
          flush=True)
    ranked = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)
    for rank, (name, (ms, n)) in enumerate(ranked):  # the longest, and the port's own wherever they rank
        if rank < top or any(own in name for own in OWN_KERNELS):
            print(f"  {ms:8.3f} ms {ms / busy_ms:6.1%} x{n:<4d} {name[:100]}", flush=True)
    # the closing torch.cuda.synchronize() is one cudaDeviceSynchronize
    calls = sorted(runtime.items(), key=lambda kv: kv[1][0], reverse=True)[:5]
    print("  host runtime calls: " + ", ".join(f"{name} x{n} {ms:.2f} ms" for name, (ms, n) in calls), flush=True)


def _plain_embed(torch, model, opts, dft_dtype, dtype):
    """make_wave_embed_fn's computation with the plain front end (reference)."""
    from asv_subtools_tpu_torch.features import cmvn_utterance, fused_fbank_plain

    shift, win = opts.frame_opts.window_shift, opts.frame_opts.window_size

    def embed(wave, mask):
        feats, _ = fused_fbank_plain(wave, opts, dft_dtype=dft_dtype, with_energy=False)
        n_frames = torch.clamp_min((mask.sum(1) - win) // shift + 1, 1)
        fmask = torch.arange(feats.shape[1], device=feats.device)[None, :] < n_frames[:, None]
        feats = cmvn_utterance(feats, mask=fmask) * fmask[..., None]
        return model(feats.to(dtype), fmask)

    return embed


def _wrappers():
    """The four kernels' wrappers by name: each counts its launches."""
    from asv_subtools_tpu_torch.features import fused_fbank
    from asv_subtools_tpu_torch.nn import fused_attentive_stats_pool, fused_res2_chain, fused_stats_pooling

    return {"fused_fbank": fused_fbank, "fused_attentive_stats_pool": fused_attentive_stats_pool,
            "fused_res2_chain": fused_res2_chain, "fused_stats_pooling": fused_stats_pooling}


def zero_launches() -> None:
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def read_launches(path: str, expected) -> dict:
    """The counts of one main path's run; every kernel of the path must
    have been launched in it."""
    counts = {name: wrapper.launches for name, wrapper in _wrappers().items()}
    print(f"launches on the {path} path: {counts}", flush=True)
    for name in expected:
        check(counts[name] > 0, f"{name} was not launched on the {path} path")
    return counts


def timed_batches(torch, embed, waves, mask, iters: int) -> float:
    """ms per served batch: host clock around `iters` batches, after one warm-up."""
    embed(waves[0], mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        embed(waves[1 + i % (len(waves) - 1)], mask)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def server_run(torch, embed, what: str) -> None:
    """Bucketed Extractor over 48 seeded utterances of 1.5..25 s to a
    vector ark/scp, then cosine scoring and EER on random trials."""
    from asv_subtools_tpu_torch.backend import compute_eer, cosine_score_matrix
    from asv_subtools_tpu_torch.extract import WAVE_BUCKETS, ExtractConfig, Extractor

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(24000, 400001, size=48)
    items = [(f"utt{i:02d}", (rng.standard_normal(n) * 1000.0).astype(np.float32))
             for i, n in enumerate(lengths)]
    ex = Extractor(embed, ExtractConfig(buckets=WAVE_BUCKETS, default_batch=32, max_chunk=WAVE_BUCKETS[-1]))
    with tempfile.TemporaryDirectory() as tmp:
        stats = ex.extract_to_ark(items, f"{tmp}/xvector.ark", f"{tmp}/xvector.scp")
        with open(f"{tmp}/xvector.scp") as f:
            keys = [line.split()[0] for line in f if line.strip()]
    check(sorted(keys) == [k for k, _ in items], f"scp holds {len(keys)} keys, expected 48")
    embs = ex.extract_all(items[:16])
    check(all(np.all(np.isfinite(e)) for e in embs.values()), f"{what}: extracted embeddings not finite")
    dev = torch.device("cuda")
    enroll = torch.as_tensor(np.stack([embs[f"utt{i:02d}"] for i in range(8)]), device=dev)
    test = torch.as_tensor(np.stack([embs[f"utt{i:02d}"] for i in range(8, 16)]), device=dev)
    scores = cosine_score_matrix(enroll, test).cpu().numpy().ravel()
    labels = rng.integers(0, 2, size=scores.size)
    labels[:2] = (0, 1)
    eer, _ = compute_eer(scores, labels)
    print(f"{what} server run: {stats['utts']} utterances in {stats['batches']} batches, "
          f"{stats['wall_s']:.2f} s wall, {stats['device_s']:.2f} s device; ark/scp keys {len(keys)}; "
          f"EER on random trials {eer:.3f} (random weights: not gated)", flush=True)


def phase_served(torch, device_label):
    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.features import FbankOptions, MelOptions
    from asv_subtools_tpu_torch.models import EcapaAttentiveStatsPool, EcapaTdnn, Res2NetBlock
    from asv_subtools_tpu_torch.nn import fused_attentive_stats_pool, fused_res2_chain
    from asv_subtools_tpu_torch.weights import init_ecapa_weights_

    dev = torch.device("cuda")
    opts = FbankOptions(mel_opts=MelOptions(num_bins=80))  # recipes/voxceleb/run.py:90
    model32 = init_ecapa_weights_(EcapaTdnn(80, channels=1024, embd_dim=192, mfa_conv=1536), SEED)
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    wave = torch.randn((BATCH, SAMPLES), generator=gen, device=dev) * 1000.0
    mask = torch.ones((BATCH, SAMPLES), dtype=torch.bool, device=dev)
    embed = make_wave_embed_fn(lambda x, m: model16(x, m), opts, dtype=torch.bfloat16)

    with torch.inference_mode():
        ref16 = _plain_embed(torch, model16, opts, torch.bfloat16, torch.bfloat16)(wave, mask)
        ref32 = _plain_embed(torch, model32, opts, torch.float32, torch.float32)(wave, mask)
        waves = [wave * (1.0 + 1e-4 * i) for i in range(7)]
        torch.cuda.synchronize()

        # the main path: counters from zero
        zero_launches()
        emb = embed(waves[0], mask)
        torch.cuda.synchronize()
        check(tuple(emb.shape) == (BATCH, 192) and bool(torch.isfinite(emb.float()).all()),
              "served embeddings not finite or of the wrong shape")
        c16, c32 = float(cosine(emb, ref16).min()), float(cosine(emb, ref32).min())
        print(f"served C1024 bf16: min per-utterance cosine vs plain front end (bf16) {c16:.6f} "
              f"(>= 0.9999), vs f32 model + f32 plain front end {c32:.6f} (>= 0.999)", flush=True)
        check(c16 >= 0.9999 and c32 >= 0.999, "served embeddings disagree with the references")
        ms = timed_batches(torch, embed, waves, mask, iters=6)
        print(f"served C1024 bf16 [128,160000]: {ms:.2f} ms/batch, "
              f"{BATCH * SAMPLES / 16.0 / ms:.0f} audio-s/s on {device_label}", flush=True)
        profile_served_batch(torch, lambda: embed(waves[0], mask))

        # one C1024 pooling through the fused kernel on the model's MFA output
        seen = {}
        hook = model16.stats.register_forward_hook(
            lambda mod, args, out: seen.update(x=args[0], mask=args[1], out=out))
        embed(waves[0], mask)
        hook.remove()
        pool = EcapaAttentiveStatsPool(1536, fused_inference=True).to(device=dev, dtype=torch.bfloat16).eval()
        pool.load_state_dict(model16.stats.state_dict())
        fused = pool(seen["x"], seen["mask"])
        e_pool = max_abs(fused, seen["out"])
        # the unfused bf16 path rounds every step to bf16: the JAX bf16
        # pooling test's bound, atol = rtol = 0.05
        close = torch.allclose(fused.float(), seen["out"].float(), atol=0.05, rtol=0.05)
        print(f"C1024 pooling on the MFA output, fused vs unfused (bf16): max abs err {e_pool:.3e} "
              f"(atol = rtol = 0.05)", flush=True)
        check(close, "fused pooling disagrees with the model's pooling")

        # the same served batch with the three Res2NetBlocks on the fused chain
        fused16 = copy.deepcopy(model16)
        chains = [m for m in fused16.modules() if isinstance(m, Res2NetBlock)]
        check(len(chains) == 3, f"expected 3 Res2NetBlocks, found {len(chains)}")
        for m in chains:
            m.fused_inference = True
        embed_f = make_wave_embed_fn(lambda x, m: fused16(x, m), opts, dtype=torch.bfloat16)
        emb_f = embed_f(waves[0], mask)
        torch.cuda.synchronize()
        check(tuple(emb_f.shape) == (BATCH, 192) and bool(torch.isfinite(emb_f.float()).all()),
              "embeddings with the fused chains not finite or of the wrong shape")
        cu, c32 = float(cosine(emb_f, emb).min()), float(cosine(emb_f, ref32).min())
        # tolerance: the two bf16 paths round at other places (the unfused
        # one rounds every conv's output to bf16, the chain keeps f32 to the
        # stage's end); 0.999 is the bar of bf16 against f32
        print(f"served C1024 bf16 with the fused Res2 chains: min per-utterance cosine vs the unfused bf16 "
              f"model {cu:.6f} (>= 0.999), vs f32 model + f32 plain front end {c32:.6f} (>= 0.999)", flush=True)
        check(cu >= 0.999 and c32 >= 0.999, "embeddings with the fused Res2 chains disagree")
        check(fused_res2_chain.last_route == "tensor_core", "the served Res2 chains left the tensor-core kernel")

        # and with every flag on: the chains and the attentive pooling fused
        all16 = copy.deepcopy(fused16)
        all16.stats.fused_inference = True
        embed_a = make_wave_embed_fn(lambda x, m: all16(x, m), opts, dtype=torch.bfloat16)
        pools_before = fused_attentive_stats_pool.launches
        emb_a = embed_a(waves[0], mask)
        torch.cuda.synchronize()
        check(fused_attentive_stats_pool.launches == pools_before + 1,
              "the batch with every flag on did not launch the attentive pooling kernel")
        check(tuple(emb_a.shape) == (BATCH, 192) and bool(torch.isfinite(emb_a.float()).all()),
              "embeddings with every flag on not finite or of the wrong shape")
        cu, c32 = float(cosine(emb_a, emb).min()), float(cosine(emb_a, ref32).min())
        print(f"served C1024 bf16 with every flag on (Res2 chains and attentive pooling fused): min per-utterance "
              f"cosine vs the unfused bf16 model {cu:.6f} (>= 0.999), vs f32 model + f32 plain front end "
              f"{c32:.6f} (>= 0.999)", flush=True)
        check(cu >= 0.999 and c32 >= 0.999, "embeddings with every flag on disagree")
        check(fused_res2_chain.last_route == "tensor_core", "the served Res2 chains left the tensor-core kernel")

        # turns: flags off, chains fused, every flag on, then back
        runs = {"off": embed, "chains": embed_f, "all": embed_a}
        order = ("off", "chains", "all", "all", "chains", "off")
        turns = [(name, timed_batches(torch, runs[name], waves, mask, iters=3)) for name in order]
        best = {name: min(ms for n, ms in turns if n == name) for name in runs}
        turns = " ".join(f"{name} {ms:.2f}" for name, ms in turns)
        print(f"served C1024 bf16 [128,160000] ms/batch: flags off {best['off']:.2f}, Res2 chains fused "
              f"{best['chains']:.2f}, every flag on {best['all']:.2f} (turns {turns})", flush=True)
        profile_served_batch(torch, lambda: embed_a(waves[0], mask))

    server_run(torch, embed, "ECAPA C1024")
    return read_launches("ECAPA C1024", ("fused_fbank", "fused_attentive_stats_pool", "fused_res2_chain"))


def phase_served_resnet(torch, device_label):
    """ResNet34 base32 x-vector at full width and depth, with the fused
    statistics pooling on."""
    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.features import FbankOptions, MelOptions
    from asv_subtools_tpu_torch.models import ResNetXvector
    from asv_subtools_tpu_torch.weights import init_weights_

    dev = torch.device("cuda")
    opts = FbankOptions(mel_opts=MelOptions(num_bins=80))
    model32 = init_weights_(ResNetXvector(80), SEED + 10)  # base32, layers 3-4-6-3, embd 512
    off16 = copy.deepcopy(model32).to(torch.bfloat16)
    on16 = copy.deepcopy(off16)
    on16.head.stats.fused_inference = True
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    wave = torch.randn((BATCH, SAMPLES), generator=gen, device=dev) * 1000.0
    mask = torch.ones((BATCH, SAMPLES), dtype=torch.bool, device=dev)
    wrap = lambda model: make_wave_embed_fn(lambda x, m: model(x, m), opts, dtype=torch.bfloat16)
    embed_on, embed_off = wrap(on16), wrap(off16)

    with torch.inference_mode():
        ref16 = _plain_embed(torch, off16, opts, torch.bfloat16, torch.bfloat16)(wave, mask)
        ref32 = _plain_embed(torch, model32, opts, torch.float32, torch.float32)(wave, mask)
        waves = [wave * (1.0 + 1e-4 * i) for i in range(4)]
        torch.cuda.synchronize()

        # the main path: counters from zero
        zero_launches()
        emb = embed_on(waves[0], mask)
        torch.cuda.synchronize()
        check(tuple(emb.shape) == (BATCH, 512) and bool(torch.isfinite(emb.float()).all()),
              "served ResNet34 embeddings not finite or of the wrong shape")
        c16, c32 = float(cosine(emb, ref16).min()), float(cosine(emb, ref32).min())
        print(f"served ResNet34 bf16, fused pooling: min per-utterance cosine vs flag off + plain front end "
              f"(bf16) {c16:.6f} (>= 0.9999), vs f32 model + f32 plain front end {c32:.6f} (>= 0.999)", flush=True)
        check(c16 >= 0.9999 and c32 >= 0.999, "served ResNet34 embeddings disagree with the references")
        ms_off1 = timed_batches(torch, embed_off, waves, mask, iters=3)
        ms_on1 = timed_batches(torch, embed_on, waves, mask, iters=3)
        ms_on2 = timed_batches(torch, embed_on, waves, mask, iters=3)
        ms_off2 = timed_batches(torch, embed_off, waves, mask, iters=3)
        ms_on, ms_off = min(ms_on1, ms_on2), min(ms_off1, ms_off2)
        audio_s = BATCH * SAMPLES / 16.0  # audio-milliseconds per batch over ms = audio-s/s
        print(f"served ResNet34 bf16 [128,160000] ms/batch: fused pooling {ms_on:.2f} ({audio_s / ms_on:.0f} "
              f"audio-s/s), unfused {ms_off:.2f} ({audio_s / ms_off:.0f} audio-s/s) on {device_label} "
              f"(turns off {ms_off1:.2f} on {ms_on1:.2f} on {ms_on2:.2f} off {ms_off2:.2f})", flush=True)
        profile_served_batch(torch, lambda: embed_on(waves[0], mask))

    server_run(torch, embed_on, "ResNet34")
    return read_launches("ResNet34", ("fused_fbank", "fused_stats_pooling"))


TRAIN_SAMPLES = 32000  # bench.py:94-117: B=128 x 2 s
# The card-against-CPU step (ECAPA C256 at B=8, one SGD step; TF32 off).
# f32 on the card against the same step on the CPU: loss and grad_norm.
F32_LOSS_TOL, F32_GRAD_NORM_TOL = 1e-4, 1e-4
# f32 on either device against the f64 step, leaf by leaf (a leaf's
# update error over its update norm; the BN running statistics likewise).
# An f32 step at B=8 is ill-conditioned: over six seeds and three heads
# (tools/train_step_conditioning.py, on an H100 and its host's CPU;
# PERF.md) the worst leaf read 5.8e-2 and the worst BN statistic 6.6e-6.
# The bounds leave a factor of two over those and hold whatever the seed;
# the f64 comparison below is the tight one.
F32_LEAF_TOL, F32_STATS_TOL = 0.12, 2e-5
# f64 on the card against f64 on the CPU, leaf by leaf
F64_LEAF_TOL = 1e-8


@contextlib.contextmanager
def no_host_sync(torch):
    """Raise if the code inside waits on the card: a blocking copy, a
    read of a device value on the host, a synchronize."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _card_against_cpu(torch, family: str = "ecapa"):
    """One f32 SGD step of the narrow net of ``family`` at B=8 (ECAPA C256,
    or the ResNet and Conformer of train/step_check.py's narrow_net) on
    the card (K1 in f32 mode, TF32 off) and on the CPU (the plain front
    end) from the same state on the same waves, each held against the f64
    step on the plain front end's features; then the f64 step on the card
    against the CPU (train/step_check.py builds the case)."""
    from asv_subtools_tpu_torch.features import fused_fbank
    from asv_subtools_tpu_torch.train.step_check import (AAM, SUBCENTER_TOPK, ZERO_GRAD, modulated_waves, narrow_net,
                                                         plain_features, rel, sgd_step, worst_leaf, worst_stat,
                                                         zero_grad_share)

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    make = narrow_net(family)
    head = SUBCENTER_TOPK if family == "ecapa" else AAM
    what = {"ecapa": "SpeakerNet ECAPA C256", "resnet": "SpeakerNet ResNet base8 1-1-1-1",
            "conformer": "SpeakerNet Conformer 2L-64D-2H, dropout 0",
            "ftdnn": "SpeakerNet F-TDNN width 0.125, use_semi_orth over step 0 (0 % 4 == 0)",
            "repvgg": "SpeakerNet RepVGG RepSPK 1-1-1-1 base 8",
            "reconformer": "SpeakerNet ReConformer 2L-64D-2H re_conv2d, dropout 0",
            "transformer": "SpeakerNet Transformer x-vector 2L-64D-2H, dropout 0",
            "gau_conformer": "SpeakerNet GAU Conformer 2L-64D-2H conv2d2 (GAU 128/32, RoPE, T5), dropout 0"}[family]
    semi = family == "ftdnn"
    wave, y = modulated_waves(8, SEED + 30)
    feats, seed = plain_features(wave), SEED + 32
    ref = sgd_step("cpu", torch.float64, feats, y, head, seed, make_net=make, use_semi_orth=semi)
    before = fused_fbank.launches
    card = sgd_step("cuda", torch.float32, wave, y, head, seed, wave_input=True, make_net=make, use_semi_orth=semi)
    check(fused_fbank.launches == before + 1 and fused_fbank.last_route == "cuda_core",
          "the f32 step on the card did not run K1's f32 kernel once")
    cpu = sgd_step("cpu", torch.float32, wave, y, head, seed, wave_input=True, make_net=make, use_semi_orth=semi)
    e_loss = rel(card.metrics["loss"], cpu.metrics["loss"])
    e_grad = rel(card.metrics["grad_norm"], cpu.metrics["grad_norm"])
    leaf = {d: worst_leaf(r.updates, ref.updates) for d, r in (("card", card), ("CPU", cpu))}
    stats = {d: worst_stat(r.batch_stats, ref.batch_stats) for d, r in (("card", card), ("CPU", cpu))
             if ref.batch_stats}
    noise = zero_grad_share(card.updates, cpu.updates)
    has_zero = ZERO_GRAD in ref.updates
    between = worst_leaf(card.updates, cpu.updates)  # printed, not held: no bound holds whatever the seed
    print(f"train card vs CPU ({what}, B=8 x 2 s, f32, TF32 off, one SGD step): loss "
          f"{card.metrics['loss']:.6f} vs {cpu.metrics['loss']:.6f} (rel {e_loss:.2e}, tol {F32_LOSS_TOL}), grad_norm "
          f"{card.metrics['grad_norm']:.5f} vs {cpu.metrics['grad_norm']:.5f} (rel {e_grad:.2e}, tol "
          f"{F32_GRAD_NORM_TOL}), worst leaf update {between[0]:.2e} of the CPU's at {between[1]}; against the f64 "
          f"step, worst leaf update "
          + ", ".join(f"{d} {e:.2e} at {k} (whole {w:.1e})" for d, (e, k, w) in leaf.items()) + f" (tol {F32_LEAF_TOL}; "
          f"{len(ref.updates)} leaves), worst BN statistic "
          + (", ".join(f"{d} {e:.2e} at {k}" for d, (e, k, _) in stats.items()) or "none (no BatchNorm)")
          + f" (tol {F32_STATS_TOL})" + (f"; {ZERO_GRAD} {noise:.1e} of the update (tol 1e-6)" if has_zero else ""),
          flush=True)
    check(e_loss <= F32_LOSS_TOL and e_grad <= F32_GRAD_NORM_TOL and noise <= 1e-6
          and all(e <= F32_LEAF_TOL for e, _, _ in leaf.values())
          and all(e <= F32_STATS_TOL for e, _, _ in stats.values()),
          f"the f32 train step of {what} on the card or the CPU is off the f64 step, or the two disagree")

    # the same step in float64 on the same features: the port's step on
    # the card computes what it computes on the CPU, leaf by leaf. The head
    # is the AAM margin softmax, float64 throughout: the sub-centre head
    # computes in float32 whatever its input (as the JAX one does)
    card, cpu = (sgd_step(d, torch.float64, feats, y, AAM, seed, make_net=make, use_semi_orth=semi)
                 for d in ("cuda", "cpu"))
    e, k, _ = worst_leaf(card.updates, cpu.updates)
    e_stats = worst_stat(card.batch_stats, cpu.batch_stats)[0] if cpu.batch_stats else 0.0
    e_grad = rel(card.metrics["grad_norm"], cpu.metrics["grad_norm"])
    noise = zero_grad_share(card.updates, cpu.updates)
    print(f"train card vs CPU in float64 ({what}, same batch, features in): grad_norm rel {e_grad:.2e}, worst leaf "
          f"update {e:.2e} of its norm at {k}, worst BN statistic {e_stats:.2e} (tol {F64_LEAF_TOL}; "
          f"{len(cpu.updates)} leaves)" + (f", {ZERO_GRAD} {noise:.1e} of the update (tol 1e-12)" if has_zero else ""),
          flush=True)
    check(max(e_grad, e, e_stats) <= F64_LEAF_TOL and noise <= 1e-12,
          f"the float64 train step of {what} on the card disagrees with the CPU")


def run_fixed_batch(torch, step, state, batch, gen, what: str, path: str, device_label: str,
                    falls_to: Optional[float], opt: str = "adamW", watch=None) -> dict:
    """30 steps of ``step`` on one fixed batch from ``state``, queued back to
    back, none of them allowed to wait on the card (no_host_sync: the host
    queues steps ahead of the card, as a training loop does). The first step
    is the main path's run: the launch counters are zeroed just before it
    and read just after. Prints the median ms/step of 20 steps between CUDA
    events after 3 warm-up steps, audio-s/s, the host's time to queue a step
    and the peak memory; profiles one step; requires every loss finite,
    none skipped and the last loss under ``falls_to`` times the first
    (``falls_to`` None: finite and none skipped only).
    ``watch(i, state)``, if given, runs after step i (0-based) outside the
    timed events and must not wait on the card either."""
    b, samples = batch["x"].shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with no_host_sync(torch):
        state, m = step(state, batch, gen)
        if watch is not None:
            watch(0, state)
    torch.cuda.synchronize()
    counts = read_launches(path, ("fused_fbank",))
    check(counts["fused_fbank"] == 1, f"K1 launched {counts['fused_fbank']} times in one step")
    metrics, events, host_ms = [m], [], []
    for i in range(1, 30):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with no_host_sync(torch):
            start.record()
            state, m = step(state, batch, gen)
            end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if watch is not None:
            with no_host_sync(torch):
                watch(i, state)
        metrics.append(m)
        events.append((start, end))
    torch.cuda.synchronize()
    # after 3 warm-up steps (the first one and two of the loop), 20 timed
    ms = float(np.median([s.elapsed_time(e) for s, e in events[2:22]]))
    host = float(np.median(host_ms[2:22]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{what} [{b},{samples}] {opt}: {ms:.2f} ms/step (median of 20 between CUDA events, steps queued back to "
          f"back after 3 warm-up steps), {b * samples / 16000.0 / (ms / 1e3):.0f} audio-s/s; the host {host:.2f} ms "
          f"to queue a step (median); no step waited on the card; K1 launches per step {counts['fused_fbank']}; "
          f"peak memory {peak:.2f} GiB on {device_label}", flush=True)
    profile_served_batch(torch, lambda: step(state, batch, gen), what=f"one {what} step")
    losses = torch.stack([x["loss"] for x in metrics]).cpu()
    skipped = float(torch.stack([x["skipped"] for x in metrics]).sum())
    print(f"{what} 30 steps on one batch: loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f} "
          f"(min {float(losses.min()):.4f}), skipped {skipped:.0f}, last grad_norm {float(metrics[-1]['grad_norm']):.3f}",
          flush=True)
    falls = falls_to is None or float(losses[-1]) < falls_to * float(losses[0])
    check(bool(torch.isfinite(losses).all()) and skipped == 0 and falls,
          f"the 30 {what} steps did not run finite with the last loss under {falls_to} of the first")
    return counts


def phase_train(torch, device_label):
    """The train step of ECAPA-TDNN C1024 on raw waves at B=128 x 2 s."""
    from asv_subtools_tpu_torch.features import FbankOptions, MelOptions, fused_fbank, fused_fbank_plain
    from asv_subtools_tpu_torch.features.fused_fbank import folded_dft, mel_bands
    from asv_subtools_tpu_torch.nn import MarginWarm
    from asv_subtools_tpu_torch.train import (TrainStepConfig, cyclic, get_optimizer, init_train_state,
                                              make_train_step)
    from asv_subtools_tpu_torch.train.step_check import NUM_TARGETS, SUBCENTER_TOPK, ecapa_net

    dev = torch.device("cuda")
    opts = FbankOptions(mel_opts=MelOptions(num_bins=80))  # recipes/voxceleb/run.py:90
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    wave = torch.randn((BATCH, TRAIN_SAMPLES), generator=gen, device=dev) * 1000.0  # bench.py:123-126
    labels = torch.randint(0, NUM_TARGETS, (BATCH,), generator=gen, device=dev)
    t = opts.frame_opts.num_frames(TRAIN_SAMPLES)

    # 1. K1 at the training shape
    k, _ = fused_fbank(wave, opts, dft_dtype=torch.bfloat16, with_energy=False)
    check(fused_fbank.last_route == "tensor_core", f"K1 at the training shape ran the {fused_fbank.last_route} kernel")
    p, _ = fused_fbank_plain(wave, opts, dft_dtype=torch.bfloat16, with_energy=False)
    torch.cuda.synchronize()
    err, tol = max_abs(k, p), 1e-3  # K1's bf16 tolerance (phase_fbank)
    check(tuple(k.shape) == (BATCH, t, 80) and err <= tol, "K1 at the training shape disagrees with its plain version")
    ms_p, ms_k = turns_ms(torch, lambda: fused_fbank_plain(wave, opts, dft_dtype=torch.bfloat16, with_energy=False),
                          lambda: fused_fbank(wave, opts, dft_dtype=torch.bfloat16, with_energy=False), n=10)
    fo = opts.frame_opts
    flops = 2.0 * BATCH * t * (fo.window_size * 2 * (fo.padded_window_size // 2) + mel_bands(opts)[1].size)
    nbytes = 4 * wave.numel() + 4 * BATCH * t * 80 + 2 * folded_dft(opts).size
    bound, by = bound_ms(nbytes, flops)
    print(f"train K1 bf16 [{BATCH},{TRAIN_SAMPLES}] -> [{BATCH},{t},80] (tensor_core): max abs err {err:.3e} (tol {tol}); "
          f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms (10 launches back to back), bound {bound:.4f} ms by {by} "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)", flush=True)

    # 2.-4. bench's optimizer on one fixed batch: 30 steps from a fresh state
    config = TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True, fbank_opts=opts)
    net = ecapa_net(SUBCENTER_TOPK, SEED + 21, channels=1024)
    tx = get_optimizer("adamW", 1e-3)  # bench.py:115
    state = init_train_state(net, tx, dev)
    step = make_train_step(net, tx, config=config)
    del k, p
    counts = run_fixed_batch(torch, step, state, {"x": wave, "y": labels}, gen, "train C1024 bf16", "train step",
                             device_label, falls_to=1.0)
    del state, step
    torch.cuda.empty_cache()

    # 5. the recipe's optimizer (recipes/voxceleb/run.py:100-130) with
    # accum_grad 2 on a masked batch of 1.0-2.0 s
    lengths = torch.linspace(16000, TRAIN_SAMPLES, BATCH, device=dev).long()
    smask = torch.arange(TRAIN_SAMPLES, device=dev)[None, :] < lengths[:, None]
    masked = {"x": wave * smask, "y": labels, "mask": smask}
    schedule = cyclic(base_lr=1e-8, max_lr=1e-3, step_size_up=15000, mode="triangular2")
    tx = get_optimizer("adamW", schedule, weight_decay=5e-5)
    warm = MarginWarm(1, 3, -0.2, 0.0, epoch_iter=2)
    state = init_train_state(net, tx, dev)
    step = make_train_step(net, tx, lr_schedule=schedule, config=TrainStepConfig(
        compute_dtype=torch.bfloat16, wave_input=True, fbank_opts=opts, accum_grad=2))
    rows = []
    for i in range(5):
        offset, lam = warm.step(i)
        before = fused_fbank.launches
        with no_host_sync(torch):
            state, m = step(state, masked, gen, lambda_m=lam, margin_offset=offset)
        torch.cuda.synchronize()
        check(fused_fbank.launches == before + 2, "K1 did not launch twice in a step of accum_grad 2")
        rows.append((lam, offset, {k: float(v) for k, v in m.items()}))
    print("train recipe step (adamW wd 5e-5, cyclic triangular2 1e-8..1e-3 up 15000, MarginWarm(1, 3, -0.2, 0.0, "
          "epoch_iter=2), accum_grad 2, lengths 1.0-2.0 s; K1 launches per step 2; no step waited on the card): "
          + "; ".join(f"lambda_m {lam:.3f} offset {off:.4f} lr {r['lr']:.3e} loss {r['loss']:.4f}"
                      for lam, off, r in rows), flush=True)
    check(all(np.isfinite(r["loss"]) and r["skipped"] == 0 for _, _, r in rows), "a recipe step was not finite")
    del state, step, net
    torch.cuda.empty_cache()

    # 6. the card against the CPU
    _card_against_cpu(torch)
    return counts


def _train_batch(torch, seed: int):
    """(fbank options, generator, waves [128, 32000], labels): bench.py's
    training batch (bench.py:94-126), seeded."""
    from asv_subtools_tpu_torch.train.step_check import NUM_TARGETS, OPTS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    wave = torch.randn((BATCH, TRAIN_SAMPLES), generator=gen, device=dev) * 1000.0
    return OPTS, gen, wave, torch.randint(0, NUM_TARGETS, (BATCH,), generator=gen, device=dev)


def phase_train_resnet(torch, device_label):
    """The train step of the ResNet34 x-vector (bench.py:75-81: base32,
    layers 3-4-6-3, embedding 512, AAM m=0.2 over 5994 classes) on raw
    waves at B=128 x 2 s, bf16 on f32 masters, adamW 1e-3, K1 in the step;
    then a narrow ResNet's step on the card against the CPU."""
    from asv_subtools_tpu_torch.train import TrainStepConfig, get_optimizer, init_train_state, make_train_step
    from asv_subtools_tpu_torch.train.step_check import resnet_net

    opts, gen, wave, labels = _train_batch(torch, SEED + 50)
    net = resnet_net(seed=SEED + 51)
    tx = get_optimizer("adamW", 1e-3)
    state = init_train_state(net, tx, "cuda")
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True,
                                                           fbank_opts=opts))
    counts = run_fixed_batch(torch, step, state, {"x": wave, "y": labels}, gen, "train ResNet34 bf16",
                             "ResNet34 train step", device_label, falls_to=0.5)
    del state, step, net
    torch.cuda.empty_cache()
    _card_against_cpu(torch, "resnet")
    return counts


def phase_served_conformer(torch, device_label):
    """The Conformer x-vector served at full width and depth (bench.py:82-90:
    6L-256D-4H, conv2d subsampling, embedding 256, seeded random weights,
    bf16) behind make_wave_embed_fn on one [128, 160000] batch, held
    against the same model fed by the plain front end and against an f32
    model on the f32 plain front end; timed; one batch profiled; then the
    Extractor run as in 6."""
    from asv_subtools_tpu_torch.models import ConformerXvector
    from asv_subtools_tpu_torch.weights import init_weights_

    model32 = init_weights_(ConformerXvector(80, num_blocks=6, attention_dim=256, attention_heads=4,
                                             input_layer="conv2d"), SEED + 60)
    return _serve_family(torch, model32, "Conformer 6L-256D-4H", "Conformer served", device_label, SEED + 61)


def _serve_family(torch, model32, label: str, path: str, device_label: str, seed: int) -> dict:
    """The served run of a Conformer-family ``model32`` (f32 on the card) and
    its bf16 copy (phases 10 and 24): one [128, 160000] batch behind
    make_wave_embed_fn, K1 once in the counted window; the references; the
    time; a profile; the Extractor."""
    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.train.step_check import OPTS

    dev = torch.device("cuda")
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(seed)
    wave = torch.randn((BATCH, SAMPLES), generator=gen, device=dev) * 1000.0
    mask = torch.ones((BATCH, SAMPLES), dtype=torch.bool, device=dev)
    embed = make_wave_embed_fn(lambda x, m: model16(x, m), OPTS, dtype=torch.bfloat16)
    with torch.inference_mode():
        ref16 = _plain_embed(torch, model16, OPTS, torch.bfloat16, torch.bfloat16)(wave, mask)
        ref32 = _plain_embed(torch, model32, OPTS, torch.float32, torch.float32)(wave, mask)
        k1_32 = make_wave_embed_fn(lambda x, m: model32(x, m), OPTS, dtype=torch.float32)(wave, mask)
        plain_32 = _plain_embed(torch, model32, OPTS, torch.bfloat16, torch.float32)(wave, mask)
        waves = [wave * (1.0 + 1e-4 * i) for i in range(4)]
        torch.cuda.synchronize()

        # the main path: counters from zero
        zero_launches()
        emb = embed(waves[0], mask)
        torch.cuda.synchronize()
        counts = read_launches(path, ("fused_fbank",))
        check(counts["fused_fbank"] == 1, f"K1 launched {counts['fused_fbank']} times in one served batch")
        check(tuple(emb.shape) == (BATCH, 256) and bool(torch.isfinite(emb.float()).all()),
              f"served {label} embeddings not finite or of the wrong shape")
        c16, c32 = float(cosine(emb, ref16).min()), float(cosine(emb, ref32).min())
        ck1 = float(cosine(k1_32, plain_32).min())
        # tolerance: the bf16 Conformer's embedding moves by about 4e-4 of
        # cosine when its input moves by 3e-5 (the f32 model's does not), so
        # two bf16 runs on front ends that differ by K1's rounding are held
        # at the bar of bf16 against f32, 0.999; K1 itself through the f32
        # model at 0.9999
        print(f"served {label} bf16: min per-utterance cosine vs plain front end (bf16) {c16:.6f} (>= 0.999), vs f32 "
              f"model + f32 plain front end {c32:.6f} (>= 0.999); the f32 model on K1's bf16 features vs on the plain "
              f"bf16 front end {ck1:.7f} (>= 0.9999)", flush=True)
        check(c16 >= 0.999 and c32 >= 0.999 and ck1 >= 0.9999,
              f"served {label} embeddings disagree with the references")
        ms = timed_batches(torch, embed, waves, mask, iters=6)
        print(f"served {label} bf16 [{BATCH},{SAMPLES}]: {ms:.2f} ms/batch, {BATCH * SAMPLES / 16.0 / ms:.0f} "
              f"audio-s/s on {device_label}", flush=True)
        profile_served_batch(torch, lambda: embed(waves[0], mask), what=f"one served {label} batch")
    server_run(torch, embed, label)
    return counts


def phase_train_conformer(torch, device_label):
    """The train step of the Conformer x-vector (bench.py:82-90: 6L-256D-4H
    conv2d, embedding 256, dropout 0.1 from the step's generator, AAM m=0.2
    over 5994 classes) on raw waves at B=128 x 2 s, bf16 on f32 masters,
    adamW 1e-3, K1 in the step; then five steps of the recipe's
    configuration (recipes/configs/conformer.yaml: AM m=0.2,
    model_warmup_steps 1000, adamW on the noam schedule) on a masked batch
    of 1.0-2.0 s, where warmup < 1 blends every block; then a narrow
    Conformer's step on the card against the CPU."""
    from asv_subtools_tpu_torch.features import fused_fbank
    from asv_subtools_tpu_torch.train import TrainStepConfig, get_optimizer, init_train_state, make_train_step, noam
    from asv_subtools_tpu_torch.train.step_check import conformer_net

    dev = torch.device("cuda")
    opts, gen, wave, labels = _train_batch(torch, SEED + 70)
    net = conformer_net(seed=SEED + 71)
    tx = get_optimizer("adamW", 1e-3)
    state = init_train_state(net, tx, dev)
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True,
                                                           fbank_opts=opts))
    # the last loss below the first, ECAPA's criterion, not under half:
    # from this random start the JAX step's own loss falls 16.50 -> 9.32 in
    # 30 steps at B=32 and flattens there (the port's, on the same weights
    # and features, step for step the same; PERF.md)
    counts = run_fixed_batch(torch, step, state, {"x": wave, "y": labels}, gen, "train Conformer bf16",
                             "Conformer train step", device_label, falls_to=1.0)
    del state, step, net
    torch.cuda.empty_cache()

    lengths = torch.linspace(16000, TRAIN_SAMPLES, BATCH, device=dev).long()
    smask = torch.arange(TRAIN_SAMPLES, device=dev)[None, :] < lengths[:, None]
    masked = {"x": wave * smask, "y": labels, "mask": smask}
    net = conformer_net(("margin_softmax", {"method": "am", "m": 0.2}), SEED + 72)
    schedule = noam(base_lr=1.0, model_dim=256, warmup_steps=25000)
    tx = get_optimizer("adamW", schedule)
    state = init_train_state(net, tx, dev)
    step = make_train_step(net, tx, lr_schedule=schedule, config=TrainStepConfig(
        compute_dtype=torch.bfloat16, wave_input=True, fbank_opts=opts, model_warmup_steps=1000))
    rows = []
    for _ in range(5):
        warmup = int(state.step) / 1000
        before = fused_fbank.launches
        with no_host_sync(torch):
            state, m = step(state, masked, gen)
        torch.cuda.synchronize()
        check(fused_fbank.launches == before + 1, "K1 did not launch once in a recipe step")
        rows.append((warmup, {k: float(v) for k, v in m.items()}))
    print("train Conformer recipe step (AM m=0.2, model_warmup_steps 1000, adamW wd 1e-4 on noam base_lr 1.0 "
          "model_dim 256 warmup 25000, lengths 1.0-2.0 s; K1 launches per step 1; no step waited on the card): "
          + "; ".join(f"warmup {w:.3f} lr {r['lr']:.3e} loss {r['loss']:.4f}" for w, r in rows), flush=True)
    check(all(np.isfinite(r["loss"]) and r["skipped"] == 0 for _, r in rows), "a Conformer recipe step was not finite")
    del state, step, net
    torch.cuda.empty_cache()
    _card_against_cpu(torch, "conformer")
    return counts


# 40 training utterances a speaker: 2,496 after the 64 held out, 18 steps an
# epoch for two workers (each batches its own 1,248 and drops the rest)
RECIPE_SPEAKERS, RECIPE_TRAIN_UTTS, RECIPE_EVAL_UTTS = 64, 40, 2
RECIPE_SHUFFLE = 256  # the recipe's 1,000 is most of a worker's shard here
RECIPE_STEADY = 2  # an epoch's first steps wait for the pool and the shuffle buffers
RECIPE_COSINE = 0.9999  # PERF.md section 2: K1's embeddings against the plain front end's


@contextlib.contextmanager
def counted_host_waits(counts: dict):
    """Count the host's waits on the card in Trainer.run_epoch and
    Trainer.validate, call by call (train/step_check.py host_waits):
    counts[name] their numbers, counts[name + " places"] where they were."""
    from asv_subtools_tpu_torch.train import Trainer
    from asv_subtools_tpu_torch.train.step_check import host_waits

    originals = {name: getattr(Trainer, name) for name in ("run_epoch", "validate")}

    def counting(name, fn):
        def wrapper(self, *args, **kwargs):
            out, places = host_waits(lambda: fn(self, *args, **kwargs))
            counts.setdefault(name, []).append(len(places))
            counts.setdefault(f"{name} places", []).append(places)
            return out

        return wrapper

    for name, fn in originals.items():
        setattr(Trainer, name, counting(name, fn))
    try:
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(Trainer, name, fn)


def _tree_equal(torch, a, b) -> bool:
    """Two nested dicts of tensors hold the same keys and bit-equal tensors."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_tree_equal(torch, a[k], b[k]) for k in a)
    return a.dtype == b.dtype and bool(torch.equal(a, b))


def _pace(stats: dict, skip: int = RECIPE_STEADY) -> dict:
    """An epoch's pace from its (skip + 1)-th step on: median ms/step
    (CUDA events), median host turn per step, and the host's wait for data
    as a share of the host's time (wait + turn) over those steps."""
    wait, turn = stats["data_wait_s"][skip:], stats["turn_s"][skip:]
    return {"ms": float(np.median(stats["step_ms"][skip:])), "turn_ms": float(np.median(turn)) * 1e3,
            "wait_ms": float(np.median(wait)) * 1e3, "share": sum(wait) / (sum(wait) + sum(turn)),
            "start_s": sum(stats["data_wait_s"][:skip])}


def _print_epochs(what: str, launcher, waits: list, device_label: str) -> None:
    for stats, n_waits in zip(launcher.epoch_stats, waits):
        m, wait, step_ms = stats["metrics"], stats["data_wait_s"], stats["step_ms"]
        pace = _pace(stats)
        print(f"recipe {what} epoch {stats['epoch']}: {stats['steps']} steps from step {stats['first_step']}, "
              f"{float(np.median(step_ms)):.2f} ms/step (median, CUDA events; "
              + ", ".join(f"{x:.1f}" for x in step_ms) + "), "
              f"the host's wait for the next batch {float(np.median(wait)) * 1e3:.1f} ms median, "
              f"{sum(wait) * 1e3:.0f} ms in all ({sum(wait) / stats['wall_s']:.0%} of the epoch's "
              f"{stats['wall_s']:.2f} s); from step {RECIPE_STEADY + 1} on: {pace['ms']:.2f} ms/step, the host's turn "
              f"{pace['turn_ms']:.2f} ms, its wait {pace['wait_ms']:.2f} ms (median), data wait {pace['share']:.1%} "
              f"of the host's time (the first {RECIPE_STEADY} batches waited {pace['start_s']:.2f} s); "
              f"loss {m['loss']:.4f}, accuracy {m['accuracy']:.4f}, lr {m['lr']:.3e}, validation loss "
              f"{m['valid_loss']:.4f} (accuracy {m['valid_accuracy']:.4f}); {n_waits} host waits in the epoch; "
              f"on {device_label}", flush=True)


def _k1_recipe_shapes(torch, opts, root: str, extract_batch: int) -> dict:
    """K1 against its plain version (bf16 DFT, phase 2's tolerance) at the
    recipe's shapes, on the corpus's own waves: a train batch of 128
    training waves cut to the 2.015 s chunk, and one extraction batch of
    evaluation waves zero-padded to their bucket."""
    from asv_subtools_tpu_torch.extract import WAVE_BUCKETS
    from asv_subtools_tpu_torch.features import fused_fbank, fused_fbank_plain
    from asv_subtools_tpu_torch.io import read_wav

    dev, tol, chunk = torch.device("cuda"), 1e-3, int(2.015 * 16000)

    def waves(subset):
        with open(f"{root}/{subset}/wav.scp") as f:
            return [read_wav(line.split()[1])[0] for line in f if line.strip()]

    train = np.stack([w[:chunk] for w in waves("train")[:BATCH]])
    by_bucket: dict = {}
    for w in waves("eval"):
        by_bucket.setdefault(next(b for b in WAVE_BUCKETS if len(w) <= b), []).append(w)
    bucket, group = max(by_bucket.items(), key=lambda kv: (len(kv[1]), kv[0]))
    extract = np.zeros((min(len(group), extract_batch), bucket), np.float32)
    for row, w in zip(extract, group):
        row[: len(w)] = w
    errs = {}
    for what, x in (("train", train), ("extraction", extract)):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        k, _ = fused_fbank(x, opts, dft_dtype=torch.bfloat16, with_energy=False)
        route = fused_fbank.last_route
        p, _ = fused_fbank_plain(x, opts, dft_dtype=torch.bfloat16, with_energy=False)
        torch.cuda.synchronize()
        t = opts.frame_opts.num_frames(x.shape[1])
        errs[what] = max_abs(k, p)
        print(f"recipe K1 bf16 {what} batch [{x.shape[0]},{x.shape[1]}] -> [{x.shape[0]},{t},80] ({route}), the "
              f"corpus's waves: max abs err {errs[what]:.3e} (tol {tol})", flush=True)
        check(route == "tensor_core" and tuple(k.shape) == (x.shape[0], t, 80) and errs[what] <= tol,
              f"K1 at the recipe's {what} shape disagrees with its plain version")
    return errs


def phase_recipe(torch, device_label):
    """The recipe's stages 0-2 through the port's Launcher (see 12 above)."""
    import os

    from asv_subtools_tpu_torch.data import Prefetcher
    from asv_subtools_tpu_torch.extract import WAVE_BUCKETS
    from asv_subtools_tpu_torch.features import FbankOptions, MelOptions, fused_fbank
    from asv_subtools_tpu_torch.io import read_vec_flt_scp, read_wav
    from asv_subtools_tpu_torch.launcher import Launcher
    from asv_subtools_tpu_torch.recipes.synthetic import write_corpus
    from asv_subtools_tpu_torch.recipes.voxceleb import recipe_params
    from asv_subtools_tpu_torch.train import load_checkpoint

    dev = torch.device("cuda")
    opts = FbankOptions(mel_opts=MelOptions(num_bins=80))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, num_spks=RECIPE_SPEAKERS, train_per_spk=RECIPE_TRAIN_UTTS, eval_per_spk=RECIPE_EVAL_UTTS,
                     dur=(2.5, 4.0), eval_dur=(1.5, 12.0), seed=SEED + 80)
        print(f"recipe corpus: {RECIPE_SPEAKERS} speakers x ({RECIPE_TRAIN_UTTS} train of 2.5-4.0 s + "
              f"{RECIPE_EVAL_UTTS} eval of 1.5-12 s) written in {time.perf_counter() - t0:.1f} s", flush=True)
        # the recipe's own parameters; the cyclic schedule's half period cut
        # to half of this run's 54 steps (the recipe's --step-size-up for
        # short runs)
        params = recipe_params(tmp, f"{tmp}/exp", epochs=2, batch_size=BATCH, channels=1024, step_size_up=27)
        params["data"].update(valid_utts=64, num_workers=2, shuffle_buffer=RECIPE_SHUFFLE)
        params["train"]["report_interval"] = 6
        # outside the counted window; it also brings K1's constants for the
        # recipe's options to the card, ahead of the epochs whose waits count
        k1_errs = _k1_recipe_shapes(torch, opts, tmp, params["extract"]["batch"])
        waits: dict = {}
        zero_launches()

        # stage 0-1: two epochs
        launcher = Launcher(params)
        egs = launcher.build_egs()
        launcher.build_model()
        with counted_host_waits(waits):
            state = launcher.train(egs)
        torch.cuda.synchronize()
        steps = sum(s["steps"] for s in launcher.epoch_stats)
        k1_train = fused_fbank.launches
        _print_epochs("stage 1", launcher, waits["run_epoch"], device_label)
        ckpt = f"{tmp}/exp/checkpoints/2.params"
        loaded = load_checkpoint(ckpt, state, restore_optimizer=True)
        same = all(_tree_equal(torch, getattr(loaded, f), getattr(state, f))
                   for f in ("params", "batch_stats", "opt_state")) and int(loaded.step) == int(state.step)
        saved_step = int(state.step)

        # stage 1 resumed: a third epoch from checkpoints/2.params
        params["train"]["epochs"] = 3
        resumed = Launcher(params)
        egs2 = resumed.build_egs()
        resumed.build_model()
        with counted_host_waits(waits):
            resumed.train(egs2, resume_from=ckpt)
        torch.cuda.synchronize()
        _print_epochs("stage 1 resumed", resumed, waits["run_epoch"][2:], device_label)
        steps3 = resumed.epoch_stats[0]["steps"]
        k1_resumed = fused_fbank.launches - k1_train

        # stage 2: the training and evaluation lists to ark/scp in wave mode
        train_stats = resumed.extract(f"{tmp}/train/wav.scp", f"{tmp}/exp/xvector_train")
        stats = resumed.extract(f"{tmp}/eval/wav.scp", f"{tmp}/exp/xvector_eval")
        k1_extract = fused_fbank.launches - k1_train - k1_resumed

        # stage 3: the recipe's scoring (recipes/voxceleb/run.py:176-190)
        # through Launcher.score on the card, on stage 2's ark/scp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scored = resumed.score(f"{tmp}/exp/xvector_train.scp", f"{tmp}/train/utt2spk", f"{tmp}/exp/xvector_eval.scp",
                               f"{tmp}/exp/xvector_eval.scp", f"{tmp}/eval/trials", process="submean-norm",
                               classifier="cosine", score_norm="asnorm", top_n=300, cohort_size=3000)
        score_s = time.perf_counter() - t0
        fetches = resumed.score_sets.device_fetches
        score_device = resumed.score_sets.device
        with open(f"{tmp}/eval/trials") as f:
            n_trials = sum(1 for line in f if line.strip())
        counts = read_launches("recipe", ("fused_fbank",))
        reports = egs.worker_reports + egs2.worker_reports
        embs = dict(read_vec_flt_scp(f"{tmp}/exp/xvector_eval.scp"))
        with open(f"{tmp}/eval/wav.scp") as f:
            eval_list = [line.split() for line in f if line.strip()]

        # the first 8 evaluation utterances through the plain front end, each
        # in its own bucket-padded batch of one, the same model and weights
        backbone = resumed.net.backbone
        tensors = {k[len("backbone."):]: v for k, v in {**resumed.state.params, **resumed.state.batch_stats}.items()
                   if k.startswith("backbone.")}
        plain = _plain_embed(torch, lambda x, m: torch.func.functional_call(backbone.eval(), tensors, (x, m)),
                             opts, torch.bfloat16, torch.float32)
        cos = []
        with torch.inference_mode():
            for key, path in eval_list[:8]:
                wav, _ = read_wav(path)
                bucket = next(b for b in WAVE_BUCKETS if len(wav) <= b)
                x = torch.zeros((1, bucket), device=dev)
                x[0, : len(wav)] = torch.as_tensor(wav, device=dev)
                mask = torch.arange(bucket, device=dev)[None, :] < len(wav)
                ref = plain(x, mask)[0]
                cos.append(float(cosine(torch.as_tensor(embs[key], device=dev)[None], ref[None])[0]))

        # the steady pace, outside the counted window: the resumed Trainer's
        # epochs from batches held in pinned memory (no loader, no Prefetcher
        # thread) and from the live loader through the Prefetcher, as
        # Launcher.train feeds them, in turns
        trainer, pstate = resumed.trainer, resumed.state
        egs2.set_epoch(3)
        held = list(Prefetcher(egs2, pin_memory=True))
        gen = torch.Generator(device=dev).manual_seed(SEED + 81)
        pace: dict = {"memory": [], "loader": []}
        try:
            for source in ("memory", "loader", "loader", "memory"):
                egs2.set_epoch(4)
                pstate, m = trainer.run_epoch(pstate, held if source == "memory" else Prefetcher(egs2, pin_memory=True),
                                              gen, epoch=4)
                check(np.isfinite(m["loss"]), f"a pace epoch from {source} had a loss that was not finite")
                pace[source].append(_pace(trainer.epoch_stats))
        finally:
            egs2.close()
        reports_all = egs.worker_reports + egs2.worker_reports
        del held, pstate
    for source, runs in pace.items():
        print(f"recipe pace from {source} ({'batches held in pinned memory' if source == 'memory' else 'two spawn workers through the Prefetcher'}), "
              f"from step {RECIPE_STEADY + 1} of each epoch on, two epochs: "
              + "; ".join(f"{r['ms']:.2f} ms/step, the host's turn {r['turn_ms']:.2f} ms, its wait {r['wait_ms']:.2f} ms, "
                          f"data wait {r['share']:.1%} of the host's time" for r in runs)
              + f"; on {device_label}", flush=True)
    keys = [k for k, _ in eval_list]
    print(f"recipe stage 2: train list {train_stats['utts']} utterances in {train_stats['batches']} batches, "
          f"{train_stats['wall_s']:.2f} s wall; evaluation list {stats['utts']} utterances in {stats['batches']} "
          f"batches, {stats['wall_s']:.2f} s wall, {stats['device_s']:.2f} s in the embed calls, {stats['frames']} "
          f"samples; ark/scp keys {len(embs)}; cosine of the first 8 against the plain front end: min {min(cos):.6f} "
          f"(gate {RECIPE_COSINE})", flush=True)
    print(f"recipe stage 3 (Launcher.score: submean-norm, cosine, AS-norm top 300 over the first 3,000 sorted train "
          f"vectors, enroll = test = the evaluation list, the cosine matrices on {score_device}): {n_trials} trials, "
          f"EER {scored['eer']:.4f}, minDCF(0.01) {scored['min_dcf']:.4f} (neither gated); {score_s:.2f} s; "
          f"{fetches} copies of a cosine matrix to the host; on {device_label}", flush=True)
    served = 2 * (len(launcher.epoch_stats) + len(resumed.epoch_stats))
    print(f"recipe checks: K1 against plain at the recipe's train shape {k1_errs['train']:.3e}, its extraction shape "
          f"{k1_errs['extraction']:.3e} (tol 1e-3); K1 launches {k1_train} for {steps} steps, {k1_resumed} for "
          f"{steps3} resumed steps, {k1_extract} for {train_stats['batches'] + stats['batches']} extraction batches; "
          f"host waits per epoch "
          f"{waits['run_epoch']} (expected 2 + steps // {params['train']['report_interval']}), per validation "
          f"{waits['validate']}; loader workers' reports {len(reports)} (expected {served}; "
          f"{len(reports_all)} with the pace epochs'): pids {sorted({r['pid'] for r in reports_all})}, "
          f"CUDA_VISIBLE_DEVICES {sorted({repr(r['cuda_visible_devices']) for r in reports_all})}, torch imported "
          f"{sorted({r['torch_imported'] for r in reports_all})}, CUDA initialised "
          f"{sorted({r['cuda_initialized'] for r in reports_all})}; checkpoint reload bit for bit {same}; resumed at "
          f"step {resumed.epoch_stats[0]['first_step']} (saved {saved_step})", flush=True)
    losses = [s["metrics"][k] for s in launcher.epoch_stats + resumed.epoch_stats for k in ("loss", "valid_loss")]
    check(all(np.isfinite(x) for x in losses) and all(s["metrics"]["skipped"] == 0 for s in launcher.epoch_stats),
          "a recipe loss was not finite")
    check(k1_train == steps and k1_resumed == steps3 and k1_extract == train_stats["batches"] + stats["batches"],
          "K1 did not launch once a train step and once an extraction batch")
    every = launcher.epoch_stats + resumed.epoch_stats
    expected = [2 + s["steps"] // params["train"]["report_interval"] for s in every]
    check(waits["run_epoch"] == expected, f"an epoch waited on the card {waits['run_epoch']} times, not {expected}: "
          f"{waits['run_epoch places']}")
    check(len(reports) == served and len(reports_all) == served + 2 * 3
          and all(r["cuda_visible_devices"] == "" and not r["cuda_initialized"] and r["pid"] != os.getpid()
                  for r in reports_all),
          "a loader worker saw the card or initialised CUDA, or did not report at the end of an epoch")
    check(same and resumed.epoch_stats[0]["first_step"] == saved_step and [s["epoch"] for s in every] == [1, 2, 3],
          "the checkpoint did not reload bit for bit, or the resumed epoch did not start at its step")
    check(sorted(embs) == sorted(keys) and all(e.shape == (192,) and np.isfinite(e).all() for e in embs.values()),
          "the ark/scp did not read back")
    check(min(cos) >= RECIPE_COSINE, f"the recipe's embeddings are {min(cos):.6f} from the plain front end's")
    check(train_stats["utts"] == RECIPE_SPEAKERS * RECIPE_TRAIN_UTTS, "the train list was not extracted whole")
    check(score_device.type == "cuda" and fetches == 3, f"stage 3 scored on {score_device} with {fetches} copies "
          "of a cosine matrix, not on the card with 3")
    check(scored["num_trials"] == n_trials and all(np.isfinite(v) for v in scored.values()),
          f"stage 3 scored {scored['num_trials']} of {n_trials} trials, or a metric was not finite")
    return counts


# the back end at scale: tests/test_backend_scale.py:24 (VoxCeleb1-E/H:
# 582,000 trials against a VoxCeleb2-dev cohort of 5,994), and VoxCeleb1-O
BACKEND_E, BACKEND_T, BACKEND_C, BACKEND_D = 600, 970, 5994, 256
VOX1O_UTTS, VOX1O_SPEAKERS, VOX1O_TRIALS, VOX1O_D = 4874, 40, 37720, 192
VOX2_SPEAKERS, VOX2_PER_SPEAKER = 5994, 8


def _vox1o_task(seed: int):
    """Speaker-structured embeddings at VoxCeleb1-O's sizes: 4,874 eval
    vectors of 40 speakers, 37,720 trials (half target, drawn without
    repeats), and a training set of 5,994 speakers x 8. Speaker centroids
    N(0, I), within-speaker noise N(0, diag(s)) with s from 0.5 to 8 over
    the dimensions (so that the chain's whitening and PLDA have work)."""
    rng = np.random.default_rng(seed)
    within = np.sqrt(np.linspace(0.5, 8.0, VOX1O_D))

    def draw(centroids, ids):
        return (centroids[ids] + within * rng.normal(size=(len(ids), VOX1O_D))).astype(np.float32)

    train_ids = np.repeat(np.arange(VOX2_SPEAKERS), VOX2_PER_SPEAKER)
    train = draw(rng.normal(size=(VOX2_SPEAKERS, VOX1O_D)), train_ids)
    eval_spk = np.sort(rng.integers(0, VOX1O_SPEAKERS, VOX1O_UTTS))
    evals = draw(rng.normal(size=(VOX1O_SPEAKERS, VOX1O_D)), eval_spk)
    keys = [f"id{s:05d}-{i:05d}" for i, s in enumerate(eval_spk)]
    half = VOX1O_TRIALS // 2
    same = np.flatnonzero(eval_spk[:, None] == eval_spk[None, :])
    diff = np.flatnonzero(eval_spk[:, None] != eval_spk[None, :])
    n = VOX1O_UTTS
    tar = rng.choice(same[same // n != same % n], half, replace=False)
    non = rng.choice(diff, half, replace=False)
    pairs = np.concatenate([tar, non])
    labels = np.concatenate([np.ones(half, np.int64), np.zeros(half, np.int64)])
    return train, train_ids, dict(zip(keys, evals)), [keys[i] for i in pairs // n], [keys[i] for i in pairs % n], \
        labels


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def phase_backend(torch, device_label):
    """The scoring back end at scale (see 13 above)."""
    from asv_subtools_tpu_torch.backend import (PldaStats, ScoreConfig, ScoreSets, Trials, asnorm, asnorm_device,
                                                cosine_score_matrix, estimate_plda)
    from asv_subtools_tpu_torch.backend.plda import llr_matrix_device

    dev = torch.device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    zero_launches()

    # 1. AS-norm at 600 x 970 against a 5,994-vector cohort, D=256
    rng = np.random.default_rng(SEED + 90)
    centroids = rng.normal(size=(400, BACKEND_D)).astype(np.float32)

    def draw(n):
        return (centroids[rng.integers(0, 400, n)] + 0.5 * rng.normal(size=(n, BACKEND_D))).astype(np.float32)

    enroll, test, cohort = (torch.as_tensor(draw(n), device=dev) for n in (BACKEND_E, BACKEND_T, BACKEND_C))
    raw, ec, tc = (cosine_score_matrix(a, b) for a, b in ((enroll, test), (enroll, cohort), (test, cohort)))
    got = asnorm_device(raw, ec, tc, top_n=300)
    torch.cuda.synchronize()
    on_card = [m.device.type for m in (raw, ec, tc, got)]
    finite = bool(torch.isfinite(got).all())
    raw_h, ec_h, tc_h = (m.cpu().numpy() for m in (raw, ec, tc))
    t0 = time.perf_counter()
    want = asnorm(raw_h, ec_h, tc_h, top_n=300)
    host_s = time.perf_counter() - t0
    as_ok = bool(np.allclose(got.cpu().numpy(), want, rtol=2e-3, atol=2e-4))
    as_err = float(np.abs(got.cpu().numpy() - want).max())
    as_ms = device_ms(torch, lambda: asnorm_device(raw, ec, tc, top_n=300), n=10)
    as_prof, as_seen = profiled_ms(torch, lambda: asnorm_device(raw, ec, tc, top_n=300), n=10)
    cos_ms = device_ms(torch, lambda: (cosine_score_matrix(enroll, test), cosine_score_matrix(enroll, cohort),
                                       cosine_score_matrix(test, cohort)), n=10)
    print(f"backend asnorm_device: {BACKEND_E} x {BACKEND_T} = {BACKEND_E * BACKEND_T} trials, cohort {BACKEND_C}, "
          f"D={BACKEND_D}, top 300, f32 on {got.device}: max abs err {as_err:.3e} against the f64 host asnorm "
          f"(rtol 2e-3, atol 2e-4: {as_ok}); {as_ms:.3f} ms a call on the card (CUDA events, 10 back to back), "
          f"{_fmt_ms(as_prof)} ms of kernels ({as_seen}), the three "
          f"cosine matrices {cos_ms:.3f} ms; the f64 host asnorm {host_s * 1e3:.1f} ms; on {device_label}", flush=True)

    # 2. the PLDA LLR matrix at 600 x 970, D=256, from a PLDA fitted on
    # 200 speakers x 8 vectors, 5 EM iterations
    prng = np.random.default_rng(SEED + 91)
    pc = prng.normal(size=(200, BACKEND_D))
    vecs = (pc[:, None, :] + 0.4 * prng.normal(size=(200, 8, BACKEND_D))).reshape(-1, BACKEND_D)
    t0 = time.perf_counter()
    plda = estimate_plda(PldaStats.from_vectors(vecs, np.repeat(np.arange(200), 8)), num_em_iters=5)
    fit_s = time.perf_counter() - t0
    llr = llr_matrix_device(plda, enroll, test)
    torch.cuda.synchronize()
    on_card.append(llr.device.type)
    finite = finite and bool(torch.isfinite(llr).all())
    e_h, t_h = enroll.cpu().numpy(), test.cpu().numpy()
    t0 = time.perf_counter()
    llr_want = plda.llr_matrix(e_h, t_h)
    llr_host_s = time.perf_counter() - t0
    llr_ok = bool(np.allclose(llr.cpu().numpy(), llr_want, rtol=2e-3, atol=2e-3))
    llr_err = float(np.abs(llr.cpu().numpy() - llr_want).max())
    llr_ms = device_ms(torch, lambda: llr_matrix_device(plda, enroll, test), n=10)
    llr_prof, llr_seen = profiled_ms(torch, lambda: llr_matrix_device(plda, enroll, test), n=10)
    print(f"backend llr_matrix_device: {BACKEND_E} x {BACKEND_T}, D={BACKEND_D}, f32 on {llr.device}: max abs err "
          f"{llr_err:.3e} against the f64 Plda.llr_matrix on the whole matrix (max |llr| "
          f"{float(np.abs(llr_want).max()):.1f}; rtol 2e-3, atol 2e-3: {llr_ok}); {llr_ms:.3f} ms a call on the card "
          f"(CUDA events, 10 back to back), {_fmt_ms(llr_prof)} ms of kernels ({llr_seen}); the f64 host llr_matrix {llr_host_s * 1e3:.1f} ms, the PLDA fit "
          f"(1,600 x {BACKEND_D}, 5 EM iterations) {fit_s:.2f} s; on {device_label}", flush=True)
    del raw, ec, tc, got, llr

    # 3. ScoreSets end to end at VoxCeleb1-O scale
    train, train_ids, evals, e_keys, t_keys, labels = _vox1o_task(SEED + 92)
    trials = Trials(e_keys, t_keys, labels)
    rows = {}
    for what, cfg, cohort_n in (
            ("recipe", ScoreConfig(process="submean-norm", classifier="cosine", score_norm="asnorm", top_n=300), 3000),
            ("plda", ScoreConfig(process="mean-lda-submean-whiten-norm", classifier="plda", lda_dim=128,
                                 plda_iters=10), 0)):
        t0 = time.perf_counter()
        pipe = ScoreSets(cfg).fit(train, train_ids)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = pipe.run(evals, evals, trials, cohort=train[:cohort_n] if cohort_n else None)
        run_s = time.perf_counter() - t0
        rows[what] = out
        extra = ""
        if cfg.classifier == "cosine":
            keys = sorted(evals)
            e, c = (torch.as_tensor(pipe.transform(v), dtype=torch.float32, device=dev)
                    for v in (np.stack([evals[k] for k in keys]), train[:cohort_n]))
            mats_ms = device_ms(torch, lambda: (cosine_score_matrix(e, e), cosine_score_matrix(e, c),
                                                cosine_score_matrix(e, c)), n=10)
            extra = (f"; the three cosine matrices ([{len(keys)}, {len(keys)}] and twice [{len(keys)}, {cohort_n}]) "
                     f"{mats_ms:.3f} ms on the card (CUDA events, 10 back to back), {pipe.device_fetches} copies to "
                     f"the host")
            check(pipe.device_fetches == 3, f"ScoreSets made {pipe.device_fetches} copies, not 3")
        print(f"backend ScoreSets {what} ({cfg.process}, {cfg.classifier}, score norm {cfg.score_norm}"
              f"{', cohort %d' % cohort_n if cohort_n else ''}) at VoxCeleb1-O scale ({VOX1O_UTTS} eval vectors, "
              f"D={VOX1O_D}, {len(labels)} trials, fit on {len(train)} vectors of {VOX2_SPEAKERS} speakers): fit "
              f"{fit_s:.2f} s, scoring {run_s:.2f} s (host clock); EER {out['eer']:.4f}, minDCF(0.01) "
              f"{out['min_dcf']:.4f} (not gated){extra}; on {device_label}", flush=True)
    counts = read_launches("backend", ())
    check(on_card == ["cuda"] * 5, f"a device function returned a tensor off the card: {on_card}")
    check(finite, "a device result was not finite")
    check(as_ok, f"asnorm_device is {as_err:.3e} from the f64 host asnorm (rtol 2e-3, atol 2e-4)")
    check(llr_ok, f"llr_matrix_device is {llr_err:.3e} from the f64 Plda.llr_matrix (rtol 2e-3, atol 2e-3)")
    check(all(np.isfinite(v) for out in rows.values() for v in out.values())
          and all(out["num_trials"] == VOX1O_TRIALS for out in rows.values()),
          "a ScoreSets metric was not finite, or not every trial was scored")
    return counts


# The TDNN x-vectors (recipes/configs/{snowdar,factored}_xvector.yaml):
# SnowdarXvector 512/512 pools 1500 channels, the F-TDNN at width 1.0 2048
XVECTORS = (("SnowdarXvector 512/512", "snowdar", 1500), ("FactoredXvector width 1.0", "ftdnn", 2048))


def _k4_on_the_model(torch, x, m, label: str) -> None:
    """K4 on the pooling input the served model hands over (a [B, T, D]
    view of [B, D, T] bf16 memory): its route, against its plain version,
    and its time beside its bound, the wrapper's copy of x alone, the kernel
    on a packed copy, torch.std_mean on the view and the plain version."""
    from asv_subtools_tpu_torch.nn import fused_stats_pooling, fused_stats_pooling_plain

    b, t, d = x.shape
    k = fused_stats_pooling(x, m)
    route = fused_stats_pooling.last_route
    xc = x.contiguous()
    p = fused_stats_pooling_plain(xc, m)
    torch.cuda.synchronize()
    err = max_abs(k, p)
    rtol, atol = 1e-4, 1e-5  # phase 5's: both sides sum the same values in f32
    print(f"x-vector K4 bf16 [{b},{t},{d}] ({label}'s pooling input, a [B, T, D] view with strides "
          f"{tuple(x.stride())}): route {route}, max abs err vs plain {err:.3e} (rtol {rtol}, atol {atol})", flush=True)
    check(close(torch, k, p, atol, rtol) and tuple(k.shape) == (b, 2 * d),
          f"K4 disagrees with its plain version on the {label} pooling input")

    def run_lib():
        std, mean = torch.std_mean(x, dim=1, correction=0)
        return mean, std

    runs = {"wrapper on the view (copy + kernel)": lambda: fused_stats_pooling(x, m),
            "copy of x alone (.contiguous())": lambda: x.contiguous(),
            "kernel on a packed copy": lambda: fused_stats_pooling(xc, m),
            "torch.std_mean on the view": run_lib,
            "plain version": lambda: fused_stats_pooling_plain(x, m)}
    nbytes = x.element_size() * x.numel() + b * t + 4 * 2 * b * d
    bound, by = bound_ms(nbytes, 4.0 * b * t * d, peak="f32")
    copy_bound, _ = bound_ms(2 * x.element_size() * x.numel(), 0.0)
    for name, fn in runs.items():
        prof, seen = profiled_ms(torch, fn)
        back = device_ms(torch, fn, n=20)
        prof_s = "not measured" if prof is None else f"{prof:.4f}"
        print(f"x-vector K4 bf16 [{b},{t},{d}] {name} (ms): kernels' device durations {prof_s} ({seen}), "
              f"20 launches back to back {back:.4f}", flush=True)
    print(f"x-vector K4 bf16 [{b},{t},{d}] bound {bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB); the copy's bound "
          f"{copy_bound:.4f} ms ({2 * x.element_size() * x.numel() / 1e6:.1f} MB read and written)", flush=True)


def phase_served_xvector(torch, device_label):
    """SnowdarXvector 512/512 and FactoredXvector width 1.0 served at full
    width (seeded random weights, bf16) behind make_wave_embed_fn on one
    [128, 160000] batch with 80 bins, the statistics pooling fused and
    unfused; each held against the same bf16 model fed by the plain front
    end and against an f32 model on the f32 plain front end; then the
    Extractor run as in 6. After the counted window: ms/batch in turns, one
    batch profiled, and K4 on each model's own pooling input."""
    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.train.step_check import OPTS, xvector_net

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    wave = torch.randn((BATCH, SAMPLES), generator=gen, device=dev) * 1000.0
    mask = torch.ones((BATCH, SAMPLES), dtype=torch.bool, device=dev)
    waves = [wave * (1.0 + 1e-4 * i) for i in range(4)]
    audio_s = BATCH * SAMPLES / 16.0  # audio-milliseconds per batch over ms = audio-s/s
    wrap = lambda model: make_wave_embed_fn(lambda x, m: model(x, m), OPTS, dtype=torch.bfloat16)
    models = {}
    with torch.inference_mode():
        for i, (label, family, _) in enumerate(XVECTORS):
            model32 = xvector_net(family, seed=SEED + 81 + i).backbone.to(dev).eval()
            off16 = copy.deepcopy(model32).to(torch.bfloat16)
            on16 = copy.deepcopy(off16)
            on16.stats.fused_inference = True
            refs = (_plain_embed(torch, off16, OPTS, torch.bfloat16, torch.bfloat16)(wave, mask),
                    _plain_embed(torch, model32, OPTS, torch.float32, torch.float32)(wave, mask))
            models[label] = (on16, off16, refs)
            del model32
        torch.cuda.synchronize()

        # the main path: counters from zero
        zero_launches()
        for label, (on16, off16, (ref16, ref32)) in models.items():
            for flag, model in (("fused pooling", on16), ("unfused pooling", off16)):
                emb = wrap(model)(waves[0], mask)
                torch.cuda.synchronize()
                check(tuple(emb.shape) == (BATCH, 512) and bool(torch.isfinite(emb.float()).all()),
                      f"served {label} embeddings ({flag}) not finite or of the wrong shape")
                c16, c32 = float(cosine(emb, ref16).min()), float(cosine(emb, ref32).min())
                print(f"served {label} bf16, {flag}: min per-utterance cosine vs unfused + plain front end (bf16) "
                      f"{c16:.6f} (>= 0.9999), vs f32 model + f32 plain front end {c32:.6f} (>= 0.999)", flush=True)
                check(c16 >= 0.9999 and c32 >= 0.999, f"served {label} embeddings ({flag}) disagree")
    for label, (on16, _, _) in models.items():
        server_run(torch, wrap(on16), label)
    counts = read_launches("x-vector served", ("fused_fbank", "fused_stats_pooling"))

    with torch.inference_mode():
        for label, (on16, off16, _) in models.items():
            embed_on, embed_off = wrap(on16), wrap(off16)
            turns = [timed_batches(torch, fn, waves, mask, iters=3)
                     for fn in (embed_off, embed_on, embed_on, embed_off)]
            ms_on, ms_off = min(turns[1:3]), min(turns[0], turns[3])
            print(f"served {label} bf16 [{BATCH},{SAMPLES}] ms/batch: fused pooling {ms_on:.2f} "
                  f"({audio_s / ms_on:.0f} audio-s/s), unfused {ms_off:.2f} ({audio_s / ms_off:.0f} audio-s/s) on "
                  f"{device_label} (turns off {turns[0]:.2f} on {turns[1]:.2f} on {turns[2]:.2f} off {turns[3]:.2f})",
                  flush=True)
            profile_served_batch(torch, lambda: embed_on(waves[0], mask), what=f"one served {label} batch")
            seen = {}
            hook = on16.stats.register_forward_hook(lambda mod, args, out: seen.update(x=args[0], mask=args[1]))
            embed_on(waves[0], mask)
            hook.remove()
            _k4_on_the_model(torch, seen["x"], seen["mask"], label)
            del seen
    del models
    return counts


def phase_train_xvector(torch, device_label):
    """The train steps of SnowdarXvector 512/512 and FactoredXvector width
    1.0 on their recipe configurations (recipes/configs/{snowdar,
    factored}_xvector.yaml: AM m=0.2 over 5994 classes, SGD 1e-2 on warmR
    t_0 20000, momentum 0.9 for the snowdar one, use_semi_orth for the
    F-TDNN) on raw waves at B=128 x 2 s, bf16 on f32 masters, K1 in the
    step: 30 steps on one fixed batch under the sync check, 20 timed, one
    profiled, the last loss below the first; the F-TDNN's semi-orthogonal
    objective of layer02's factor1 at steps 0, 4, 8, ...; then the narrow
    F-TDNN's steps, card against CPU, over step 0 (0 % 4 == 0)."""
    from asv_subtools_tpu_torch.nn import semi_orth_objective
    from asv_subtools_tpu_torch.train import (TrainStepConfig, get_lr_schedule, get_optimizer, init_train_state,
                                              make_train_step)
    from asv_subtools_tpu_torch.train.step_check import xvector_net

    counts = {}
    key = "backbone.layer02.factor1.conv.weight"
    for i, (label, family, _) in enumerate(XVECTORS):
        opts, gen, wave, labels = _train_batch(torch, SEED + 85 + i)
        net = xvector_net(family, seed=SEED + 87 + i)
        schedule = get_lr_schedule("warmR", base_lr=1e-2, t_0=20000)
        momentum = 0.9 if family == "snowdar" else None
        tx = get_optimizer("sgd", schedule, momentum=momentum)
        state = init_train_state(net, tx, "cuda")
        semi = family == "ftdnn"
        step = make_train_step(net, tx, schedule, TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True,
                                                                 fbank_opts=opts, use_semi_orth=semi))
        objective = {}
        if semi:
            objective["before step 0"] = semi_orth_objective(state.params[key])

            def watch(n, st):
                if n % 4 == 0:  # the state after step n, which applied the update
                    objective[f"after step {n}"] = semi_orth_objective(st.params[key])
        opt = f"sgd{' momentum 0.9' if momentum else ''} warmR 1e-2{', use_semi_orth' if semi else ''}"
        c = run_fixed_batch(torch, step, state, {"x": wave, "y": labels}, gen, f"train {label} bf16",
                            f"{label} train step", device_label, falls_to=1.0, opt=opt,
                            watch=watch if semi else None)
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        if semi:
            values = {k: float(v) for k, v in objective.items()}
            print(f"train {label}: semi-orthogonal objective ||P - scale I||^2 of {key} (P = M M^T, "
                  f"M [{state.params[key].shape[0]}, {state.params[key].shape[1] * state.params[key].shape[2]}]): "
                  + ", ".join(f"{k} {v:.4e}" for k, v in values.items()), flush=True)
            check(all(np.isfinite(v) for v in values.values()) and values["after step 0"] < values["before step 0"],
                  "the semi-orthogonal update did not lower the objective of a factor1 weight")
        del state, step, net
        torch.cuda.empty_cache()
    _card_against_cpu(torch, "ftdnn")
    return counts


# 10 languages of one speaker each, 128 training utterances of 2.5-4.0 s
# and 8 evaluation ones: 5 steps an epoch at the recipe's B = 256
OLR_LANGS, OLR_TRAIN_UTTS, OLR_EVAL_UTTS = 10, 128, 8


def phase_olr(torch, device_label):
    """The OLR language-identification recipe's stages 0-3 through
    asv_subtools_tpu_torch.recipes.olr (recipes/olr/run.py: extended_xvector
    width 512, AM m=0.2, SGD 1e-2 on warmR t_0 20000, 3.0 s chunks,
    B=256, host fbank) on a synthetic language corpus (10 languages, 128
    training utterances of 2.5-4.0 s each and 8 evaluation ones), two
    epochs. Stage 3 fits the logistic regression with the lbfgs solver
    (scipy; the script needs no sklearn). Per epoch: ms/step, the host's wait,
    loss, accuracy; then the extraction stats, Cavg and EER% (not gated).
    Checks: every loss finite, the ark/scp read back, Cavg finite. No
    kernel runs here (host fbank, unfused pooling): the counters show it."""
    import os

    from asv_subtools_tpu_torch.io import read_vec_flt_scp
    from asv_subtools_tpu_torch.recipes import olr
    from asv_subtools_tpu_torch.recipes.synthetic import write_corpus

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = write_corpus(f"{tmp}/data", num_spks=OLR_LANGS, train_per_spk=OLR_TRAIN_UTTS,
                            eval_per_spk=OLR_EVAL_UTTS, dur=(2.5, 4.0), seed=SEED + 95, num_langs=OLR_LANGS)
        corpus_s = time.perf_counter() - t0
        exp = f"{tmp}/exp"
        zero_launches()
        t0 = time.perf_counter()
        launcher, extracted, _ = olr.run(data, exp, stop_stage=2, epochs=2)
        t_score = time.perf_counter()
        out = olr.score_languages(data, exp, "lbfgs")
        score_s = time.perf_counter() - t_score
        run_s = time.perf_counter() - t0
        counts = read_launches("OLR recipe", ())
        p = launcher.params
        print(f"OLR recipe ({p['model']['name']} width {p['model']['params']['num_frame_channels']}, B "
              f"{p['data']['batch_size']}, {p['data']['chunk_seconds']} s chunks, {OLR_LANGS} languages x "
              f"{OLR_TRAIN_UTTS} training utterances; corpus written in {corpus_s:.1f} s): stages 0-3 in "
              f"{run_s:.1f} s on {device_label}", flush=True)
        losses = []
        for stats in launcher.epoch_stats:
            m, wait = stats["metrics"], stats["data_wait_s"]
            losses.append(m["loss"])
            print(f"OLR epoch {stats['epoch']}: {stats['steps']} steps, "
                  f"{float(np.median(stats['step_ms'])):.2f} ms/step (median, CUDA events; "
                  + ", ".join(f"{x:.1f}" for x in stats["step_ms"]) + f"), the host's wait for the next batch "
                  f"{float(np.median(wait)) * 1e3:.1f} ms median, {sum(wait):.2f} s in all of the epoch's "
                  f"{stats['wall_s']:.2f} s; loss {m['loss']:.4f}, accuracy {m['accuracy']:.4f}", flush=True)
        read = {}
        for subset, n in (("train", OLR_LANGS * OLR_TRAIN_UTTS), ("eval", OLR_LANGS * OLR_EVAL_UTTS)):
            embs = dict(read_vec_flt_scp(os.path.join(exp, f"xvector_{subset}.scp")))
            read[subset] = len(embs) == n and all(v.shape == (p["model"]["params"]["embd_dim"],)
                                                  and np.isfinite(v).all() for v in embs.values())
        for subset, st in extracted.items():
            print(f"OLR extraction of the {subset} list (feature mode, host fbank): {st['utts']} utterances, "
                  f"{st['frames']} frames in {st['batches']} batches, {st['wall_s']:.2f} s wall, {st['device_s']:.2f} s "
                  f"device", flush=True)
        print(f"OLR ark/scp read back {read}; stage 3 (lbfgs logistic regression, {score_s:.1f} s on the host): "
              f"Cavg {out['Cavg']:.4f}, EER {out['EER%']:.2f}% (not gated)", flush=True)
    check(len(losses) == 2 and all(np.isfinite(x) for x in losses), f"an OLR epoch loss was not finite: {losses}")
    check(all(read.values()), f"the OLR ark/scp did not read back: {read}")
    check(np.isfinite(out["Cavg"]), "the OLR Cavg is not finite")
    check(not any(counts.values()), f"a kernel ran on the OLR path, which uses host features: {counts}")
    return counts


# The RepVGG x-vector, the roadmap ECAPA and the lawlict ECAPA
# (recipes/configs/{repvgg,ecapa_roadmap,ecapa_lawlict}.yaml)
REPVGG_COSINE = 0.99999  # the deployed f32 model against its train shape, per utterance


def _seed_running_stats(torch, model, seed: int):
    """BatchNorm running statistics away from (0, 1): means N(0, 0.1^2),
    variances U[0.5, 2], so that a fold of the BNs into the convs shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith(".mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith(".var"):
                b.copy_(torch.rand(b.shape, generator=g) * 1.5 + 0.5)
    return model


def _served_batch(torch, seed: int):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    wave = torch.randn((BATCH, SAMPLES), generator=gen, device=dev) * 1000.0
    mask = torch.ones((BATCH, SAMPLES), dtype=torch.bool, device=dev)
    return [wave * (1.0 + 1e-4 * i) for i in range(4)], mask


def _hold(torch, label: str, emb, embd: int, refs: dict) -> None:
    """emb finite and [BATCH, embd]; its least per-utterance cosine against
    each reference of ``refs`` ({what: (embeddings, bar)}) at its bar."""
    check(tuple(emb.shape) == (BATCH, embd) and bool(torch.isfinite(emb.float()).all()),
          f"served {label} embeddings not finite or of the wrong shape")
    got = {what: (float(cosine(emb, ref).min()), bar) for what, (ref, bar) in refs.items()}
    print(f"served {label}: min per-utterance cosine " + ", ".join(f"vs {w} {c:.6f} (>= {b})"
                                                                    for w, (c, b) in got.items()), flush=True)
    check(all(c >= b for c, b in got.values()), f"served {label} embeddings disagree with the references")


def _turns(torch, label: str, runs: dict, waves, mask, device_label: str) -> dict:
    """ms/batch of each run of ``runs`` in turns (a, b, ..., ..., b, a),
    the best of each printed beside the turns."""
    order = list(runs) + list(runs)[::-1]
    turns = [(name, timed_batches(torch, runs[name], waves, mask, iters=3)) for name in order]
    best = {name: min(ms for n, ms in turns if n == name) for name in runs}
    audio_s = BATCH * SAMPLES / 16.0
    print(f"served {label} [{BATCH},{SAMPLES}] ms/batch on {device_label}: "
          + ", ".join(f"{name} {ms:.2f} ({audio_s / ms:.0f} audio-s/s)" for name, ms in best.items())
          + " (turns " + " ".join(f"{n} {ms:.2f}" for n, ms in turns) + ")", flush=True)
    return best


def phase_served_repvgg(torch, device_label):
    """RepVggXvector at full width and depth from repvgg.yaml (RepSPK blocks
    2-4-14-1, base 32, width (1, 1, 1, 2.5), embedding 256; seeded random
    weights and running statistics away from (0, 1)), bf16, behind
    make_wave_embed_fn on one [128, 160000] batch: the train shape with the
    statistics pooling fused (K4) and unfused, and the deployed model
    (deploy_repvgg_xvector: one 5x5 conv a block, K4 fused). Each is held
    against the unfused bf16 train shape on the plain front end and the
    f32 train shape on the f32 plain front end; the deployed f32 model
    against the f32 train shape on the same features at REPVGG_COSINE.
    Then the Extractor run as in 6. After the counted window: ms/batch in
    turns (which of the two shapes is faster is printed), one batch of
    each shape profiled, and K4 on the model's own pooling input
    [128, 125, 6400]."""
    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.models import RepVggXvector, deploy_repvgg_xvector
    from asv_subtools_tpu_torch.train.step_check import OPTS
    from asv_subtools_tpu_torch.weights import init_weights_

    model32 = _seed_running_stats(torch, init_weights_(RepVggXvector(80, base_channels=32, device="cpu"), SEED + 100),
                                  SEED + 101).cuda()
    off16 = copy.deepcopy(model32).to(torch.bfloat16)
    on16 = copy.deepcopy(off16)
    on16.head.stats.fused_inference = True
    dep32 = deploy_repvgg_xvector(model32)
    dep16 = copy.deepcopy(dep32).to(torch.bfloat16)
    dep16.head.stats.fused_inference = True
    waves, mask = _served_batch(torch, SEED + 102)
    wrap = lambda model: make_wave_embed_fn(lambda x, m: model(x, m), OPTS, dtype=torch.bfloat16)
    embed = {"train shape, fused pooling": wrap(on16), "train shape, unfused": wrap(off16),
             "deployed, fused pooling": wrap(dep16)}
    with torch.inference_mode():
        ref16 = _plain_embed(torch, off16, OPTS, torch.bfloat16, torch.bfloat16)(waves[0], mask)
        ref32 = _plain_embed(torch, model32, OPTS, torch.float32, torch.float32)(waves[0], mask)
        dep_ref32 = _plain_embed(torch, dep32, OPTS, torch.float32, torch.float32)(waves[0], mask)
        c = float(cosine(dep_ref32, ref32).min())
        print(f"RepVGG deployed f32 vs train shape f32 on the same f32 plain features: min per-utterance cosine "
              f"{c:.7f} (>= {REPVGG_COSINE})", flush=True)
        check(c >= REPVGG_COSINE, "the deployed RepVGG disagrees with its train shape")
        del dep_ref32
        torch.cuda.synchronize()

        # the main path: counters from zero
        zero_launches()
        for name, fn in embed.items():
            emb = fn(waves[0], mask)
            torch.cuda.synchronize()
            # the deployed bf16 trunk rounds at other places (one folded
            # 5x5 conv where the train shape sums three bf16 branches): it
            # is held at the bar of bf16 against f32 on both references
            bar16 = 0.999 if name.startswith("deployed") else 0.9999
            _hold(torch, f"RepVGG bf16 {name}", emb, 256,
                  {"the unfused train shape + plain front end (bf16)": (ref16, bar16),
                   "the f32 train shape + f32 plain front end": (ref32, 0.999)})
    server_run(torch, embed["train shape, fused pooling"], "RepVGG train shape")
    server_run(torch, embed["deployed, fused pooling"], "RepVGG deployed")
    counts = read_launches("RepVGG served", ("fused_fbank", "fused_stats_pooling"))

    with torch.inference_mode():
        best = _turns(torch, "RepVGG bf16", embed, waves, mask, device_label)
        fast = min(("train shape, fused pooling", "deployed, fused pooling"), key=best.get)
        print(f"served RepVGG: the faster of the two shapes on this card is the {fast.split(',')[0]} "
              f"(5x5 deploy convs: about 41.5 GMAC an utterance; the train shape's branches 18/25 of that)",
              flush=True)
        for name in ("train shape, fused pooling", "deployed, fused pooling"):
            profile_served_batch(torch, lambda: embed[name](waves[0], mask), what=f"one served RepVGG batch ({name})")
        seen = {}
        hook = on16.head.stats.register_forward_hook(lambda mod, args, out: seen.update(x=args[0], mask=args[1]))
        embed["train shape, fused pooling"](waves[0], mask)
        hook.remove()
        _k4_on_the_model(torch, seen["x"], seen["mask"], "RepVGG")
    return counts


def phase_served_roadmap_ecapa(torch, device_label):
    """ECAPA-TDNN C1024 with MQMHA pooling (ecapa_roadmap.yaml: 2 queries x
    2 heads, embedding 192; seeded random weights), bf16, behind
    make_wave_embed_fn on one [128, 160000] batch, with its three Res2
    chains unfused and fused (K3); held and timed as in 6, one batch
    profiled, the Extractor run."""
    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.models import EcapaTdnn, Res2NetBlock
    from asv_subtools_tpu_torch.nn import fused_res2_chain
    from asv_subtools_tpu_torch.train.step_check import OPTS, ROADMAP_ECAPA
    from asv_subtools_tpu_torch.weights import init_weights_

    model32 = init_weights_(EcapaTdnn(80, channels=1024, embd_dim=192, **ROADMAP_ECAPA), SEED + 110)
    off16 = copy.deepcopy(model32).to(torch.bfloat16)
    on16 = copy.deepcopy(off16)
    chains = [m for m in on16.modules() if isinstance(m, Res2NetBlock)]
    check(len(chains) == 3, f"expected 3 Res2NetBlocks, found {len(chains)}")
    for m in chains:
        m.fused_inference = True
    waves, mask = _served_batch(torch, SEED + 111)
    wrap = lambda model: make_wave_embed_fn(lambda x, m: model(x, m), OPTS, dtype=torch.bfloat16)
    embed = {"chains unfused": wrap(off16), "chains fused": wrap(on16)}
    with torch.inference_mode():
        ref16 = _plain_embed(torch, off16, OPTS, torch.bfloat16, torch.bfloat16)(waves[0], mask)
        ref32 = _plain_embed(torch, model32, OPTS, torch.float32, torch.float32)(waves[0], mask)
        torch.cuda.synchronize()

        # the main path: counters from zero
        zero_launches()
        emb_off = embed["chains unfused"](waves[0], mask)
        _hold(torch, "ECAPA C1024 MQMHA bf16, chains unfused", emb_off, 192,
              {"the same model + plain front end (bf16)": (ref16, 0.9999),
               "the f32 model + f32 plain front end": (ref32, 0.999)})
        emb_on = embed["chains fused"](waves[0], mask)
        torch.cuda.synchronize()
        # phase 6's bars for the fused chains: the two bf16 paths round at
        # other places
        _hold(torch, "ECAPA C1024 MQMHA bf16, chains fused", emb_on, 192,
              {"the unfused bf16 model": (emb_off, 0.999), "the f32 model + f32 plain front end": (ref32, 0.999)})
        check(fused_res2_chain.last_route == "tensor_core", "the served Res2 chains left the tensor-core kernel")
    server_run(torch, embed["chains fused"], "ECAPA C1024 MQMHA")
    counts = read_launches("ECAPA C1024 MQMHA served", ("fused_fbank", "fused_res2_chain"))
    with torch.inference_mode():
        _turns(torch, "ECAPA C1024 MQMHA bf16", embed, waves, mask, device_label)
        profile_served_batch(torch, lambda: embed["chains fused"](waves[0], mask),
                             what="one served ECAPA C1024 MQMHA batch (chains fused)")
    return counts


def phase_served_lawlict(torch, device_label):
    """The lawlict ECAPA-TDNN C512 (ecapa_lawlict.yaml: embedding 192; seeded
    random weights), bf16, behind make_wave_embed_fn on one [128, 160000]
    batch; held and timed as in 6, one batch profiled, the Extractor run.
    K1 is its only kernel."""
    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.models import EcapaLawlict
    from asv_subtools_tpu_torch.train.step_check import OPTS
    from asv_subtools_tpu_torch.weights import init_weights_

    model32 = init_weights_(EcapaLawlict(80, channels=512, embd_dim=192), SEED + 120)
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    waves, mask = _served_batch(torch, SEED + 121)
    embed = make_wave_embed_fn(lambda x, m: model16(x, m), OPTS, dtype=torch.bfloat16)
    with torch.inference_mode():
        ref16 = _plain_embed(torch, model16, OPTS, torch.bfloat16, torch.bfloat16)(waves[0], mask)
        ref32 = _plain_embed(torch, model32, OPTS, torch.float32, torch.float32)(waves[0], mask)
        torch.cuda.synchronize()

        # the main path: counters from zero
        zero_launches()
        emb = embed(waves[0], mask)
        torch.cuda.synchronize()
        _hold(torch, "ECAPA lawlict C512 bf16", emb, 192,
              {"the same model + plain front end (bf16)": (ref16, 0.9999),
               "the f32 model + f32 plain front end": (ref32, 0.999)})
    server_run(torch, embed, "ECAPA lawlict C512")
    counts = read_launches("ECAPA lawlict C512 served", ("fused_fbank",))
    with torch.inference_mode():
        _turns(torch, "ECAPA lawlict C512 bf16", {"bf16": embed}, waves, mask, device_label)
        profile_served_batch(torch, lambda: embed(waves[0], mask), what="one served ECAPA lawlict C512 batch")
    return counts


def _warm_step(step, warm):
    """``step`` with the margin warm-up's (offset, lambda) of each step fed
    in as Python numbers (the host counts the steps: no wait on the card)."""
    count = [0]

    def run(state, batch, gen):
        offset, lam = warm.step(count[0])
        count[0] += 1
        return step(state, batch, gen, lambda_m=lam, margin_offset=offset)

    return run


def phase_train_new(torch, device_label):
    """The train steps of RepVggXvector, the MQMHA ECAPA C1024 and the
    lawlict ECAPA C512 on their presets (5994 classes): RepVGG with AAM
    m=0.2 through margin_softmax_v1 and sgd 1e-2 on warmR t_0 20000
    (repvgg.yaml); the MQMHA ECAPA with the sub-centre top-k AAM head and
    adamW (wd 5e-5) on 1cycle (max_lr 2e-3, 90000 steps), MarginWarm(1, 3,
    -0.2, 0.0, epoch_iter 10000) feeding the margin (ecapa_roadmap.yaml);
    lawlict with AM m=0.2 s=30 and adamW (wd 5e-5) on cyclic triangular2
    (1e-8..1e-3, up 15000; ecapa_lawlict.yaml). Each as in 9: B=128 x 2 s
    of raw waves, bf16 on f32 masters, K1 in the step, 30 steps on one
    fixed batch under the sync check, 20 timed, one profiled, the last loss
    below the first. Then a narrow RepVGG's (blocks 1-1-1-1, base 8) f32
    and f64 steps, card against CPU, with 8's bounds."""
    from asv_subtools_tpu_torch.nn import MarginWarm
    from asv_subtools_tpu_torch.train import (TrainStepConfig, cyclic, get_lr_schedule, get_optimizer,
                                              init_train_state, make_train_step, one_cycle)
    from asv_subtools_tpu_torch.train.step_check import (LAWLICT_AM, ROADMAP_ECAPA, ROADMAP_HEAD, ecapa_net,
                                                         lawlict_net, repvgg_net)

    runs = (
        ("RepVGG", lambda: repvgg_net(seed=SEED + 130), lambda: get_lr_schedule("warmR", base_lr=1e-2, t_0=20000),
         lambda sched: get_optimizer("sgd", sched), None, "sgd momentum 0.9 wd 1e-4 warmR 1e-2"),
        ("ECAPA C1024 MQMHA", lambda: ecapa_net(ROADMAP_HEAD, SEED + 131, channels=1024, **ROADMAP_ECAPA),
         lambda: one_cycle(max_lr=2e-3, total_steps=90000),
         lambda sched: get_optimizer("adamW", sched, weight_decay=5e-5), MarginWarm(1, 3, -0.2, 0.0, epoch_iter=10000),
         "adamW wd 5e-5 1cycle 2e-3, MarginWarm"),
        ("ECAPA lawlict C512", lambda: lawlict_net(LAWLICT_AM, SEED + 132),
         lambda: cyclic(base_lr=1e-8, max_lr=1e-3, step_size_up=15000, mode="triangular2"),
         lambda sched: get_optimizer("adamW", sched, weight_decay=5e-5), None,
         "adamW wd 5e-5 cyclic triangular2 1e-8..1e-3"),
    )
    counts = {}
    for i, (label, make_net, make_sched, make_tx, warm, opt) in enumerate(runs):
        opts, gen, wave, labels = _train_batch(torch, SEED + 135 + i)
        net = make_net()
        schedule = make_sched()
        tx = make_tx(schedule)
        state = init_train_state(net, tx, "cuda")
        step = make_train_step(net, tx, schedule, TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True,
                                                                  fbank_opts=opts))
        if warm is not None:
            step = _warm_step(step, warm)
        c = run_fixed_batch(torch, step, state, {"x": wave, "y": labels}, gen, f"train {label} bf16",
                            f"{label} train step", device_label, falls_to=1.0, opt=opt)
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        del state, step, net
        torch.cuda.empty_cache()
    _card_against_cpu(torch, "repvgg")
    return counts


# The repo's EER gates at a cut (the full runs: 400-600 steps, 25 epochs)
GATE_STEPS = 40
GATE_LM_STEPS = 10
GATE_KEYS = {
    "quality": {"metric", "eer_percent", "band", "pass", "speakers", "train_steps", "final_loss", "final_acc",
                "train_seconds", "device"},
    "roadmap row": {"config", "eer_percent", "final_acc", "train_seconds"},
    "roadmap": {"metric", "rows"},
    "antispoof": {"metric", "cm_eer_percent", "min_tdcf", "band", "pass", "train_steps", "final_loss",
                  "train_seconds", "device"},
    "adaptation": {"metric", "eer_percent", "best_adaptation", "improves", "train_steps", "train_seconds",
                   "device"},
    "adaptation table": {"cosine", "plda_source", "plda_aplda", "plda_coral", "plda_coral_plus",
                         "plda_indomain_only", "plda_lip_reg", "plda_cip_reg"},
    "demo": {"speakers", "train_steps", "train_seconds", "final_loss", "eval_utts", "extract_seconds",
             "eer_percent", "eer_asnorm_percent", "min_dcf_p05", "device"},
    "repvgg": {"deploy_vs_train_mean_cosine", "eer_train", "eer_deploy"},
}


def phase_gates(torch, device_label):
    """The repo's EER gates through the port's own functions, on the card,
    at a cut (see 21 in the module docstring). Each gate prints its JSON
    line; the EERs are not gated here."""
    from asv_subtools_tpu_torch.recipes import (adaptation_gate, antispoof_gate, demo_synthetic, quality_gate,
                                                repvgg_deploy_gate, roadmap_gate, synth_datadir)
    from asv_subtools_tpu_torch.recipes.gate_corpus import Renderer

    def has_keys(label, line, keys):
        missing = keys - set(line)
        check(not missing, f"the {label} gate's JSON line lacks {sorted(missing)}")

    def finite(label, losses):
        check(len(losses) > 0 and all(np.isfinite(losses)), f"a {label} gate loss was not finite: {losses}")

    def falls(label, losses, start=0):
        """Finite, and the last loss below the one at ``start`` (under
        MarginWarm: the step from which the margin is full)."""
        finite(label, losses)
        check(losses[-1] < losses[start],
              f"the {label} gate's loss did not fall: {losses[start]:.4f} at step {start + 1} -> {losses[-1]:.4f}")
        print(f"gate {label}: loss {losses[start]:.4f} at step {start + 1} -> {losses[-1]:.4f} at step "
              f"{len(losses)}", flush=True)

    zero_launches()
    t0 = time.perf_counter()
    times = {}
    out = quality_gate.run_gate(steps=GATE_STEPS, seed=7, device="cuda")
    has_keys("quality", out, GATE_KEYS["quality"])
    falls("quality", out["losses"])
    times["quality"] = time.perf_counter() - t0

    t = time.perf_counter()
    out = roadmap_gate.run(steps=GATE_STEPS, lm_steps=GATE_LM_STEPS, configs=("mqmha",), device="cuda")
    has_keys("roadmap", out, GATE_KEYS["roadmap"])
    for row in out["rows"]:
        has_keys("roadmap", row, GATE_KEYS["roadmap row"])
    check([r["config"] for r in out["rows"]] == ["mqmha", "lm_finetune"], f"roadmap rows: {out['rows']}")
    # the margin warms up over the first GATE_STEPS // 4 steps, raising the
    # loss; the LM finetune's 10 steps at lr under 5e-5 only show it finite
    falls("roadmap mqmha", out["losses"]["mqmha"], start=GATE_STEPS // 4)
    finite("roadmap lm_finetune", out["losses"]["lm_finetune"])
    times["roadmap"] = time.perf_counter() - t

    t = time.perf_counter()
    out = antispoof_gate.run_gate(steps=GATE_STEPS, device="cuda")
    has_keys("antispoof", out, GATE_KEYS["antispoof"])
    falls("antispoof", out["losses"])
    times["antispoof"] = time.perf_counter() - t

    t = time.perf_counter()
    out = adaptation_gate.run_gate(steps=GATE_STEPS, device="cuda")
    has_keys("adaptation", out, GATE_KEYS["adaptation"])
    has_keys("adaptation", out["eer_percent"], GATE_KEYS["adaptation table"])
    falls("adaptation", out["losses"])
    times["adaptation"] = time.perf_counter() - t

    t = time.perf_counter()
    out = demo_synthetic.run(steps=GATE_STEPS, device="cuda")
    has_keys("demo", out, GATE_KEYS["demo"])
    falls("demo", out["losses"])
    times["demo"] = time.perf_counter() - t

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with Renderer() as render:
            synth_datadir.write_datadir(f"{tmp}/data", spk=24, train_utts=8, eval_utts=4, render=render)
        out = repvgg_deploy_gate.run_gate(f"{tmp}/data", f"{tmp}/exp", epochs=1, device="cuda")
    has_keys("repvgg", out, GATE_KEYS["repvgg"])
    finite("RepVGG", out["losses"])
    check(out["deploy_vs_train_mean_cosine"] > repvgg_deploy_gate.MIN_COSINE,
          f"the RepVGG fold's mean cosine {out['deploy_vs_train_mean_cosine']} is not above "
          f"{repvgg_deploy_gate.MIN_COSINE}")
    times["repvgg"] = time.perf_counter() - t
    counts = read_launches("gates", ("fused_fbank",))
    print("gates: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
          + f"; {time.perf_counter() - t0:.1f} s in all on {device_label}", flush=True)
    return counts


# the offline route: 64 synthetic speakers x 24 training utterances of
# 2.5-4.0 s (and 2 evaluation ones of 1.5-12 s) through the Kaldi-style
# host front end; chunks of 200 frames, 64 utterances held out
OFFLINE_SPEAKERS, OFFLINE_TRAIN_UTTS, OFFLINE_EVAL_UTTS = 64, 24, 2
OFFLINE_CHUNK, OFFLINE_VALID, OFFLINE_PHONES, OFFLINE_AUX = 200, 64, 128, 9
OFFLINE_REPORT = 4  # a report point every 4 steps: the losses the phase holds
FIND_LR_STEPS = 20
OFFLINE_MAX_CHUNK = 400  # frames: extract_embedding_chunked's chunk on the long evaluation utterances


def _preset(name: str) -> dict:
    from asv_subtools_tpu_torch.utils import load_yaml

    return load_yaml(f"recipes/configs/{name}.yaml")


def _offline_params(preset: str, tmp: str, exp: str, **data) -> dict:
    """``preset``'s model, head, optimizer and schedule at full width on the
    offline egs of ``tmp``, bf16, B=128, one epoch."""
    p = _preset(preset)
    return {"exp_dir": f"{tmp}/{exp}", "seed": SEED + 90,
            "data": {"egs_type": "offline", "egs_dir": f"{tmp}/egs", "batch_size": BATCH, "num_bins": 80, **data},
            "model": p["model"], "loss": p["loss"],
            "train": dict(p["train"], epochs=1, compute_dtype="bfloat16", report_interval=OFFLINE_REPORT),
            "extract": {"mode": "wave", "batch": 32, "workers": 4,
                        "batch_sizes": {200: 64, 400: 32, 800: 16, 1600: 8}}}


def _step_ms(torch, run, n: int = 6) -> float:
    """Median ms of ``run()`` between CUDA events over n calls after one,
    none allowed to wait on the card."""
    run()
    events = []
    with no_host_sync(torch):
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def _reported_losses(exp: str) -> list:
    from asv_subtools_tpu_torch.train import read_report_csv

    return list(read_report_csv(f"{exp}/log/train.csv")["loss"])


def phase_offline(torch, device_label):
    """The offline chunk-egs route through the port's Launcher (see 22 in
    the module docstring)."""
    import itertools

    from asv_subtools_tpu_torch.data import prepare_egs_dir
    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.features import FbankOptions, MelOptions, fused_fbank, fused_fbank_plain
    from asv_subtools_tpu_torch.io import read_vec_flt_scp, read_wav
    from asv_subtools_tpu_torch.launcher import Launcher
    from asv_subtools_tpu_torch.models import extract_embedding_chunked, phone_frame_loss
    from asv_subtools_tpu_torch.nn import fused_stats_pooling, fused_stats_pooling_plain
    from asv_subtools_tpu_torch.recipes.synthetic import write_corpus, write_feature_datadir, write_offline_labels
    from asv_subtools_tpu_torch.recipes.voxceleb import recipe_params
    from asv_subtools_tpu_torch.train import (TrainStepConfig, get_optimizer, init_fd_state, init_train_state,
                                              make_fd_train_step, make_sam_train_step, make_train_step)
    from asv_subtools_tpu_torch.train.fd import is_adversary
    from asv_subtools_tpu_torch.train.step_check import fd_net, host_waits, multitask_net

    dev = torch.device("cuda")
    opts = FbankOptions(mel_opts=MelOptions(num_bins=80))
    with tempfile.TemporaryDirectory() as tmp:
        # 1. host preparation
        t0 = time.perf_counter()
        write_corpus(tmp, num_spks=OFFLINE_SPEAKERS, train_per_spk=OFFLINE_TRAIN_UTTS,
                     eval_per_spk=OFFLINE_EVAL_UTTS, dur=(2.5, 4.0), eval_dur=(1.5, 12.0), seed=SEED + 91)
        t1 = time.perf_counter()
        n_utts = write_feature_datadir(f"{tmp}/train", f"{tmp}/feats", num_bins=80, seed=SEED + 92)
        t2 = time.perf_counter()
        ali_scp, utt2aux = write_offline_labels(f"{tmp}/feats", OFFLINE_PHONES, OFFLINE_AUX, seed=SEED + 93)
        feat_dim, targets = prepare_egs_dir(f"{tmp}/feats", f"{tmp}/egs", chunk_size=OFFLINE_CHUNK,
                                            valid_num_utts=OFFLINE_VALID, seed=SEED + 94)
        with open(f"{tmp}/egs/train.egs.csv") as f:
            n_chunks = sum(1 for _ in f) - 1
        with open(f"{tmp}/feats/utt2num_frames") as f:
            voiced = sum(int(line.split()[1]) for line in f if line.strip())
        print(f"offline host preparation: corpus {OFFLINE_SPEAKERS} speakers x ({OFFLINE_TRAIN_UTTS} of 2.5-4.0 s + "
              f"{OFFLINE_EVAL_UTTS} eval of 1.5-12 s) {t1 - t0:.1f} s; Kaldi-style host features of {n_utts} "
              f"utterances (80-bin fbank, dither 1.0, energy VAD, sliding CMVN 300, voiced frames: {voiced} frames) "
              f"{t2 - t1:.1f} s; {OFFLINE_PHONES}-phone alignments, {OFFLINE_AUX} aux classes; egs dir: feat_dim "
              f"{feat_dim}, {targets} targets, {n_chunks} training chunks of {OFFLINE_CHUNK} frames, "
              f"{OFFLINE_VALID} utterances held out ({time.perf_counter() - t2:.1f} s)", flush=True)
        check(feat_dim == 80 and targets == OFFLINE_SPEAKERS and n_chunks >= 4 * BATCH,
              "the offline egs dir is not what the corpus should give")

        # K1 against its plain version at find_lr's shape (the recipe's
        # chunk), outside the counted window
        fl_params = recipe_params(tmp, f"{tmp}/find_lr", epochs=1, batch_size=BATCH, channels=1024)
        fl_params["data"].update(shuffle_buffer=RECIPE_SHUFFLE, workers=4)
        finder = Launcher(fl_params)
        fl_egs = finder.build_egs()
        finder.build_model()
        batches = []
        for epoch in itertools.count():
            fl_egs.set_epoch(epoch)
            batches += list(itertools.islice(iter(fl_egs), FIND_LR_STEPS - len(batches)))
            if len(batches) >= FIND_LR_STEPS:
                break
        x = torch.as_tensor(batches[0]["x"], device=dev)
        k, _ = fused_fbank(x, opts, dft_dtype=torch.bfloat16, with_energy=False)
        route = fused_fbank.last_route
        pl, _ = fused_fbank_plain(x, opts, dft_dtype=torch.bfloat16, with_energy=False)
        torch.cuda.synchronize()
        k1_err = max_abs(k, pl)
        check(route == "tensor_core" and k1_err <= 1e-3,
              f"K1 at find_lr's shape {tuple(x.shape)} disagrees with its plain version ({k1_err:.3e})")
        del x, k, pl

        # the main path: counters from zero
        zero_launches()

        # 2. multitask.yaml at full width: two spawn workers, one epoch
        waits: dict = {}
        mt = Launcher(_offline_params("multitask", tmp, "mt", ali_scp=ali_scp, num_workers=2))
        mt_egs = mt.build_egs()
        mt.build_model()
        with counted_host_waits(waits):
            mt_state = mt.train(mt_egs)
        torch.cuda.synchronize()
        st = mt.epoch_stats[0]
        mt_losses = _reported_losses(f"{tmp}/mt")
        pace = _pace(st, skip=2)
        vb = next(iter(mt.valid_egs))
        with torch.inference_mode():
            tensors = {k[len("backbone."):]: v for k, v in {**mt_state.params, **mt_state.batch_stats}.items()
                       if k.startswith("backbone.")}
            _, ph = torch.func.functional_call(mt.net.backbone.eval(), tensors, (torch.as_tensor(vb["x"], device=dev),))
            logits = torch.nn.functional.linear(ph, mt_state.params["phone_affine.weight"],
                                                mt_state.params["phone_affine.bias"])
            phones = torch.as_tensor(vb["phone_y"], device=dev).long()
            ph_loss = float(phone_frame_loss(logits, phones, num_phones=OFFLINE_PHONES))
            ph_acc = float((logits.argmax(-1) == phones).float().mean())
        mt_reports = mt_egs.worker_reports
        print(f"offline multitask.yaml (MultiTaskXvector 512 / tdnn5 1500 / embedding 512, phonetic branch 3x512, "
              f"softmax head over {targets}, {OFFLINE_PHONES} phones, sgd 1e-2 warmR, bf16) [{BATCH},{OFFLINE_CHUNK},80], "
              f"two spawn workers: {st['steps']} steps, {float(np.median(st['step_ms'])):.2f} ms/step (median, CUDA "
              f"events; {pace['ms']:.2f} from step 3), the host's wait for a batch {pace['wait_ms']:.2f} ms median "
              f"(data wait {pace['share']:.1%} of the host's time from step 3); loss (reported every "
              f"{OFFLINE_REPORT} steps) " + ", ".join(f"{v:.4f}" for v in mt_losses)
              + f"; epoch loss {st['metrics']['loss']:.4f}, speaker accuracy {st['metrics']['accuracy']:.4f}, "
              f"validation loss {st['metrics']['valid_loss']:.4f} (accuracy {st['metrics']['valid_accuracy']:.4f}); "
              f"phone loss {ph_loss:.4f}, phone accuracy {ph_acc:.4f} on a validation batch (random phones: chance "
              f"{1 / OFFLINE_PHONES:.4f}); host waits {waits['run_epoch']} (expected 2 + steps // {OFFLINE_REPORT}); "
              f"on {device_label}", flush=True)
        check(all(np.isfinite(mt_losses)) and len(mt_losses) >= 3 and mt_losses[-1] < mt_losses[0]
              and np.isfinite(st["metrics"]["valid_loss"]) and np.isfinite(ph_loss),
              "the multi-task losses were not finite or did not fall")
        check(waits["run_epoch"] == [2 + st["steps"] // OFFLINE_REPORT],
              f"the multi-task epoch waited on the card {waits['run_epoch']} times: {waits['run_epoch places']}")
        check(len(mt_reports) == 2 and all(r["cuda_visible_devices"] == "" and not r["cuda_initialized"]
                                           for r in mt_reports), "a loader worker saw the card")
        del mt_state
        torch.cuda.empty_cache()

        # 3. fd_xvector at full width on the same egs, 9 aux classes
        fd_params = _offline_params("snowdar_xvector", tmp, "fd", aux_utt2label=utt2aux)
        fd_params["model"] = {"name": "fd_xvector", "params": {"num_aux_targets": OFFLINE_AUX}}
        fd_params["train"]["fd"] = {"cycle": 4, "adv_steps": 2}
        fd = Launcher(fd_params)
        fd_egs = fd.build_egs()
        fd.build_model()
        waits = {}
        with counted_host_waits(waits):
            fd_state = fd.train(fd_egs)
        fd_stats = fd.epoch_stats[0]
        fd_losses = _reported_losses(f"{tmp}/fd")
        fd_pace = _pace(fd_stats, skip=2)
        # the cycle on the card: an adversary step moves the DAL projections
        # alone, a main step every leaf but them; no step waits on the card
        b0 = fd_egs.example_batch() if hasattr(fd_egs, "example_batch") else next(iter(fd_egs))
        batch = {"x": torch.as_tensor(b0["x"], device=dev), "y": torch.as_tensor(b0["y"], device=dev).long(),
                 "aux_y": torch.as_tensor(b0["aux_y"], device=dev).long()}
        tx_main, tx_adv = get_optimizer("sgd", 1e-2, momentum=0.9), get_optimizer("sgd", 1e-2)
        step = make_fd_train_step(fd.net, tx_main, tx_adv, cycle=4, adv_steps=2,
                                  config=TrainStepConfig(compute_dtype=torch.bfloat16))
        state = init_fd_state(fd.net, tx_main, tx_adv, dev)
        state.params = dict(fd_state.params)
        dal = {k for k in state.params if is_adversary(k)}
        state, _ = step(state, batch, step_index=0)
        torch.cuda.synchronize()
        moved, fd_ms = [], {}
        for i in range(1, 5):
            before = dict(state.params)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with no_host_sync(torch):
                start.record()
                state, m = step(state, batch, step_index=i)
                end.record()
            torch.cuda.synchronize()
            fd_ms.setdefault("adversary" if i % 4 < 2 else "main", []).append(start.elapsed_time(end))
            moved.append({k for k in state.params if not torch.equal(before[k], state.params[k])})
        print(f"offline FD-AL (FDXvector 512/1500/512, AM head over {targets}, softmax aux head over {OFFLINE_AUX}, "
              f"cycle 4, 2 adversary steps, sgd warmR; bf16) [{BATCH},{OFFLINE_CHUNK},80]: {fd_stats['steps']} steps "
              f"through the Launcher's Trainer, {float(np.median(fd_stats['step_ms'])):.2f} ms/step (median, CUDA "
              f"events; {fd_pace['ms']:.2f} from step 3), data wait {fd_pace['share']:.1%} of the host's time from "
              f"step 3; loss (every {OFFLINE_REPORT} steps) " + ", ".join(f"{v:.4f}" for v in fd_losses)
              + f", epoch loss {fd_stats['metrics']['loss']:.4f}; host waits {waits['run_epoch']}; "
              f"on the card: a step {np.median(fd_ms['adversary']):.2f} ms (adversary), "
              f"{np.median(fd_ms['main']):.2f} ms (main), CUDA events; leaves moved per step (steps 1-4): "
              f"{[len(x) for x in moved]} of {len(state.params)} ({len(dal)} DAL leaves); on {device_label}",
              flush=True)
        check(all(np.isfinite(fd_losses)) and len(fd_losses) >= 3 and fd_losses[-1] < fd_losses[0],
              "the FD losses were not finite or did not fall")
        check(waits["run_epoch"] == [2 + fd_stats["steps"] // OFFLINE_REPORT],
              f"the FD epoch waited on the card {waits['run_epoch']} times: {waits['run_epoch places']}")
        rest = set(state.params) - dal
        check(moved == [dal, rest, rest, dal] and len(dal) == 2,
              "an FD adversary step moved other leaves than the DAL projections, or a main step moved them")
        del state, fd_state, step
        torch.cuda.empty_cache()

        # 4. snowdar_xvector.yaml with train.sam rho 0.05 (runSnowdarXvectorSAM)
        sam_params = _offline_params("snowdar_xvector", tmp, "sam")
        sam_params["train"]["sam"] = {"rho": 0.05}
        sam = Launcher(sam_params)
        sam_egs = sam.build_egs()
        sam.build_model()
        waits = {}
        with counted_host_waits(waits):
            sam_state = sam.train(sam_egs)
        sam_losses = _reported_losses(f"{tmp}/sam")
        sst = sam.epoch_stats[0]
        batch = {"x": torch.as_tensor(b0["x"], device=dev), "y": torch.as_tensor(b0["y"], device=dev).long()}
        tx = get_optimizer("sgd", 1e-2, momentum=0.9)
        config = TrainStepConfig(compute_dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(SEED + 95)
        plain_state = init_train_state(sam.net, tx, dev)
        sam_step, plain_step = make_sam_train_step(sam.net, tx, config=config), make_train_step(sam.net, tx,
                                                                                                config=config)
        ms_sam = _step_ms(torch, lambda: sam_step(plain_state, batch, gen))
        ms_plain = _step_ms(torch, lambda: plain_step(plain_state, batch, gen))
        print(f"offline snowdar_xvector.yaml + train.sam rho 0.05 (AM head over {targets}, sgd momentum 0.9 warmR, "
              f"bf16) [{BATCH},{OFFLINE_CHUNK},80]: {sst['steps']} steps, {float(np.median(sst['step_ms'])):.2f} "
              f"ms/step in the epoch (CUDA events); on one batch {ms_sam:.2f} ms/step against the plain step's "
              f"{ms_plain:.2f} ({ms_sam / ms_plain:.2f}x), neither waiting on the card; loss (every {OFFLINE_REPORT} "
              f"steps) " + ", ".join(f"{v:.4f}" for v in sam_losses) + f", validation loss "
              f"{sst['metrics']['valid_loss']:.4f}; host waits {waits['run_epoch']}; on {device_label}", flush=True)
        check(all(np.isfinite(sam_losses)) and sam_losses[-1] < sam_losses[0],
              "the SAM losses were not finite or did not fall")
        check(waits["run_epoch"] == [2 + sst["steps"] // OFFLINE_REPORT],
              f"the SAM epoch waited on the card {waits['run_epoch']} times: {waits['run_epoch places']}")
        del sam_state, plain_state, sam_step, plain_step
        torch.cuda.empty_cache()

        # 5. Launcher.find_lr on the voxceleb recipe's Launcher (ECAPA C1024,
        # wave input, K1 in the step)
        before = fused_fbank.launches
        t0 = time.perf_counter()
        found, fl_waits = host_waits(lambda: finder.find_lr(batches, start_lr=1e-7, end_lr=1e-1,
                                                            num_steps=FIND_LR_STEPS))
        fl_s = time.perf_counter() - t0
        fl_k1 = fused_fbank.launches - before
        print(f"offline find_lr (the recipe's ECAPA C1024, adamW, wave input [{BATCH},{batches[0]['x'].shape[1]}], "
              f"K1 in the step; K1 against plain there {k1_err:.3e}): {len(found['lrs'])} steps of "
              f"{FIND_LR_STEPS}, {fl_s:.2f} s, suggested lr {found['suggested_lr']}; smoothed losses "
              + ", ".join(f"{v:.3f}" for v in found["losses"]) + "; raw losses "
              + ", ".join(f"{v:.4f}" for v in found["raw_losses"]) + f"; K1 launches {fl_k1}, host waits "
              f"{len(fl_waits)} (one a step: the loss read); on {device_label}", flush=True)
        check(len(found["lrs"]) > 5 and found["suggested_lr"] is not None, "find_lr gave no suggestion")
        # the smoothed curve is the debiased running mean of the steps' own
        # losses (seeded with the first, as in JAX); a step that gives a
        # non-finite loss or a wrong one shows here
        raw = np.asarray(found["raw_losses"], np.float64)
        avg = np.empty_like(raw)
        for i, v in enumerate(raw):
            avg[i] = v if i == 0 else 0.95 * avg[i - 1] + 0.05 * v
        smoothed = avg / (1 - 0.95 ** np.arange(1, len(raw) + 1))
        check(len(raw) == len(found["lrs"]) and np.isfinite(raw).all() and raw.min() > 0
              and np.allclose(found["losses"], smoothed, rtol=1e-9, atol=0),
              "find_lr's raw losses are not finite and positive, or its smoothed curve does not follow them")
        check(fl_k1 in (len(found["lrs"]), len(found["lrs"]) + 1) and len(fl_waits) == fl_k1,
              f"find_lr's K1 launches ({fl_k1}) and host waits ({len(fl_waits)}) are not one a step: {fl_waits}")
        del finder
        torch.cuda.empty_cache()

        # 6. serving: the multi-task and FD x-vectors behind make_wave_embed_fn,
        # the statistics pooling fused (K4) and unfused
        gen = torch.Generator(device=dev).manual_seed(SEED + 96)
        wave = torch.randn((BATCH, SAMPLES), generator=gen, device=dev) * 1000.0
        mask = torch.ones((BATCH, SAMPLES), dtype=torch.bool, device=dev)
        first = lambda model: (lambda x, m: model(x, m)[0])
        pooled = {}
        with torch.inference_mode():
            for label, make in (("MultiTaskXvector 512/1500/512", multitask_net), ("FDXvector 512/1500/512", fd_net)):
                model32 = make(SEED + 97).backbone.to(dev).eval()
                off16 = copy.deepcopy(model32).to(torch.bfloat16)
                on16 = copy.deepcopy(off16)
                on16.stats.fused_inference = True
                ref16 = _plain_embed(torch, first(off16), opts, torch.bfloat16, torch.bfloat16)(wave, mask)
                ref32 = _plain_embed(torch, first(model32), opts, torch.float32, torch.float32)(wave, mask)
                seen = {}
                hook = on16.stats.register_forward_hook(lambda mod, args, out: seen.update(x=args[0], m=args[1]))
                for flag, model in (("fused pooling", on16), ("unfused pooling", off16)):
                    emb = make_wave_embed_fn(first(model), opts, dtype=torch.bfloat16)(wave, mask)
                    torch.cuda.synchronize()
                    c16, c32 = float(cosine(emb, ref16).min()), float(cosine(emb, ref32).min())
                    print(f"offline served {label} bf16 [{BATCH},{SAMPLES}], {flag}: min per-utterance cosine vs "
                          f"unfused + plain front end (bf16) {c16:.6f} (>= 0.9999), vs f32 model + f32 plain front "
                          f"end {c32:.6f} (>= 0.999)", flush=True)
                    check(tuple(emb.shape) == (BATCH, 512) and c16 >= 0.9999 and c32 >= 0.999,
                          f"served {label} embeddings ({flag}) disagree")
                hook.remove()
                pooled[label] = seen
                del model32, off16, on16

        # Launcher.extract of the evaluation list with the trained multi-task
        # net: wave mode (K1) and feature mode (host features, batch_sizes)
        ex_stats = {}
        for mode in ("wave", "feature"):
            mt.params["extract"]["mode"] = mode
            ex_stats[mode] = mt.extract(f"{tmp}/eval/wav.scp", f"{tmp}/xv_{mode}")
        embs = {m: dict(read_vec_flt_scp(f"{tmp}/xv_{m}.scp")) for m in ex_stats}
        n_eval = OFFLINE_SPEAKERS * OFFLINE_EVAL_UTTS
        check(all(len(e) == n_eval and all(v.shape == (512,) and np.isfinite(v).all() for v in e.values())
                  for e in embs.values()), "an extraction did not read back whole and finite")
        counts = read_launches("offline route", ("fused_fbank", "fused_stats_pooling"))

        # K4 against its plain version on the served models' pooling inputs,
        # after the counted window
        k4_errs = {}
        with torch.inference_mode():
            for label, seen in pooled.items():
                kx = fused_stats_pooling(seen["x"], seen["m"])
                px = fused_stats_pooling_plain(seen["x"].contiguous(), seen["m"])
                k4_errs[label] = (max_abs(kx, px), tuple(seen["x"].shape))
                check(close(torch, kx, px, 1e-5, 1e-4),
                      f"K4 disagrees with its plain version on {label}'s pooling input {tuple(seen['x'].shape)}")
        print("offline K4 against its plain version on the served models' pooling input (bf16, a [B, T, D] view "
              "of [B, D, T] memory): " + ", ".join(f"{k} {list(shape)} {e:.3e}" for k, (e, shape) in k4_errs.items())
              + " (rtol 1e-4, atol 1e-5)", flush=True)
        del pooled, kx, px
        # extract_embedding_chunked on the evaluation utterances longer than
        # the chunk, against the chunks embedded one at a time (f32 weights)
        backbone = mt.net.backbone.eval()
        tensors = {k[len("backbone."):]: v for k, v in {**mt.state.params, **mt.state.batch_stats}.items()
                   if k.startswith("backbone.")}
        embed = lambda x, m: torch.func.functional_call(backbone, tensors, (x, m))[0]
        from asv_subtools_tpu_torch.data.processor import compute_feats
        from asv_subtools_tpu_torch.models import chunk_utterance

        with open(f"{tmp}/eval/wav.scp") as f:
            entries = [line.split() for line in f if line.strip()]
        feats = [s["feat"] for s in compute_feats(opts)({"wav": read_wav(p)[0]} for _, p in entries)]
        long = [f for f in feats if f.shape[0] > OFFLINE_MAX_CHUNK]
        cos = []
        with torch.inference_mode():
            for f in long:
                got = extract_embedding_chunked(embed, f, OFFLINE_MAX_CHUNK)
                chunks, w = chunk_utterance(f, OFFLINE_MAX_CHUNK)
                ref = sum(float(wi) * embed(torch.as_tensor(c[None], device=dev), None)[0] for c, wi in zip(chunks, w))
                cos.append(float(cosine(got[None], ref[None])[0]))
        print(f"offline extraction ({n_eval} evaluation utterances of 1.5-12 s, the trained multi-task net): wave mode "
              f"{ex_stats['wave']['batches']} batches, {ex_stats['wave']['wall_s']:.2f} s; feature mode (host "
              f"features, batch_sizes {mt.params['extract']['batch_sizes']}) {ex_stats['feature']['batches']} "
              f"batches, {ex_stats['feature']['wall_s']:.2f} s; extract_embedding_chunked at {OFFLINE_MAX_CHUNK} "
              f"frames on {len(long)} longer utterances against their chunks one at a time: min cosine "
              f"{min(cos):.7f} (>= 0.99999); on {device_label}", flush=True)
        check(len(long) > 0 and min(cos) >= 0.99999, "extract_embedding_chunked disagrees with its chunks")
    return counts


# Phase 23: the step options, the reference's own optimizers and the ReConformer
MIXUP_ALPHA = 1.0  # the alpha of JAX's mixup (nn/tdnn.py:489) when the step turns it on
REMAT_POLICIES = (None, "dots", "dots_batch", "full")
# One SGD step under each remat policy against the no-remat step, from one
# state, batch and generator seed. The forward is the same computation, so
# the loss and the BN statistics (f32 sums of the same bf16 activations)
# hold at 1e-5 of their scale; the backward reads recomputed activations
# equal to the stored ones, but cuDNN's and cuBLAS's backward kernels may
# sum in another order from call to call, which moves bf16 gradients by
# their rounding (2^-9): grad_norm at 1e-3 and the whole update at 1e-2 of
# its norm. Dropout masks drawn anew in the recompute would move the
# update by tens of percent.
REMAT_LOSS_TOL, REMAT_GRAD_TOL, REMAT_UPDATE_TOL = 1e-5, 1e-3, 1e-2
NEW_OPTIMIZERS = (("adamW", dict(name="adamW", learning_rate=1e-3)),
                  ("ralamb", dict(name="ralamb", learning_rate=1e-3)),
                  ("adamod", dict(name="adamod", learning_rate=1e-3)),
                  ("novograd", dict(name="novograd", learning_rate=1e-3)),
                  ("eve", dict(name="eve", learning_rate=1e-3)),
                  ("adamW gc", dict(name="adamW", learning_rate=1e-3, gc=True)),
                  ("sgd lookahead k5 a0.5", dict(name="sgd", learning_rate=1e-2, lookahead=True, lookahead_k=5,
                                                 lookahead_alpha=0.5)))


def _queued_ms(torch, step, state, batch, gen, n: int, warm: int = 2):
    """(state, median ms/step of ``n`` steps between CUDA events after
    ``warm`` steps, queued back to back under the sync check, the metrics
    of every step, K1's launches per step)."""
    from asv_subtools_tpu_torch.features import fused_fbank

    metrics, events = [], []
    before = fused_fbank.launches
    for i in range(warm + n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with no_host_sync(torch):
            start.record()
            state, m = step(state, batch, gen)
            end.record()
        metrics.append(m)
        events.append((start, end))
    torch.cuda.synchronize()
    ms = float(np.median([s.elapsed_time(e) for s, e in events[warm:]]))
    return state, ms, metrics, (fused_fbank.launches - before) / (warm + n)


def _one_sgd_step(torch, net, config, batch, seed: int):
    """(loss, grad_norm, the update of every leaf, the new BN statistics) of
    one SGD step (lr 0.1) of ``net`` from its own weights, the generator
    seeded with ``seed``; under the sync check."""
    from asv_subtools_tpu_torch.train import init_train_state, make_train_step, sgd

    tx = sgd(0.1)
    state = init_train_state(net, tx, "cuda")
    step = make_train_step(net, tx, config=config)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with no_host_sync(torch):
        new, m = step(state, batch, gen)
    torch.cuda.synchronize()
    return (float(m["loss"]), float(m["grad_norm"]), {k: new.params[k] - state.params[k] for k in state.params},
            new.batch_stats)


def _remat_distance(torch, ref, got):
    """(loss, grad_norm, BN statistics, whole update) relative distances."""
    from asv_subtools_tpu_torch.train.step_check import rel

    num = sum(float(((got[2][k] - u) ** 2).sum()) for k, u in ref[2].items())
    den = sum(float((u ** 2).sum()) for u in ref[2].values())
    stats = max((float((got[3][k] - v).abs().max()) / max(float(v.abs().max()), 1e-30) for k, v in ref[3].items()),
                default=0.0)
    return rel(got[0], ref[0]), rel(got[1], ref[1]), stats, (num / den) ** 0.5


def phase_step_options(torch, device_label):
    """The step options, the reference's own optimizers and the ReConformer
    at full width (B=128 x 2 s of raw waves, bf16 on f32 masters, K1 in the
    step, 5994 classes, every step under the sync check): ECAPA-TDNN C1024
    with mixup (alpha 1.0) on the recipe's head and adamW, 30 steps, and
    ms/step beside the plain step in turns; the four remat policies on
    ECAPA C1024 (ms/step, peak memory, K1 per step) and one SGD step of each
    against the no-remat step on ECAPA and on the bench's Conformer with
    dropout 0.1; ralamb, adamod, novograd, eve, adamW with gc and sgd with
    lookahead (k 5, alpha 0.5), 10 steps each beside adamW's; the
    ReConformer of recipes/configs/reconformer.yaml served behind
    make_wave_embed_fn on [128, 160000] and trained (its AM head, adamW on
    noam, model warm-up 1000) for 30 steps; a narrow ReConformer's f32 and
    f64 steps, card against CPU."""
    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.features import fused_fbank
    from asv_subtools_tpu_torch.train import TrainStepConfig, get_optimizer, init_train_state, make_train_step, noam
    from asv_subtools_tpu_torch.train.step_check import (AM, OPTS, SUBCENTER_TOPK, conformer_net, ecapa_net,
                                                         reconformer_net)

    dev = torch.device("cuda")
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    opts, gen, wave, labels = _train_batch(torch, SEED + 230)
    batch = {"x": wave, "y": labels}
    config = dict(compute_dtype=torch.bfloat16, wave_input=True, fbank_opts=opts)
    # K1's constants for these options, made once (a host-to-device copy),
    # outside the counted windows and the sync check
    fused_fbank(wave[:1], opts, dft_dtype=torch.bfloat16, with_energy=False)

    # 1. mixup at full width, and its ms/step beside the plain step in turns
    net = ecapa_net(SUBCENTER_TOPK, SEED + 231, channels=1024)
    tx = get_optimizer("adamW", 1e-3)
    mix_step = make_train_step(net, tx, config=TrainStepConfig(mixup_alpha=MIXUP_ALPHA, **config))
    add(run_fixed_batch(torch, mix_step, init_train_state(net, tx, dev), batch, gen, "train C1024 bf16 mixup 1.0",
                        "mixup train step", device_label, falls_to=1.0))
    plain_step = make_train_step(net, tx, config=TrainStepConfig(**config))
    states = {"plain": init_train_state(net, tx, dev), "mixup": init_train_state(net, tx, dev)}
    steps = {"plain": plain_step, "mixup": mix_step}
    turns = {"plain": [], "mixup": []}
    for order in (("plain", "mixup"), ("mixup", "plain"), ("plain", "mixup"), ("mixup", "plain")):
        for name in order:
            states[name], ms, _, _ = _queued_ms(torch, steps[name], states[name], batch, gen, n=5, warm=1)
            turns[name].append(ms)
    ms_plain, ms_mix = (float(np.median(turns[k])) for k in ("plain", "mixup"))
    print(f"train C1024 bf16 [{BATCH},{TRAIN_SAMPLES}] adamW in turns (4 turns of 5 steps, median): plain "
          f"{ms_plain:.2f} ms/step, mixup {ms_mix:.2f} ms/step ({ms_mix / ms_plain:.2f}x: the net runs twice, on y "
          f"and on y[perm], as JAX's step does) on {device_label}", flush=True)
    del states, steps, mix_step, plain_step
    torch.cuda.empty_cache()

    # 2. remat: ms/step, peak memory and K1 per step under each policy
    rows = []
    for policy in REMAT_POLICIES:
        step = make_train_step(net, tx, config=TrainStepConfig(remat=policy, **config))
        state = init_train_state(net, tx, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        state, ms, metrics, k1 = _queued_ms(torch, step, state, batch, gen, n=6)
        add(read_launches(f"remat={policy} train step", ("fused_fbank",)))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = bool(torch.isfinite(torch.stack([m["loss"] for m in metrics])).all())
        rows.append((policy, ms, peak, k1))
        check(finite and k1 == 1, f"remat={policy}: a loss not finite or K1 launched {k1} times a step")
        del state, step
    print(f"train C1024 bf16 [{BATCH},{TRAIN_SAMPLES}] adamW by remat policy (median of 6 steps after 2, queued "
          "back to back): " + "; ".join(f"{p} {ms:.2f} ms/step, peak {peak:.2f} GiB, K1 {k1:.0f}/step"
                                        for p, ms, peak, k1 in rows) + f" on {device_label}", flush=True)
    torch.cuda.empty_cache()

    # one SGD step under each policy against the no-remat step: ECAPA, and
    # the Conformer with dropout 0.1 (the generator's replay in the recompute)
    conformer = conformer_net(AM, SEED + 232, dropout_rate=0.1)
    for label, make in (("ECAPA C1024", lambda: copy.deepcopy(net)), ("Conformer 6L-256D-4H dropout 0.1",
                                                                      lambda: copy.deepcopy(conformer))):
        ref = _one_sgd_step(torch, make(), TrainStepConfig(**config), batch, SEED + 233)
        again = _one_sgd_step(torch, make(), TrainStepConfig(**config), batch, SEED + 233)
        floor = _remat_distance(torch, ref, again)
        parts = [f"no remat twice: loss {floor[0]:.1e}, grad_norm {floor[1]:.1e}, BN {floor[2]:.1e}, update "
                 f"{floor[3]:.1e}"]
        ok = True
        for policy in REMAT_POLICIES[1:]:
            d = _remat_distance(torch, ref, _one_sgd_step(torch, make(), TrainStepConfig(remat=policy, **config),
                                                          batch, SEED + 233))
            parts.append(f"{policy}: loss {d[0]:.1e}, grad_norm {d[1]:.1e}, BN {d[2]:.1e}, update {d[3]:.1e}")
            ok &= d[0] <= REMAT_LOSS_TOL and d[2] <= REMAT_LOSS_TOL and d[1] <= REMAT_GRAD_TOL \
                and d[3] <= REMAT_UPDATE_TOL
        print(f"remat against no remat, one SGD step of {label} bf16 (tol loss and BN {REMAT_LOSS_TOL}, grad_norm "
              f"{REMAT_GRAD_TOL}, update {REMAT_UPDATE_TOL}): " + "; ".join(parts), flush=True)
        check(ok, f"a remat step of {label} is off the no-remat step")
        del ref, again
        torch.cuda.empty_cache()
    del conformer

    # 3. the reference's own optimizers and the wrappers, 10 steps each
    rows = []
    for label, kw in NEW_OPTIMIZERS:
        otx = get_optimizer(**kw)
        step = make_train_step(net, otx, config=TrainStepConfig(**config))
        zero_launches()
        state, ms, metrics, k1 = _queued_ms(torch, step, init_train_state(net, otx, dev), batch, gen, n=8)
        add(read_launches(f"{label} train step", ("fused_fbank",)))
        opt = state.opt_state
        count = int((opt[1] if isinstance(opt, tuple) else opt)["count"])
        losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
        rows.append((label, ms, float(losses[0]), float(losses[-1])))
        check(bool(torch.isfinite(losses).all()) and count == 10 and k1 == 1,
              f"{label}: a loss not finite, the count at {count} after 10 steps, or K1 {k1} a step")
        del state, step
    print(f"train C1024 bf16 [{BATCH},{TRAIN_SAMPLES}] by optimizer, 10 steps (median ms/step of 8 after 2; loss "
          "first -> last; count 10): " + "; ".join(f"{label} {ms:.2f} ms/step {a:.3f} -> {b:.3f}"
                                                  for label, ms, a, b in rows) + f" on {device_label}", flush=True)
    del net, tx
    torch.cuda.empty_cache()

    # 4. the ReConformer: served, then trained. This random-weight model
    # moves with the front end's DFT precision: on the host's CPU the f32
    # model on the bf16-DFT features of 8 such 10 s waves sits at cosine
    # 0.9972 from itself on the f32-DFT features (the Conformer: 0.999998).
    # So its references take the bf16 DFT, as K1 does here; the f32-DFT
    # reading is printed, not held.
    model32 = reconformer_net(seed=SEED + 234).backbone.to(dev).eval()
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    sgen = torch.Generator(device=dev).manual_seed(SEED + 235)
    swave = torch.randn((BATCH, SAMPLES), generator=sgen, device=dev) * 1000.0
    smask = torch.ones((BATCH, SAMPLES), dtype=torch.bool, device=dev)
    embed = make_wave_embed_fn(lambda x, m: model16(x, m), OPTS, dtype=torch.bfloat16)
    with torch.inference_mode():
        ref16 = _plain_embed(torch, model16, OPTS, torch.bfloat16, torch.bfloat16)(swave, smask)
        ref32 = _plain_embed(torch, model32, OPTS, torch.bfloat16, torch.float32)(swave, smask)
        ref32_f32dft = _plain_embed(torch, model32, OPTS, torch.float32, torch.float32)(swave, smask)
        k1_32 = make_wave_embed_fn(lambda x, m: model32(x, m), OPTS, dtype=torch.float32)(swave, smask)
        waves = [swave * (1.0 + 1e-4 * i) for i in range(4)]
        torch.cuda.synchronize()
        zero_launches()
        emb = embed(waves[0], smask)
        torch.cuda.synchronize()
        add(read_launches("ReConformer served", ("fused_fbank",)))
        check(tuple(emb.shape) == (BATCH, 256) and bool(torch.isfinite(emb.float()).all()),
              "served ReConformer embeddings not finite or of the wrong shape")
        c16, c32 = float(cosine(emb, ref16).min()), float(cosine(emb, ref32).min())
        ck1, cdft = float(cosine(k1_32, ref32).min()), float(cosine(ref32, ref32_f32dft).min())
        print(f"served ReConformer 6L-256D-4H re_conv2d bf16: min per-utterance cosine vs plain front end (bf16) "
              f"{c16:.6f} (>= 0.999), vs f32 model + plain front end (bf16 DFT) {c32:.6f} (>= 0.999); the f32 model "
              f"on K1's features vs on the plain bf16 front end's {ck1:.7f} (>= 0.9999; phase 10's bars); the f32 "
              f"model on bf16-DFT vs f32-DFT plain features {cdft:.6f} (printed: the DFT's precision)", flush=True)
        check(c16 >= 0.999 and c32 >= 0.999 and ck1 >= 0.9999,
              "served ReConformer embeddings disagree with the references")
        ms = timed_batches(torch, embed, waves, smask, iters=6)
        print(f"served ReConformer bf16 [{BATCH},{SAMPLES}]: {ms:.2f} ms/batch, {BATCH * SAMPLES / 16.0 / ms:.0f} "
              f"audio-s/s on {device_label}", flush=True)
        profile_served_batch(torch, lambda: embed(waves[0], smask), what="one served ReConformer batch")
    del model16, model32, ref16, ref32, ref32_f32dft, k1_32, waves, emb
    torch.cuda.empty_cache()

    rnet = reconformer_net(AM, SEED + 236)
    schedule = noam(base_lr=1.0, model_dim=256, warmup_steps=25000)
    rtx = get_optimizer("adamW", schedule)
    rstep = make_train_step(rnet, rtx, lr_schedule=schedule, config=TrainStepConfig(model_warmup_steps=1000,
                                                                                     **config))
    # noam's lr at step 30 is 4.7e-7 (warm-up 25000): finite losses, no fall required
    add(run_fixed_batch(torch, rstep, init_train_state(rnet, rtx, dev), batch, gen,
                        "train ReConformer bf16 (AM m=0.2, adamW on noam, model warm-up 1000)",
                        "ReConformer train step", device_label, falls_to=None, opt="adamW noam"))
    del rnet, rstep
    torch.cuda.empty_cache()
    _card_against_cpu(torch, "reconformer")
    return counts


FAMILY = (("transformer", "Transformer x-vector 6L-256D-4H conv2d"),
          ("gau_conformer", "GAU Conformer 6L-256D-4H conv2d2 (GAU 512/64, RoPE, softmax_plus, T5, layer drop 0.1, "
                            "dynamic chunks)"))
SWEEP_TOL = 1e-5  # one f32 eval forward, card against CPU, of the output's scale (TF32 off)


def _sweep_options(torch) -> None:
    """One f32 eval forward of each option of train/step_check.py's
    OPTION_SWEEP over the narrow Conformer on features [4, 200, 80], card
    against CPU."""
    from asv_subtools_tpu_torch.train.step_check import OPTION_SWEEP, sweep_net

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    g = torch.Generator().manual_seed(SEED + 245)
    x = torch.randn(4, 200, 80, generator=g)
    mask = torch.arange(200)[None, :] < torch.tensor([200, 160, 90, 41])[:, None]
    rows, worst = [], 0.0
    for name in OPTION_SWEEP:
        cpu = sweep_net(name, SEED + 246)
        card = copy.deepcopy(cpu).to("cuda")
        with torch.inference_mode():
            ref = cpu(x, mask)
            got = card(x.cuda(), mask.cuda()).cpu()
        err = float((got - ref).abs().max() / ref.abs().max())
        check(tuple(got.shape) == (4, 256) and bool(torch.isfinite(got).all()), f"option {name}: not finite")
        rows.append(f"{name} {err:.1e}")
        worst = max(worst, err)
    print(f"option sweep (narrow Conformer 2L-64D-2H, one f32 eval forward on [4, 200, 80] features, card against "
          f"CPU, max abs err over the output's scale, tol {SWEEP_TOL}): " + ", ".join(rows), flush=True)
    check(worst <= SWEEP_TOL, "an option's forward on the card disagrees with the CPU")


def phase_conformer_family(torch, device_label):
    """Phase 24: (a) and (b) served, trained and narrow card against CPU;
    then the option sweep."""
    from asv_subtools_tpu_torch.features import fused_fbank
    from asv_subtools_tpu_torch.train import TrainStepConfig, get_optimizer, init_train_state, make_train_step
    from asv_subtools_tpu_torch.train.step_check import AM, GAU_CONFORMER, TRANSFORMER, conformer_net

    dev = torch.device("cuda")
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    opts, gen, wave, labels = _train_batch(torch, SEED + 240)
    # K1's constants, made once (a host-to-device copy), outside the
    # counted windows and the sync check
    fused_fbank(wave[:1], opts, dft_dtype=torch.bfloat16, with_energy=False)
    configs = {"transformer": TRANSFORMER, "gau_conformer": GAU_CONFORMER}
    for i, (family, label) in enumerate(FAMILY):
        model32 = conformer_net(seed=SEED + 241 + i, **configs[family]).backbone.to(dev).eval()
        add(_serve_family(torch, model32, label, f"{label} served", device_label, SEED + 243 + i))
        del model32
        torch.cuda.empty_cache()
        net = conformer_net(AM, SEED + 247 + i, **configs[family])
        tx = get_optimizer("adamW", 1e-3)
        step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True,
                                                               fbank_opts=opts))
        add(run_fixed_batch(torch, step, init_train_state(net, tx, dev), {"x": wave, "y": labels}, gen,
                            f"train {label} bf16 (AM m=0.2)", f"{label} train step", device_label, falls_to=1.0))
        del net, step
        torch.cuda.empty_cache()
        _card_against_cpu(torch, family)
    _sweep_options(torch)
    return counts


# --- phase 25: ASV-Subtools checkpoints and the serving path --------------------------------------------------------

CONVERT_COSINE = 0.999  # the converted model's bf16 batch, every flag on, against its unfused bf16 model (phase 6)
INT8_COSINE = 0.999  # JAX tests/test_int8.py:41-53: int8 products against the bf16 model
EXPORT_COSINE = 0.99999  # a loaded exported program against the same model eager
SERVER_COSINE = 0.99999  # a socket reply against server.embed on the same features
SERVER_THREADS, SERVER_REQUESTS = 4, 32  # client threads, requests each
SERVER_ALONE = 16  # requests from one client thread before them
REF_TARGETS = 5994  # VoxCeleb2's speakers: the reference's margin head


class _RefState:
    """An ASV-Subtools (reference) state_dict drawn from a numpy seed: the
    reference's own keys and shapes, BatchNorms with num_batches_tracked."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.sd = {}

    def weight(self, key, shape, bias: bool = True):
        fan_in = int(np.prod(shape[1:]))
        self.sd[f"{key}.weight"] = (self.rng.standard_normal(shape, np.float32) / np.float32(np.sqrt(fan_in)))
        if bias:
            self.sd[f"{key}.bias"] = self.rng.standard_normal(shape[0], np.float32) * np.float32(0.1)

    def bn(self, key, n: int):
        r = self.rng
        self.sd[f"{key}.weight"] = r.uniform(0.8, 1.2, n).astype(np.float32)
        self.sd[f"{key}.bias"] = r.standard_normal(n, np.float32) * np.float32(0.1)
        self.sd[f"{key}.running_mean"] = r.standard_normal(n, np.float32) * np.float32(0.1)
        self.sd[f"{key}.running_var"] = r.uniform(0.5, 2.0, n).astype(np.float32)
        self.sd[f"{key}.num_batches_tracked"] = np.asarray(1000, np.int64)

    def tdnn(self, key, out: int, inp: int, k: int):
        """A reference ReluBatchNormTdnnLayer: TdnnAffine [out, in, k] + BN."""
        self.weight(f"{key}.affine", (out, inp, k))
        self.bn(f"{key}.batchnorm", out)

    def tensors(self, torch):
        return {k: torch.from_numpy(v) for k, v in self.sd.items()}


def reference_ecapa(torch, seed: int, feat: int = 80, c: int = 1024, mfa: int = 1536, embd: int = 192):
    """ASV-Subtools ECAPA_TDNN (ecapa_tdnn_xvector.py) C1024: the SE-Res2
    blocks' dilated convs as masked full-width kernels [h, h, 2d+1], the
    attention over [x; mean; std], the margin head's loss.weight."""
    r, h = _RefState(seed), c // 8
    r.tdnn("layer1", c, feat, 5)
    for li in (2, 3, 4):
        r.tdnn(f"layer{li}.conv_relu_bn1", c, c, 1)
        for b in range(7):
            r.tdnn(f"layer{li}.res2net_block.blocks.{b}", h, h, 2 * li + 1)
        r.tdnn(f"layer{li}.conv_relu_bn2", c, c, 1)
        r.weight(f"layer{li}.se.se.1", (128, c, 1))
        r.weight(f"layer{li}.se.se.3", (c, 128, 1))
    r.tdnn("mfa", mfa, 3 * c, 1)
    r.weight("stats.attention.0", (128, 3 * mfa, 1))
    r.bn("stats.attention.2", 128)
    r.weight("stats.attention.4", (mfa, 128, 1))
    r.bn("bn_stats", 2 * mfa)
    r.tdnn("fc2", embd, 2 * mfa, 1)
    r.weight("loss", (REF_TARGETS, embd, 1), bias=False)
    return r.tensors(torch)


def reference_resnet34(torch, seed: int, feat: int = 80, base: int = 32, embd: int = 512):
    """ASV-Subtools ResNetXvector (resnet_xvector.py), ResNet34 base 32, full
    pre-activation: 2-D kernels [out, in, kF, kT], the fc head over the
    channel-major [C, F'] flatten of the statistics."""
    r = _RefState(seed)
    r.weight("resnet.conv1", (base, 1, 3, 3), bias=False)
    r.bn("resnet.bn1", base)
    inp = base
    for stage, (blocks, stride) in enumerate(zip((3, 4, 6, 3), (1, 2, 2, 2)), start=1):
        planes = base * 2 ** (stage - 1)
        for b in range(blocks):
            pre = f"resnet.layer{stage}.{b}"
            r.bn(f"{pre}.bn1", inp)
            r.weight(f"{pre}.conv1", (planes, inp, 3, 3), bias=False)
            r.bn(f"{pre}.bn2", planes)
            r.weight(f"{pre}.conv2", (planes, planes, 3, 3), bias=False)
            if b == 0 and (stride != 1 or inp != planes):
                r.weight(f"{pre}.downsample.0", (planes, inp, 1, 1), bias=False)
                r.bn(f"{pre}.downsample.1", planes)
            inp = planes
    r.tdnn("fc2", embd, 2 * inp * -(-feat // 8), 1)
    r.weight("loss", (REF_TARGETS, embd, 1), bias=False)
    return r.tensors(torch)


def _all_flags(model, on: bool = True):
    """ECAPA's fused Res2 chains (K3) and attentive pooling (K2)."""
    for block in (model.layer2, model.layer3, model.layer4):
        block.res2net.fused_inference = on
    model.stats.fused_inference = on
    return model


def _feature_batch(torch, b: int, t: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, 80), generator=gen)
    lengths = torch.linspace(t // 2, t, b).long() if b > 1 else torch.tensor([t])
    return x, torch.arange(t)[None, :] < lengths[:, None]


def _kernel_events(torch, fn) -> dict:
    """{name: count} of the port's kernels in one profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for own in ("attend_mma_kernel", "attend_kernel", "res2_mma_kernel", "res2_kernel"):
                if re.search(rf"\b{own}\b", e.name):
                    counts[own] = counts.get(own, 0) + 1
    return counts


def phase_checkpoints_and_serving(torch, device_label):
    """Phase 25: (a) ASV-Subtools ECAPA C1024 and ResNet34 converted and
    served, (b) exported back, (c) int8, (d) torch.export, (e) the socket
    server."""
    import socket
    import struct
    import threading

    from asv_subtools_tpu_torch import convert, quantize
    from asv_subtools_tpu_torch.export import export_embed_fn, load_embed_fn
    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.features import FbankOptions, MelOptions
    from asv_subtools_tpu_torch.models import EcapaTdnn, ResNetXvector
    from asv_subtools_tpu_torch.nn.int8 import int8_matmul, quantize_rows
    from asv_subtools_tpu_torch.reverse_convert import ReverseConverter, margin_loss_reverse
    from asv_subtools_tpu_torch.serving import MAGIC, EmbeddingServer, embed_request

    dev = torch.device("cuda")
    opts = FbankOptions(mel_opts=MelOptions(num_bins=80))
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # (a) convert on the host, load onto the card, serve
    sd = reference_ecapa(torch, SEED + 250)
    t0 = time.perf_counter()
    converted = convert.convert_ecapa_state_dict(sd)
    convert_s = time.perf_counter() - t0
    model32 = EcapaTdnn(80, channels=1024, embd_dim=192, mfa_conv=1536)
    model32.load_state_dict(converted)
    off16 = copy.deepcopy(model32).to(torch.bfloat16)
    on16 = _all_flags(copy.deepcopy(off16))
    gen = torch.Generator(device=dev).manual_seed(SEED + 251)
    wave = torch.randn((BATCH, SAMPLES), generator=gen, device=dev) * 1000.0
    mask = torch.ones((BATCH, SAMPLES), dtype=torch.bool, device=dev)
    embed = make_wave_embed_fn(lambda x, m: on16(x, m), opts, dtype=torch.bfloat16)
    n_ref = sum(v.numel() for k, v in sd.items() if v.is_floating_point())
    print(f"phase 25 (a): ASV-Subtools ECAPA C1024 state_dict ({len(sd)} tensors, {n_ref} floats) converted on the "
          f"host in {convert_s:.3f} s", flush=True)
    with torch.inference_mode():
        ref16 = _plain_embed(torch, off16, opts, torch.bfloat16, torch.bfloat16)(wave, mask)
        ref32 = _plain_embed(torch, model32, opts, torch.float32, torch.float32)(wave, mask)
        waves = [wave * (1.0 + 1e-4 * i) for i in range(4)]
        torch.cuda.synchronize()
        zero_launches()
        emb16 = embed(waves[0], mask)
        torch.cuda.synchronize()
        c = read_launches("converted ECAPA C1024 served", ("fused_fbank", "fused_attentive_stats_pool",
                                                           "fused_res2_chain"))
        add(c)
        check(c["fused_res2_chain"] == 3 and c["fused_attentive_stats_pool"] == 1,
              f"the converted ECAPA's batch launched K3 {c['fused_res2_chain']} and K2 "
              f"{c['fused_attentive_stats_pool']} times")
        check(tuple(emb16.shape) == (BATCH, 192) and bool(torch.isfinite(emb16.float()).all()),
              "converted ECAPA embeddings not finite or of the wrong shape")
        c16, c32 = float(cosine(emb16, ref16).min()), float(cosine(emb16, ref32).min())
        print(f"converted ECAPA C1024 bf16, every flag on: min per-utterance cosine vs flags off + plain front end "
              f"(bf16) {c16:.6f} (>= {CONVERT_COSINE}), vs f32 model + f32 plain front end {c32:.6f} (>= 0.999)",
              flush=True)
        check(c16 >= CONVERT_COSINE and c32 >= 0.999, "converted ECAPA embeddings disagree with the references")
        ms_bf16 = timed_batches(torch, embed, waves, mask, iters=3)
        print(f"converted ECAPA C1024 bf16 [{BATCH},{SAMPLES}], every flag on: {ms_bf16:.2f} ms/batch on "
              f"{device_label}", flush=True)

    rsd = reference_resnet34(torch, SEED + 252)
    t0 = time.perf_counter()
    rconv = convert.convert_resnet_state_dict(rsd, freq_out=10)
    rconvert_s = time.perf_counter() - t0
    res32 = ResNetXvector(80)
    res32.load_state_dict(rconv)
    res_off = copy.deepcopy(res32).to(torch.bfloat16)
    res_on = copy.deepcopy(res_off)
    res_on.head.stats.fused_inference = True
    r_embed = make_wave_embed_fn(lambda x, m: res_on(x, m), opts, dtype=torch.bfloat16)
    with torch.inference_mode():
        rref16 = _plain_embed(torch, res_off, opts, torch.bfloat16, torch.bfloat16)(wave, mask)
        rref32 = _plain_embed(torch, res32, opts, torch.float32, torch.float32)(wave, mask)
        torch.cuda.synchronize()
        zero_launches()
        remb = r_embed(waves[0], mask)
        torch.cuda.synchronize()
        c = read_launches("converted ResNet34 served", ("fused_fbank", "fused_stats_pooling"))
        add(c)
        check(tuple(remb.shape) == (BATCH, 512) and bool(torch.isfinite(remb.float()).all()),
              "converted ResNet34 embeddings not finite or of the wrong shape")
        c16, c32 = float(cosine(remb, rref16).min()), float(cosine(remb, rref32).min())
        print(f"converted ResNet34 bf16, fused pooling: min per-utterance cosine vs flag off + plain front end "
              f"(bf16) {c16:.6f} (>= 0.9999), vs f32 model + f32 plain front end {c32:.6f} (>= 0.999)", flush=True)
        check(c16 >= 0.9999 and c32 >= 0.999, "converted ResNet34 embeddings disagree with the references")
        rms = timed_batches(torch, r_embed, waves, mask, iters=3)
        print(f"converted ResNet34 ({len(rsd)} tensors, host conversion {rconvert_s:.3f} s) bf16 "
              f"[{BATCH},{SAMPLES}], fused pooling: {rms:.2f} ms/batch on {device_label}", flush=True)
    del res32, res_off, res_on, r_embed
    torch.cuda.empty_cache()

    # (b) the served ECAPA's weights back to the reference's layout
    t0 = time.perf_counter()
    template = {k: v for k, v in sd.items() if not k.startswith("loss.")}
    rc = ReverseConverter(convert.convert_ecapa_state_dict, template)
    back = rc({k: v.cpu() for k, v in model32.state_dict().items()})
    back.update(margin_loss_reverse({"loss.weight": sd["loss.weight"][:, :, 0]}))
    reverse_s = time.perf_counter() - t0
    masked = {f"layer{li}.res2net_block.blocks.{b}.affine.weight": 128 * 128 * (2 * li - 2)
              for li in (2, 3, 4) for b in range(7)}
    counters = {k: 1 for k in sd if k.endswith("num_batches_tracked")}
    check(rc.uncovered == {**masked, **counters},
          f"uncovered positions {sum(rc.uncovered.values())} are not the masked taps and the batch counters")
    check(sorted(back) == sorted(sd), "the export's keys are not the reference's")
    differ = []
    for key, want in sd.items():
        got = back[key].reshape(want.shape)
        if key in masked:
            d = int(key[len("layer")])  # layer l's dilation is l: taps 0, d, 2d kept
            want = want.clone()
            keep = torch.zeros(want.shape[2], dtype=torch.bool)
            keep[[0, d, 2 * d]] = True
            want[:, :, ~keep] = 0
        elif key in counters:
            want = torch.zeros_like(want)
        if got.dtype != want.dtype or not torch.equal(got, want):
            differ.append(key)
    check(not differ, f"the export differs from the input state_dict at {differ[:4]}")
    print(f"phase 25 (b): export_to_reference of the served ECAPA's weights in {reverse_s:.2f} s on the host: "
          f"{len(back)} tensors equal to the input bit for bit at every covered position; uncovered "
          f"{sum(rc.uncovered.values())} values (the masked taps and {len(counters)} num_batches_tracked)", flush=True)

    # (c) int8: the channel-mixing products as dynamic int8 GEMMs, chains and pooling fused
    q16 = _all_flags(EcapaTdnn(80, channels=1024, embd_dim=192, mfa_conv=1536, int8_inference=True))
    q16.load_state_dict(model32.state_dict())
    q16 = q16.to(torch.bfloat16)
    q_embed = make_wave_embed_fn(lambda x, m: q16(x, m), opts, dtype=torch.bfloat16)
    with torch.inference_mode():
        zero_launches()
        int8_matmul.launches = 0
        emb_q = q_embed(waves[0], mask)
        torch.cuda.synchronize()
        c = read_launches("converted ECAPA C1024 int8", ("fused_fbank", "fused_attentive_stats_pool",
                                                         "fused_res2_chain"))
        add(c)
        check(int8_matmul.launches == 7, f"{int8_matmul.launches} int8 GEMMs in one batch, expected 7")
        cq = float(cosine(emb_q, emb16).min())
        print(f"converted ECAPA C1024 int8 (7 int8 GEMMs a batch): min per-utterance cosine vs the bf16 batch "
              f"{cq:.6f} (>= {INT8_COSINE})", flush=True)
        check(bool(torch.isfinite(emb_q.float()).all()) and cq >= INT8_COSINE, "int8 embeddings disagree with bf16")
        turns = [timed_batches(torch, e, waves, mask, iters=3) for e in (embed, q_embed, q_embed, embed)]
        print(f"converted ECAPA C1024 [{BATCH},{SAMPLES}] ms/batch: bf16 {min(turns[0], turns[3]):.2f}, int8 "
              f"{min(turns[1], turns[2]):.2f} on {device_label} (turns bf16 {turns[0]:.2f} int8 {turns[1]:.2f} "
              f"int8 {turns[2]:.2f} bf16 {turns[3]:.2f})", flush=True)
        profile_served_batch(torch, lambda: q_embed(waves[0], mask), what="one int8 batch")
        # the MFA's product: one utterance's 998 frames x 3072 channels into 1536, card against CPU
        seen = {}
        hook = q16.mfa.register_forward_hook(lambda mod, args, out: seen.update(x=args[0]))
        q16(torch.randn((1, 998, 80), device=dev, dtype=torch.bfloat16), None)
        hook.remove()
        xq, _ = quantize_rows(seen["x"][0].t(), 1e-8)
        wq, _ = quantize_rows(q16.mfa.affine.conv.weight[:, :, 0], 1e-12)
        card_i32 = int8_matmul(xq, wq).cpu()
        cpu_i32 = int8_matmul(xq.cpu(), wq.cpu())
        check(card_i32.dtype == torch.int32 and torch.equal(card_i32, cpu_i32),
              "the card's int8 product differs from the CPU's")
        full_x = torch.randint(-127, 128, (BATCH * 998, 3072), device=dev, dtype=torch.int8)
        full_xb = full_x.to(torch.bfloat16)
        wb = wq.to(torch.bfloat16)
        gemm_i8 = device_ms(torch, lambda: int8_matmul(full_x, wq), 10)
        gemm_bf16 = device_ms(torch, lambda: full_xb @ wb.t(), 10)
        print(f"int8 product at the MFA's shape [998, 3072] x [3072, 1536]: card equals CPU (int32, exact); at "
              f"the batch's [{BATCH * 998}, 3072] x [3072, 1536]: int8 {gemm_i8:.3f} ms, bf16 {gemm_bf16:.3f} ms "
              f"(device time)", flush=True)
        del full_x, full_xb
    del q16, q_embed
    qstate = quantize.quantize_params({k: v.cpu() for k, v in model32.state_dict().items()})
    qerr = quantize.quantization_error({k: v.cpu() for k, v in model32.state_dict().items()}, qstate)
    qbytes = sum(sum(t.numel() * t.element_size() for t in v.values()) if isinstance(v, dict)
                 else v.numel() * v.element_size() for v in qstate.values())
    fbytes = sum(v.numel() * v.element_size() for v in model32.state_dict().values())
    deq16 = _all_flags(EcapaTdnn(80, channels=1024, embd_dim=192, mfa_conv=1536))
    deq16.load_state_dict(quantize.dequantize_params(qstate))
    deq16 = deq16.to(torch.bfloat16)
    with torch.inference_mode():
        emb_deq = make_wave_embed_fn(lambda x, m: deq16(x, m), opts, dtype=torch.bfloat16)(waves[0], mask)
    cdq = float(cosine(emb_deq, emb16).min())
    print(f"quantize_params of the converted weights: max relative error {qerr:.5f} (< 0.01), {qbytes} bytes "
          f"against {fbytes} f32 ({fbytes / qbytes:.2f}x, > 3.5x); the dequantized model's min cosine vs the bf16 "
          f"batch {cdq:.6f} (> 0.999)", flush=True)
    check(qerr < 0.01 and qbytes < fbytes / 3.5 and cdq > 0.999, "weight quantization out of its bounds")
    del deq16, emb_deq
    torch.cuda.empty_cache()

    # (d) torch.export at two shapes, K2 and K3 inside the program
    feats_fn = lambda x, m: on16(x.to(torch.bfloat16), m).float()
    with tempfile.TemporaryDirectory() as tmp:
        for b, t in ((1, 400), (32, 1600)):
            t0 = time.perf_counter()
            path = export_embed_fn(feats_fn, 80, tmp, bucket_lengths=(t,), batch_sizes=(b,))[f"b{b}_t{t}"]
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = load_embed_fn(path)
            load_s = time.perf_counter() - t0
            x, m = _feature_batch(torch, b, t, SEED + 253 + b)
            x, m = x.to(dev), m.to(dev)
            with torch.inference_mode():
                eager = feats_fn(x, m)
                zero_launches()
                got = loaded(x, m)
                torch.cuda.synchronize()
                c = read_launches(f"exported ECAPA b{b}_t{t}", ("fused_attentive_stats_pool", "fused_res2_chain"))
                add(c)
                check(c["fused_res2_chain"] == 3 and c["fused_attentive_stats_pool"] == 1,
                      f"the loaded program launched K3 {c['fused_res2_chain']} and K2 "
                      f"{c['fused_attentive_stats_pool']} times")
                ce, err = float(cosine(got, eager).min()), max_abs(got, eager)
                events = _kernel_events(torch, lambda: loaded(x, m))
                k2 = events.get("attend_mma_kernel", 0) + events.get("attend_kernel", 0)
                k3 = events.get("res2_mma_kernel", 0) + events.get("res2_kernel", 0)
                ms_loaded = median_ms(torch, lambda: loaded(x, m), warmup=2, iters=10)
                ms_eager = median_ms(torch, lambda: feats_fn(x, m), warmup=2, iters=10)
                launched = {what: _profile(torch, fn, 1)[2] for what, fn in
                            (("loaded", lambda: loaded(x, m)), ("eager", lambda: feats_fn(x, m)))}
            print(f"exported ECAPA C1024 b{b}_t{t} (bf16, K2 and K3 on): export {export_s:.1f} s, save+load "
                  f"{load_s:.1f} s; loaded vs eager min cosine {ce:.7f} (>= {EXPORT_COSINE}), max abs diff "
                  f"{err:.3e}; the profiler counts {k2} K2 and {k3} K3 launches a call; {ms_loaded:.2f} ms a call "
                  f"loaded, {ms_eager:.2f} eager; kernel launches a call loaded {launched['loaded']}, eager "
                  f"{launched['eager']}", flush=True)
            check(tuple(got.shape) == (b, 192) and ce >= EXPORT_COSINE, "the loaded program disagrees with eager")
            if not events:
                print("the profiler recorded no device kernels (the launch counts above stand)", flush=True)
            check((k2, k3) == (1, 3) or not events, f"the profiler saw {k2} K2 and {k3} K3 launches, expected 1 and 3")

    # (e) the socket server: four client threads, one utterance a request
    server = EmbeddingServer(feats_fn)
    server.start()
    try:
        rng = np.random.default_rng(SEED + 254)
        batches = [[rng.standard_normal((int(n), 80)).astype(np.float32)
                    for n in rng.integers(200, 2001, size=SERVER_REQUESTS)] for _ in range(SERVER_THREADS)]
        for feats in batches[0][:4]:  # warm-up: the first calls of each bucket
            embed_request("127.0.0.1", server.port, feats)
        replies = [[None] * SERVER_REQUESTS for _ in range(SERVER_THREADS)]
        latency = []
        errors = []

        def client(i):
            try:
                for j, feats in enumerate(batches[i]):
                    t0 = time.perf_counter()
                    replies[i][j] = embed_request("127.0.0.1", server.port, feats)
                    latency.append((time.perf_counter() - t0) * 1e3)
            except Exception as e:  # noqa: BLE001 - a failed request fails the phase below
                errors.append(repr(e))

        # one client alone first: the server's pace without contention for the GIL
        t0 = time.perf_counter()
        alone = []
        for feats in batches[0][:SERVER_ALONE]:
            t1 = time.perf_counter()
            embed_request("127.0.0.1", server.port, feats)
            alone.append((time.perf_counter() - t1) * 1e3)
        alone_wall = time.perf_counter() - t0
        zero_launches()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVER_THREADS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        c = read_launches("socket server", ("fused_attentive_stats_pool", "fused_res2_chain"))
        add(c)
        n = SERVER_THREADS * SERVER_REQUESTS
        check(not errors and all(r is not None and r.shape == (192,) for rs in replies for r in rs),
              f"empty or failed server replies: {errors[:2]}")
        worst = min(float(cosine(torch.from_numpy(replies[i][j]), torch.from_numpy(server.embed(batches[i][j]))))
                    for i in range(SERVER_THREADS) for j in range(SERVER_REQUESTS))
        with socket.create_connection(("127.0.0.1", server.port)) as sock:
            sock.sendall(struct.pack("<III", 0xDEADBEEF, 10, 80))
            bad = struct.unpack("<II", sock.recv(8))
        profile_served_batch(torch, lambda: server.embed(batches[0][0]),
                             what=f"one server request of {len(batches[0][0])} frames")
    finally:
        server.stop()
    print(f"socket server, ECAPA C1024 bf16 (K2, K3), one client thread alone: {SERVER_ALONE} requests in "
          f"{alone_wall:.2f} s, {SERVER_ALONE / alone_wall:.1f} requests/s, latency p50 {np.percentile(alone, 50):.2f} "
          f"ms", flush=True)
    print(f"socket server, ECAPA C1024 bf16 (K2, K3): {n} requests of 200-2000 frames from {SERVER_THREADS} "
          f"threads in {wall:.2f} s, {n / wall:.1f} requests/s, latency p50 {np.percentile(latency, 50):.2f} ms p99 "
          f"{np.percentile(latency, 99):.2f} ms; K2 {c['fused_attentive_stats_pool'] / n:.2f} and K3 "
          f"{c['fused_res2_chain'] / n:.2f} launches a request; replies vs server.embed min cosine {worst:.7f} "
          f"(>= {SERVER_COSINE}); a bad magic got (magic, E) = ({bad[0]:#x}, {bad[1]})", flush=True)
    check(worst >= SERVER_COSINE, "server replies disagree with server.embed")
    check(c["fused_attentive_stats_pool"] == n and c["fused_res2_chain"] == 3 * n,
          "the server's launches are not 1 K2 and 3 K3 a request")
    check(bad == (MAGIC, 0), f"a bad magic got {bad}, not the error reply")
    del model32, off16, on16
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import asv_subtools_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (asv_subtools_tpu_torch not found)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    name, smi = phase_device(torch)
    kernels = {"fused_fbank": phase_fbank(torch), "fused_attentive_stats_pool": phase_att_pooling(torch),
               "fused_res2_chain": phase_res2(torch), "fused_stats_pooling": phase_stats_pooling(torch)}
    torch.cuda.empty_cache()
    paths = [phase_served(torch, smi)]
    torch.cuda.empty_cache()
    paths.append(phase_served_resnet(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_train(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_train_resnet(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_served_conformer(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_train_conformer(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_recipe(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_backend(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_served_xvector(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_train_xvector(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_olr(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_served_repvgg(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_served_roadmap_ecapa(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_served_lawlict(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_train_new(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_gates(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_offline(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_step_options(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_conformer_family(torch, smi))
    torch.cuda.empty_cache()
    paths.append(phase_checkpoints_and_serving(torch, smi))
    for kernel_name, k in kernels.items():
        k["launches"] = sum(counts[kernel_name] for counts in paths)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [{k: v[k] for k in order} for v in kernels.values()]}))
    print(smi, flush=True)
    # the run used one card, whatever the host holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
