"""asv_subtools_tpu_torch: the PyTorch and CUDA port of asv_subtools_tpu.

The JAX package ``asv_subtools_tpu`` is the reference; this package never
imports it (nor JAX). It serves and trains the three families of the JAX
benchmark: ECAPA-TDNN, the ResNet34 x-vector and the Conformer x-vector.
Serving: waveform -> fused Kaldi fbank (CUDA kernel) -> utterance CMVN ->
model -> embedding (``extract.py``). Training: the train step
(``train/``: the same front end inside the step, the margin losses, the
optimizers and schedules), the epoch ``Trainer`` with validation,
checkpoints and the reporter. Scoring: the statistical back end
(``backend/``: transforms, PLDA and its adaptation, S-norm/AS-norm,
classifiers, fusion, i-vectors, the metrics and ``ScoreSets``), f64 numpy
on the host, with the cosine score matrices, ``asnorm_device`` and the
PLDA LLR matrix (``llr_matrix_device``) in f32 on the card. The recipe's
entry point, ``launcher.Launcher`` (stages 0-3: online wave egs or the
offline chunk egs of ``data/``, training, with the multi-task and FD-AL
x-vectors, SAM and the LR finder, extraction to a Kaldi ark/scp, scoring
a trial list with EER and minDCF), runs as
``python -m asv_subtools_tpu_torch.recipes.voxceleb``. Public functions
keep the JAX layouts: channels-last ``[B, T, C]`` and ``[B, T]`` masks,
True = valid.
"""
