"""asv_subtools_tpu_torch: the PyTorch and CUDA port of asv_subtools_tpu.

The JAX package ``asv_subtools_tpu`` is the reference; this package never
imports it (nor JAX). It serves and trains the three families of the JAX
benchmark: ECAPA-TDNN, the ResNet34 x-vector and the Conformer x-vector.
Serving: waveform -> fused Kaldi fbank (CUDA kernel) -> utterance CMVN ->
model -> embedding (``extract.py``) -> cosine scoring and EER
(``backend/``). Training: the train step (``train/``: the same front end
inside the step, the margin losses, the optimizers and schedules), the
epoch ``Trainer`` with validation, checkpoints and the reporter. The
recipe's entry point, ``launcher.Launcher`` (stages 0-2: online wave egs
from ``data/``, training, extraction to a Kaldi ark/scp), runs as
``python -m asv_subtools_tpu_torch.recipes.voxceleb``. Public functions
keep the JAX layouts: channels-last ``[B, T, C]`` and ``[B, T]`` masks,
True = valid.
"""
