"""asv_subtools_tpu_torch: the PyTorch and CUDA port of asv_subtools_tpu.

The JAX package ``asv_subtools_tpu`` is the reference; this package never
imports it (nor JAX). So far it covers the serving path: waveform ->
fused Kaldi fbank (CUDA kernel) -> utterance CMVN -> ECAPA-TDNN or
ResNet34 x-vector -> embedding -> cosine scoring and EER; and the
ECAPA-TDNN train step (``train/``): the same front end inside the step,
the margin losses, the optimizers and schedules. Public functions keep the JAX
layouts: channels-last ``[B, T, C]`` and ``[B, T]`` masks, True = valid.
"""
