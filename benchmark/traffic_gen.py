"""The one generator of the benchmark's traffic, driven by a mix's file.

A mix (``benchmark/traffic/<mix>.json``) gives numbers only: the
utterance lengths' distribution, the pool they are drawn in, the noise
the waves are cut from, the batch and buckets. Every seed gets the same
set of lengths, in its own order: the pool holds the distribution's
quantiles at (i + 0.5) / pool, and each pass over it is a permutation
drawn from the seed. So seeds differ in order and content, not in the
amount of work.

Distributions (``length.dist``):
- ``shifted_exponential``: ``min_s`` plus an exponential of mean
  ``mean_extra_s``, the total capped at ``cap_s``.
- ``fixed``: every utterance ``s`` seconds.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one use (``stream``) of the run's seed."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def length_pool(mix: dict) -> np.ndarray:
    """The pool's lengths in samples, ascending: the quantiles of the mix's
    distribution."""
    spec, rate, n = mix["length"], mix["sample_rate"], mix.get("pool", 1)
    if spec["dist"] == "fixed":
        return np.full(n, int(round(spec["s"] * rate)), np.int64)
    if spec["dist"] != "shifted_exponential":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    p = (np.arange(n) + 0.5) / n
    seconds = np.minimum(spec["min_s"] - spec["mean_extra_s"] * np.log1p(-p), spec["cap_s"])
    return np.round(seconds * rate).astype(np.int64)


def noise(mix: dict, seed: int) -> np.ndarray:
    """The host buffer the waves are cut from: seeded Gaussian noise of
    ``amplitude`` standard deviation, rounded to integers and clipped to
    int16's range, as float32."""
    rng = np.random.default_rng(derived_seed(seed, 1))
    n = int(mix["noise_s"] * mix["sample_rate"])
    x = np.round(rng.standard_normal(n) * mix["amplitude"])
    return np.clip(x, -32767, 32767).astype(np.float32)


class UtteranceStream:
    """Endless (index, samples, offset) of a mix, from the seed: lengths
    from the pool in seeded passes, offsets uniform over the noise."""

    def __init__(self, mix: dict, seed: int):
        self.pool = length_pool(mix)
        self.rng = np.random.default_rng(derived_seed(seed, 2))
        self.room = int(mix["noise_s"] * mix["sample_rate"])
        if self.pool.max() > self.room:
            raise ValueError("the noise buffer is shorter than the longest utterance")
        self.index = 0

    def __iter__(self) -> Iterator[Tuple[int, int, int]]:
        while True:
            for n in self.pool[self.rng.permutation(len(self.pool))]:
                off = int(self.rng.integers(0, self.room - n + 1))
                yield self.index, int(n), off
                self.index += 1


def device_waves(mix: dict, shape, generator, device):
    """Waves [..., S] drawn on the device from ``generator``: Gaussian
    noise of ``amplitude`` standard deviation, rounded to integers and
    clipped to int16's range, as float32."""
    import torch

    x = torch.round(torch.randn(shape, generator=generator, device=device) * mix["amplitude"])
    return torch.clamp(x, -32767, 32767)


def bucket_of(samples: int, buckets) -> int:
    for b in buckets:
        if samples <= b:
            return b
    return buckets[-1]


def chunk_samples(mix: dict) -> int:
    return int(round(mix["length"]["s"] * mix["sample_rate"]))

