"""The synthetic corpora of the repo's EER gates (numpy and scipy only).

The port's own copy of the JAX package's gate synthesizers; a seed gives
the same waves bit for bit, since every function consumes the numpy
``Generator`` in the same order:

* ``make_speaker``, ``synth_utt``: formant-identity voices with
  overlapping f0, a per-utterance channel tilt and 5-20 dB noise
  (recipes/quality_gate.py:36-84);
* ``spoof_utt``: three spoof families over a bona-fide wave
  (recipes/antispoof_gate.py:37-64);
* ``to_target_domain``: a telephone-like channel
  (recipes/adaptation_gate.py:43-57);
* ``make_demo_speaker``, ``synth_demo_utt``: the demo's harmonic-stack
  voices (recipes/demo_synthetic.py:23-40).

Rendering a wave costs far more than drawing its random numbers. A
:class:`Renderer` keeps the draws in one thread, in order: for each job it
notes the generator's state, then consumes exactly the job's draws
without rendering (the ``advance_*`` functions); worker processes render
from the noted states. The waves are those of a serial run, bit for bit.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

SR = 16000


def make_speaker(rng):
    """Vocal-tract-like identity: 4 formant resonators. f0 deliberately
    overlaps across speakers so pitch alone cannot separate them."""
    return {
        "formants": np.array([
            rng.uniform(280, 900),
            rng.uniform(900, 2200),
            rng.uniform(2200, 3100),
            rng.uniform(3100, 4200),
        ]),
        "bw": rng.uniform(60, 140, size=4),
        "gains": rng.dirichlet(np.ones(4)) + 0.1,
        "f0_mean": rng.uniform(110, 220),
    }


def synth_utt(spk, dur, rng, sr=SR):
    """Glottal harmonic source -> formant cascade -> channel tilt + noise."""
    from scipy import signal as sps

    n = int(sr * dur)
    t = np.arange(n) / sr
    f0 = spk["f0_mean"] * rng.uniform(0.8, 1.25)  # per-utt pitch variation
    vib = rng.uniform(3.0, 7.0)
    f_inst = f0 * (1.0 + 0.02 * np.sin(2 * np.pi * vib * t)
                   + 0.01 * rng.normal(size=n).cumsum() / np.sqrt(np.arange(1, n + 1)))
    phase = 2 * np.pi * np.cumsum(f_inst) / sr
    n_harm = max(3, int(4000 / max(f0, 1.0)))
    src = sum(
        np.sin((h + 1) * phase + rng.uniform(0, 6.28)) / (h + 1)
        for h in range(n_harm)
    )

    # formant cascade: 2nd-order resonators at the speaker's formants
    out = np.zeros_like(src)
    for fc, bw, g in zip(spk["formants"], spk["bw"], spk["gains"]):
        r = np.exp(-np.pi * bw / sr)
        theta = 2 * np.pi * fc / sr
        b = [1.0 - r]
        a = [1.0, -2 * r * np.cos(theta), r * r]
        out = out + g * sps.lfilter(b, a, src)

    # per-utterance channel: random spectral tilt (1st-order) + gain
    tilt = rng.uniform(-0.7, 0.7)
    out = sps.lfilter([1.0, tilt], [1.0], out)
    out = out / (np.abs(out).max() + 1e-9) * rng.uniform(2000, 8000)

    # additive noise at 5-20 dB SNR
    snr_db = rng.uniform(5.0, 20.0)
    sig_p = np.mean(out**2)
    noise = rng.normal(size=n)
    noise *= np.sqrt(sig_p / (10 ** (snr_db / 10.0)))
    return (out + noise).astype(np.float32)


def advance_synth_utt(spk, dur, rng, sr=SR) -> None:
    """Consume the draws of ``synth_utt(spk, dur, rng, sr)``, in its order,
    without rendering."""
    n = int(sr * dur)
    f0 = spk["f0_mean"] * rng.uniform(0.8, 1.25)
    rng.uniform(3.0, 7.0)
    rng.normal(size=n)
    for _ in range(max(3, int(4000 / max(f0, 1.0)))):
        rng.uniform(0, 6.28)
    rng.uniform(-0.7, 0.7)
    rng.uniform(2000, 8000)
    rng.uniform(5.0, 20.0)
    rng.normal(size=n)


def spoof_utt(wav: np.ndarray, attack: int, rng) -> np.ndarray:
    """Three synthetic spoof families over a bona-fide waveform: hard mu-law
    companding (attack 0), hard clipping at 30-60% of peak (1), a 4 kHz
    bandwidth round trip (2)."""
    from scipy import signal as sps

    if attack == 0:
        peak = np.abs(wav).max() + 1e-9
        mu = float(rng.uniform(255, 2047))
        x = wav / peak
        out = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu) * peak
    elif attack == 1:
        peak = np.abs(wav).max() + 1e-9
        c = float(rng.uniform(0.3, 0.6)) * peak
        out = np.clip(wav, -c, c)
    else:
        out = sps.resample_poly(sps.resample_poly(wav, 1, 4), 4, 1)[: len(wav)]
    out = np.asarray(out, np.float32)
    if len(out) < len(wav):
        out = np.pad(out, (0, len(wav) - len(out)))
    return out


def advance_spoof_utt(attack: int, rng) -> None:
    """Consume the draws of ``spoof_utt(wav, attack, rng)``."""
    if attack == 0:
        rng.uniform(255, 2047)
    elif attack == 1:
        rng.uniform(0.3, 0.6)


def to_target_domain(wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Telephone-like channel: 300-3400 Hz bandpass, extra 1st-order tilt,
    additive noise at 0-12 dB SNR (measured on the band-limited signal)."""
    from scipy import signal as sps

    sos = sps.butter(4, [300.0, 3400.0], btype="bandpass", fs=SR, output="sos")
    out = sps.sosfilt(sos, wav.astype(np.float64))
    tilt = rng.uniform(0.3, 0.9)  # strong, always-positive tilt (darker)
    out = sps.lfilter([1.0, tilt], [1.0], out)
    snr_db = rng.uniform(0.0, 12.0)
    sig_p = np.mean(out**2) + 1e-12
    noise = rng.normal(size=out.shape)
    noise *= np.sqrt(sig_p / (10 ** (snr_db / 10.0)))
    out = out + noise
    return (out / (np.abs(out).max() + 1e-9) * 4000.0).astype(np.float32)


def advance_to_target_domain(n: int, rng) -> None:
    """Consume the draws of ``to_target_domain`` on a wave of n samples."""
    rng.uniform(0.3, 0.9)
    rng.uniform(0.0, 12.0)
    rng.normal(size=(n,))


def make_demo_speaker(rng, sr=16000):
    """The demo's voice: f0, six harmonic weights, a vibrato rate."""
    f0 = rng.uniform(90.0, 280.0)
    weights = rng.dirichlet(np.ones(6))
    vibrato = rng.uniform(2.0, 8.0)
    return f0, weights, vibrato


def synth_demo_utt(spk, dur, rng, sr=16000):
    """A harmonic stack with vibrato and additive noise."""
    f0, weights, vib = spk
    n = int(sr * dur)
    t = np.arange(n) / sr
    f_inst = f0 * (1.0 + 0.01 * np.sin(2 * np.pi * vib * t))
    phase = 2 * np.pi * np.cumsum(f_inst) / sr
    wav = sum(
        w * np.sin((h + 1) * phase + rng.uniform(0, 6.28)) for h, w in enumerate(weights)
    )
    wav = wav * 4000 + rng.normal(size=n) * rng.uniform(100, 400)
    return wav.astype(np.float32)


def advance_synth_demo_utt(spk, dur, rng, sr=16000) -> None:
    """Consume the draws of ``synth_demo_utt(spk, dur, rng, sr)``."""
    for _ in spk[1]:
        rng.uniform(0, 6.28)
    rng.normal(size=int(sr * dur))
    rng.uniform(100, 400)


# -- jobs: one wave each, rendered from a noted generator state ---------------

def _spoof_pair(spk, dur, rng):
    """A bona-fide wave, then the spoof of it that antispoof_gate.py:124-128
    draws next: (bona fide, spoof)."""
    w = synth_utt(spk, dur, rng)
    attack = int(rng.integers(0, 3))
    return w, spoof_utt(w, attack, rng)


def _advance_spoof_pair(spk, dur, rng):
    advance_synth_utt(spk, dur, rng)
    advance_spoof_utt(int(rng.integers(0, 3)), rng)


def _target_utt(spk, dur, rng):
    """synth_utt, then to_target_domain on the same generator."""
    return to_target_domain(synth_utt(spk, dur, rng), rng)


def _advance_target_utt(spk, dur, rng):
    advance_synth_utt(spk, dur, rng)
    advance_to_target_domain(int(SR * dur), rng)


def _spoofed_utt(spk, dur, attack, rng):
    """synth_utt, then spoof_utt with a given attack (the evaluation set's
    odd utterances, antispoof_gate.py:159-160)."""
    return spoof_utt(synth_utt(spk, dur, rng), attack, rng)


def _advance_spoofed_utt(spk, dur, attack, rng):
    advance_synth_utt(spk, dur, rng)
    advance_spoof_utt(attack, rng)


JOBS: Dict[str, Tuple[Callable, Callable]] = {
    "synth": (synth_utt, advance_synth_utt),
    "demo": (synth_demo_utt, advance_synth_demo_utt),
    "spoof_pair": (_spoof_pair, _advance_spoof_pair),
    "target": (_target_utt, _advance_target_utt),
    "spoofed": (_spoofed_utt, _advance_spoofed_utt),
}


def _render(kind: str, args: tuple, state: dict):
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = state
    return JOBS[kind][0](*args, rng)


class Renderer:
    """Renders gate waves in ``workers`` processes (0: in this thread;
    None: every core but one, at most 7).

    ``submit(rng, kind, *args)`` takes the draws of the job
    ``JOBS[kind][0](*args, rng)`` from ``rng`` at once and returns a
    function that waits for the job's result. Jobs submitted one after
    another leave ``rng`` where the serial calls leave it, and their
    results are the serial calls' bit for bit. The workers are spawned
    (the parent may hold a CUDA context) and import numpy and scipy only.
    """

    def __init__(self, workers: Optional[int] = None):
        if workers is None:
            workers = max(0, min(7, (os.cpu_count() or 1) - 1))
        self.workers = workers
        self._pool: Optional[ProcessPoolExecutor] = None
        if workers > 0:
            self._pool = ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"))

    def submit(self, rng, kind: str, *args) -> Callable[[], Any]:
        render, advance = JOBS[kind]
        if self._pool is None:
            out = render(*args, rng)
            return lambda: out
        state = rng.bit_generator.state
        advance(*args, rng)
        return self._pool.submit(_render, kind, args, state).result

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self) -> "Renderer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
