"""The port's dropout layers (asv_subtools_tpu_torch.nn.dropout) against
JAX's nn/dropout.py.

The two packages' random streams differ, so each port layer splits into a
draw and an apply. JAX's own draw is read off its layer fed ones (its
output is then the mask times its scale, or 1 + the noise), turned into
the port's draw, and the port's apply on a random x (numpy, from a seed)
is held against JAX's output on that x with the same key at 1e-6 (f32).
The port's own draws are held to their laws: the keep rates, the band
widths (at most max(1, int(size * max_frac))) and the band starts (in
[0, max(1, size - max_w)), JAX nn/dropout.py:97-108). train=False and a
zero rate return x itself.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.nn import dropout as jdrop

# the module, not the function nn/__init__.py exports under its name
tdrop = importlib.import_module("asv_subtools_tpu_torch.nn.dropout")

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPE = (4, 50, 40)


def _x(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax(layer, x, seed):
    return np.asarray(layer.apply({}, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(seed)}))


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_context_dropout_applies_jax_draw(p, seed):
    x = _x(seed)
    scaled = _jax(jdrop.ContextDropout(p=p), np.ones(SHAPE, np.float32), seed)
    keep = torch.from_numpy(scaled[..., :1] > 0)
    assert (scaled == scaled[..., :1]).all()  # whole frames
    got = tdrop.ContextDropout(p).apply_draw(torch.from_numpy(x), keep).numpy()
    np.testing.assert_allclose(got, _jax(jdrop.ContextDropout(p=p), x, seed), **TOL)


@pytest.mark.parametrize("p", [0.3, 0.9])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_dropout_applies_jax_draw(p, seed):
    x = _x(seed)
    scaled = _jax(jdrop.RandomDropout(p=p), np.ones(SHAPE, np.float32), seed)
    keep = scaled > 0
    rate = torch.tensor(1.0 - 1.0 / float(scaled[keep].max()))
    got = tdrop.RandomDropout(p).apply_draw(torch.from_numpy(x), (rate, torch.from_numpy(keep))).numpy()
    np.testing.assert_allclose(got, _jax(jdrop.RandomDropout(p=p), x, seed), **TOL)


@pytest.mark.parametrize("noise_type", ["uniform", "gaussian"])
@pytest.mark.parametrize("seed", [0, 1])
def test_noise_dropout_applies_jax_draw(noise_type, seed):
    x = _x(seed)
    layer = jdrop.NoiseDropout(p=0.2, noise_type=noise_type)
    noise = torch.from_numpy(_jax(layer, np.ones(SHAPE, np.float32), seed) - 1.0)
    got = tdrop.NoiseDropout(0.2, noise_type).apply_draw(torch.from_numpy(x), noise).numpy()
    np.testing.assert_allclose(got, _jax(layer, x, seed), **TOL)


@pytest.mark.parametrize("kw", [dict(), dict(frequency=0.3, frame=0.1, rows=2, cols=3), dict(frequency=0.0),
                                dict(frame=0.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_specaugment_dropout_applies_jax_draw(kw, seed):
    x = _x(seed)
    layer = jdrop.SpecAugmentDropout(**kw)
    m = _jax(layer, np.ones(SHAPE, np.float32), seed)
    port = tdrop.SpecAugmentDropout(**kw)
    # a band is narrower than its axis, so each bin and frame shows in some row of the other axis
    fmask = torch.from_numpy(m.max(axis=1)) if port.frequency > 0 else None
    tmask = torch.from_numpy(m.max(axis=2)) if port.frame > 0 else None
    got = port.apply_draw(torch.from_numpy(x), (fmask, tmask)).numpy()
    np.testing.assert_allclose(got, _jax(layer, x, seed), **TOL)


@pytest.mark.parametrize("layer", [tdrop.ContextDropout(0.0), tdrop.RandomDropout(0.0), tdrop.NoiseDropout(0.0),
                                   tdrop.SpecAugmentDropout(0.0, 0.0), tdrop.Dropout(0.0), tdrop.ContextDropout(0.5),
                                   tdrop.RandomDropout(0.5), tdrop.NoiseDropout(0.5), tdrop.SpecAugmentDropout()])
def test_eval_and_zero_rate_return_x(layer):
    x = torch.from_numpy(_x(3))
    assert layer(x, train=False) is x
    if not layer.active():
        assert layer(x) is x
    else:
        assert not torch.equal(layer(x, generator=torch.Generator().manual_seed(0)), x)


def test_draws_keep_their_rates():
    x = torch.ones((64, 200, 80))
    gen = torch.Generator().manual_seed(0)
    for p in (0.1, 0.3):
        keep = tdrop.ContextDropout(p).draw(x, gen)
        assert keep.shape == (64, 200, 1) and abs(float(keep.float().mean()) - (1 - p)) < 0.01
        keep = tdrop.Dropout(p).draw(x, gen)
        assert abs(float(keep.float().mean()) - (1 - p)) < 0.01
    rates = []
    for _ in range(40):
        rate, keep = tdrop.RandomDropout(0.4).draw(x, gen)
        assert 0.0 <= float(rate) <= 0.4 and abs(float(keep.float().mean()) - (1 - float(rate))) < 0.01
        rates.append(float(rate))
    assert 0.12 < np.mean(rates) < 0.28
    noise = tdrop.NoiseDropout(0.2).draw(x, gen)
    assert float(noise.abs().max()) <= 0.2 and abs(float(noise.mean())) < 0.01
    assert abs(float(tdrop.NoiseDropout(0.2, "gaussian").draw(x, gen).std()) - 0.2) < 0.01
    with pytest.raises(ValueError):
        tdrop.NoiseDropout(0.2, "laplace")


@pytest.mark.parametrize("size,max_frac,n", [(200, 0.2, 1), (80, 0.3, 2), (4, 0.1, 3)])
def test_band_widths_and_starts(size, max_frac, n):
    """Each band of a mask is a run of zeros: width <= max_w, start in
    [0, max(1, size - max_w)); every width 0..max_w turns up."""
    gen = torch.Generator().manual_seed(1)
    max_w = max(1, int(size * max_frac))
    widths, starts = set(), set()
    for _ in range(20):
        mask = tdrop.SpecAugmentDropout.band_mask((256,), size, max_frac, n, gen, torch.ones(1))
        assert mask.shape == (256, size) and set(mask.unique().tolist()) <= {0.0, 1.0}
        if n == 1:
            for row in mask:
                zeros = torch.nonzero(row == 0).flatten()
                if len(zeros):
                    assert int(zeros[-1] - zeros[0]) + 1 == len(zeros) <= max_w
                    assert 0 <= int(zeros[0]) < max(1, size - max_w)
                    starts.add(int(zeros[0]))
                widths.add(len(zeros))
        else:
            assert int((mask == 0).sum(1).max()) <= n * max_w
    if n == 1:
        assert widths == set(range(max_w + 1)) and min(starts) == 0
