"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test takes the `card` fixture, which skips where no
CUDA device exists. The machine with the card has no JAX, and
tests/conftest.py imports it, so run them as:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: log-mel 1e-3 and pooling 2e-4 (f32): both sides sum the same
products in f32, in another order. Pooling 2e-2 with bf16 inputs: both
sides round the attention hidden h to bf16, and another summation order
can move a value across a bf16 rounding boundary.
"""

import pytest
import torch

from asv_subtools_tpu_torch.features import FbankOptions, FrameOptions, MelOptions, fused_fbank, fused_fbank_plain
from asv_subtools_tpu_torch.nn import fused_attentive_stats_pool, fused_attentive_stats_pool_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dft_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,num_bins,length_ms,shift_ms", [
    ((3, 20480), 23, 25.0, 10.0),
    ((2, 16000 * 3 + 77), 80, 25.0, 10.0),
    ((1, 32000), 40, 30.0, 15.0),
    ((2, 32000), 23, 32.0, 10.0),
    ((1, 400), 23, 25.0, 10.0),
])
def test_fbank_kernel_matches_plain(card, dft_dtype, shape, num_bins, length_ms, shift_ms):
    opts = FbankOptions(frame_opts=FrameOptions(frame_length_ms=length_ms, frame_shift_ms=shift_ms),
                        mel_opts=MelOptions(num_bins=num_bins))
    gen = torch.Generator(device=card).manual_seed(0)
    wave = torch.randn(shape, generator=gen, device=card) * 1000
    before = fused_fbank.launches
    k, ke = fused_fbank(wave, opts, dft_dtype=dft_dtype)
    p, pe = fused_fbank_plain(wave, opts, dft_dtype=dft_dtype)
    torch.cuda.synchronize()
    assert fused_fbank.launches == before + 1
    assert k.shape == p.shape == (shape[0], opts.frame_opts.num_frames(shape[1]), num_bins)
    torch.testing.assert_close(k, p, atol=1e-3, rtol=0)
    torch.testing.assert_close(ke, pe, atol=1e-3, rtol=0)


@pytest.mark.parametrize("kw", [dict(use_power=False), dict(use_log_fbank=False),
                                dict(frame_opts=FrameOptions(remove_dc_offset=False))])
def test_fbank_kernel_options(card, kw):
    opts = FbankOptions(**kw)
    wave = torch.randn((2, 8000), generator=torch.Generator(device=card).manual_seed(1), device=card) * 1000
    k, ke = fused_fbank(wave, opts)
    p, pe = fused_fbank_plain(wave, opts)
    torch.testing.assert_close(k, p, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(ke, pe, atol=1e-3, rtol=0)


def test_fbank_kernel_raises_on_unsupported_geometry(card):
    wave = torch.zeros((1, 16000), device=card)
    with pytest.raises(ValueError):  # padded window 1024
        fused_fbank(wave, FbankOptions(frame_opts=FrameOptions(frame_length_ms=40.0)))
    with pytest.raises(ValueError):
        fused_fbank(wave.double())


def _pool_inputs(card, b, t, c, k, dtype, lengths, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device=card) * scale
    x = r(b, t, c).to(dtype)
    ws = [r(c, k, scale=c ** -0.5).to(dtype) for _ in range(3)]
    w2 = r(k, c, scale=k ** -0.5).to(dtype)
    vecs = (r(k, scale=0.1), 1.0 + r(k, scale=0.1), r(k, scale=0.1))
    mask = None if lengths is None else torch.arange(t, device=card)[None, :] < torch.tensor(lengths, device=card)[:, None]
    return (x, *ws, *vecs, w2, r(c, scale=0.1)), mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,k,lengths", [
    (2, 300, 256, 128, None),
    (3, 130, 200, 40, (130, 64, 1)),
    (2, 65, 128, 256, (65, 0)),
    (2, 511, 384, 64, (511, 173)),
    (1, 60000, 128, 64, (59000,)),
])
def test_att_pooling_kernel_matches_plain(card, dtype, b, t, c, k, lengths):
    args, mask = _pool_inputs(card, b, t, c, k, dtype, lengths)
    before = fused_attentive_stats_pool.launches
    out = fused_attentive_stats_pool(*args, mask=mask)
    ref = fused_attentive_stats_pool_plain(*args, mask=mask)
    torch.cuda.synchronize()
    assert fused_attentive_stats_pool.launches == before + 1
    assert out.shape == (b, 2 * c) and out.dtype == torch.float32
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_att_pooling_kernel_takes_transposed_view(card):
    """The model hands over a [B, T, C] view of [B, C, T] memory."""
    args, mask = _pool_inputs(card, 2, 100, 128, 128, torch.float32, (100, 50))
    x_ct = args[0].transpose(1, 2).contiguous()
    out = fused_attentive_stats_pool(x_ct.transpose(1, 2), *args[1:], mask=mask)
    ref = fused_attentive_stats_pool(*args, mask=mask)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_att_pooling_kernel_raises_on_mixed_types(card):
    args, _ = _pool_inputs(card, 1, 10, 128, 64, torch.float32, None)
    with pytest.raises(ValueError):
        fused_attentive_stats_pool(args[0].bfloat16(), *args[1:])
