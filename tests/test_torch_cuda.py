"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test takes the `card` fixture, which skips where no
CUDA device exists. The machine with the card has no JAX, and
tests/conftest.py imports it, so run them as:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: log-mel 1e-3 and pooling 2e-4 (f32; 1e-3 where logits of
several hundred carry their f32 rounding into the softmax): both sides sum the same
products in f32, in another order (the bf16 DFT runs on the tensor cores
when the frame shift is a multiple of 8 samples, else on the CUDA cores
like the f32 DFT). Pooling 2e-2 with bf16 inputs: both
sides round the attention hidden h to bf16, and another summation order
can move a value across a bf16 rounding boundary. Res2 chain 1e-4 (f32)
and 2e-2 (bf16: one bf16 ulp where a sum in another order crosses a
rounding boundary, which the next stages carry on; bf16 at h = 16, 32, 64,
128 runs the tensor-core kernel, everything else the CUDA-core one). Statistics pooling
rtol 1e-4 / atol 1e-5, for f32 and bf16 inputs alike (both sides read the
same values and sum in f32).

The train step (train/step_check.py builds the case: ECAPA C256, B=8):
a bf16 wave-input step whose loss is finite and which launches K1 once;
bf16 steps, unmasked, masked and at accum_grad 2, that never wait on the
card; the f64 step on the card against the same step on the CPU, on the
same features: each parameter's update to 1e-8 of its norm, loss,
grad_norm, accuracy and the BN running statistics to 1e-10; the f32
wave-input step (K1's f32 mode, TF32 off): loss and grad_norm to 1e-4 of
the CPU's, and on each device every leaf to 0.12 and every BN statistic
to 2e-5 of its norm from the f64 step (an f32 step at B=8 is
ill-conditioned: over six seeds and three heads a leaf read up to 5.8e-2
and a statistic 6.6e-6 from it; PERF.md).

The recipe's epoch loop (launcher.py, a narrow ECAPA, bf16, wave mode):
one epoch on the card, its batches handed over pinned, whose only host
waits are the Trainer's fetches (the step counter at the start, each
report point, the epoch's end), counted under
torch.cuda.set_sync_debug_mode("warn"); and spawn loader workers that
compute host features (torch imported) while the parent holds the card:
none sees the card or initialises CUDA, and none shows in nvidia-smi.

The TDNN x-vectors: K4 on the x-vector's layout (a [B, T, D] view of
[B, D, T] memory) at D = 1500 (bf16: 3,000-byte rows, the direct kernel)
and D = 2048 (the ring kernel after the wrapper's copy), rtol 1e-4 /
atol 1e-5 against the plain version; the narrow F-TDNN's step (width
0.125, use_semi_orth, step 0, where step % 4 == 0 applies the update)
on the card against the CPU with the bounds of the ECAPA step; and one
served SnowdarXvector batch (512 channels, bf16, the fused pooling)
against the f32 model on the f32 plain front end at cosine 0.999, K4
launched once.

RepVGG, the lawlict ECAPA and the MQMHA ECAPA: K4 on RepVGG's pooling
input [128, 125, 6400] bf16 (12,800-byte rows: the ring kernel), rtol
1e-4 / atol 1e-5 against the plain version; a RepVggXvector (RepSPK,
blocks 1-2-2-1, base 16, running statistics away from (0, 1)) deployed
against its train shape on the card in f32, TF32 off, at per-utterance
cosine 0.99999; one bf16 forward of each of the three models, card
against CPU, at cosine 0.999 (both round every layer to bf16, in other
orders).

The offline route (the multi-task, FD-AL and SAM steps on features): one
SGD step of each narrow net (128 channels, B=8, 198 frames) card against
CPU with the bounds of the ECAPA step (f64 leaves to F64_LEAF_TOL, loss
and grad_norm to 1e-10; f32 loss and grad_norm to 1e-4 of the CPU's and
every leaf and BN statistic against the f64 step to F32_LEAF_TOL and
F32_STATS_TOL); bf16 steps of each that never wait on the card; a whole
FD cycle on the card where an adversary step moves the ``dal`` leaves
alone and a main step none of them; and Launcher.find_lr on wave egs
(a narrow ECAPA): K1 once a step and one host wait a step.

The step options, the reference's optimizers and the ReConformer: the
float64 step with mixup (a pinned draw: the two devices' generators draw
other values) and with each remat policy, card against CPU to
F64_LEAF_TOL; on the card, a remat step of a Conformer with dropout 0.1
and train-mode BatchNorm against the plain step at 1e-10 (the recompute
replays the generator); bf16 steps with mixup, remat and each new
optimizer and wrapper that never wait on the card; the balancer's
backward card against CPU (f64 1e-12, f32 1e-6, bf16 2e-2); the narrow
ReConformer's step card against CPU with the Conformer's bounds; and
reconformer.yaml's model served on the card against the CPU (f32
cosine 0.9999, bf16 0.999).

The rest of the Conformer family (chip_smoke's phase 24 nets, narrow):
the Transformer x-vector's and the GAU Conformer's steps card against
CPU with the ReConformer's bounds; the GAU Conformer's f64 step with
softmax_plus, layer drop and the dynamic chunk, the draws pinned on both
devices, to F64_LEAF_TOL, and its bf16 step with the draws on the card's
generator under the sync check; each option of step_check.OPTION_SWEEP,
one f32 eval forward card against CPU at 1e-5; RoPE, T5 and GAU modules
card against CPU in f32 (1e-5) and bf16 (3e-2), the T5 buckets equal;
both nets served at full width on ragged waves against the CPU (f32
cosine 0.99999, K1 f32 0.9999, bf16 0.999).

The scoring back end's device functions (f32, TF32 off): asnorm_device at
E=100, T=130 against a cohort of 600 (top 64) and at the scale of
tests/test_backend_scale.py (600 x 970, cohort 5,994, top 300) against
the f64 host asnorm at rtol 2e-3, atol 2e-4; llr_matrix_device at
600 x 970, D=256, against the f64 Plda.llr_matrix at 2e-3; each result a
tensor on the card.

The native host front end and the mesh: the C++ library builds on the
card's host (plain c++) and its fbank agrees with the port's host fbank
at 1e-3; under a world-1 NCCL group ``resolve_device()`` is
``cuda:LOCAL_RANK``, and the mesh step of a narrow ECAPA (C256, B=8,
bf16 on f32 masters, K1 in the step) through ``Trainer(mesh=
make_mesh(1, 1))``, with and without ZeRO-3 rules, equals the plain step
from the same seed at chip_smoke phase 28's bars (loss and grad_norm
1e-5 relative, BN statistics 1e-6, every leaf within 2.5 lr) and never
waits on the card.

The native runtime (asv_subtools_tpu_torch/runtime): each kernel's C++
registration (runtime/ops.cc), run by bundle_runner inside an
AOTInductor package, equals the Python op on the same CUDA inputs bit
for bit (K2 f32 and bf16, K3 on the CUDA and tensor cores, K4 on a
contiguous x, on a transposed view and without a mask), one launch a
call; a narrow ECAPA bundle (K2 and K3 on, f32) through the CUDA runner
matches eager at 1e-5 with K2 once and K3 three times a call; a runner
built without ops.cc fails on that package, and the CPU device refuses
a CUDA package: nothing falls back.

The Extractor's staging: a narrow bf16 ECAPA behind make_wave_embed_fn
over a stream that fills two buckets, with partial tails and a chunked
utterance; the pinned, one-in-flight path yields the keys, the order and
the embeddings of a synchronous pageable path (a fresh zero-padded batch,
a host mask, ``.cpu()``) bit for bit, copies in from pinned memory only,
and allocates no slab on a second pass.

The fused relative-position attention (K5): at the Conformer cell's
shapes (B 8-16, T' 396 / 796 / 1,596, 4 heads of 64, mixed lengths) the
kernel's relative L2 gap to the same attention in f32 is at most 1.5
times the bf16 chain's (the module's unfused path on the card), padded
rows are zero; fp16 and no mask run; the 6L-256D-4H Conformer x-vector's
eval forward launches it once a layer and never waits on the card; and
``torch.export`` keeps it as one node of the exported program.

The kernel wrappers' dispatch: an eager call of K2, K3 or K4 on a CUDA
tensor launches its kernel once without entering its custom op (the op,
swapped for one that raises, is never called), and ``torch.export`` of a
module that calls the three wrappers keeps the three ops as nodes of the
program, which launches each kernel once.
"""

import numpy as np
import pytest
import torch

from asv_subtools_tpu_torch.features import FbankOptions, FrameOptions, MelOptions, fused_fbank, fused_fbank_plain
from asv_subtools_tpu_torch.models import Res2NetBlock
from asv_subtools_tpu_torch.nn import (
    StatisticsPooling,
    fused_attentive_stats_pool,
    fused_attentive_stats_pool_plain,
    fused_rel_attention,
    fused_rel_attention_plain,
    fused_res2_chain,
    fused_res2_chain_plain,
    fused_stats_pooling,
    fused_stats_pooling_plain,
)
from asv_subtools_tpu_torch.weights import init_weights_

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
    ((2, 400 + 160 * 64), 80, 25.0, 10.0),   # 65 frames: one frame past a tile edge
    ((3, 400 + 160 * 127), 23, 25.5, 10.0),  # 127 frames; a 408-sample window in 416 matrix rows
    ((2, 12001), 40, 30.0, 7.5),             # shift 120: no spare pieces in the span; odd length
    ((2, 16000), 23, 25.0, 7.75),            # shift 124: not a multiple of 8, the CUDA-core kernel in bf16 too
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
    on_tensor_cores = dft_dtype == torch.bfloat16 and opts.frame_opts.window_shift % 8 == 0
    assert fused_fbank.last_route == ("tensor_core" if on_tensor_cores else "cuda_core")
    assert k.shape == p.shape == (shape[0], opts.frame_opts.num_frames(shape[1]), num_bins)
    torch.testing.assert_close(k, p, atol=1e-3, rtol=0)
    torch.testing.assert_close(ke, pe, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dft_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(use_power=False), dict(use_log_fbank=False),
                                dict(frame_opts=FrameOptions(remove_dc_offset=False))])
def test_fbank_kernel_options(card, kw, dft_dtype):
    opts = FbankOptions(**kw)
    wave = torch.randn((2, 8000), generator=torch.Generator(device=card).manual_seed(1), device=card) * 1000
    k, ke = fused_fbank(wave, opts, dft_dtype=dft_dtype)
    p, pe = fused_fbank_plain(wave, opts, dft_dtype=dft_dtype)
    torch.testing.assert_close(k, p, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(ke, pe, atol=1e-3, rtol=0)


def test_fbank_kernel_raises_on_unsupported_geometry(card):
    wave = torch.zeros((1, 16000), device=card)
    with pytest.raises(ValueError):  # padded window 1024
        fused_fbank(wave, FbankOptions(frame_opts=FrameOptions(frame_length_ms=40.0)))
    for dft_dtype in (torch.float32, torch.bfloat16):  # shift 125: neither kernel takes it
        with pytest.raises(ValueError):
            fused_fbank(wave, FbankOptions(frame_opts=FrameOptions(frame_shift_ms=7.8125)), dft_dtype=dft_dtype)
    with pytest.raises(ValueError):
        fused_fbank(wave.double())


def _pool_inputs(card, b, t, c, k, dtype, lengths, seed=0, logit_scale=1.0):
    g = torch.Generator(device=card).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device=card) * scale
    x = r(b, t, c).to(dtype)
    ws = [r(c, k, scale=c ** -0.5).to(dtype) for _ in range(3)]
    w2 = r(k, c, scale=logit_scale * k ** -0.5).to(dtype)
    vecs = (r(k, scale=0.1), 1.0 + r(k, scale=0.1), r(k, scale=0.1))
    mask = None if lengths is None else torch.arange(t, device=card)[None, :] < torch.tensor(lengths, device=card)[:, None]
    return (x, *ws, *vecs, w2, r(c, scale=0.1)), mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,k,lengths", [
    (2, 300, 256, 128, None),
    (3, 130, 200, 40, (130, 64, 1)),      # C not a multiple of a channel chunk
    (2, 65, 128, 256, (65, 0)),           # one frame past a tile; a row without valid frames
    (2, 511, 384, 64, (511, 173)),        # odd T: the tensor-core kernel's 2-byte loads
    (1, 60000, 128, 64, (59000,)),
    (2, 63, 1000, 192, (63, 17)),         # T shorter than a tile
    (1, 1, 128, 128, None),               # T = 1, B = 1
    (2, 998, 1536, 128, (998, 0)),        # the served T and C
])
def test_att_pooling_kernel_matches_plain(card, dtype, b, t, c, k, lengths):
    args, mask = _pool_inputs(card, b, t, c, k, dtype, lengths)
    before = fused_attentive_stats_pool.launches
    out = fused_attentive_stats_pool(*args, mask=mask)
    ref = fused_attentive_stats_pool_plain(*args, mask=mask)
    torch.cuda.synchronize()
    assert fused_attentive_stats_pool.launches == before + 1
    assert fused_attentive_stats_pool.last_route == ("tensor_core" if dtype == torch.bfloat16 else "cuda_core")
    assert out.shape == (b, 2 * c) and out.dtype == torch.float32
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_att_pooling_kernel_takes_transposed_view(card, dtype):
    """The model hands over a [B, T, C] view of [B, C, T] memory; the
    kernel reads it as it lies and gives what it gives on contiguous x."""
    args, mask = _pool_inputs(card, 2, 100, 128, 128, dtype, (100, 50))
    x_ct = args[0].transpose(1, 2).contiguous()
    out = fused_attentive_stats_pool(x_ct.transpose(1, 2), *args[1:], mask=mask)
    ref = fused_attentive_stats_pool(*args, mask=mask)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("dtype,logit_scale,tol", [(torch.float32, 300.0, 1e-3), (torch.bfloat16, 100.0, 2e-2)])
@pytest.mark.parametrize("k", [64, 128])
def test_att_pooling_kernel_mask_holes_and_large_logits(card, dtype, logit_scale, tol, k):
    """A mask with holes (frame 0 masked, one row empty) and logits of
    several hundred, on x as the model lays it out; the running max keeps
    the softmax exact where the TPU kernel's clamp at 80 would not."""
    b, t, c = 3, 300, 384
    args, _ = _pool_inputs(card, b, t, c, k, dtype, None, seed=5, logit_scale=logit_scale)
    g = torch.Generator(device=card).manual_seed(6)
    mask = torch.rand((b, t), generator=g, device=card) > 0.5
    mask[:, 0] = False
    mask[-1] = False
    x = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    out = fused_attentive_stats_pool(x, *args[1:], mask=mask)
    ref = fused_attentive_stats_pool_plain(x, *args[1:], mask=mask)
    h = torch.tanh(torch.relu(x.float() @ args[1].float() + args[4]))
    assert float((h @ args[7].float()).abs().max()) > 80
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    floor = torch.cat([torch.zeros(c, device=card), torch.full((c,), 1e-5, device=card).sqrt()])
    torch.testing.assert_close(out[-1], floor, atol=1e-7, rtol=0)


def test_att_pooling_kernel_raises_on_mixed_types(card):
    args, _ = _pool_inputs(card, 1, 10, 128, 64, torch.float32, None)
    with pytest.raises(ValueError):
        fused_attentive_stats_pool(args[0].bfloat16(), *args[1:])


def _chain_inputs(card, b, t, h, dtype, seed=0, n=7):
    g = torch.Generator(device=card).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device=card) * scale
    x = r(b, t, (n + 1) * h).to(dtype)
    w = r(n, 3, h, h, scale=(3 * h) ** -0.5).to(dtype)
    return x, w, r(n, h, scale=0.1), 1.0 + r(n, h, scale=0.1), r(n, h, scale=0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,dilation,n", [
    (3, 197, 16, 4, 7),     # ragged: two tiles, h below a warp
    (2, 200, 128, 2, 7),    # the ECAPA width
    (2, 64, 128, 4, 7),
    (1, 1500, 64, 3, 7),    # T above the TPU kernel's limit: 11 tiles
    (2, 5, 32, 4, 7),       # T shorter than the dilation's reach
    (2, 300, 40, 1, 3),     # another scale, h not a multiple of 32
    (2, 170, 8, 12, 7),     # a wide halo: tiles of 48 frames
    (1, 120, 128, 14, 7),   # the widest halo the tile plan takes: the most shared memory
    (1, 998, 128, 1, 7),    # the served T, dilation 1, B = 1
    (2, 998, 128, 3, 7),    # the served shape's rows
    (2, 333, 128, 8, 7),    # odd T: 2-byte copies of the parts and outputs
    (2, 100, 32, 2, 7),     # T shorter than one tile
    (2, 199, 64, 5, 7),
])
def test_res2_chain_kernel_matches_plain(card, dtype, b, t, h, dilation, n):
    args = _chain_inputs(card, b, t, h, dtype, n=n)
    before = fused_res2_chain.launches
    out = fused_res2_chain(*args, dilation=dilation)
    ref = fused_res2_chain_plain(*args, dilation=dilation)
    torch.cuda.synchronize()
    assert fused_res2_chain.launches == before + 1
    on_tensor_cores = dtype == torch.bfloat16 and h in (16, 32, 64, 128)
    assert fused_res2_chain.last_route == ("tensor_core" if on_tensor_cores else "cuda_core")
    assert out.shape == ref.shape and out.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert float((out.float() - ref.float()).abs().mean()) < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_res2_chain_kernel_row_padding_isolated(card, dtype):
    """Frames past T read as zero at every stage: 16 more frames appended
    leave the head unchanged (tests/test_pallas_res2.py:54-67)."""
    args = _chain_inputs(card, 1, 197, 128, dtype, seed=1)
    more = torch.randn((1, 16, 1024), generator=torch.Generator(device=card).manual_seed(2), device=card).to(dtype)
    full = fused_res2_chain(*args, dilation=4)
    full2 = fused_res2_chain(torch.cat([args[0], more], dim=1), *args[1:], dilation=4)
    assert fused_res2_chain.last_route == ("tensor_core" if dtype == torch.bfloat16 else "cuda_core")
    torch.testing.assert_close(full[:, :150].float(), full2[:, :150].float(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_res2_chain_kernel_takes_the_models_layout(card, dtype):
    """The model hands over a [B, T, C] view of [B, C, T] memory and gets
    the same layout back."""
    args = _chain_inputs(card, 2, 100, 32, dtype)
    x_ct = args[0].transpose(1, 2).contiguous()
    out = fused_res2_chain(x_ct.transpose(1, 2), *args[1:], dilation=2)
    ref = fused_res2_chain(*args, dilation=2)
    assert out.stride() == x_ct.transpose(1, 2).stride()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.06)])
def test_res2net_block_fused_matches_unfused(card, dtype, tol):
    block = init_weights_(Res2NetBlock(256, dilation=3), 0)
    g = torch.Generator().manual_seed(1)
    for blk in block.blocks:
        blk.act_bn.bn.mean.copy_(torch.randn(32, generator=g) * 0.1)
        blk.act_bn.bn.var.copy_(torch.rand(32, generator=g) * 1.5 + 0.5)
        blk.affine.conv.bias.data.copy_(torch.randn(32, generator=g) * 0.1)
    block = block.to(device=card, dtype=dtype).eval()
    torch.backends.cudnn.allow_tf32 = False
    x = torch.randn((2, 256, 300), generator=torch.Generator(device=card).manual_seed(3), device=card).to(dtype)
    with torch.inference_mode():
        off = block(x)
        block.fused_inference = True
        on = block(x)
    assert on.shape == off.shape and float((on.float() - off.float()).abs().max()) <= tol


def test_res2_chain_kernel_raises_on_what_it_does_not_take(card):
    args = _chain_inputs(card, 1, 50, 16, torch.float32)
    with pytest.raises(ValueError):
        fused_res2_chain(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError):
        fused_res2_chain(*args, dilation=15)
    with pytest.raises(ValueError):
        fused_res2_chain(*_chain_inputs(card, 1, 20, 160, torch.float32))
    with pytest.raises(ValueError):
        fused_res2_chain(args[0].double(), args[1].double(), *args[2:])


def _lengths_mask(card, b, t, lengths):
    if lengths is None:
        return None
    return torch.arange(t, device=card)[None, :] < torch.tensor(lengths, device=card)[:, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,lengths", [
    (3, 700, 200, (700, 350, 100)),
    (3, 65, 30, (65, 32, 9)),          # D not a multiple of the vector: scalar loads
    (2, 300, 64, None),
    (16, 125, 2560, tuple(range(18, 126, 7))),
    (4, 1000, 1536, (1000, 900, 143, 1)),   # T split across blocks
    (2, 64, 8, (64, 0)),               # a row without valid frames
    (1, 5000, 8, (4321,)),
    (2, 1, 16, (1, 0)),                # T = 1
    (3, 1, 30, None),
])
def test_stats_pooling_kernel_matches_plain(card, dtype, b, t, d, lengths):
    g = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn((b, t, d), generator=g, device=card) + 0.5).to(dtype)
    mask = _lengths_mask(card, b, t, lengths)
    before = fused_stats_pooling.launches
    out = fused_stats_pooling(x, mask)
    ref = fused_stats_pooling_plain(x, mask)
    torch.cuda.synchronize()
    assert fused_stats_pooling.launches == before + 1
    assert fused_stats_pooling.last_route == ("ring" if d % (16 // x.element_size()) == 0 else "direct")
    assert out.shape == (b, 2 * d) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d", [(4, 125, 256), (3, 700, 200), (2, 300, 30), (2, 2000, 64)])
def test_stats_pooling_kernel_takes_a_mask_with_holes(card, dtype, b, t, d):
    """Not a prefix; frame 0 is masked and, like every masked frame, holds
    inf. Both kernels where the input is aligned for the ring."""
    from asv_subtools_tpu_torch.nn.fused_stats_pooling import _launch_kernel

    g = torch.Generator(device=card).manual_seed(3)
    mask = torch.rand((b, t), generator=g, device=card) > 0.4
    mask[:, 0] = False
    mask[-1, : t // 2] = False  # the first spans of the last row are empty
    x = (torch.randn((b, t, d), generator=g, device=card) + 2.0).to(dtype)
    x = torch.where(mask[..., None], x, float("inf"))
    ref = fused_stats_pooling_plain(x, mask)
    out = fused_stats_pooling(x, mask)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    if fused_stats_pooling.last_route == "ring":
        torch.testing.assert_close(_launch_kernel(x, mask, 1e-10, route="direct"), ref, atol=1e-5, rtol=1e-4)
        assert fused_stats_pooling.last_route == "direct"


def test_stats_pooling_kernel_takes_other_mask_types(card):
    g = torch.Generator(device=card).manual_seed(4)
    x = torch.randn((3, 90, 64), generator=g, device=card)
    mask = torch.rand((3, 90), generator=g, device=card) > 0.3
    ref = fused_stats_pooling(x, mask)
    for other in (mask.float() * 0.5, mask.to(torch.int64) * 3, mask.to(torch.uint8), mask.cpu()):
        torch.testing.assert_close(fused_stats_pooling(x, other), ref, atol=0, rtol=0)


def test_stats_pooling_kernel_matches_two_pass_at_a_shifted_mean(card):
    x = torch.randn((4, 1000, 256), generator=torch.Generator(device=card).manual_seed(1), device=card) + 10.0
    mask = _lengths_mask(card, 4, 1000, (1000, 600, 300, 40))
    ref = StatisticsPooling()(x.double(), mask).float()
    torch.testing.assert_close(fused_stats_pooling(x, mask), ref, atol=1e-5, rtol=0)


def test_stats_pooling_kernel_takes_strided_views(card):
    """A [B, T, F*C] view of channels-last maps (16-byte loads), and a
    view whose strides force scalar loads, against a packed copy."""
    g = torch.Generator(device=card).manual_seed(2)
    maps = torch.randn((3, 32, 40, 5), generator=g, device=card).contiguous(memory_format=torch.channels_last)
    x = maps.permute(0, 2, 3, 1).reshape(3, 40, 160)
    assert x.data_ptr() == maps.data_ptr()
    torch.testing.assert_close(fused_stats_pooling(x), fused_stats_pooling(x.clone()), atol=0, rtol=0)
    wide = torch.randn((2, 50, 70), generator=g, device=card)
    view = wide[:, :, 3:67]
    torch.testing.assert_close(fused_stats_pooling(view), fused_stats_pooling_plain(view.contiguous()),
                               atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(fused_stats_pooling(wide.transpose(1, 2)),
                               fused_stats_pooling_plain(wide.transpose(1, 2).contiguous()), atol=1e-5, rtol=1e-4)


def test_stats_pooling_kernel_raises_on_other_types(card):
    with pytest.raises(ValueError):
        fused_stats_pooling(torch.zeros((1, 4, 8), dtype=torch.float16, device=card))


# f32 on either device against the f64 step, leaf by leaf, and f64 on the
# card against the CPU: the bounds of chip_smoke.py (see there and PERF.md)
F32_LEAF_TOL, F32_STATS_TOL, F64_LEAF_TOL = 0.12, 2e-5, 1e-8
# The f32 wave step's grad_norm, card against CPU. The narrow ResNet's read
# up to 1.043e-4 over 24 seeds on an H100 (python3 -m
# asv_subtools_tpu_torch.train.step_check resnet 24; PERF.md section 6): the
# CPU's f32 step sits up to 8.2e-5 from the f64 step, the card's 1.5e-5 on
# the same features, and K1's f32 features move the card's by up to 4.5e-5
# more. Its bound is twice the sweep's largest, as F32_LEAF_TOL is.
FAMILY_F32_GRAD_NORM_TOL = {"resnet": 2e-4, "conformer": 1e-4}


def _bf16_wave_step(card, mode):
    """A bf16 wave-input step of ECAPA C256 at B=8 with adamW: no mask,
    a sample mask of 1.0-2.0 s, or accum_grad 2 on that masked batch with
    the cyclic schedule and SpecAugment."""
    from asv_subtools_tpu_torch.train import TrainStepConfig, cyclic, get_optimizer, init_train_state, make_train_step
    from asv_subtools_tpu_torch.train.step_check import OPTS, ecapa_net, modulated_waves

    wave, y = modulated_waves(8, 1)
    batch = {"x": wave.to(card), "y": y.to(card)}
    schedule = None
    if mode != "unmasked":
        lengths = torch.linspace(16000, 32000, 8, device=card).long()
        batch["mask"] = torch.arange(32000, device=card)[None, :] < lengths[:, None]
        batch["x"] = batch["x"] * batch["mask"]
    if mode == "accum_grad 2":
        schedule = cyclic(base_lr=1e-8, max_lr=1e-3, step_size_up=15000, mode="triangular2")
    config = TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True, fbank_opts=OPTS,
                             accum_grad=2 if mode == "accum_grad 2" else 1, spec_aug=mode == "accum_grad 2")
    net = ecapa_net()
    tx = get_optimizer("adamW", schedule or 1e-3, weight_decay=5e-5)
    return init_train_state(net, tx, card), make_train_step(net, tx, schedule, config), batch


def test_train_step_bf16_launches_the_fbank_kernel_once(card):
    state, step, batch = _bf16_wave_step(card, "unmasked")
    before = fused_fbank.launches
    new, m = step(state, batch, torch.Generator(device=card).manual_seed(0))
    torch.cuda.synchronize()
    assert fused_fbank.launches == before + 1 and fused_fbank.last_route == "tensor_core"
    assert bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0
    assert all(p.dtype == torch.float32 and p.is_cuda for p in new.params.values())


@pytest.mark.parametrize("mode", ["unmasked", "masked", "accum_grad 2"])
def test_train_step_never_waits_on_the_card(card, mode):
    """A step after the first (which builds the fbank kernel's constants)
    under torch.cuda.set_sync_debug_mode("error"): a blocking copy, a read
    of a device value on the host or a synchronize in the step raises."""
    state, step, batch = _bf16_wave_step(card, mode)
    gen = torch.Generator(device=card).manual_seed(0)
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batch, gen, lambda_m=0.5, margin_offset=-0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0


def test_train_step_on_the_card_matches_the_cpu(card):
    """The float64 step on the same features: every leaf's update to 1e-8
    of its norm, loss, grad_norm, accuracy and every BN running statistic
    to 1e-10, with the AAM margin softmax, float64 throughout
    (the sub-centre head computes in float32 whatever its input, as the
    JAX one does)."""
    from asv_subtools_tpu_torch.train.step_check import (AAM, modulated_waves, plain_features, sgd_step,
                                                         worst_leaf, zero_grad_share)

    wave, y = modulated_waves(8, 1)
    cd, cpu = (sgd_step(d, torch.float64, plain_features(wave), y, AAM) for d in (card, torch.device("cpu")))
    for key in ("loss", "grad_norm", "accuracy"):
        assert abs(cd.metrics[key] - cpu.metrics[key]) <= 1e-10 * max(abs(cpu.metrics[key]), 1e-30), key
    assert worst_leaf(cd.updates, cpu.updates)[0] <= F64_LEAF_TOL
    assert zero_grad_share(cd.updates, cpu.updates) <= 1e-12
    for k in cpu.batch_stats:
        torch.testing.assert_close(cd.batch_stats[k], cpu.batch_stats[k], rtol=1e-10, atol=1e-12)


def test_train_step_f32_with_the_fbank_kernel_matches_the_cpu(card):
    """The float32 wave-input step, K1 in its f32 mode on the card and the
    plain front end on the CPU, TF32 off: loss and grad_norm to 1e-4 of
    each other, and on each device every leaf's update and every BN
    running statistic against the float64 step on the plain front end's
    features (F32_LEAF_TOL, F32_STATS_TOL)."""
    from asv_subtools_tpu_torch.train.step_check import (modulated_waves, plain_features, rel, sgd_step,
                                                         worst_leaf, zero_grad_share)

    torch.backends.cudnn.allow_tf32 = False
    wave, y = modulated_waves(8, 1)
    ref = sgd_step("cpu", torch.float64, plain_features(wave), y)
    before = fused_fbank.launches
    cd = sgd_step(card, torch.float32, wave, y, wave_input=True)
    assert fused_fbank.launches == before + 1 and fused_fbank.last_route == "cuda_core"
    cpu = sgd_step("cpu", torch.float32, wave, y, wave_input=True)
    for key in ("loss", "grad_norm"):
        assert rel(cd.metrics[key], cpu.metrics[key]) <= 1e-4, key
    for r in (cd, cpu):
        assert worst_leaf(r.updates, ref.updates)[0] <= F32_LEAF_TOL
        assert worst_leaf(r.batch_stats, ref.batch_stats)[0] <= F32_STATS_TOL
    assert zero_grad_share(cd.updates, cpu.updates) <= 1e-6


@pytest.mark.parametrize("dft_dtype", [torch.float32, torch.bfloat16])
def test_fbank_kernel_at_the_training_shape(card, dft_dtype):
    """K1 at the train step's [B, 2 s] shape (198 frames a row), 80 bins."""
    opts = FbankOptions(mel_opts=MelOptions(num_bins=80))
    wave = torch.randn((16, 32000), generator=torch.Generator(device=card).manual_seed(2), device=card) * 1000
    k, _ = fused_fbank(wave, opts, dft_dtype=dft_dtype, with_energy=False)
    p, _ = fused_fbank_plain(wave, opts, dft_dtype=dft_dtype, with_energy=False)
    assert k.shape == (16, 198, 80)
    torch.testing.assert_close(k, p, atol=1e-3, rtol=0)


def _family_wave_step(card, family, mode):
    """A bf16 wave-input step of the narrow ResNet or Conformer at B=8 with
    adamW (the Conformer at dropout 0.1 with the model warm-up): no mask, a
    sample mask of 1.0-2.0 s, or accum_grad 2 on that masked batch."""
    from asv_subtools_tpu_torch.train import TrainStepConfig, get_optimizer, init_train_state, make_train_step
    from asv_subtools_tpu_torch.train.step_check import (NARROW_CONFORMER, NARROW_RESNET, OPTS, conformer_net,
                                                         modulated_waves, resnet_net)

    wave, y = modulated_waves(8, 2)
    batch = {"x": wave.to(card), "y": y.to(card)}
    if mode != "unmasked":
        lengths = torch.linspace(16000, 32000, 8, device=card).long()
        batch["mask"] = torch.arange(32000, device=card)[None, :] < lengths[:, None]
        batch["x"] = batch["x"] * batch["mask"]
    if family == "resnet":
        net = resnet_net(**NARROW_RESNET)
    else:
        net = conformer_net(**{**NARROW_CONFORMER, "dropout_rate": 0.1})
    config = TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True, fbank_opts=OPTS,
                             accum_grad=2 if mode == "accum_grad 2" else 1,
                             model_warmup_steps=1000 if family == "conformer" else 0)
    tx = get_optimizer("adamW", 1e-3)
    return init_train_state(net, tx, card), make_train_step(net, tx, config=config), batch


@pytest.mark.parametrize("mode", ["unmasked", "masked", "accum_grad 2"])
@pytest.mark.parametrize("family", ["resnet", "conformer"])
def test_family_train_step_never_waits_on_the_card(card, family, mode):
    """The ResNet and Conformer steps, after a first one, under
    torch.cuda.set_sync_debug_mode("error"); K1 launches once a microbatch."""
    state, step, batch = _family_wave_step(card, family, mode)
    gen = torch.Generator(device=card).manual_seed(0)
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    before = fused_fbank.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fused_fbank.launches == before + (2 if mode == "accum_grad 2" else 1)
    assert bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0


@pytest.mark.parametrize("family", ["resnet", "conformer"])
def test_family_train_step_on_the_card_matches_the_cpu(card, family):
    """The narrow ResNet and Conformer (dropout 0): the float64 step on the
    same features, card against CPU, each leaf to F64_LEAF_TOL; the float32
    wave step (K1's f32 mode, TF32 off), loss to 1e-4 of the CPU's and
    grad_norm to FAMILY_F32_GRAD_NORM_TOL, and on each device every leaf
    and BN statistic against the f64 step (F32_LEAF_TOL, F32_STATS_TOL),
    the bounds of the ECAPA step. The ResNet stem's running mean, a
    cancellation, is measured against its std (step_check.worst_stat)."""
    from asv_subtools_tpu_torch.train.step_check import (AAM, modulated_waves, narrow_net, plain_features, rel,
                                                         sgd_step, worst_leaf, worst_stat)

    torch.backends.cudnn.allow_tf32 = False
    make = narrow_net(family)
    wave, y = modulated_waves(8, 3)
    feats = plain_features(wave)
    cd, cpu = (sgd_step(d, torch.float64, feats, y, AAM, make_net=make) for d in (card, torch.device("cpu")))
    assert worst_leaf(cd.updates, cpu.updates)[0] <= F64_LEAF_TOL
    for key in ("loss", "grad_norm"):
        assert rel(cd.metrics[key], cpu.metrics[key]) <= 1e-10, key
    ref = sgd_step("cpu", torch.float64, feats, y, AAM, make_net=make)
    cd = sgd_step(card, torch.float32, wave, y, AAM, wave_input=True, make_net=make)
    cpu = sgd_step("cpu", torch.float32, wave, y, AAM, wave_input=True, make_net=make)
    assert rel(cd.metrics["loss"], cpu.metrics["loss"]) <= 1e-4
    assert rel(cd.metrics["grad_norm"], cpu.metrics["grad_norm"]) <= FAMILY_F32_GRAD_NORM_TOL[family]
    for r in (cd, cpu):
        assert worst_leaf(r.updates, ref.updates)[0] <= F32_LEAF_TOL
        if ref.batch_stats:
            assert worst_stat(r.batch_stats, ref.batch_stats)[0] <= F32_STATS_TOL


def test_resnet_fused_pooling_flag_leaves_training_alone(card):
    """A train-mode ResNet with the fused statistics pooling flag on launches
    no K4 and gets the trunk gradients of the unfused model bit for bit."""
    from asv_subtools_tpu_torch.models import ResNetXvector

    x = torch.randn((4, 120, 80), generator=torch.Generator(device=card).manual_seed(4), device=card)
    grads = {}
    for fused in (False, True):
        torch.manual_seed(0)
        model = ResNetXvector(80, layers=(1, 1, 1, 1), base_planes=8, embd_dim=16,
                              pooling_params={"fused_inference": fused}, device=card).train()
        torch.backends.cudnn.deterministic = True
        before = fused_stats_pooling.launches
        model(x).square().sum().backward()
        assert fused_stats_pooling.launches == before
        grads[fused] = {k: p.grad for k, p in model.resnet.named_parameters()}
    torch.backends.cudnn.deterministic = False
    for key, g in grads[False].items():
        assert float(g.abs().max()) > 0 and torch.equal(g, grads[True][key]), key


def test_served_conformer_bf16_against_f32(card):
    """The bench's Conformer (6L-256D-4H conv2d, seeded random weights)
    behind make_wave_embed_fn: bf16 against the f32 model on the f32 plain
    front end, per-utterance cosine >= 0.999, on ragged 1-4 s waves."""
    import copy

    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.features import cmvn_utterance
    from asv_subtools_tpu_torch.train.step_check import OPTS, conformer_net

    model32 = conformer_net(seed=5).backbone.to(card).eval()
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    gen = torch.Generator(device=card).manual_seed(6)
    wave = torch.randn((8, 64000), generator=gen, device=card) * 1000.0
    mask = torch.arange(64000, device=card)[None, :] < torch.linspace(16000, 64000, 8, device=card).long()[:, None]
    with torch.inference_mode():
        emb = make_wave_embed_fn(lambda x, m: model16(x, m), OPTS, dtype=torch.bfloat16)(wave * mask, mask)
        feats, _ = fused_fbank_plain(wave * mask, OPTS, dft_dtype=torch.float32, with_energy=False)
        n = torch.clamp_min((mask.sum(1) - 400) // 160 + 1, 1)
        fmask = torch.arange(feats.shape[1], device=card)[None, :] < n[:, None]
        ref = model32(cmvn_utterance(feats, mask=fmask) * fmask[..., None], fmask)
    assert emb.shape == (8, 256) and bool(torch.isfinite(emb.float()).all())
    cos = torch.nn.functional.cosine_similarity(emb.float(), ref, dim=-1)
    assert float(cos.min()) >= 0.999, cos


def test_launcher_epoch_waits_only_where_it_fetches(card, tmp_path, monkeypatch):
    import math

    from asv_subtools_tpu_torch.launcher import Launcher
    from asv_subtools_tpu_torch.recipes.synthetic import write_corpus
    from asv_subtools_tpu_torch.train import Trainer
    from asv_subtools_tpu_torch.train.step_check import host_waits

    corpus = write_corpus(str(tmp_path / "corpus"), num_spks=4, train_per_spk=8)
    # K1's constants for these options reach the card on their first call
    fused_fbank(torch.randn(2, 16000, device=card), FbankOptions(mel_opts=MelOptions(num_bins=24)),
                dft_dtype=torch.bfloat16)
    epochs, pinned = [], []
    run_epoch, to_device = Trainer.run_epoch, Trainer._to_device

    def counted(self, *args, **kwargs):
        out, waits = host_waits(lambda: run_epoch(self, *args, **kwargs))
        epochs.append((waits, self.epoch_stats["steps"], out[1]))
        return out

    def watched(self, batch):
        pinned.append(all(v.is_pinned() for k, v in batch.items() if k in ("x", "y", "mask")))
        return to_device(self, batch)

    monkeypatch.setattr(Trainer, "run_epoch", counted)
    monkeypatch.setattr(Trainer, "_to_device", watched)
    params = {
        "exp_dir": str(tmp_path / "exp"),
        "data": {"train_wav_scp": f"{corpus}/train/wav.scp", "train_utt2spk": f"{corpus}/train/utt2spk",
                 "chunk_seconds": 1.0, "batch_size": 8, "shuffle_buffer": 16, "compute_feat": False,
                 "spec_aug": True, "speed_perturb": True, "num_bins": 24},
        "model": {"name": "ecapa_tdnn", "params": {"channels": 32, "mfa_conv": 96, "embd_dim": 16}},
        "loss": {"name": "margin_softmax_v1", "params": {"method": "aam", "m": 0.2, "sub_k": 2,
                                                         "adapt_method": "topk", "topk": 5}},
        "train": {"epochs": 1, "optimizer": {"name": "adamW", "learning_rate": 1e-3, "weight_decay": 5e-5},
                  "lr_schedule": {"name": "cyclic", "base_lr": 1e-8, "max_lr": 1e-3, "step_size_up": 4},
                  "margin_warm": {"start_epoch": 1, "end_epoch": 2, "offset_margin": -0.2, "init_lambda": 0.0,
                                  "epoch_iter": 4},
                  "report_interval": 2},
    }
    launcher = Launcher(params)  # the card, asked for by no one
    assert launcher.device.type == "cuda"
    egs = launcher.build_egs()
    launcher.build_model()
    before = fused_fbank.launches
    launcher.train(egs)
    (waits, steps, metrics), = epochs
    assert steps == 4 and fused_fbank.launches - before == steps
    assert len(waits) == 2 + steps // 2, f"{len(waits)} host waits in an epoch of {steps} steps: {waits}"
    assert pinned and all(pinned)
    assert math.isfinite(metrics["loss"]) and metrics["skipped"] == 0
    assert len(launcher.epoch_stats[0]["step_ms"]) == steps


def test_spawn_workers_never_initialise_cuda(card, tmp_path):
    import functools
    import os
    import subprocess
    import sys

    from asv_subtools_tpu_torch.data import MultiprocessLoader, build_spk2int
    from asv_subtools_tpu_torch.features import FbankOptions as Opts
    from asv_subtools_tpu_torch.recipes.synthetic import write_corpus

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_worker_probe import probe_egs

    corpus = write_corpus(str(tmp_path / "corpus"), num_spks=2, train_per_spk=4)
    torch.zeros(1, device=card)  # the parent holds a CUDA context
    u2s = f"{corpus}/train/utt2spk"
    cfg = dict(train_scp=f"{corpus}/train/wav.scp", train_u2s=u2s, spk2int=build_spk2int(u2s), chunk_seconds=0.5,
               batch_size=2, compute_feat=True, feat_opts=Opts(), shuffle_buffer=2, seed=0)
    loader = MultiprocessLoader(functools.partial(probe_egs, cfg), num_workers=2)
    try:
        batches = list(loader)
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout
        on_card = {int(p) for p in smi.split() if p.strip().isdigit()}
        workers = set(loader.worker_pids)
    finally:
        loader.close()
    assert len(workers) == 2 and not workers & on_card
    assert batches and all(b["torch_imported"] and b["cuda_visible_devices"] == "" and not b["cuda_available"]
                           and not b["cuda_initialized"] for b in batches)


@pytest.mark.parametrize("e,t,c,top_n", [(100, 130, 600, 64), (600, 970, 5994, 300)])
def test_asnorm_device_on_the_card_matches_f64(card, e, t, c, top_n):
    import numpy as np

    from asv_subtools_tpu_torch.backend import asnorm, asnorm_device, cosine_score_matrix

    rng = np.random.default_rng(0)
    centroids = rng.normal(size=(400, 256)).astype(np.float32)

    def draw(n):
        return torch.as_tensor(centroids[rng.integers(0, 400, n)] + 0.5 * rng.normal(size=(n, 256)),
                               dtype=torch.float32, device=card)

    enroll, test, cohort = draw(e), draw(t), draw(c)
    raw, ec, tc = cosine_score_matrix(enroll, test), cosine_score_matrix(enroll, cohort), cosine_score_matrix(test, cohort)
    got = asnorm_device(raw, ec, tc, top_n=top_n)
    assert got.device.type == "cuda" and got.dtype == torch.float32 and got.shape == (e, t)
    want = asnorm(raw.cpu().numpy(), ec.cpu().numpy(), tc.cpu().numpy(), top_n=top_n)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-3, atol=2e-4)


def test_llr_matrix_device_on_the_card_matches_f64(card):
    import numpy as np

    from asv_subtools_tpu_torch.backend import PldaStats, estimate_plda
    from asv_subtools_tpu_torch.backend.plda import llr_matrix_device

    rng = np.random.default_rng(1)
    centroids = rng.normal(size=(200, 256))
    vecs = (centroids[:, None, :] + 0.4 * rng.normal(size=(200, 8, 256))).reshape(-1, 256)
    plda = estimate_plda(PldaStats.from_vectors(vecs, np.repeat(np.arange(200), 8)), num_em_iters=5)
    enroll = (centroids[rng.integers(0, 200, 600)] + 0.5 * rng.normal(size=(600, 256))).astype(np.float32)
    test = (centroids[rng.integers(0, 200, 970)] + 0.5 * rng.normal(size=(970, 256))).astype(np.float32)
    counts = rng.integers(1, 4, 600)
    for c in (None, counts):
        got = llr_matrix_device(plda, enroll, test, c)
        assert got.device.type == "cuda" and got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), plda.llr_matrix(enroll, test, c), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1500, 2048])
def test_stats_pooling_kernel_on_the_xvector_layout(card, d, dtype):
    """The x-vector's pooling input: a [B, T, D] view of the TDNN's
    [B, D, T] activations, masked; 1500 bf16 channels are 3,000-byte rows,
    off the ring kernel's 16-byte grain."""
    g = torch.Generator(device=card).manual_seed(7)
    h = (torch.randn((6, d, 998), generator=g, device=card) + 0.5).to(dtype)
    x = h.transpose(1, 2)
    mask = _lengths_mask(card, 6, 998, (998, 900, 500, 333, 120, 40))
    got = fused_stats_pooling(x, mask)
    route = fused_stats_pooling.last_route
    assert route == ("direct" if (d, dtype) == (1500, torch.bfloat16) else "ring")
    torch.testing.assert_close(got, fused_stats_pooling_plain(x.contiguous(), mask), atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got, fused_stats_pooling(x.contiguous(), mask), atol=1e-5, rtol=1e-4)


def test_ftdnn_train_step_on_the_card_matches_the_cpu(card):
    """The narrow F-TDNN with use_semi_orth over step 0 (0 % 4 == 0: the
    factor1 weights take the semi-orthogonal update): the float64 step on
    the same features, card against CPU, each leaf to F64_LEAF_TOL; the
    float32 wave step (K1's f32 mode, TF32 off) against the CPU's and the
    f64 step, with the ECAPA step's bounds."""
    from asv_subtools_tpu_torch.train.step_check import (AAM, modulated_waves, narrow_net, plain_features, rel,
                                                         sgd_step, worst_leaf, worst_stat)

    torch.backends.cudnn.allow_tf32 = False
    make = narrow_net("ftdnn")
    wave, y = modulated_waves(8, 4)
    feats = plain_features(wave)
    cd, cpu = (sgd_step(d, torch.float64, feats, y, AAM, make_net=make, use_semi_orth=True)
               for d in (card, torch.device("cpu")))
    assert worst_leaf(cd.updates, cpu.updates)[0] <= F64_LEAF_TOL
    plain = sgd_step("cpu", torch.float64, feats, y, AAM, make_net=make)
    key = "backbone.layer02.factor1.conv.weight"
    assert not torch.allclose(plain.updates[key], cpu.updates[key])  # the update acted
    ref = cpu
    cd = sgd_step(card, torch.float32, wave, y, AAM, wave_input=True, make_net=make, use_semi_orth=True)
    cpu = sgd_step("cpu", torch.float32, wave, y, AAM, wave_input=True, make_net=make, use_semi_orth=True)
    for k in ("loss", "grad_norm"):
        assert rel(cd.metrics[k], cpu.metrics[k]) <= 1e-4, k
    for r in (cd, cpu):
        assert worst_leaf(r.updates, ref.updates)[0] <= F32_LEAF_TOL
        assert worst_stat(r.batch_stats, ref.batch_stats)[0] <= F32_STATS_TOL


def test_served_xvector_with_the_fused_pooling(card):
    """SnowdarXvector 512/512 (seeded random weights) behind
    make_wave_embed_fn in bf16 with the fused statistics pooling: one K4
    launch (the direct kernel at 1500 bf16 channels), cosine >= 0.999
    against the f32 model on the f32 plain front end, on ragged 1-4 s waves."""
    import copy

    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.features import cmvn_utterance
    from asv_subtools_tpu_torch.train.step_check import OPTS, xvector_net

    model32 = xvector_net(seed=8).backbone.to(card).eval()
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    model16.stats.fused_inference = True
    gen = torch.Generator(device=card).manual_seed(9)
    wave = torch.randn((8, 64000), generator=gen, device=card) * 1000.0
    mask = torch.arange(64000, device=card)[None, :] < torch.linspace(16000, 64000, 8, device=card).long()[:, None]
    with torch.inference_mode():
        before = fused_stats_pooling.launches
        emb = make_wave_embed_fn(lambda x, m: model16(x, m), OPTS, dtype=torch.bfloat16)(wave * mask, mask)
        assert fused_stats_pooling.launches == before + 1 and fused_stats_pooling.last_route == "direct"
        feats, _ = fused_fbank_plain(wave * mask, OPTS, dft_dtype=torch.float32, with_energy=False)
        n = torch.clamp_min((mask.sum(1) - 400) // 160 + 1, 1)
        fmask = torch.arange(feats.shape[1], device=card)[None, :] < n[:, None]
        ref = model32(cmvn_utterance(feats, mask=fmask) * fmask[..., None], fmask)
    assert emb.shape == (8, 512) and bool(torch.isfinite(emb.float()).all())
    cos = torch.nn.functional.cosine_similarity(emb.float(), ref, dim=-1)
    assert float(cos.min()) >= 0.999, cos


def test_stats_pooling_kernel_on_the_repvgg_pooling_input(card):
    """RepVggXvector's pooling input at B=128 x 10 s: [128, 125, 6400] bf16
    (F'=10 x C=640, contiguous after the flatten), masked."""
    g = torch.Generator(device=card).manual_seed(11)
    x = (torch.randn((128, 125, 6400), generator=g, device=card) + 0.5).to(torch.bfloat16)
    lengths = torch.linspace(20, 125, 128, device=card).long()
    mask = torch.arange(125, device=card)[None, :] < lengths[:, None]
    got = fused_stats_pooling(x, mask)
    assert fused_stats_pooling.last_route == "ring" and got.shape == (128, 12800)
    torch.testing.assert_close(got, fused_stats_pooling_plain(x, mask), atol=1e-5, rtol=1e-4)


def _seeded_stats(model, seed):
    """Running statistics away from (0, 1), so that a fold shows them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith(".mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith(".var"):
                b.copy_(torch.rand(b.shape, generator=g) * 1.5 + 0.5)
    return model


def test_deployed_repvgg_matches_the_train_shape_on_the_card(card):
    from asv_subtools_tpu_torch.models import RepVggXvector, deploy_repvgg_xvector

    torch.backends.cudnn.allow_tf32 = False
    model = _seeded_stats(init_weights_(RepVggXvector(80, num_blocks=(1, 2, 2, 1), base_channels=16,
                                                      device="cpu"), 3), 4).to(card)
    deployed = deploy_repvgg_xvector(model)
    assert next(deployed.parameters()).is_cuda
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((8, 300, 80), generator=g, device=card)
    mask = torch.arange(300, device=card)[None, :] < torch.linspace(100, 300, 8, device=card).long()[:, None]
    with torch.inference_mode():
        a, b = model(x, mask), deployed(x, mask)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    assert float(cos.min()) >= 0.99999, cos


@pytest.mark.parametrize("family", ["repvgg", "lawlict", "roadmap_ecapa"])
def test_new_models_bf16_forward_card_against_cpu(card, family):
    import copy

    from asv_subtools_tpu_torch.models import EcapaLawlict, EcapaTdnn, RepVggXvector
    from asv_subtools_tpu_torch.train.step_check import ROADMAP_ECAPA

    make = {"repvgg": lambda: RepVggXvector(80, num_blocks=(1, 2, 2, 1), base_channels=16, device="cpu"),
            "lawlict": lambda: EcapaLawlict(80, channels=128, device="cpu"),
            "roadmap_ecapa": lambda: EcapaTdnn(80, channels=128, mfa_conv=384, **ROADMAP_ECAPA, device="cpu")}[family]
    cpu = _seeded_stats(init_weights_(make(), 6), 7).to(torch.bfloat16)
    on_card = copy.deepcopy(cpu).to(card)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((4, 200, 80), generator=g).to(torch.bfloat16)
    mask = torch.arange(200)[None, :] < torch.tensor([200, 150, 90, 40])[:, None]
    with torch.inference_mode():
        got = on_card(x.to(card), mask.to(card)).float().cpu()
        ref = cpu(x, mask).float()
    assert bool(torch.isfinite(got).all())
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    assert float(cos.min()) >= 0.999, cos


@pytest.mark.parametrize("kind", ["multitask", "fd", "sam"])
def test_offline_step_on_the_card_matches_the_cpu(card, kind):
    from asv_subtools_tpu_torch.train.step_check import (modulated_waves, offline_step, plain_features, rel,
                                                         worst_leaf, worst_stat)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    wave, y = modulated_waves(8, 4)
    feats = plain_features(wave)
    cd, cpu = (offline_step(kind, d, torch.float64, feats, y) for d in (card, torch.device("cpu")))
    assert worst_leaf(cd.updates, cpu.updates)[0] <= F64_LEAF_TOL
    keys = ("loss",) if kind == "fd" else ("loss", "grad_norm")
    for key in keys:
        assert rel(cd.metrics[key], cpu.metrics[key]) <= 1e-10, key
    ref = cpu
    cd, cpu = (offline_step(kind, d, torch.float32, feats, y) for d in (card, torch.device("cpu")))
    for key in keys:
        assert rel(cd.metrics[key], cpu.metrics[key]) <= 1e-4, key
    for r in (cd, cpu):
        assert worst_leaf(r.updates, ref.updates)[0] <= F32_LEAF_TOL
        assert worst_stat(r.batch_stats, ref.batch_stats)[0] <= F32_STATS_TOL


def _offline_bf16(card, kind):
    """(state, step(state, i), batch) of a narrow offline-route net in bf16 on the card."""
    from asv_subtools_tpu_torch.train import init_fd_state, init_train_state, make_fd_train_step, make_train_step, sgd
    from asv_subtools_tpu_torch.train.sam import make_sam_train_step
    from asv_subtools_tpu_torch.train.step_check import (AM, FD_CYCLE, NARROW_OFFLINE, PHONES, fd_net,
                                                         modulated_waves, multitask_net, plain_features, xvector_net)
    from asv_subtools_tpu_torch.train import TrainStepConfig

    wave, y = modulated_waves(8, 5)
    batch = {"x": plain_features(wave).to(card), "y": y.to(card)}
    config = TrainStepConfig(compute_dtype=torch.bfloat16)
    tx = sgd(1e-2, momentum=0.9)
    gen = torch.Generator(device=card).manual_seed(0)
    if kind == "fd":
        net = fd_net(**NARROW_OFFLINE)
        batch["aux_y"] = y.to(card) % 9
        fd_step = make_fd_train_step(net, tx, tx, config=config, **FD_CYCLE)
        return init_fd_state(net, tx, tx, card), lambda state, i: fd_step(state, batch, step_index=i), batch
    if kind == "multitask":
        net = multitask_net(**NARROW_OFFLINE)
        batch["y"] = {"spk": batch["y"], "phone": torch.randint(0, PHONES, batch["x"].shape[:2], device=card)}
        step = make_train_step(net, tx, config=config)
    else:
        net = xvector_net("snowdar", AM, **NARROW_OFFLINE)
        step = make_sam_train_step(net, tx, config=config)
    return init_train_state(net, tx, card), lambda state, i: step(state, batch, gen), batch


@pytest.mark.parametrize("kind", ["multitask", "fd", "sam"])
def test_offline_steps_never_wait_on_the_card(card, kind):
    """bf16 steps after a first one under set_sync_debug_mode("error"); for
    FD an adversary step and a main step."""
    state, step, _ = _offline_bf16(card, kind)
    state, _ = step(state, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in (1, 2):
            state, m = step(state, i)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0


def test_fd_partition_on_the_card(card):
    """One cycle (4 steps, 2 adversary): an adversary step moves the two
    DAL projections and nothing else; a main step moves every other leaf
    and neither projection."""
    from asv_subtools_tpu_torch.train.fd import is_adversary

    state, step, _ = _offline_bf16(card, "fd")
    dal = {k for k in state.params if is_adversary(k)}
    assert dal == {"dal.w_noise.weight", "dal.w_id.weight"}
    for i in range(4):
        new, m = step(state, i)
        moved = {k for k in state.params if not torch.equal(new.params[k], state.params[k])}
        assert m["phase_adv"] == float(i < 2)
        assert moved == (dal if i < 2 else set(state.params) - dal), (i, moved ^ dal)
        state = new


def test_find_lr_on_wave_input_launches_k1_once_a_step(card, tmp_path):
    from asv_subtools_tpu_torch.launcher import Launcher
    from asv_subtools_tpu_torch.recipes.synthetic import write_corpus
    from asv_subtools_tpu_torch.train.step_check import host_waits

    corpus = write_corpus(str(tmp_path / "corpus"), num_spks=4, train_per_spk=8)
    opts = FbankOptions(mel_opts=MelOptions(num_bins=24))
    fused_fbank(torch.randn(2, 16000, device=card), opts, dft_dtype=torch.bfloat16)  # K1's constants
    params = {
        "exp_dir": str(tmp_path / "exp"),
        "data": {"train_wav_scp": f"{corpus}/train/wav.scp", "train_utt2spk": f"{corpus}/train/utt2spk",
                 "chunk_seconds": 1.0, "batch_size": 4, "shuffle_buffer": 8, "compute_feat": False, "num_bins": 24},
        "model": {"name": "ecapa_tdnn", "params": {"channels": 32, "mfa_conv": 96, "embd_dim": 16}},
        "loss": {"name": "margin_softmax", "params": {"method": "aam", "m": 0.2}},
        "train": {"optimizer": {"name": "adamW", "weight_decay": 5e-5}},
    }
    launcher = Launcher(params)
    egs = launcher.build_egs()
    launcher.build_model()
    batches = list(egs)[:6]
    before = fused_fbank.launches
    out, waits = host_waits(lambda: launcher.find_lr(batches, start_lr=1e-6, end_lr=1e-1, num_steps=6))
    assert len(out["lrs"]) == 6 and fused_fbank.launches - before == 6
    assert len(waits) == 6, waits
    assert out["suggested_lr"] is not None and all(map(lambda v: v == v, out["losses"]))


# -- the step options, the reference's own optimizers and the ReConformer ---------

def _fixed_mixup(monkeypatch):
    """mixup's draw pinned to lam 0.3 and a fixed permutation on whatever
    device asks: the card's and the CPU's generators draw other values."""
    from asv_subtools_tpu_torch.nn import tdnn

    def draw(batch, alpha, generator, device, dtype):
        return (torch.tensor(0.3, dtype=dtype, device=device),
                torch.roll(torch.arange(batch, device=device), 3))

    monkeypatch.setattr(tdnn, "mixup_draw", draw)


@pytest.mark.parametrize("option", [dict(mixup_alpha=1.0), dict(remat="full"), dict(remat="dots"),
                                    dict(remat="dots_batch"), dict(mixup_alpha=1.0, remat="dots")], ids=str)
def test_step_options_on_the_card_match_the_cpu(card, monkeypatch, option):
    """The float64 step of the narrow ECAPA on the same features with mixup
    (a pinned draw) or remat: card against CPU, each leaf's update to
    F64_LEAF_TOL, loss and grad_norm to 1e-10."""
    from asv_subtools_tpu_torch.train.step_check import (AAM, modulated_waves, plain_features, rel, sgd_step,
                                                         worst_leaf)

    _fixed_mixup(monkeypatch)
    wave, y = modulated_waves(8, 4)
    feats = plain_features(wave)
    cd, cpu = (sgd_step(d, torch.float64, feats, y, AAM, **option) for d in (card, torch.device("cpu")))
    plain = sgd_step("cpu", torch.float64, feats, y, AAM)
    assert worst_leaf(cd.updates, cpu.updates)[0] <= F64_LEAF_TOL
    for key in ("loss", "grad_norm"):
        assert rel(cd.metrics[key], cpu.metrics[key]) <= 1e-10, key
    if "mixup_alpha" in option:  # the mix moved the step
        assert rel(cpu.metrics["loss"], plain.metrics["loss"]) > 1e-3


@pytest.mark.parametrize("policy", ["full", "dots", "dots_batch"])
def test_remat_replays_dropout_on_the_card(card, policy):
    """A narrow Conformer with dropout 0.1 and train-mode BatchNorm in its
    conv modules, float64 on the card: the remat step against the plain
    one from the same generator seed, every leaf to 1e-10 of its norm and
    the BN statistics to 1e-12 (the recompute draws the forward's masks)."""
    from asv_subtools_tpu_torch.train.step_check import (AAM, NARROW_CONFORMER, conformer_net, modulated_waves,
                                                         plain_features, sgd_step, worst_leaf)

    make = lambda head=AAM, seed=0: conformer_net(head, seed, **{**NARROW_CONFORMER, "dropout_rate": 0.1},
                                                  encoder_params={"cnn_norm_type": "batch_norm"})
    wave, y = modulated_waves(8, 5)
    feats = plain_features(wave)
    ref = sgd_step(card, torch.float64, feats, y, AAM, make_net=make)
    got = sgd_step(card, torch.float64, feats, y, AAM, make_net=make, remat=policy)
    assert worst_leaf(got.updates, ref.updates)[0] <= 1e-10
    assert ref.batch_stats and all(torch.allclose(got.batch_stats[k], v, rtol=1e-12, atol=1e-14)
                                   for k, v in ref.batch_stats.items())


NEVER_WAITS = {"mixup": ("adamW", {}, dict(mixup_alpha=1.0)), "remat dots": ("adamW", {}, dict(remat="dots")),
               "remat full": ("adamW", {}, dict(remat="full")), "ralamb": ("ralamb", {}, {}),
               "adamod": ("adamod", {}, {}), "novograd": ("novograd", {}, {}), "eve": ("eve", {}, {}),
               "gc": ("adamW", {"gc": True}, {}), "lookahead": ("sgd", {"lookahead": True, "lookahead_k": 2}, {})}


@pytest.mark.parametrize("case", list(NEVER_WAITS))
def test_step_options_and_optimizers_never_wait_on_the_card(card, case):
    """bf16 wave-input steps of ECAPA C256 at B=8 with each new option or
    optimizer, after a first step, under set_sync_debug_mode("error"):
    K1 once a step, losses finite (lookahead's sync step among them)."""
    from asv_subtools_tpu_torch.train import TrainStepConfig, get_optimizer, init_train_state, make_train_step
    from asv_subtools_tpu_torch.train.step_check import OPTS, ecapa_net, modulated_waves

    name, opt, options = NEVER_WAITS[case]
    wave, y = modulated_waves(8, 6)
    batch = {"x": wave.to(card), "y": y.to(card)}
    net = ecapa_net()
    tx = get_optimizer(name, 1e-3, **opt)
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True,
                                                           fbank_opts=OPTS, **options))
    gen = torch.Generator(device=card).manual_seed(0)
    state, _ = step(init_train_state(net, tx, card), batch, gen)
    torch.cuda.synchronize()
    before = fused_fbank.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m1 = step(state, batch, gen)
        state, m2 = step(state, batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fused_fbank.launches == before + 2
    assert all(bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0 for m in (m1, m2))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_balancer_backward_on_the_card_matches_the_cpu(card, dtype):
    """The balancer's backward on [B, C, T, F] maps with channels that
    engage each branch: card against CPU, to 1e-12 (f64), 1e-6 (f32) or
    one bf16 rounding (2e-2) of the gradient's scale."""
    from asv_subtools_tpu_torch.nn.conformer.scaling import activation_balancer

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(4, 10, 30, 9, generator=gen, dtype=torch.float64)
    x = x * torch.tensor([1.0, 1.0, 1e-2, 300.0, 1.0] * 2, dtype=torch.float64).view(1, 10, 1, 1) \
        + torch.tensor([-3.0, 3.0, 0.0, 0.0, 0.0] * 2, dtype=torch.float64).view(1, 10, 1, 1)
    g = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    grads = {}
    for d in (card, torch.device("cpu")):
        xd = x.to(d, dtype).requires_grad_()
        (grads[d.type],) = torch.autograd.grad(activation_balancer(xd, 1), xd, g.to(d, dtype))
    tol = {torch.float64: 1e-12, torch.float32: 1e-6, torch.bfloat16: 2e-2}[dtype]
    a, b = grads["cuda"].double().cpu(), grads["cpu"].double()
    assert not torch.allclose(b, g.to(dtype).double())
    assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_reconformer_step_on_the_card_matches_the_cpu(card):
    """The narrow ReConformer (2 blocks, d = 64, re_conv2d, dropout 0), as
    the Conformer's family test: the f64 step card against CPU to
    F64_LEAF_TOL; the f32 wave step (K1's f32 mode, TF32 off), loss and
    grad_norm to 1e-4 of the CPU's and every leaf against the f64 step to
    F32_LEAF_TOL. Its balancers' backward runs in every block."""
    from asv_subtools_tpu_torch.train.step_check import (AAM, modulated_waves, narrow_net, plain_features, rel,
                                                         sgd_step, worst_leaf)

    torch.backends.cudnn.allow_tf32 = False
    make = narrow_net("reconformer")
    wave, y = modulated_waves(8, 3)
    feats = plain_features(wave)
    cd, cpu = (sgd_step(d, torch.float64, feats, y, AAM, make_net=make) for d in (card, torch.device("cpu")))
    assert worst_leaf(cd.updates, cpu.updates)[0] <= F64_LEAF_TOL
    for key in ("loss", "grad_norm"):
        assert rel(cd.metrics[key], cpu.metrics[key]) <= 1e-10, key
    cd32 = sgd_step(card, torch.float32, wave, y, AAM, wave_input=True, make_net=make)
    cpu32 = sgd_step("cpu", torch.float32, wave, y, AAM, wave_input=True, make_net=make)
    for key in ("loss", "grad_norm"):
        assert rel(cd32.metrics[key], cpu32.metrics[key]) <= 1e-4, key
    for r in (cd32, cpu32):
        assert worst_leaf(r.updates, cpu.updates)[0] <= F32_LEAF_TOL


def test_served_reconformer_on_the_card_against_the_cpu(card):
    """reconformer.yaml's model (seeded random weights) on ragged 1-4 s
    waves: the f32 model on the card against the f32 model on the CPU on
    the same features at per-utterance cosine 0.99999 (TF32 off); behind
    make_wave_embed_fn (K1, bf16 DFT) the f32 model at 0.9999 and the bf16
    model at 0.999 against the CPU's f32 model on the plain bf16-DFT front
    end (phase 10's bars). The references take the bf16 DFT: this model
    moves by up to 3e-3 of cosine between bf16- and f32-DFT features."""
    import copy

    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.features import wave_features
    from asv_subtools_tpu_torch.train.step_check import OPTS, reconformer_net

    torch.backends.cudnn.allow_tf32 = False
    cpu_model = reconformer_net(seed=8).backbone.eval()
    model32 = copy.deepcopy(cpu_model).to(card)
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(9)
    wave = torch.randn((8, 64000), generator=gen) * 1000.0
    mask = torch.arange(64000)[None, :] < torch.linspace(16000, 64000, 8).long()[:, None]
    wave = wave * mask
    with torch.inference_mode():
        feats, fmask = wave_features(wave, mask, OPTS, torch.bfloat16)
        ref = cpu_model(feats, fmask)
        same = model32(feats.to(card), fmask.to(card))
        e32 = make_wave_embed_fn(lambda x, m: model32(x, m), OPTS, dtype=torch.float32)(wave.to(card), mask.to(card))
        e16 = make_wave_embed_fn(lambda x, m: model16(x, m), OPTS, dtype=torch.bfloat16)(wave.to(card), mask.to(card))
    cos = lambda a: torch.nn.functional.cosine_similarity(a.float().cpu(), ref, dim=-1)
    assert e32.shape == (8, 256) and bool(torch.isfinite(e16.float()).all())
    assert float(cos(same).min()) >= 0.99999, cos(same)
    assert float(cos(e32).min()) >= 0.9999, cos(e32)
    assert float(cos(e16).min()) >= 0.999, cos(e16)


# -- the rest of the Conformer family (phase 24's nets) ----------------------------


@pytest.mark.parametrize("family", ["transformer", "gau_conformer"])
def test_conformer_family_step_on_the_card_matches_the_cpu(card, family):
    """The narrow Transformer x-vector and GAU Conformer (step_check's
    NARROW_TRANSFORMER and NARROW_GAU_CONFORMER, dropout 0), as the
    ReConformer's test: the f64 step card against CPU to F64_LEAF_TOL,
    loss and grad_norm to 1e-10; the f32 wave step (K1's f32 mode, TF32
    off), loss and grad_norm to 1e-4 of the CPU's and every leaf against
    the f64 step to F32_LEAF_TOL."""
    from asv_subtools_tpu_torch.train.step_check import (AAM, modulated_waves, narrow_net, plain_features, rel,
                                                         sgd_step, worst_leaf)

    torch.backends.cudnn.allow_tf32 = False
    make = narrow_net(family)
    wave, y = modulated_waves(8, 3)
    feats = plain_features(wave)
    cd, cpu = (sgd_step(d, torch.float64, feats, y, AAM, make_net=make) for d in (card, torch.device("cpu")))
    assert worst_leaf(cd.updates, cpu.updates)[0] <= F64_LEAF_TOL
    for key in ("loss", "grad_norm"):
        assert rel(cd.metrics[key], cpu.metrics[key]) <= 1e-10, key
    cd32 = sgd_step(card, torch.float32, wave, y, AAM, wave_input=True, make_net=make)
    cpu32 = sgd_step("cpu", torch.float32, wave, y, AAM, wave_input=True, make_net=make)
    for key in ("loss", "grad_norm"):
        assert rel(cd32.metrics[key], cpu32.metrics[key]) <= 1e-4, key
    for r in (cd32, cpu32):
        assert worst_leaf(r.updates, cpu.updates)[0] <= F32_LEAF_TOL


def _drawing_gau_net(head, seed=0):
    """The narrow GAU Conformer with softmax_plus, layer drop 0.5 and the
    dynamic chunk with left chunks."""
    from asv_subtools_tpu_torch.train.step_check import NARROW_GAU_CONFORMER, conformer_net

    enc = {**NARROW_GAU_CONFORMER["encoder_params"], "attention_norm_args": {"norm_method": "softmax_plus"},
           "layer_dropout": 0.5, "use_dynamic_chunk": True, "use_dynamic_left_chunk": True}
    return conformer_net(head, seed, **{**NARROW_GAU_CONFORMER, "encoder_params": enc})


def test_gau_conformer_draws_f64_step_on_the_card_matches_the_cpu(card, monkeypatch):
    """softmax_plus, layer drop and the dynamic chunk in the f64 step, the
    draws pinned on both devices (the card's generator draws other values
    than the CPU's): block 0 kept and block 1 dropped, chunk 4 with one
    left chunk; card against CPU to F64_LEAF_TOL."""
    import itertools

    from asv_subtools_tpu_torch.nn.conformer import encoder as penc
    from asv_subtools_tpu_torch.nn.conformer import mask as pmask
    from asv_subtools_tpu_torch.train.step_check import AAM, modulated_waves, plain_features, sgd_step, worst_leaf

    keeps = itertools.cycle((True, False))
    monkeypatch.setattr(penc, "layer_drop_keep", lambda g, rate, device: torch.tensor(next(keeps), device=device))
    monkeypatch.setattr(pmask, "dynamic_chunk_draw", lambda g, size, use_left=False, device=None: (
        torch.tensor(4, device=device), torch.tensor(1, device=device)))
    wave, y = modulated_waves(8, 4)
    feats = plain_features(wave)
    cd, cpu = (sgd_step(d, torch.float64, feats, y, AAM, make_net=_drawing_gau_net)
               for d in (card, torch.device("cpu")))
    assert worst_leaf(cd.updates, cpu.updates)[0] <= F64_LEAF_TOL
    train_len = [k for k in cpu.updates if k.endswith("train_len")]
    assert train_len and all(float(cpu.updates[k].abs().max()) > 0 for k in train_len)


def test_gau_conformer_bf16_step_with_its_draws_never_waits_on_the_card(card):
    """The narrow GAU Conformer with softmax_plus, layer drop and dynamic
    chunks: a bf16 wave step after a first one under
    torch.cuda.set_sync_debug_mode("error"), the draws on the card's
    generator; K1 once; the loss finite."""
    from asv_subtools_tpu_torch.train import TrainStepConfig, get_optimizer, init_train_state, make_train_step
    from asv_subtools_tpu_torch.train.step_check import AM, OPTS, modulated_waves

    wave, y = modulated_waves(8, 5)
    net = _drawing_gau_net(AM)
    tx = get_optimizer("adamW", 1e-3)
    state = init_train_state(net, tx, card)
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True,
                                                           fbank_opts=OPTS))
    batch, gen = {"x": wave.to(card), "y": y.to(card)}, torch.Generator(device=card).manual_seed(0)
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    before = fused_fbank.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, m = step(state, batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fused_fbank.launches == before + 3
    assert bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0


def _option_names():
    from asv_subtools_tpu_torch.train.step_check import OPTION_SWEEP

    return list(OPTION_SWEEP)


@pytest.mark.parametrize("name", _option_names())
def test_conformer_option_forward_card_against_cpu(card, name):
    """chip_smoke's option sweep: one f32 eval forward of the narrow
    Conformer with the option on ragged features, card against CPU at
    1e-5 of the output's scale (TF32 off)."""
    import copy

    from asv_subtools_tpu_torch.train.step_check import sweep_net

    torch.backends.cudnn.allow_tf32 = False
    cpu = sweep_net(name, 1)
    model = copy.deepcopy(cpu).to(card)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 200, 80, generator=g)
    mask = torch.arange(200)[None, :] < torch.tensor([200, 160, 90, 41])[:, None]
    with torch.inference_mode():
        ref = cpu(x, mask)
        got = model(x.to(card), mask.to(card)).cpu()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("module", ["rope", "t5", "gau"])
def test_rope_t5_gau_on_the_card_match_the_cpu(card, module, dtype, tol):
    """RoPE self-attention, the T5 bias (inside a plain attention) and GAU
    on a masked batch, card against CPU in the same type (bf16: both sides
    round q, k, v and the weights to bf16, at 3e-2 of the output's scale);
    the T5 buckets equal on both up to T = 1000."""
    import copy

    from asv_subtools_tpu_torch.nn import conformer as pc

    torch.manual_seed(0)
    t5 = pc.T5RelPositionBias()
    if module == "t5":
        cpu_buckets, card_buckets = t5.buckets(1000, torch.device("cpu")), t5.buckets(1000, card)
        assert torch.equal(card_buckets.cpu(), cpu_buckets)
    att = {"rope": lambda: pc.RoPESelfAttention(64, 4), "t5": lambda: pc.MultiHeadedAttention(64, 4),
           "gau": lambda: pc.GAU(64, 128, 32)}[module]()
    init_weights_(att, 3)
    att, t5 = att.to(dtype).eval(), init_weights_(t5, 4).to(dtype)
    x = torch.randn(3, 120, 64, generator=torch.Generator().manual_seed(5)).to(dtype)
    pad = torch.arange(120)[None, :] < torch.tensor([120, 77, 30])[:, None]
    mask = pad[:, None, None, :] & pad[:, None, :, None]

    def run(mod, bias, dev):
        with torch.inference_mode():
            extra = bias(120, dev) if module != "rope" else None
            return mod(x.to(dev), mask.to(dev), None, extra).float().cpu()

    ref = run(att, t5, torch.device("cpu"))
    got = run(copy.deepcopy(att).to(card), copy.deepcopy(t5).to(card), card)
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("family", ["transformer", "gau_conformer"])
def test_served_conformer_family_on_the_card_against_the_cpu(card, family):
    """Phase 24's (a) and (b) at full width (seeded random weights) on
    ragged 1-4 s waves: the f32 model on the card against the f32 model on
    the CPU on the same features at per-utterance cosine 0.99999 (TF32
    off); behind make_wave_embed_fn (K1, bf16 DFT) the f32 model at 0.9999
    and the bf16 model at 0.999 against the CPU's f32 model on the plain
    bf16-DFT front end (phase 10's bars)."""
    import copy

    from asv_subtools_tpu_torch.extract import make_wave_embed_fn
    from asv_subtools_tpu_torch.features import wave_features
    from asv_subtools_tpu_torch.train.step_check import GAU_CONFORMER, OPTS, TRANSFORMER, conformer_net

    torch.backends.cudnn.allow_tf32 = False
    config = TRANSFORMER if family == "transformer" else GAU_CONFORMER
    cpu_model = conformer_net(seed=8, **config).backbone.eval()
    model32 = copy.deepcopy(cpu_model).to(card)
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(9)
    wave = torch.randn((8, 64000), generator=gen) * 1000.0
    mask = torch.arange(64000)[None, :] < torch.linspace(16000, 64000, 8).long()[:, None]
    wave = wave * mask
    with torch.inference_mode():
        feats, fmask = wave_features(wave, mask, OPTS, torch.bfloat16)
        ref = cpu_model(feats, fmask)
        same = model32(feats.to(card), fmask.to(card))
        e32 = make_wave_embed_fn(lambda x, m: model32(x, m), OPTS, dtype=torch.float32)(wave.to(card), mask.to(card))
        e16 = make_wave_embed_fn(lambda x, m: model16(x, m), OPTS, dtype=torch.bfloat16)(wave.to(card), mask.to(card))
    cos = lambda a: torch.nn.functional.cosine_similarity(a.float().cpu(), ref, dim=-1)
    assert e32.shape == (8, 256) and bool(torch.isfinite(e16.float()).all())
    assert float(cos(same).min()) >= 0.99999, cos(same)
    assert float(cos(e32).min()) >= 0.9999, cos(e32)
    assert float(cos(e16).min()) >= 0.999, cos(e16)


# --- checkpoint conversion and the serving path ---------------------------------------------------------------------

def _narrow_served_ecapa(card, seed=0, **kw):
    """A narrow ECAPA on the card (h = 16: K3's tensor-core width), bf16,
    the fused chains and pooling on, random running statistics."""
    from asv_subtools_tpu_torch.models import EcapaTdnn

    model = init_weights_(EcapaTdnn(input_dim=80, channels=128, mfa_conv=192, embd_dim=32, device="cpu", **kw), seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
            elif name.endswith(".var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    model16 = model.to(card).to(torch.bfloat16)
    for block in (model16.layer2, model16.layer3, model16.layer4):
        block.res2net.fused_inference = True
    model16.stats.fused_inference = True
    return model16


def _kernel_case(card, op):
    """(the wrapper's module, the op's arguments, tolerance) of one call
    of K2, K3 or K4 in bf16."""
    import importlib

    mod = importlib.import_module({"fused_res2_chain": "asv_subtools_tpu_torch.nn.fused_res2",
                                   "fused_attentive_stats_pool": "asv_subtools_tpu_torch.nn.fused_att_pooling",
                                   "fused_stats_pooling": "asv_subtools_tpu_torch.nn.fused_stats_pooling"}[op])
    gen = torch.Generator().manual_seed(3)
    b, t, c, k, h = 3, 197, 256, 128, 32
    x = (torch.randn((b, t, c), generator=gen)).to(card, torch.bfloat16)
    mask = (torch.arange(t)[None, :] < torch.tensor([t, 120, 33])[:, None]).to(card)
    if op == "fused_res2_chain":
        args = (x[..., : 8 * h], *(torch.randn(s, generator=gen).mul(0.2).to(card) for s in ((7, 3, h, h), (7, h),
                                                                                              (7, h), (7, h))))
        return mod, (args[0], args[1].bfloat16(), *args[2:], 2), 2e-2
    if op == "fused_attentive_stats_pool":
        w = [torch.randn(s, generator=gen).mul(0.1).to(card) for s in ((c, k), (c, k), (c, k), (k,), (k,), (k,),
                                                                        (k, c), (c,))]
        for i in (0, 1, 2, 6):
            w[i] = w[i].bfloat16()
        return mod, (x, *w, mask), 2e-2
    return mod, (x, mask, 1e-10), 1e-4


KERNEL_OPS = ["fused_res2_chain", "fused_attentive_stats_pool", "fused_stats_pooling"]


@pytest.mark.parametrize("op", KERNEL_OPS)
def test_kernel_custom_ops_on_the_card_match_their_plain_versions(card, op):
    """The ops' CUDA implementations (the kernels) against their plain
    versions, and the launch counters counting them."""
    mod, args, tol = _kernel_case(card, op)
    counter, plain = getattr(mod, op), getattr(mod, f"{op}_plain")
    before = counter.launches
    got = getattr(mod, f"{op}_op")(*args)
    assert counter.launches == before + 1
    torch.testing.assert_close(got.float(), plain(*args).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("op", KERNEL_OPS)
def test_eager_kernel_calls_launch_without_their_custom_op(card, op, monkeypatch):
    """Outside tracing a wrapper launches its kernel directly: the custom
    op, swapped here for one that raises, is never entered, and the launch
    is counted once."""
    mod, args, tol = _kernel_case(card, op)
    wrapper, plain = getattr(mod, op), getattr(mod, f"{op}_plain")

    def refuse(*a, **kw):
        raise AssertionError(f"an eager {op} entered its custom op")

    monkeypatch.setattr(mod, f"{op}_op", refuse)
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got.float(), plain(*args).float(), atol=tol, rtol=tol)


def test_export_of_the_wrappers_keeps_the_three_ops(card):
    """torch.export of a module that calls the three wrappers (not their
    ops) traces each call into one node of its op, and the program runs
    the kernels."""
    _, res2, _ = _kernel_case(card, "fused_res2_chain")
    _, att, _ = _kernel_case(card, "fused_attentive_stats_pool")
    x, mask = att[0], att[-1]

    class Wrappers(torch.nn.Module):
        def forward(self, x, mask):
            y = fused_res2_chain(x, *res2[1:5], dilation=2)
            return fused_attentive_stats_pool(y, *att[1:9], mask=mask) + fused_stats_pooling(y, mask)

    program = torch.export.export(Wrappers(), (x, mask))
    names = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"asv_subtools_tpu_torch.fused_res2_chain.default",
            "asv_subtools_tpu_torch.fused_attentive_stats_pool.default",
            "asv_subtools_tpu_torch.fused_stats_pooling.default"} <= names
    counts = [f.launches for f in (fused_res2_chain, fused_attentive_stats_pool, fused_stats_pooling)]
    with torch.no_grad():
        got = program.module()(x, mask)
    assert [f.launches for f in (fused_res2_chain, fused_attentive_stats_pool, fused_stats_pooling)] == \
        [n + 1 for n in counts]
    with torch.no_grad():
        torch.testing.assert_close(got, Wrappers()(x, mask), atol=1e-6, rtol=0)


def test_dynamic_int8_dot_on_the_card_equals_the_cpu(card):
    from asv_subtools_tpu_torch.nn.int8 import dynamic_int8_dot, int8_matmul, quantize_rows

    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 50, 96), generator=gen)
    w = torch.randn((64, 96), generator=gen) * 0.1
    xq, _ = quantize_rows(x.reshape(-1, 96), 1e-8)
    wq, _ = quantize_rows(w, 1e-12)
    before = int8_matmul.launches
    on_card = int8_matmul(xq.to(card), wq.to(card))
    assert int8_matmul.launches == before + 1 and on_card.dtype == torch.int32
    assert torch.equal(on_card.cpu(), int8_matmul(xq, wq))
    torch.testing.assert_close(dynamic_int8_dot(x.to(card), w.to(card)).cpu(), dynamic_int8_dot(x, w),
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="m > 16"):
        int8_matmul(xq[:16].to(card), wq.to(card))


def test_int8_ecapa_on_the_card_against_bf16(card):
    from asv_subtools_tpu_torch.nn.int8 import int8_matmul

    model16 = _narrow_served_ecapa(card, seed=5)
    q16 = _narrow_served_ecapa(card, seed=5, int8_inference=True)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((4, 300, 80), generator=gen).to(card)
    mask = (torch.arange(300)[None, :] < torch.tensor([300, 260, 180, 90])[:, None]).to(card)
    before = int8_matmul.launches
    with torch.inference_mode():
        ref, got = model16(x.bfloat16(), mask).float(), q16(x.bfloat16(), mask).float()
    assert int8_matmul.launches == before + 7
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    assert float(cos.min()) >= 0.999, cos


def test_exported_program_on_the_card_launches_k2_and_k3(card, tmp_path):
    from asv_subtools_tpu_torch.export import export_embed_fn, load_embed_fn
    from asv_subtools_tpu_torch.nn import fused_attentive_stats_pool as k2
    from asv_subtools_tpu_torch.nn import fused_res2_chain as k3

    model16 = _narrow_served_ecapa(card, seed=7)
    fn = lambda x, m: model16(x.to(torch.bfloat16), m).float()
    paths = export_embed_fn(fn, 80, str(tmp_path), bucket_lengths=(200,), batch_sizes=(4,))
    program = torch.export.load(paths["b4_t200"])
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"asv_subtools_tpu_torch.fused_res2_chain.default",
            "asv_subtools_tpu_torch.fused_attentive_stats_pool.default"} <= ops
    loaded = load_embed_fn(paths["b4_t200"])
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((4, 200, 80), generator=gen).to(card)
    mask = (torch.arange(200)[None, :] < torch.tensor([200, 170, 120, 60])[:, None]).to(card)
    k2_0, k3_0 = k2.launches, k3.launches
    with torch.inference_mode():
        got = loaded(x, mask)
        assert (k2.launches - k2_0, k3.launches - k3_0) == (1, 3)
        want = fn(x, mask)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert float(cos.min()) >= 0.99999, cos
    with pytest.raises(ValueError, match="cannot run"):
        load_embed_fn(paths["b4_t200"], device="cpu")


def test_server_on_the_card_answers_as_embed(card):
    import numpy as np

    from asv_subtools_tpu_torch.nn import fused_res2_chain as k3
    from asv_subtools_tpu_torch.serving import EmbeddingServer, embed_request

    model16 = _narrow_served_ecapa(card, seed=9)
    server = EmbeddingServer(lambda x, m: model16(x.to(torch.bfloat16), m).float(), buckets=(200, 400))
    server.start()
    try:
        rng = np.random.default_rng(10)
        for frames in (150, 400, 700):  # the last is cut to the last bucket
            feats = rng.standard_normal((frames, 80)).astype(np.float32)
            before = k3.launches
            got = embed_request("127.0.0.1", server.port, feats)
            assert k3.launches == before + 3
            want = server.embed(feats)
            assert got.shape == (32,) and np.all(np.isfinite(got))
            assert float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want))) >= 0.99999
    finally:
        server.stop()


def test_chip_smoke_phase_25_runs(card):
    """chip_smoke's phase 25 (ASV-Subtools ECAPA C1024 and ResNet34
    converted and served, exported back, int8, torch.export, the socket
    server) at full width."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    torch.backends.cudnn.allow_tf32 = False
    counts = chip_smoke.phase_checkpoints_and_serving(torch, "card test")
    assert all(counts[k] > 0 for k in ("fused_fbank", "fused_attentive_stats_pool", "fused_res2_chain",
                                       "fused_stats_pooling"))


def _warped_fbank(F, x, opts, warp, mode):
    """The VTLN-warped log-mel fbank from the front end's pieces, as
    chip_smoke.py's warped_fbank builds it (compute_fbank takes no warp)."""
    from asv_subtools_tpu_torch.features.functional import _frames_and_energy

    fo = opts.frame_opts
    padded, _ = _frames_and_energy(x, fo, False, True, None)
    spec = F.power_spectrum(padded, fo, keep_bins=fo.padded_window_size // 2, fft_mode=mode)
    mel = spec @ torch.as_tensor(F.mel_banks(opts.mel_opts, fo, warp), dtype=spec.dtype, device=spec.device)
    return torch.log(torch.clamp_min(mel, F.EPSILON))


HOST_FEATURES = {  # the host front end's features and (atol, rtol) in f32, as phase_tail of chip_smoke.py runs them
    "mfcc": (lambda F: (lambda x, mode: F.compute_mfcc(x, F.MfccOptions(
        mel_opts=F.MelOptions(num_bins=23, high_freq=-200.0), num_ceps=23), fft_mode=mode)), (2e-4, 2e-4)),
    "plp": (lambda F: (lambda x, mode: F.compute_plp(x, F.PlpOptions(), fft_mode=mode)), (2e-4, 2e-4)),
    "spectrogram": (lambda F: (lambda x, mode: F.compute_spectrogram(x, F.SpectrogramOptions(), fft_mode=mode)),
                    (2e-3, 0.0)),
    "vtln_fbank": (lambda F: (lambda x, mode: _warped_fbank(
        F, x, F.FbankOptions(mel_opts=F.MelOptions(num_bins=80)), 0.9, mode)), (2e-3, 0.0)),
}


@pytest.mark.parametrize("name", sorted(HOST_FEATURES))
@pytest.mark.parametrize("mode", ["gemm", "rfft"])
def test_host_features_on_the_card_match_the_cpu_in_f64(card, name, mode):
    """MFCC, PLP, the spectrogram and the VTLN-warped fbank in f32 on the
    card (TF32 off) against the same function in float64 on the CPU, at
    chip_smoke.py's TAIL_TOL: MFCC and PLP 2e-4, the spectrogram and the
    warped fbank 2e-3 absolute (their lowest DFT bin); the card in float64
    against the CPU in float64 at 1e-8."""
    from asv_subtools_tpu_torch import features as F

    make, (atol, rtol) = HOST_FEATURES[name]
    fn = make(F)
    wave = torch.randn((4, 48000), generator=torch.Generator().manual_seed(3)) * 1000.0
    want = fn(wave.double(), "rfft")
    got = fn(wave.to(card), mode)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu().double(), want, rtol=rtol, atol=atol)
    torch.testing.assert_close(fn(wave.double().to(card), mode).cpu(), want, rtol=1e-8, atol=1e-8)


def test_dropouts_on_the_card_keep_their_rates(card):
    import importlib

    drop = importlib.import_module("asv_subtools_tpu_torch.nn.dropout")
    x = torch.ones((128, 200, 80), device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    keep = drop.ContextDropout(0.2)(x, generator=gen)
    assert keep.device.type == "cuda" and abs(float((keep > 0).float().mean()) - 0.8) < 0.01
    assert float(keep.max()) == pytest.approx(1.25)
    rate, mask = drop.RandomDropout(0.4).draw(x, gen)
    assert 0.0 <= float(rate) <= 0.4 and abs(float(mask.float().mean()) - (1.0 - float(rate))) < 0.01
    noise = drop.NoiseDropout(0.1)(x, generator=gen)
    assert float((noise - 1.0).abs().max()) <= 0.1 and abs(float(noise.mean()) - 1.0) < 1e-3
    spec = drop.SpecAugmentDropout(frequency=0.2, frame=0.2)(x, generator=gen)
    zero_bins = (spec == 0).all(1).sum(-1)
    zero_frames = (spec == 0).all(2).sum(-1)
    assert int(zero_bins.max()) <= 16 and int(zero_frames.max()) <= 40 and int(zero_bins.sum()) > 0
    for layer in (drop.ContextDropout(0.2), drop.RandomDropout(0.4), drop.NoiseDropout(0.1),
                  drop.SpecAugmentDropout()):
        assert layer(x, train=False) is x


def test_nan_batch_dump_on_the_card(card, tmp_path):
    """A Trainer on the card fed finite, NaN, finite batches: with
    nan_debug_dir one dump, whose replay on the card finds the input bad
    and the weights finite; without it the epoch waits on the card only
    where it fetches (the step counter and the epoch's end)."""
    import numpy as np

    from asv_subtools_tpu_torch.models import SpeakerNet, Xvector
    from asv_subtools_tpu_torch.train import Trainer, TrainStepConfig, get_optimizer
    from asv_subtools_tpu_torch.train.debug import replay_nan_batch
    from asv_subtools_tpu_torch.train.step_check import host_waits

    rng = np.random.default_rng(0)
    # pinned, as the Launcher's Prefetcher hands batches over
    good = {"x": torch.from_numpy(rng.standard_normal((8, 40, 16)).astype(np.float32)).pin_memory(),
            "y": torch.from_numpy(rng.integers(0, 4, 8)).pin_memory()}
    bad = dict(good, x=torch.full((8, 40, 16), float("nan")).pin_memory())
    net = lambda: SpeakerNet(Xvector(16, 32, 8, device="cpu"), "softmax", {}, num_targets=4)
    waits = {}
    for where in (None, str(tmp_path / "nan")):
        trainer = Trainer(net(), get_optimizer("sgd", learning_rate=1e-2), report_interval=100,
                          config=TrainStepConfig(compute_dtype=torch.float32), nan_debug_dir=where)
        state = trainer.init_state()
        (state, out), waits[where] = host_waits(
            lambda: trainer.run_epoch(state, iter([good, bad, good]), torch.Generator(device=card).manual_seed(0)))
        assert out["skipped"] == 1.0
    assert len(waits[None]) == 2, waits[None]
    assert len(waits[str(tmp_path / "nan")]) > 2
    dumps = sorted((tmp_path / "nan").iterdir())
    assert [p.name for p in dumps] == ["nan_batch_step2.pkl"]
    report = replay_nan_batch(str(dumps[0]), net())
    assert report["x_finite"] is False and report["params_finite"] is True and report["loss_finite"] is False


def test_native_front_end_builds_on_the_cards_host(card):
    import numpy as np

    from asv_subtools_tpu_torch.features import native
    from asv_subtools_tpu_torch.features.functional import compute_fbank

    assert native.native_available()
    opts = FbankOptions(mel_opts=MelOptions(num_bins=80))
    wave = (np.random.default_rng(0).normal(size=48000) * 1000).astype(np.float32)
    got = native.native_fbank(wave, opts)
    want = compute_fbank(torch.from_numpy(wave), opts, fft_mode="rfft").numpy()
    assert got.shape == want.shape == (298, 80)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.fixture
def nccl_world1(card, monkeypatch):
    import socket

    from asv_subtools_tpu_torch.parallel import initialize_multihost, make_mesh

    monkeypatch.setenv("LOCAL_RANK", "0")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    initialize_multihost(f"127.0.0.1:{port}", num_processes=1, process_id=0, backend="nccl")
    try:
        yield make_mesh(1, 1)
    finally:
        torch.distributed.destroy_process_group()


def test_resolve_device_under_a_group_is_the_local_rank(nccl_world1):
    from asv_subtools_tpu_torch.device import resolve_device

    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("fsdp", [False, True])
def test_world1_mesh_step_equals_the_plain_step(nccl_world1, fsdp):
    from asv_subtools_tpu_torch.parallel import make_fsdp_rules
    from asv_subtools_tpu_torch.train import Trainer, TrainStepConfig, get_optimizer, init_train_state, make_train_step
    from asv_subtools_tpu_torch.train.step_check import OPTS, SUBCENTER_TOPK, ecapa_net, host_waits, modulated_waves

    dev = torch.device("cuda", 0)
    lr = 1e-3
    config = TrainStepConfig(compute_dtype=torch.bfloat16, wave_input=True, fbank_opts=OPTS)
    x, y = modulated_waves(8, 0)
    batch = {"x": x.to(dev), "y": y.to(dev)}
    net = ecapa_net(SUBCENTER_TOPK, 3, channels=256)
    tx = get_optimizer("adamW", lr)
    plain_state, plain_m = make_train_step(net, tx, config=config)(
        init_train_state(net, tx, dev), batch, torch.Generator(device=dev).manual_seed(5))
    trainer = Trainer(net, tx, config=config, device=dev, mesh=nccl_world1,
                      partition_rules=make_fsdp_rules(nccl_world1) if fsdp else None)
    state = trainer.init_state()
    trainer._train_step(state, batch, torch.Generator(device=dev).manual_seed(5))  # NCCL's communicator
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(5)
    (state, m), waits = host_waits(lambda: trainer._train_step(state, batch, gen))
    assert not waits, waits
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(plain_m[k])) <= 1e-5 * abs(float(plain_m[k])), k
    full = trainer.full_state(state)
    for k, v in plain_state.batch_stats.items():
        if v.is_floating_point():
            assert float((full.batch_stats[k] - v).abs().max()) <= 1e-6, k
    for k, v in plain_state.params.items():
        assert float((full.params[k] - v).abs().max()) <= 2.5 * lr, k


# The native runtime (asv_subtools_tpu_torch/runtime): the C++ op
# registrations of runtime/ops.cc against the Python ops bit for bit, a
# narrow ECAPA bundle through the CUDA runner against eager, and a runner
# built without ops.cc failing on a package that holds the ops.


@pytest.fixture(scope="module")
def runtime_built():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from asv_subtools_tpu_torch.kernels._build import build_runtime, runtime_has_cuda

    assert runtime_has_cuda(), "torch with CUDA and nvcc build the CUDA variant"
    build_runtime()


def _op_bundle(tmp_path, fn, args):
    from asv_subtools_tpu_torch.export import export_pjrt_bundle

    return export_pjrt_bundle(fn, args, str(tmp_path / "bundle"), device="cuda")


def _held_bit_for_bit(proc, outs, want):
    from asv_subtools_tpu_torch.export import raw_bytes

    assert proc.returncode == 0, proc.stderr
    assert outs == [raw_bytes(want)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_native_att_pooling_op_equals_the_python_op(card, runtime_built, tmp_path, dtype):
    from asv_subtools_tpu_torch.nn.fused_att_pooling import fused_attentive_stats_pool_op
    from asv_subtools_tpu_torch.runtime import parse_fields, run_bundle

    g = torch.Generator().manual_seed(3)
    c, k, b, t = 64, 16, 2, 150
    r = lambda *s: (torch.randn(*s, generator=g) * 0.3).to(card)  # noqa: E731
    x = r(b, c, t).to(dtype).transpose(1, 2)  # the model's [B, T, C] view of [B, C, T] memory
    ws = [r(c, k).to(dtype), r(c, k).to(dtype), r(c, k).to(dtype), r(k), r(k).abs() + 0.5, r(k),
          r(k, c).to(dtype), r(c)]
    mask = torch.arange(t, device=card)[None, :] < torch.tensor([[t], [t - 37]], device=card)

    def fn(xt, mask, *w):
        return fused_attentive_stats_pool_op(xt.transpose(1, 2), *w, mask)

    xt = x.transpose(1, 2).contiguous()
    bundle = _op_bundle(tmp_path, fn, (xt, mask, *ws))
    proc, outs = run_bundle(bundle, dict(enumerate((xt, mask, *ws))))
    _held_bit_for_bit(proc, outs, fused_attentive_stats_pool_op(xt.transpose(1, 2), *ws, mask))
    assert parse_fields(proc.stdout, "ops per call:")["fused_attentive_stats_pool"] == 1


@pytest.mark.parametrize("dtype,h", [(torch.bfloat16, 16), (torch.float32, 24)])
def test_native_res2_op_equals_the_python_op(card, runtime_built, tmp_path, dtype, h):
    from asv_subtools_tpu_torch.nn.fused_res2 import fused_res2_chain_op
    from asv_subtools_tpu_torch.runtime import parse_fields, run_bundle

    g = torch.Generator().manual_seed(4)
    n, b, t = 7, 2, 203
    xt = torch.randn(b, 8 * h, t, generator=g).to(card, dtype)
    w = (torch.randn(n, 3, h, h, generator=g) * (3 * h) ** -0.5).to(card, dtype)
    vecs = [torch.randn(n, h, generator=g).to(card) * 0.1 for _ in range(3)]

    def fn(xt, w, b, s, sh):
        return fused_res2_chain_op(xt.transpose(1, 2), w, b, s, sh, 2)

    bundle = _op_bundle(tmp_path, fn, (xt, w, *vecs))
    proc, outs = run_bundle(bundle, dict(enumerate((xt, w, *vecs))))
    _held_bit_for_bit(proc, outs, fused_res2_chain_op(xt.transpose(1, 2), w, *vecs, 2).contiguous())
    assert parse_fields(proc.stdout, "ops per call:")["fused_res2_chain"] == 1


@pytest.mark.parametrize("dtype,layout,masked", [(torch.float32, "contiguous", True),
                                                  (torch.bfloat16, "transposed", True),
                                                  (torch.float32, "transposed", False)])
def test_native_stats_pooling_op_equals_the_python_op(card, runtime_built, tmp_path, dtype, layout, masked):
    from asv_subtools_tpu_torch.nn.fused_stats_pooling import fused_stats_pooling_op
    from asv_subtools_tpu_torch.runtime import parse_fields, run_bundle

    g = torch.Generator().manual_seed(5)
    b, t, d = 3, 125, 96
    if layout == "transposed":  # K4 on the x-vector's [B, T, D] view of [B, D, T] memory
        x = torch.randn(b, d, t, generator=g).to(card, dtype)
        view = lambda x: x.transpose(1, 2)  # noqa: E731
    else:
        x = torch.randn(b, t, d, generator=g).to(card, dtype)
        view = lambda x: x  # noqa: E731
    mask = torch.arange(t, device=card)[None, :] < torch.tensor([[t], [60], [1]], device=card)
    args = (x, mask) if masked else (x,)

    def fn(x, mask=None):
        return fused_stats_pooling_op(view(x), mask, 1e-10)

    bundle = _op_bundle(tmp_path, fn, args)
    proc, outs = run_bundle(bundle, dict(enumerate(args)))
    _held_bit_for_bit(proc, outs, fused_stats_pooling_op(view(x), mask if masked else None, 1e-10))
    assert parse_fields(proc.stdout, "ops per call:")["fused_stats_pooling"] == 1


def _narrow_ecapa(card):
    from asv_subtools_tpu_torch.models import EcapaTdnn

    model = init_weights_(EcapaTdnn(input_dim=24, channels=64, mfa_conv=96, embd_dim=16, device=card), 1)
    for blk in (model.layer2, model.layer3, model.layer4):
        blk.res2net.fused_inference = True
    model.stats.fused_inference = True
    return model


def test_native_ecapa_bundle_on_the_card_matches_eager(card, runtime_built, tmp_path):
    from asv_subtools_tpu_torch.export import export_pjrt_embed_bundles
    from asv_subtools_tpu_torch.runtime import parse_fields, run_bundle

    model = _narrow_ecapa(card)
    paths = export_pjrt_embed_bundles(model, {"params": model.state_dict()}, 24, str(tmp_path / "ecapa"),
                                      bucket_lengths=(160,), device="cuda", batch=2)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 160, 24, generator=g)
    mask = torch.arange(160)[None, :] < torch.tensor([[160], [97]])
    proc, outs = run_bundle(paths[160], {1: x, 2: mask}, iters=2)
    assert proc.returncode == 0, proc.stderr
    got = torch.from_numpy(np.frombuffer(outs[0], np.float32).reshape(2, 16).copy())
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the executor computes f32 in f32
    try:
        with torch.no_grad():
            want = model(x.to(card), mask.to(card)).float().cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    ops = parse_fields(proc.stdout, "ops per call:")
    assert ops["fused_attentive_stats_pool"] == 1 and ops["fused_res2_chain"] == 3, proc.stdout


def test_a_runner_without_ops_refuses_a_package_with_the_kernels(card, runtime_built, tmp_path):
    from asv_subtools_tpu_torch.export import export_pjrt_embed_bundles
    from asv_subtools_tpu_torch.kernels._build import build_runtime, runtime_binary
    from asv_subtools_tpu_torch.runtime import run_bundle

    model = _narrow_ecapa(card)
    paths = export_pjrt_embed_bundles(model, {"params": model.state_dict()}, 24, str(tmp_path / "ecapa"),
                                      bucket_lengths=(64,), device="cuda")
    build_runtime(tmp_path / "no_ops", ops=False)
    proc, outs = run_bundle(paths[64], {}, runner=runtime_binary("bundle_runner", tmp_path / "no_ops"))
    assert proc.returncode != 0 and not outs, proc.stdout
    assert "fused_" in proc.stderr, proc.stderr
    proc, outs = run_bundle(paths[64], {}, device="cpu")  # a CUDA package on the CPU: no fallback either
    assert proc.returncode != 0 and not outs and "compiled for 'cuda'" in proc.stderr, proc.stderr


def _pageable_extract(embed, cfg, items, device):
    """The synchronous pageable path: the Extractor's batching and weighted
    sums over a fresh zero-padded batch and a host mask, each copied in
    from pageable memory, the answers read back with ``.cpu()``."""
    from asv_subtools_tpu_torch.extract import _bucket_for, _chunk

    pending = {b: [] for b in cfg.buckets}
    acc, expected, out = {}, {}, []

    def flush(bucket, batch):
        lens = np.asarray([c.shape[0] for _, c, _ in batch])
        x = np.zeros((len(batch), bucket), np.float32)
        for i, (_, c, _) in enumerate(batch):
            x[i, :c.shape[0]] = c
        mask = np.arange(bucket)[None, :] < lens[:, None]
        with torch.inference_mode():
            embs = embed(torch.from_numpy(x).to(device), torch.from_numpy(mask).to(device)).float().cpu().numpy()
        for (key, _, w), e in zip(batch, embs):
            acc.setdefault(key, []).append(w * e)
            if len(acc[key]) == expected[key]:
                out.append((key, np.sum(acc.pop(key), axis=0)))

    for key, wave in items:
        chunks, weights = _chunk(wave, cfg.max_chunk)
        expected[key] = len(chunks)
        for c, w in zip(chunks, weights):
            b = _bucket_for(c.shape[0], cfg.buckets)
            pending[b].append((key, c, w))
            if len(pending[b]) >= cfg.default_batch:
                flush(b, pending[b])
                pending[b] = []
    for b in cfg.buckets:
        if pending[b]:
            flush(b, pending[b])
    return out


def test_pinned_extractor_matches_a_pageable_path_bit_for_bit(card):
    from torch.profiler import ProfilerActivity, profile

    from asv_subtools_tpu_torch.extract import ExtractConfig, Extractor, make_wave_embed_fn
    from asv_subtools_tpu_torch.utils import profiling

    model = _narrow_ecapa(card).to(torch.bfloat16).eval()
    embed = make_wave_embed_fn(lambda x, m: model(x, m), FbankOptions(mel_opts=MelOptions(num_bins=24)),
                               dtype=torch.bfloat16)
    cfg = ExtractConfig(buckets=(16000, 32000), default_batch=4, max_chunk=32000)
    rng = np.random.default_rng(8)
    lengths = [9000, 30000, 400, 16000, 70000, 12000, 32000, 20000, 15000, 24000, 8000, 31000, 5000, 27000]
    items = [(f"u{i}", (rng.standard_normal(n) * 1000).astype(np.float32)) for i, n in enumerate(lengths)]
    want = _pageable_extract(embed, cfg, items, card)
    ex = Extractor(embed, cfg, device=card)
    with profiling.tracing():
        got = list(ex.extract_iter(iter(items)))
        first = profiling.totals()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = list(ex.extract_iter(iter(items)))
    second = profiling.totals()
    assert [k for k, _ in got] == [k for k, _ in want] == [k for k, _ in again] and len(want) == len(items)
    for (key, a), (_, b), (_, c) in zip(got, want, again):
        assert np.array_equal(a, b) and np.array_equal(c, b), key
    batches = second["extract.copy_in"][0]
    assert batches == ex._stats["batches"] // 2 >= 5
    assert first["extract.staging_allocs"] >= 1 and second["extract.staging_allocs"] == 0
    assert 0 <= second["extract.overlap_batches"] <= batches
    assert len(ex._staging) == 1 and all(s.is_pinned() for s in ex._staging[0].slabs)
    copies = [e.name for e in prof.events() if "Memcpy HtoD" in e.name]
    assert copies and all("Pinned" in n for n in copies), sorted(set(copies))


def _rel_attention_module(card, dim=256, heads=4, seed=0):
    """A bf16 RelPositionMultiHeadedAttention whose output projection is the
    identity, so that its output is the heads' [B, T, D] rows."""
    from asv_subtools_tpu_torch.nn.conformer import RelPositionMultiHeadedAttention

    torch.manual_seed(seed)
    mod = RelPositionMultiHeadedAttention(dim, heads).eval()
    with torch.no_grad():
        mod.pos_bias_u.normal_(0.0, 0.5)
        mod.pos_bias_v.normal_(0.0, 0.5)
    mod.out = torch.nn.Identity()
    return mod.to(device=card, dtype=torch.bfloat16)


def _rel_gap(got, want, valid):
    d = (got.float() - want)[valid]
    return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(want[valid]))


@pytest.mark.parametrize("b,t", [(16, 396), (16, 796), (8, 1596)])
def test_rel_attention_kernel_at_the_cells_shapes(card, b, t):
    from asv_subtools_tpu_torch.nn.conformer import make_pad_mask, position_table

    mod = _rel_attention_module(card, seed=t)
    gen = torch.Generator(device=card).manual_seed(t)
    x = torch.randn((b, t, 256), generator=gen, device=card).to(torch.bfloat16)
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=card)
    lengths[0], lengths[1] = t, 1  # a full row and a 1-frame row
    pad = make_pad_mask(lengths, t)
    att = pad[:, None, None, :] & pad[:, None, :, None]
    with torch.inference_mode():
        before = fused_rel_attention.launches
        got = mod(x, att, pad_mask=pad)  # the kernel
        assert fused_rel_attention.launches == before + 1
        chain = mod(x, att)  # no pad_mask: the unfused chain
        assert fused_rel_attention.launches == before + 1
        qkv, p = mod.qkv(x), mod.pos(position_table(t, 256, card).to(torch.bfloat16))
        f32 = [a.float() for a in (qkv, p, mod.pos_bias_u, mod.pos_bias_v)]
        want = fused_rel_attention_plain(*f32, 4, pad)
        plain = fused_rel_attention_plain(qkv, p, mod.pos_bias_u, mod.pos_bias_v, 4, pad)
    torch.cuda.synchronize()
    valid = pad[..., None].expand_as(want)
    gap_k, gap_c, gap_p = _rel_gap(got, want, valid), _rel_gap(chain, want, valid), _rel_gap(plain, want, valid)
    print(f"K5 [{b}, {t}]: relative L2 gap to f32, kernel {gap_k:.3e}, bf16 chain {gap_c:.3e}, "
          f"plain bf16 {gap_p:.3e}")
    assert gap_k <= 1.5 * gap_c, (gap_k, gap_c)
    assert bool((got[~pad] == 0).all()) and bool(torch.isfinite(got.float()).all())


def test_rel_attention_kernel_fp16_and_without_a_mask(card):
    b, t, heads = 4, 333, 4
    gen = torch.Generator(device=card).manual_seed(3)
    qkv = torch.randn((b, t, 3 * 256), generator=gen, device=card)
    p = torch.randn((t, 256), generator=gen, device=card)
    u, v = (torch.randn((heads, 64), generator=gen, device=card) * 0.5 for _ in range(2))
    pad = torch.arange(t, device=card)[None, :] < torch.tensor([333, 200, 64, 65], device=card)[:, None]
    for dt, mask in ((torch.float16, pad), (torch.bfloat16, None), (torch.float16, None)):
        args = [a.to(dt) for a in (qkv, p, u, v)]
        got = fused_rel_attention(*args, heads, mask)
        want = fused_rel_attention_plain(*[a.float() for a in args], heads, mask)
        valid = (torch.ones((b, t), dtype=torch.bool, device=card) if mask is None else mask)[..., None]
        valid = valid.expand_as(want)
        gap = _rel_gap(got, want, valid)
        # one rounding of P and of the output to the 8- or 11-bit mantissa
        assert gap <= (1e-2 if dt == torch.bfloat16 else 2e-3), (dt, mask is None, gap)
        assert got.dtype == dt and bool(torch.isfinite(got.float()).all())


def _served_conformer(card):
    from asv_subtools_tpu_torch.models import ConformerXvector

    model = init_weights_(ConformerXvector(80, num_blocks=6, attention_dim=256, attention_heads=4,
                                           input_layer="conv2d2", device="cpu"), 11)
    return model.to(device=card, dtype=torch.bfloat16).eval()


def test_conformer_forward_launches_k5_a_layer_and_never_waits(card):
    model = _served_conformer(card)
    gen = torch.Generator(device=card).manual_seed(12)
    x = torch.randn((8, 400, 80), generator=gen, device=card).to(torch.bfloat16)
    mask = torch.arange(400, device=card)[None, :] < torch.linspace(40, 400, 8, device=card).long()[:, None]
    with torch.inference_mode():
        model(x, mask)  # builds the kernels
        torch.cuda.synchronize()
        before = fused_rel_attention.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            emb = model(x, mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert fused_rel_attention.launches == before + 6
    assert emb.shape == (8, 256) and bool(torch.isfinite(emb.float()).all())


def test_exported_conformer_keeps_k5(card, tmp_path):
    from asv_subtools_tpu_torch.export import export_embed_fn, load_embed_fn

    model = _served_conformer(card)
    fn = lambda x, m: model(x.to(torch.bfloat16), m).float()
    paths = export_embed_fn(fn, 80, str(tmp_path), bucket_lengths=(200,), batch_sizes=(4,))
    program = torch.export.load(paths["b4_t200"])
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "asv_subtools_tpu_torch.fused_rel_attention.default" in ops
    loaded = load_embed_fn(paths["b4_t200"])
    gen = torch.Generator(device=card).manual_seed(13)
    x = torch.randn((4, 200, 80), generator=gen, device=card)
    mask = torch.arange(200, device=card)[None, :] < torch.tensor([200, 170, 120, 60], device=card)[:, None]
    with torch.inference_mode():
        before = fused_rel_attention.launches
        got = loaded(x, mask)
        assert fused_rel_attention.launches == before + 6
        want = fn(x, mask)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert float(cos.min()) >= 0.99999, cos
