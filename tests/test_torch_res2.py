"""Port Res2Net chain (kernel K3's plain version, and the port's
Res2NetBlock fused and unfused) against the JAX Pallas `fused_res2_chain`
(interpret mode on the CPU) and the JAX Res2NetBlock.

Inputs and weights are made with numpy from a seed. Tolerances: against the
JAX kernel the inputs are bf16-representable and both sides round the same
operands to bf16 and sum in f32, so outputs differ by one bf16 ulp where a
sum in another order crosses a rounding boundary (atol = rtol = 2e-2, mean
abs < 1e-3); against the f32 module atol 1e-4; a bf16 chain against the f32
module max 0.06 / mean 5e-3, the scale of tests/test_pallas_res2.py:50-51.

The kernel tiles T and recomputes a halo; `_tiled_chain` below walks the
same tile plan, window and per-stage zeroing on the CPU, so the scheme is
held against the plain version here and the CUDA code against the plain
version on the card (tests/test_torch_cuda.py). The plans are the
launcher's own (csrc/launch_plan.h through tests/kernel_plans.py); the
cells' plans are pinned to the values they had when the plans were
written in Python.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from asv_subtools_tpu.models.ecapa import Res2NetBlock as JaxRes2Net
from asv_subtools_tpu.nn.pallas_res2 import fused_res2_chain as jax_fused
from asv_subtools_tpu_torch.models import EcapaTdnn, Res2NetBlock
from asv_subtools_tpu_torch.nn import fused_res2_chain, fused_res2_chain_plain
from asv_subtools_tpu_torch.weights import load_variables
from kernel_plans import res2_plan, smem_limit, tensor_core_plan, tile_plan

torch.set_num_threads(2)

SCALE = 8


def _bf16(a):
    """Round a float32 numpy array to bf16-representable values."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _chain_inputs(b, t, h, seed=0, representable=False):
    rng = np.random.default_rng(seed)
    n = SCALE - 1
    x = rng.normal(size=(b, t, SCALE * h)).astype(np.float32)
    w = (rng.normal(size=(n, 3, h, h)) * (3 * h) ** -0.5).astype(np.float32)
    bias = (rng.normal(size=(n, h)) * 0.1).astype(np.float32)
    bn_s = rng.uniform(0.8, 1.2, size=(n, h)).astype(np.float32)
    bn_t = (rng.normal(size=(n, h)) * 0.1).astype(np.float32)
    if representable:
        x, w = _bf16(x), _bf16(w)
    return x, w, bias, bn_s, bn_t


def _plain(args, dilation, dtype=torch.float32):
    x, w, *vecs = (torch.from_numpy(a) for a in args)
    with torch.inference_mode():
        return fused_res2_chain_plain(x.to(dtype), w.to(dtype), *vecs, dilation=dilation).float().numpy()


@pytest.mark.parametrize("t,dilation", [(200, 2), (197, 3), (64, 4)])
def test_plain_matches_jax_kernel(t, dilation):
    args = _chain_inputs(2, t, 128, representable=True)  # the JAX kernel needs h % 128 == 0
    ref = np.asarray(jax_fused(*(jnp.asarray(a) for a in args), dilation=dilation), np.float32)
    got = _plain(args, dilation, torch.bfloat16)
    assert got.shape == ref.shape == (2, t, 1024)
    np.testing.assert_array_equal(got[..., :128], ref[..., :128])  # group 0 passes through
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    assert np.abs(got - ref).mean() < 1e-3


def _jax_block(c, dilation, x, seed=0):
    mod = JaxRes2Net(c, scale=SCALE, dilation=dilation)
    v = mod.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), train=False)
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.default_rng(seed)
    for i in range(SCALE - 1):
        blk = v["params"][f"block_{i}"]
        blk["affine"]["conv"]["bias"] = (rng.normal(size=blk["affine"]["conv"]["bias"].shape) * 0.1).astype(np.float32)
        bn = blk["act_bn"]["bn"]
        bn["scale"] = rng.uniform(0.8, 1.2, size=bn["scale"].shape).astype(np.float32)
        bn["bias"] = (rng.normal(size=bn["bias"].shape) * 0.1).astype(np.float32)
        st = v["batch_stats"][f"block_{i}"]["act_bn"]["bn"]
        st["mean"] = (rng.normal(size=st["mean"].shape) * 0.1).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, size=st["var"].shape).astype(np.float32)
    return mod, v


def _fold(v):
    """Chain arguments from a Res2NetBlock variable tree (numpy)."""
    p, s = v["params"], v["batch_stats"]
    blocks = [f"block_{i}" for i in range(SCALE - 1)]
    w = np.stack([p[k]["affine"]["conv"]["kernel"] for k in blocks])
    b = np.stack([p[k]["affine"]["conv"]["bias"] for k in blocks])
    bn = [(p[k]["act_bn"]["bn"], s[k]["act_bn"]["bn"]) for k in blocks]
    bn_s = np.stack([q["scale"] / np.sqrt(r["var"] + 1e-5) for q, r in bn]).astype(np.float32)
    bn_t = np.stack([q["bias"] for q, _ in bn]) - np.stack([r["mean"] for _, r in bn]) * bn_s
    return w, b, bn_s, bn_t.astype(np.float32)


@pytest.mark.parametrize("t,dilation", [(200, 2), (197, 3), (64, 4), (5, 4)])
def test_plain_matches_jax_block_f32(t, dilation):
    x = np.random.default_rng(1).normal(size=(2, t, 64)).astype(np.float32)
    mod, v = _jax_block(64, dilation, x)
    ref = np.asarray(mod.apply(v, jnp.asarray(x), train=False))
    np.testing.assert_allclose(_plain((x, *_fold(v)), dilation), ref, atol=1e-4, rtol=0)


def test_bf16_chain_stays_near_the_f32_block():
    x = np.random.default_rng(2).normal(size=(2, 120, 256)).astype(np.float32)
    mod, v = _jax_block(256, 3, x)
    ref = np.asarray(mod.apply(v, jnp.asarray(x), train=False))
    d = np.abs(_plain((x, *_fold(v)), 3, torch.bfloat16) - ref)
    assert d.max() < 0.06 and d.mean() < 5e-3, (d.max(), d.mean())


def test_row_padding_isolated():
    """Frames past T do not leak into valid frames through the taps: the
    same content with 16 more frames appended gives the same head."""
    args = _chain_inputs(1, 197, 16, seed=3)
    full = _plain(args, 4)
    x2 = np.concatenate([args[0], np.random.default_rng(4).normal(size=(1, 16, 128)).astype(np.float32)], axis=1)
    full2 = _plain((x2, *args[1:]), 4)
    np.testing.assert_allclose(full[:, :150], full2[:, :150], atol=1e-6)
    # and the last frames do see the zero padding, not relu(bias) * scale + shift
    assert np.abs(full[:, 190:] - full2[:, 190:197]).max() > 1e-3


def _tiled_chain(x, w, bias, bn_s, bn_t, d):
    """The kernel's scheme in numpy, f32: tiles of TT frames, a window of
    TT + 2*n*d rows, the computed rows shrinking by d a side each stage,
    rows outside [0, T) written back as zero after every stage."""
    bsz, t, c = x.shape
    n, _, h, _ = w.shape
    tt, tiles, rp = tile_plan(t, n, d)
    halo = n * d
    rows = tt + 2 * halo
    assert rows <= rp and tt + 2 * (n - 1) * d <= 192 and tiles * tt >= t
    out = np.zeros_like(x)
    out[..., :h] = x[..., :h]
    for tile in range(tiles):
        t0 = tile * tt
        frames = t0 - halo + np.arange(rows)
        inside = (frames >= 0) & (frames < t)
        own = (frames >= t0) & (frames < min(t0 + tt, t))

        def window(group):
            win = np.zeros((bsz, rows, h), np.float32)
            win[:, inside] = x[:, frames[inside], group * h:(group + 1) * h]
            return win

        state = window(1)
        for s in range(n):
            lo, hi = (s + 1) * d, rows - (s + 1) * d
            taps = np.concatenate([state[:, lo + (k - 1) * d:hi + (k - 1) * d] for k in range(3)], axis=-1)
            z = np.maximum(taps @ w[s].reshape(3 * h, h) + bias[s], 0) * bn_s[s] + bn_t[s]
            z[:, ~inside[lo:hi]] = 0.0
            state[:, lo:hi] = z  # rows outside [lo, hi) are stale and never read again
            sel = own[lo:hi]
            out[:, frames[lo:hi][sel], (s + 1) * h:(s + 2) * h] = z[:, sel]
            if s + 1 < n:
                state[:, lo:hi] += window(s + 2)[:, lo:hi]
    return out


@pytest.mark.parametrize("t,dilation,h", [(197, 4, 16), (400, 2, 8), (150, 3, 8), (1000, 4, 8), (31, 1, 8)])
def test_tiling_scheme_matches_plain(t, dilation, h):
    args = _chain_inputs(2, t, h, seed=5)
    np.testing.assert_allclose(_tiled_chain(*args, dilation), _plain(args, dilation), atol=1e-5, rtol=0)


def _tiled_chain_tc(x, w, bias, bn_s, bn_t, d):
    """The tensor-core kernel's data flow in numpy, f32: the plan of
    `tensor_core_plan`; each part brought into a [h][SP] buffer from an even
    frame ta (zero outside [0, T)); the state [rows][h] filled from part 1's
    buffer; a stage's result plus the buffer's part the next state, in
    place; the result of the tile's own frames sent out."""
    bsz, t, c = x.shape
    n, _, h, _ = w.shape
    tt, tiles, rows, sp, smem = tensor_core_plan(t, h, n, d)
    halo = n * d
    big = tt + 2 * halo  # R, the window's rows
    assert tt % 2 == 0 and rows >= big and smem > 0
    out = np.full_like(x, np.nan)
    out[..., :h] = x[..., :h]

    def fetch(group, ta, frames):
        buf = np.full((bsz, h, sp), np.nan, np.float32)
        n_copy = 2 * -(-frames // 2)  # whole 4-byte pairs
        assert n_copy <= sp
        fr = ta + np.arange(n_copy)
        ok = (fr >= 0) & (fr < t)
        buf[:, :, :n_copy] = 0.0
        buf[:, :, :n_copy][:, :, ok] = x[:, fr[ok], group * h:(group + 1) * h].transpose(0, 2, 1)
        return buf

    for tile in range(tiles):
        t0 = tile * tt
        tt_n = min(tt, t - t0)
        wa = (t0 - halo) & ~1
        p = fetch(1, wa, big + (t0 - halo - wa))
        state = np.zeros((bsz, rows, h), np.float32)
        state[:, :big] = p[:, :, (t0 - halo - wa) + np.arange(big)].transpose(0, 2, 1)
        for s in range(n):
            lo, hi = (s + 1) * d, big - (s + 1) * d
            last = s == n - 1
            ta = (t0 - halo + lo) & ~1
            if not last:
                p = fetch(s + 2, ta, (hi - lo) + (t0 - halo + lo - ta))
            taps = np.concatenate([state[:, lo + (k - 1) * d:hi + (k - 1) * d] for k in range(3)], axis=-1)
            z = np.maximum(taps @ w[s].reshape(3 * h, h) + bias[s], 0) * bn_s[s] + bn_t[s]
            frames = t0 - halo + np.arange(lo, hi)
            z[:, (frames < 0) | (frames >= t)] = 0.0
            if not last:
                state[:, lo:hi] = z + p[:, :, frames - ta].transpose(0, 2, 1)
            own = (frames >= t0) & (frames < t0 + tt_n)
            out[:, frames[own], (s + 1) * h:(s + 2) * h] = z[:, own]
    return out


@pytest.mark.parametrize("t,dilation,h", [(998, 4, 16), (998, 2, 16), (197, 3, 32), (31, 1, 16), (120, 14, 16),
                                          (5, 4, 16)])
def test_tensor_core_plan_matches_plain(t, dilation, h):
    args = _chain_inputs(1, t, h, seed=9)
    got = _tiled_chain_tc(*args, dilation)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _plain(args, dilation), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dilation,fits", [(2, True), (3, True), (4, True), (14, True)])
def test_tensor_core_plan_fits_shared_memory(dilation, fits):
    """At the ECAPA width (h = 128) the tensor-core kernel's state, weight
    ring and part buffer fit one block's shared memory up to dilation 14."""
    tt, tiles, rows, sp, smem = tensor_core_plan(998, 128, SCALE - 1, dilation)
    assert (smem <= smem_limit()) == fits
    assert sp % 64 == 8 and sp >= tt + 2 * (SCALE - 1) * dilation + 2
    assert rows == SCALE * dilation + 192


@pytest.mark.parametrize("t,dilation,tt,tiles", [(998, 2, 168, 6), (998, 3, 144, 7), (998, 4, 144, 7),
                                                (197, 4, 100, 2), (64, 4, 64, 1)])
def test_tile_plan(t, dilation, tt, tiles):
    got_tt, got_tiles, rp = tile_plan(t, SCALE - 1, dilation)
    assert (got_tt, got_tiles) == (tt, tiles)
    assert got_tt % 2 == 0 and got_tt + 2 * (SCALE - 2) * dilation <= 192 and got_tiles * got_tt >= t
    assert rp % 2 == 1 and rp >= 8 * dilation + 192


def test_tile_plan_raises_when_the_halo_leaves_no_room():
    with pytest.raises(ValueError):
        tile_plan(998, SCALE - 1, 15)
    assert res2_plan(1, 998, 128, SCALE - 1, 15, True)[0] is False  # so the launcher refuses the call


# The ECAPA cell's chains (h = 128, 7 stages) at its buckets' frames: (T,
# dilation) -> TT, tiles, rows, SP, shared memory of the tensor-core plan
# (bf16) and TT, tiles, RP, shared memory of the CUDA-core plan (f32).
CELL_PLANS = {
    (798, 2): ((160, 5, 208, 200, 177440), (160, 5, 209, 123392)),
    (798, 3): ((134, 6, 216, 200, 179616), (134, 6, 217, 127488)),
    (798, 4): ((134, 6, 224, 200, 181792), (134, 6, 225, 131584)),
    (1598, 2): ((160, 10, 208, 200, 177440), (160, 10, 209, 123392)),
    (1598, 3): ((146, 11, 216, 200, 179616), (146, 11, 217, 127488)),
    (1598, 4): ((134, 12, 224, 200, 181792), (134, 12, 225, 131584)),
    (3198, 2): ((160, 20, 208, 200, 177440), (160, 20, 209, 123392)),
    (3198, 3): ((154, 21, 216, 200, 179616), (154, 21, 217, 127488)),
    (3198, 4): ((140, 23, 224, 200, 181792), (140, 23, 225, 131584)),
}


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("t,dilation", list(CELL_PLANS))
def test_plan_at_the_cells_shapes(t, dilation, bf16):
    ok, p = res2_plan(128, t, 128, SCALE - 1, dilation, bf16)
    tensor, cuda = CELL_PLANS[(t, dilation)]
    assert ok and p["tensor"] == int(bf16)
    if bf16:
        assert (p["tt"], p["tiles"], p["rp"], p["sp"], p["smem"]) == tensor
        assert p["bytes"] == 2 * (SCALE - 1) * 3 * 128 * 136  # the weights [n, 3, h out, h in + 8] bf16
    else:
        assert (p["tt"], p["tiles"], p["rp"], p["smem"]) == cuda and p["sp"] == 0 and p["bytes"] == 0


@pytest.mark.parametrize("b,h,n,d,bf16,route", [
    (2, 64, 1, 310, True, 0),     # the tensor cores' part buffer does not fit: the CUDA cores' state does
    (2, 128, 1, 300, True, None),  # neither fits
    (2, 129, 7, 2, False, None),   # wider than a thread's registers hold
    (65536, 128, 7, 2, True, None),
])
def test_plan_takes_the_cuda_cores_or_refuses(b, h, n, d, bf16, route):
    ok, p = res2_plan(b, 500, h, n, d, bf16)
    assert ok == (route is not None)
    if ok:
        assert p["tensor"] == route and p["smem"] <= smem_limit() < tensor_core_plan(500, h, n, d)[4]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 0.06)])
@pytest.mark.parametrize("dilation", [2, 3, 4])
def test_block_flag_on_matches_off(dilation, dtype, atol):
    x = np.random.default_rng(6).normal(size=(2, 90, 64)).astype(np.float32)
    _, v = _jax_block(64, dilation, x)
    port = Res2NetBlock(64, dilation=dilation)
    load_variables(port, v)
    port = port.to(dtype).eval()
    xt = torch.from_numpy(x).to(dtype).transpose(1, 2)  # the model's [B, C, T]
    with torch.inference_mode():
        off = port(xt)
        port.fused_inference = True
        on = port(xt)
    assert on.shape == off.shape and on.dtype == off.dtype
    d = (on.float() - off.float()).abs()
    assert float(d.max()) <= atol, float(d.max())
    if dtype == torch.bfloat16:
        assert float(d.mean()) < 5e-3


def test_block_flag_is_off_by_default_and_model_signature_unchanged():
    assert Res2NetBlock(64).fused_inference is False
    model = EcapaTdnn(input_dim=24, channels=64, mfa_conv=96, embd_dim=16, device="cpu")
    assert not any(m.fused_inference for m in model.modules() if isinstance(m, Res2NetBlock))


def test_model_with_fused_chains_matches_jax():
    small = dict(channels=64, mfa_conv=96, embd_dim=16)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 100, 24)).astype(np.float32)
    mask = np.arange(100)[None, :] < np.array([100, 61, 20])[:, None]
    jm = JaxEcapa(**small)
    v = jax.tree_util.tree_map(np.array, jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=False))
    port = EcapaTdnn(input_dim=24, device="cpu", **small)
    load_variables(port, v)
    for m in port.modules():
        if isinstance(m, Res2NetBlock):
            m.fused_inference = True
    before = fused_res2_chain.launches
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert fused_res2_chain.launches == before  # the CPU path launches no kernel
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_wrapper_takes_the_models_layout():
    """x as a [B, T, C] view of [B, C, T] memory gives the same values."""
    args = [torch.from_numpy(a) for a in _chain_inputs(2, 40, 8, seed=8)]
    x_ct = args[0].transpose(1, 2).contiguous()
    with torch.inference_mode():
        a = fused_res2_chain(x_ct.transpose(1, 2), *args[1:], dilation=2)
        b = fused_res2_chain(*args, dilation=2)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_wrapper_checks_geometry():
    x, w, b, s, t = (torch.from_numpy(a) for a in _chain_inputs(1, 20, 8))
    with pytest.raises(ValueError):
        fused_res2_chain(x[0], w, b, s, t)
    with pytest.raises(ValueError):
        fused_res2_chain(x[..., :56], w, b, s, t)
    with pytest.raises(ValueError):
        fused_res2_chain(x, w[:, :2], b, s, t)
    with pytest.raises(ValueError):
        fused_res2_chain(x, w, b[:6], s, t)
    with pytest.raises(ValueError):
        fused_res2_chain(x, w, b, s, t, dilation=0)
