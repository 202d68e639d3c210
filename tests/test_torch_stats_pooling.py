"""Port statistics pooling (kernel K4's plain version, and the port's
StatisticsPooling fused and unfused) against the JAX Pallas
`fused_stats_pooling` (interpret mode) and the JAX modules.

Inputs are made with numpy from a seed. Tolerances: rtol 1e-4, atol 1e-5
(tests/test_pallas_pooling.py:23), f32 sums in another order.

The shifted-mean case states what the one-pass variance costs: at mean 10,
std 1, T = 1000 in f32 the JAX kernel's E[x^2] - mean^2 is 2.2e-5 off the
two-pass StatisticsPooling (max abs, measured on the CPU), and the port's
version, which sums x - x[:, 0], 2.9e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.nn.pallas_pooling import fused_stats_pooling as jax_fused
from asv_subtools_tpu.nn.pooling import POOLINGS as JAX_POOLINGS
from asv_subtools_tpu.nn.pooling import FreeStatisticsPooling as JaxFreePool
from asv_subtools_tpu.nn.pooling import StatisticsPooling as JaxPool
from asv_subtools_tpu_torch.nn import (
    POOLINGS,
    FreeStatisticsPooling,
    StatisticsPooling,
    build_pooling,
    fused_stats_pooling,
    fused_stats_pooling_plain,
)
from asv_subtools_tpu_torch.nn.fused_stats_pooling import _mask_bytes
from kernel_plans import direct_plan, ring_plan, stats_plan, t_splits

torch.set_num_threads(2)

SHAPES = [(700, 200), (512, 128), (65, 30), (1500, 80)]  # tests/test_pallas_pooling.py:13


def _inputs(t, d, seed=0, loc=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(3, t, d)) + loc).astype(np.float32)
    lengths = np.asarray([t, max(1, t // 2), max(1, t // 7)])
    return x, np.arange(t)[None, :] < lengths[:, None]


def _jax_module(mod, x, mask):
    return np.asarray(mod.apply({}, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask)))


def _port(path, x, mask):
    xt = torch.from_numpy(x)
    m = None if mask is None else torch.from_numpy(mask)
    with torch.inference_mode():
        if path == "plain":
            return fused_stats_pooling_plain(xt, m).numpy()
        if path == "wrapper":
            return fused_stats_pooling(xt, m).numpy()
        return StatisticsPooling(fused_inference=path == "fused").eval()(xt, m).numpy()


PATHS = ["plain", "wrapper", "fused", "unfused"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("t,d", SHAPES)
def test_matches_jax_kernel(t, d, path):
    x, mask = _inputs(t, d)
    ref = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(mask), interpret=True))
    np.testing.assert_allclose(_port(path, x, mask), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("t,d", SHAPES)
def test_matches_jax_module(t, d, path):
    x, mask = _inputs(t, d, seed=1)
    np.testing.assert_allclose(_port(path, x, mask), _jax_module(JaxPool(), x, mask),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("path", PATHS)
def test_no_mask(path):
    x = np.random.default_rng(1).normal(size=(2, 300, 64)).astype(np.float32)
    ref = np.asarray(jax_fused(jnp.asarray(x), interpret=True))
    got = _port(path, x, None)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[:, :64], x.mean(axis=1), rtol=1e-5, atol=1e-5)


def test_shifted_mean_deviation_from_two_pass():
    """mean 10, std 1: the one-pass E[x^2] - mean^2 loses digits in f32;
    summing x - x[:, 0] keeps them."""
    x, mask = _inputs(1000, 64, seed=2, loc=10.0)
    two_pass = _jax_module(JaxPool(), x, mask)
    exact = np.concatenate([
        np.stack([x[i, m].astype(np.float64).mean(0) for i, m in enumerate(mask)]),
        np.stack([x[i, m].astype(np.float64).std(0) for i, m in enumerate(mask)])], axis=-1)
    dev_jax_kernel = np.abs(np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(mask), interpret=True)) - two_pass).max()
    dev_port = np.abs(_port("plain", x, mask) - two_pass).max()
    assert np.abs(two_pass - exact).max() < 5e-6
    assert dev_port < 5e-6, dev_port          # measured 2.9e-6
    assert dev_jax_kernel < 2e-4, dev_jax_kernel  # measured 2.2e-5: the cancellation
    assert dev_port <= dev_jax_kernel
    np.testing.assert_allclose(_port("plain", x, mask), exact, rtol=0, atol=5e-6)


@pytest.mark.parametrize("kw", [dict(stddev=False), dict(unbiased=True), dict(eps=1e-3),
                                dict(stddev=True, unbiased=True, eps=1e-6)])
@pytest.mark.parametrize("masked", [False, True])
def test_module_options_match_jax(kw, masked):
    x, mask = _inputs(120, 24, seed=3)
    x[2] *= 1e-3  # a small-variance row, so eps matters
    m = mask if masked else None
    with torch.inference_mode():
        got = StatisticsPooling(**kw)(torch.from_numpy(x), None if m is None else torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, _jax_module(JaxPool(**kw), x, m), rtol=1e-5, atol=1e-6)


def test_free_statistics_pooling_ignores_the_mask():
    x, mask = _inputs(90, 16, seed=4)
    with torch.inference_mode():
        got = FreeStatisticsPooling()(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, _jax_module(JaxFreePool(), x, mask), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _jax_module(JaxPool(), x, None), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", ["plain", "fused"])
def test_bf16_input_is_read_in_its_own_type_and_summed_in_f32(path):
    x, mask = _inputs(400, 48, seed=5)
    xb = torch.from_numpy(x).bfloat16()
    m = torch.from_numpy(mask)
    ref = _jax_module(JaxPool(), xb.float().numpy(), mask)
    with torch.inference_mode():
        if path == "plain":
            got = fused_stats_pooling_plain(xb, m)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
        else:
            got = StatisticsPooling(fused_inference=True).eval()(xb, m)
            assert got.dtype == torch.bfloat16  # the module casts to x's type
            np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2, atol=1e-2)  # one bf16 rounding


def test_row_without_valid_frames_gives_zero_mean_and_floor_std():
    x, _ = _inputs(64, 8, seed=6, loc=3.0)
    mask = np.zeros((3, 64), bool)
    mask[0] = True
    got = _port("plain", x, mask)
    ref = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(mask), interpret=True))
    np.testing.assert_allclose(got[1:], np.tile(np.r_[np.zeros(8), np.full(8, 1e-5)], (2, 1)), atol=1e-9)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_masked_frames_may_hold_anything():
    x, mask = _inputs(50, 8, seed=7)
    ref = _port("plain", x, mask)
    x[~mask] = np.inf
    np.testing.assert_array_equal(_port("plain", x, mask), ref)


def test_takes_a_strided_view():
    """The ResNet trunk hands over a [B, T, F*C] view of channels-last maps."""
    maps = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 6, 30, 5)).astype(np.float32))
    maps = maps.contiguous(memory_format=torch.channels_last)  # [B, C, T, F]
    x = maps.permute(0, 2, 3, 1).reshape(2, 30, 30)
    assert x.data_ptr() == maps.data_ptr()
    np.testing.assert_allclose(fused_stats_pooling(x).numpy(),
                               fused_stats_pooling_plain(x.contiguous().clone()).numpy(), atol=0)


@pytest.mark.parametrize("name", sorted(set(JAX_POOLINGS) - {"statistics", "free-statistics"}))
def test_queued_poolings_raise_by_name(name):
    """The eight poolings that were queued are ported now (each held
    against JAX in tests/test_torch_pooling_zoo.py): none raises; each
    builds by name for a width and pools a masked batch to that width."""
    assert name in POOLINGS
    pool = build_pooling(name, 24).eval()
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(3, 37, 24)).astype(np.float32))
    mask = torch.arange(37)[None, :] < torch.tensor([37, 20, 9])[:, None]
    with torch.no_grad():
        out = pool(x, mask)
    assert out.shape == (3, pool.output_dim(24)) and bool(torch.isfinite(out).all())


def test_pooling_table_has_the_jax_names():
    assert set(POOLINGS) == set(JAX_POOLINGS)
    assert POOLINGS["statistics"] is StatisticsPooling
    assert POOLINGS["free-statistics"] is FreeStatisticsPooling


@pytest.mark.parametrize("kw", [dict(stddev=False), dict(unbiased=True)])
def test_fused_inference_takes_mean_and_biased_std_only(kw):
    with pytest.raises(ValueError):
        StatisticsPooling(fused_inference=True, **kw)(torch.zeros(1, 4, 2))


def test_fused_inference_is_off_by_default():
    assert StatisticsPooling().fused_inference is False


def test_wrapper_checks_shapes():
    with pytest.raises(ValueError):
        fused_stats_pooling(torch.zeros(4, 8))
    with pytest.raises(ValueError):
        fused_stats_pooling(torch.zeros(2, 0, 8))
    with pytest.raises(ValueError):
        fused_stats_pooling(torch.zeros(2, 5, 8), torch.ones(2, 4, dtype=torch.bool))


@pytest.mark.parametrize("b,t,d,vec,want", [
    (128, 125, 2560, 8, 1),    # the served ResNet34 batch: 1280 blocks without a split
    (64, 1000, 1536, 8, 3),    # long T, few (row, D tile) pairs
    (1, 1000, 256, 8, 31),     # one row: at least 32 frames a span
    (3, 20, 64, 4, 1),         # T below 32 is never split
])
def test_time_split_plan(b, t, d, vec, want):
    assert t_splits(b, t, d, vec) == want


# ---------------------------------------------------------------------------
# The ring kernel's plan (csrc/launch_plan.h, through tests/kernel_plans.py)
# and the wrapper's mask handling, on the CPU.

RING_BLOCKS = 2 * 132  # two persistent blocks for each SM of an H100


def _walk_ring_items(b, t, d, vec, blocks):
    """csrc/stats_pooling.cu, stats_ring_kernel: block k takes items k,
    k + grid, ...; an item is (pair, split), a pair (row, D tile); a span
    goes through the ring in stages of 32 rows. Yields (block, row, D tile,
    first frame, frames) per stage."""
    splits, span_rows = ring_plan(b, t, d, vec, blocks)
    assert span_rows % 32 == 0 and (splits - 1) * span_rows < t <= splits * span_rows
    d_tiles = -(-d // (32 * vec))
    items = b * d_tiles * splits
    grid = min(items, blocks)
    for block in range(grid):
        for item in range(block, items, grid):
            pair, split = divmod(item, splits)
            row, d_tile = divmod(pair, d_tiles)
            tbeg = split * span_rows
            tend = min(t, tbeg + span_rows)
            for t0 in range(tbeg, tend, 32):
                yield block, row, d_tile, t0, min(32, tend - t0)


@pytest.mark.parametrize("b,t,d,vec,want_splits", [
    (128, 125, 2560, 8, 1),   # the served ResNet34 batch: 1280 items on 264 blocks
    (64, 1000, 1536, 8, 3),   # long T, few (row, D tile) pairs: spans of 11 stages
    (3, 197, 200, 4, 7),      # ragged: the last stage of 5 frames, the last D tile of 72 features
    (2, 1, 16, 8, 1),         # T = 1
])
def test_ring_plan_covers_every_stage_once(b, t, d, vec, want_splits):
    assert ring_plan(b, t, d, vec, RING_BLOCKS)[0] == want_splits
    seen = {}
    load = {}
    for block, row, d_tile, t0, n in _walk_ring_items(b, t, d, vec, RING_BLOCKS):
        assert t0 % 32 == 0 and 0 < n <= 32 and (row, d_tile, t0) not in seen
        seen[(row, d_tile, t0)] = n
        load[block] = load.get(block, 0) + 1
    d_tiles = -(-d // (32 * vec))
    assert set(seen) == {(r, dt, t0) for r in range(b) for dt in range(d_tiles) for t0 in range(0, t, 32)}
    assert sum(n for (r, dt, _), n in seen.items() if (r, dt) == (b - 1, d_tiles - 1)) == t
    assert max(load.values()) - min(load.values()) <= -(-t // 32)  # blocks differ by one item at most


@pytest.mark.parametrize("b,t,d,vec", [(1, 5000, 8, 4), (64, 1000, 1536, 8), (3, 20, 64, 4), (1, 1000, 256, 1)])
def test_direct_plan_has_no_empty_span(b, t, d, vec):
    splits, span_rows = direct_plan(b, t, d, vec)
    assert splits <= t_splits(b, t, d, vec) and (splits - 1) * span_rows < t <= splits * span_rows


# ResNet34's pooling input [128, T, 2560] at the train chunk's 125 frames
# and the extraction buckets' 100, 200 and 400, and the TDNN x-vectors'
# [128, 998, 1500]: (B, T, D, element bytes) -> route, vec, splits,
# span_rows as the launcher plans them for a contiguous x on an H100 (132
# SMs), and the direct kernel's (splits, span_rows).
CELL_PLANS = {
    (128, 100, 2560, 2): ((1, 8, 1, 128), (1, 100)),
    (128, 100, 2560, 4): ((1, 4, 1, 128), (1, 100)),
    (128, 125, 2560, 2): ((1, 8, 1, 128), (1, 125)),
    (128, 125, 2560, 4): ((1, 4, 1, 128), (1, 125)),
    (128, 200, 2560, 2): ((1, 8, 1, 224), (1, 200)),
    (128, 200, 2560, 4): ((1, 4, 1, 224), (1, 200)),
    (128, 400, 2560, 2): ((1, 8, 1, 416), (1, 400)),
    (128, 400, 2560, 4): ((1, 4, 1, 416), (1, 400)),
    (128, 998, 1500, 2): ((0, 1, 1, 998), (1, 998)),  # rows of 3,000 bytes: the direct kernel
    (128, 998, 1500, 4): ((1, 4, 1, 1024), (1, 998)),
}


@pytest.mark.parametrize("b,t,d,elem", list(CELL_PLANS))
def test_plan_at_the_cells_shapes(b, t, d, elem):
    chosen, direct = CELL_PLANS[(b, t, d, elem)]
    ok, p = stats_plan(b, t, d, elem)
    assert ok and (p["ring"], p["vec"], p["splits"], p["span_rows"]) == chosen
    assert p["blocks"] == 2 * 132 and p["bytes"] == 0  # one span: no partial sums
    ok, p = stats_plan(b, t, d, elem, route=0)
    assert ok and p["ring"] == 0 and (p["splits"], p["span_rows"]) == direct


def test_plan_refuses_the_ring_where_x_is_not_aligned():
    assert stats_plan(4, 100, 256, 2, route=1)[0]
    for kw in ({"address": 8}, {"strides": (100 * 256, 260)}):
        assert stats_plan(4, 100, 256, 2, route=1, **kw)[0] is False
        ok, p = stats_plan(4, 100, 256, 2, **kw)
        assert ok and p["ring"] == 0 and p["vec"] == 1


def test_plan_sizes_the_spans_partial_sums():
    ok, p = stats_plan(64, 1000, 1536, 2)
    assert ok and p["splits"] > 1 and p["bytes"] == 4 * 64 * p["splits"] * (3 * 1536 + 1)


def test_spans_merge_to_the_plain_result():
    """The merge kernel's arithmetic: each span's sums about its own first
    valid frame, merged as (count, mean, M2) pairs."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, 200, 6)) + 10.0).astype(np.float32)
    mask = rng.random((2, 200)) > 0.3
    mask[0, :70] = False  # the first span of row 0 is empty, the second starts masked
    ref = _port("plain", x, mask)
    got = np.zeros_like(ref)
    for row in range(2):
        n, mean, m2 = np.float32(0), np.zeros(6, np.float32), np.zeros(6, np.float32)
        for tbeg in range(0, 200, 64):
            xs, ms = x[row, tbeg:tbeg + 64], mask[row, tbeg:tbeg + 64]
            ns = np.float32(ms.sum())
            if ns == 0:
                continue
            delta = xs[ms] - xs[ms][0]
            a1, a2 = delta.sum(0, dtype=np.float32), (delta * delta).sum(0, dtype=np.float32)
            mean_s, m2_s = xs[ms][0] + a1 / ns, a2 - a1 * a1 / ns
            tot, dm = n + ns, mean_s - mean
            mean, m2, n = mean + dm * (ns / tot), m2 + m2_s + dm * dm * (n * ns / tot), tot
        got[row] = np.r_[mean, np.sqrt(np.maximum(m2 / max(n, 1), 1e-10))]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_bool_mask_reaches_the_kernel_without_a_copy():
    dev = torch.device("cpu")
    mask = torch.from_numpy(_inputs(40, 4)[1])
    as_bytes = _mask_bytes(mask, dev)
    assert as_bytes.dtype == torch.uint8 and as_bytes.data_ptr() == mask.data_ptr()
    u8 = mask.to(torch.uint8)
    assert _mask_bytes(u8, dev).data_ptr() == u8.data_ptr()
    assert _mask_bytes(None, dev) is None


@pytest.mark.parametrize("make", [lambda m: m.float() * 0.5, lambda m: m.to(torch.int64) * 3,
                                  lambda m: m.t().contiguous().t()], ids=["float", "int64", "strided-bool"])
def test_other_masks_are_converted_to_one_byte_a_frame(make):
    mask = torch.from_numpy(_inputs(40, 4)[1])
    other = make(mask)
    as_bytes = _mask_bytes(other, torch.device("cpu"))
    assert as_bytes.dtype == torch.uint8 and as_bytes.is_contiguous()
    assert as_bytes.data_ptr() != other.data_ptr()
    np.testing.assert_array_equal(as_bytes.numpy() != 0, mask.numpy())  # any non-zero value is valid


@pytest.mark.parametrize("path", PATHS)
def test_holes_in_the_mask_with_frame_0_masked_and_inf(path):
    """The shift is the row's first valid frame: an inf in a masked frame
    0 reaches nothing."""
    x, _ = _inputs(50, 8, seed=9, loc=2.0)
    mask = np.random.default_rng(9).random((3, 50)) > 0.4
    mask[:, 0] = False
    ref = np.concatenate([np.stack([x[i, m].astype(np.float64).mean(0) for i, m in enumerate(mask)]),
                          np.stack([x[i, m].astype(np.float64).std(0) for i, m in enumerate(mask)])], axis=-1)
    x[~mask] = np.inf
    tol = dict(rtol=1e-4, atol=1e-5)
    if path == "unfused":  # the two-pass module multiplies by the mask: it needs finite frames
        x[~mask] = 1e6
    np.testing.assert_allclose(_port(path, x, mask), ref, **tol)


@pytest.mark.parametrize("path", ["plain", "wrapper", "fused"])
def test_a_single_frame(path):
    x = np.random.default_rng(10).normal(size=(2, 1, 8)).astype(np.float32)
    mask = np.asarray([[True], [False]])
    got = _port(path, x, mask)
    np.testing.assert_allclose(got[0], np.r_[x[0, 0], np.full(8, 1e-5)], atol=1e-7)
    np.testing.assert_allclose(got[1], np.r_[np.zeros(8), np.full(8, 1e-5)], atol=1e-9)
