"""Port attentive statistics pooling (kernel K2's plain version, and the
port's EcapaAttentiveStatsPool fused and unfused) against the JAX Pallas
`fused_attentive_stats_pool` (interpret mode) and the JAX module's XLA path.

Inputs and weights are made with numpy from a seed; the JAX variables are
carried into the port by asv_subtools_tpu_torch.weights. Tolerances: 2e-4
in f32 (tests/test_pallas_att_pooling.py:37), also for the large-logit
case, 0.05 in bf16 (:59). The large-logit case is held against the XLA
path only: the TPU kernel clamps logits at 80 where the port subtracts the
true max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.models.ecapa import EcapaAttentiveStatsPool as JaxPool
from asv_subtools_tpu.nn.pallas_att_pooling import fused_attentive_stats_pool as jax_fused
from asv_subtools_tpu_torch.models import EcapaAttentiveStatsPool
from asv_subtools_tpu_torch.nn import fused_attentive_stats_pool, fused_attentive_stats_pool_plain
from asv_subtools_tpu_torch.weights import load_ecapa_variables
from kernel_plans import att_plan

torch.set_num_threads(2)

# (b, t, c, bottleneck, lengths or None, logit scale)
CASES = {
    "unmasked": (2, 300, 256, 128, None, 1.0),
    "masked": (2, 511, 256, 128, (511, 173), 1.0),
    "k64": (2, 200, 128, 64, (200, 57), 1.0),
    "c200_k40": (3, 150, 200, 40, (150, 90, 1), 1.0),
}


def _setup(b, t, c, k, lengths, scale, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    mask = None if lengths is None else np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    jmod = JaxPool(bottleneck=k, fused_inference=False)
    v = jmod.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), train=False)
    v = jax.tree_util.tree_map(np.array, v)
    v["params"]["att1"]["bias"] = rng.normal(size=(k,)).astype(np.float32) * 0.1
    v["params"]["att2"]["kernel"] = v["params"]["att2"]["kernel"] * np.float32(scale)
    v["params"]["att_bn"]["scale"] = rng.uniform(0.8, 1.2, size=(k,)).astype(np.float32)
    v["batch_stats"]["att_bn"] = {
        "mean": (rng.normal(size=(k,)) * 0.1).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, size=(k,)).astype(np.float32),
    }
    port = EcapaAttentiveStatsPool(c, bottleneck=k).eval()  # inference: att_bn on its running statistics
    load_ecapa_variables(port, v)
    return x, mask, v, port


def _jax_refs(x, mask, v, k, with_kernel=True):
    jm = None if mask is None else jnp.asarray(mask)
    xla = np.asarray(JaxPool(bottleneck=k).apply(v, jnp.asarray(x), train=False, mask=jm))
    if not with_kernel:
        return xla, None
    p, bs = v["params"], v["batch_stats"]
    kern = p["att1"]["kernel"][0]
    d = x.shape[-1]
    inv = 1.0 / np.sqrt(bs["att_bn"]["var"] + 1e-5)
    bn_s = p["att_bn"]["scale"] * inv
    bn_t = p["att_bn"]["bias"] - bs["att_bn"]["mean"] * bn_s
    kernel = np.asarray(jax_fused(
        jnp.asarray(x), kern[:d], kern[d:2 * d], kern[2 * d:], p["att1"]["bias"],
        jnp.asarray(bn_s), jnp.asarray(bn_t), p["att2"]["kernel"][0], p["att2"]["bias"],
        mask=jm, interpret=True))
    return xla, kernel


def _port_outputs(x, mask, port):
    xt = torch.from_numpy(x).to(next(port.parameters()).dtype)
    m = None if mask is None else torch.from_numpy(mask)
    with torch.inference_mode():
        unfused = port(xt, m)
        port.fused_inference = True
        fused = port(xt, m)
        port.fused_inference = False
        d = xt.shape[-1]
        k = port.att1.kernel[0]
        s, t = port.att_bn.folded()
        plain = fused_attentive_stats_pool_plain(
            xt, k[:d], k[d:2 * d], k[2 * d:], port.att1.bias, s, t,
            port.att2.weight[..., 0].t(), port.att2.bias, mask=m)
    return {"plain": plain.float().numpy(), "fused": fused.float().numpy(),
            "unfused": unfused.float().numpy()}


@pytest.fixture(scope="module")
def results():
    """Every case computed once: JAX references and the port's three paths."""
    out = {}
    for name, (b, t, c, k, lengths, scale) in CASES.items():
        x, mask, v, port = _setup(b, t, c, k, lengths, scale)
        # the JAX kernel needs C % 128 == 0: hold the others to the XLA path
        xla, kernel = _jax_refs(x, mask, v, k, with_kernel=c % 128 == 0)
        out[name] = (xla, kernel, _port_outputs(x, mask, port))
    return out


@pytest.mark.parametrize("path", ["plain", "fused", "unfused"])
@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_xla_path(results, case, path):
    xla, _, port = results[case]
    np.testing.assert_allclose(port[path], xla, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("path", ["plain", "fused", "unfused"])
@pytest.mark.parametrize("case", ["unmasked", "masked", "k64"])
def test_matches_jax_kernel(results, case, path):
    _, kernel, port = results[case]
    np.testing.assert_allclose(port[path], kernel, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("path", ["plain", "fused", "unfused"])
def test_bf16_matches_jax(path):
    """Serving configuration: bf16 x and weights on both sides."""
    x, mask, v, port = _setup(2, 300, 256, 128, (300, 140), 1.0, seed=1)
    vb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    jm = jnp.asarray(mask)
    ref = np.asarray(JaxPool().apply(vb, jnp.asarray(x, jnp.bfloat16), train=False, mask=jm), np.float32)
    got = _port_outputs(x, mask, port.to(torch.bfloat16))[path]
    np.testing.assert_allclose(got, ref, atol=0.05, rtol=0.05)


@pytest.mark.parametrize("path", ["plain", "fused", "unfused"])
def test_large_logits_match_xla_path(path):
    """Logits of several hundred: the max-subtracting softmax stays exact
    (the TPU kernel's clamp at 80 would not)."""
    x, mask, v, port = _setup(2, 200, 128, 128, (200, 120), 300.0, seed=2)
    xla, _ = _jax_refs(x, mask, v, 128, with_kernel=False)
    got = _port_outputs(x, mask, port)[path]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, xla, atol=2e-4, rtol=2e-4)


def test_logits_exceed_80_in_large_case():
    x, mask, v, port = _setup(2, 200, 128, 128, (200, 120), 300.0, seed=2)
    xt = torch.from_numpy(x).transpose(1, 2)
    with torch.inference_mode():
        mean, std = xt.mean(-1), xt.std(-1)
        a = port.att2(torch.tanh(port.att_bn(torch.relu(port.att1(xt, mean, std)))))
    assert float(a.abs().max()) > 80


def test_fully_masked_row_gives_floor_std():
    x, _, _, port = _setup(2, 64, 128, 128, None, 1.0)
    mask = np.zeros((2, 64), bool)
    mask[0] = True
    out = _port_outputs(x, mask, port)["plain"]
    np.testing.assert_allclose(out[1], np.r_[np.zeros(128), np.full(128, np.sqrt(1e-5))], atol=1e-7)


def test_wrapper_checks_shapes():
    with pytest.raises(ValueError):
        fused_attentive_stats_pool(torch.zeros(4, 8), *(torch.zeros(1),) * 8)


def _tiled_pool(x, mask, port, tile):
    """The tensor-core kernel's scheme in numpy, f32: the weights
    transposed and zero-padded to the launcher's plan (csrc/launch_plan.h,
    through tests/kernel_plans.py), tiles of `tile` frames, per tile and
    channel the partials (max, sum e, sum e x, sum e x^2) of a softmax taken
    in base 2 over the tile's valid frames (a tile without one: max -inf),
    merged as `combine_kernel` merges them."""
    b, t, c = x.shape
    m = np.ones((b, t), bool) if mask is None else mask
    with torch.inference_mode():
        kern = port.att1.kernel[0]
        wx, wm, ws = (kern[i * c:(i + 1) * c].numpy() for i in range(3))
        w2 = port.att2.weight[..., 0].t()
        w2 = w2.numpy()
        bn_s, bn_t = (v.numpy() for v in port.att_bn.folded())
        b1, b2 = port.att1.bias.numpy(), port.att2.bias.numpy()
    k = wx.shape[1]
    _, plan = att_plan(b, c, t, k, bf16=True)
    kp = plan["kp"]
    wxt = np.zeros((kp, plan["wxt_cols"]), np.float32)
    wxt[:k, :c] = wx.T
    w2t = np.zeros((plan["w2t_rows"], kp), np.float32)
    w2t[:c, :k] = w2.T
    assert wxt.shape[1] % 64 == 0 and w2t.shape[0] % 128 == 0 and not wxt[k:].any() and not w2t[c:].any()
    mf = m.astype(np.float32)[..., None]
    cnt = np.maximum(mf.sum(1), 1.0)
    mean = (x * mf).sum(1) / cnt
    var = ((x * mf * x).sum(1) - cnt * mean * mean) / np.maximum(cnt - 1.0, 1.0)
    std = np.sqrt(np.maximum(var, 0.0) + 1e-5)
    pad = lambda v: np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, kp - k)])
    glob, bn_s, bn_t = pad(mean @ wm + std @ ws + b1), pad(bn_s), pad(bn_t)
    n_tiles = -(-t // tile)
    part = np.zeros((b, n_tiles, 4, c), np.float32)
    log2e = np.float32(1.4426950408889634)
    for j in range(n_tiles):
        fr = slice(j * tile, min(t, (j + 1) * tile))
        u = x[:, fr] @ wxt[:, :c].T + glob[:, None]  # [B, n, KP]
        h = np.tanh(np.maximum(u, 0.0) * bn_s + bn_t)
        a = (h @ w2t[:c].T + b2) * log2e
        valid = m[:, fr][..., None]
        a = np.where(valid, a, -np.inf)
        mx = a.max(1)  # [B, C]
        with np.errstate(invalid="ignore"):
            e = np.where(valid & np.isfinite(mx)[:, None], np.exp2(a - mx[:, None]), 0.0)
        part[:, j] = np.stack([mx / log2e, e.sum(1), (e * x[:, fr]).sum(1), (e * x[:, fr] ** 2).sum(1)], 1)
    mx = part[:, :, 0].max(1)  # [B, C]
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.where(np.isfinite(part[:, :, 0]), np.exp(part[:, :, 0] - mx[:, None]), 0.0)
    s, n1, n2 = ((r * part[:, :, i]).sum(1) for i in (1, 2, 3))
    s = np.maximum(s, 1e-30)
    mean_w = n1 / s
    return np.concatenate([mean_w, np.sqrt(np.maximum(n2 / s - mean_w ** 2, 1e-5))], -1)


# (b, t, c, bottleneck, lengths or None, logit scale)
TILE_CASES = {
    "ragged_tiles": (2, 150, 200, 40, (150, 37), 1.0),        # T and C not multiples of a tile or chunk
    "empty_tiles": (3, 300, 128, 128, (300, 65, 0), 1.0),     # whole tiles without a valid frame, an empty row
    "large_logits": (2, 200, 128, 128, (200, 120), 300.0),    # logits above 80
    "k192": (1, 70, 64, 192, None, 1.0),                      # K padded to 256 units
}


# the kernels' tile (pinned by test_plan_at_the_cells_shapes), and a ragged
# one: the merge holds for any
@pytest.mark.parametrize("tile", [64, 37])
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tensor_core_plan_matches_plain(case, tile):
    b, t, c, k, lengths, scale = TILE_CASES[case]
    x, mask, v, port = _setup(b, t, c, k, lengths, scale, seed=3)
    got = _tiled_pool(x, mask, port, tile)
    plain = _port_outputs(x, mask, port)["plain"]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, plain, atol=2e-4, rtol=2e-4)
    xla, _ = _jax_refs(x, mask, v, k, with_kernel=False)
    if lengths is None or min(lengths) > 0:  # the XLA path gives NaN for a row without valid frames
        np.testing.assert_allclose(got, xla, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("t,tiles", [(798, 13), (1598, 25), (3198, 50)])
def test_plan_at_the_cells_shapes(t, tiles, bf16):
    """The ECAPA cell's pooling (C 1536, K 128, B 128) at its buckets'
    frames: 64-frame tiles, 128 units, Wx^T [128, 1536] and W2^T [1536,
    128] on the tensor cores, and the workspace that holds the scratch
    and those layouts."""
    b, c, k = 128, 1536, 128
    ok, p = att_plan(b, c, t, k, bf16)
    assert ok and (p["tensor"], p["tiles"], p["kp"], p["wxt_cols"], p["w2t_rows"]) == (int(bf16), tiles, 128, 1536,
                                                                                       1536)
    parts = [4 * b * 2 * c, 4 * 4 * b * k, 4 * b * tiles * 4 * c] + ([2 * 128 * 1536, 2 * 1536 * 128] if bf16 else [])
    starts = [p["stats"], p["glob"], p["part"]] + ([p["wxt"], p["w2t"]] if bf16 else [])
    ends = starts[1:] + [p["bytes"]]
    assert starts[0] == 0 and all(s % 256 == 0 and e - s >= n for s, e, n in zip(starts, ends, parts))
    assert p["bytes"] - starts[-1] == parts[-1]


@pytest.mark.parametrize("b,k", [(1, 257), (65536, 128), (0, 128)])
def test_plan_refuses_what_the_kernels_do_not_take(b, k):
    assert att_plan(b, 256, 100, k, True)[0] is False
