"""Dynamic int8 serving products against JAX's.

``dynamic_int8_dot`` against JAX's ``nn/int8.py`` (exact .5 roundings
included, f32 1e-6), the int32 product exact, the layers' ``int8_compute``
rule, and ``EcapaTdnn(int8_inference=True)`` against JAX's on the same
weights at narrow width (f32 1e-5; one JAX jit). Train mode takes the float
path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.models import EcapaTdnn as JaxEcapa
from asv_subtools_tpu.nn.int8 import dynamic_int8_dot as jax_int8_dot
from asv_subtools_tpu_torch.models import EcapaTdnn
from asv_subtools_tpu_torch.nn.int8 import dynamic_int8_dot, int8_matmul, quantize_rows
from asv_subtools_tpu_torch.nn.tdnn import TdnnAffine
from asv_subtools_tpu_torch.weights import init_weights_, state_dict_to_variables

torch.set_num_threads(2)

NARROW = dict(channels=32, mfa_conv=48, embd_dim=16)
F_IN = 24


def _halves():
    """x and w whose scales are exactly 1 (row / column max 127), so that
    x / scale lands on exact .5 values: round half to even on both sides."""
    x = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 4.5, -126.5],
                  [-127.0, 5.5, 6.5, -7.5, 0.0, 3.0, -2.5, 100.5]], np.float32)
    w = np.array([[127.0, 0.5, -1.5], [2.5, -127.0, 3.5], [-0.5, 1.5, 127.0], [4.5, -2.5, 0.5],
                  [1.0, 1.0, 1.0], [-6.5, 7.5, -8.5], [0.5, 0.5, -0.5], [9.5, -10.5, 11.5]], np.float32)
    return x, w  # JAX's w is [in, out]


def test_rounding_is_half_to_even():
    x, _ = _halves()
    q, scale = quantize_rows(torch.from_numpy(x), 1e-8)
    assert torch.equal(scale, torch.ones(2, 1))
    assert q[0].tolist() == [127, 2, -4, 0, 0, 2, 4, -126]
    assert q[1].tolist() == [-127, 6, 6, -8, 0, 3, -2, 100]


@pytest.mark.parametrize("case", ["halves", "random", "random_bias", "zero_rows"])
def test_dynamic_int8_dot_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "halves":
        x, w = _halves()
        bias = None
    else:
        x = rng.normal(size=(3, 20, 40)).astype(np.float32)
        w = (rng.normal(size=(40, 24)) * 0.1).astype(np.float32)
        bias = rng.normal(size=(24,)).astype(np.float32) if case == "random_bias" else None
        if case == "zero_rows":
            x[1, 3:9] = 0.0  # max|x| below the floor: the row's scale is 1e-8 / 127
            w[:, 5] = 0.0
    want = np.asarray(jax_int8_dot(jnp.asarray(x), jnp.asarray(w), None if bias is None else jnp.asarray(bias)))
    got = dynamic_int8_dot(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                           None if bias is None else torch.from_numpy(bias))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_int8_matmul_is_exact_int32():
    rng = np.random.default_rng(1)
    a = rng.integers(-127, 128, size=(40, 3072)).astype(np.int8)
    b = rng.integers(-127, 128, size=(24, 3072)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)
    with pytest.raises(ValueError, match="int8 operands"):
        int8_matmul(torch.from_numpy(a).float(), torch.from_numpy(b))


def test_tdnn_int8_compute_only_for_a_1x1_conv_in_eval():
    torch.manual_seed(0)
    x = torch.randn(2, 16, 30)
    one = TdnnAffine(16, 8, int8_compute=True).eval()
    want = dynamic_int8_dot(x.transpose(1, 2), one.conv.weight[:, :, 0], one.conv.bias).transpose(1, 2)
    assert torch.equal(one(x), want)
    assert not torch.equal(one.train()(x), want)  # train mode: the float conv
    wide = TdnnAffine(16, 8, context=(-1, 0, 1), int8_compute=True).eval()
    ref = TdnnAffine(16, 8, context=(-1, 0, 1)).eval()
    ref.load_state_dict(wide.state_dict())
    assert torch.equal(wide(x), ref(x))
    half = one.eval().to(torch.bfloat16)(x.bfloat16())
    assert half.dtype == torch.bfloat16  # cast back to x's type


@pytest.fixture(scope="module")
def narrow_ecapa():
    port = init_weights_(EcapaTdnn(input_dim=F_IN, device="cpu", **NARROW), seed=3)
    rng = np.random.default_rng(3)
    with torch.no_grad():  # non-trivial BN statistics
        for name, buf in port.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.from_numpy(rng.normal(size=buf.shape).astype(np.float32) * 0.1))
            elif name.endswith(".var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, size=buf.shape).astype(np.float32)))
    jmodel = JaxEcapa(int8_inference=True, **NARROW)
    fn = jax.jit(lambda v, x, m: jmodel.apply(v, x, mask=m, train=False))
    return port, state_dict_to_variables(port.state_dict()), fn


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 70, F_IN)).astype(np.float32)
    mask = np.arange(70)[None, :] < np.asarray([70, 52, 19])[:, None]
    return x, mask


@pytest.mark.parametrize("fused", [False, True])
def test_int8_ecapa_matches_jax(narrow_ecapa, fused):
    port, variables, fn = narrow_ecapa
    x, mask = _batch()
    want = np.asarray(fn(variables, jnp.asarray(x), jnp.asarray(mask)))
    q = EcapaTdnn(input_dim=F_IN, int8_inference=True, device="cpu", **NARROW)
    q.load_state_dict(port.state_dict())
    for blk in (q.layer2, q.layer3, q.layer4):
        blk.res2net.fused_inference = fused
    q.stats.fused_inference = fused
    with torch.inference_mode():
        got = q(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        plain = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    cos = (got * plain).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(plain, axis=-1))
    assert cos.min() >= 0.999, cos
    assert not np.array_equal(got, plain)  # the int8 products ran


def test_int8_flag_is_inert_in_train_mode(narrow_ecapa):
    port, _, _ = narrow_ecapa
    q = EcapaTdnn(input_dim=F_IN, int8_inference=True, device="cpu", **NARROW)
    f = EcapaTdnn(input_dim=F_IN, device="cpu", **NARROW)
    q.load_state_dict(port.state_dict())
    f.load_state_dict(port.state_dict())
    x, mask = _batch(5)
    xq, xf = torch.from_numpy(x), torch.from_numpy(x)
    out_q, out_f = q.train()(xq, torch.from_numpy(mask)), f.train()(xf, torch.from_numpy(mask))
    assert torch.equal(out_q, out_f)
    out_q.square().sum().backward()
    g = q.layer2.conv1.affine.conv.weight.grad
    assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
