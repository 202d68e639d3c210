"""The rest of the TDNN layer library against the JAX package's
(asv_subtools_tpu/nn/tdnn.py:384-503, nn/loss.py:384-388): AdaptivePCMN,
SoftmaxAffineLayer, GruAffine, ImportantScale, MultiAffine,
ChunkSeparationAffine, mixup and mixup_loss.

Each layer gets the JAX module's weights through weights.py (randomised
away from flax's init) and the same seeded input: float64 at 1e-10 and
float32 at 1e-5 (one summation order against another), absolute over the
output's scale. JAX's GruAffine runs in float32 only (flax's GRUCell
makes its carry in its param_dtype, float32, and the scan refuses a
float64 carry), so the float64 GRU is held against the same flax cell
built with param_dtype float64; float32 against GruAffine itself. The
port's AdaptivePCMN takes the TDNNs' [B, D, T]; the others act on the
last axis of [B, T, D], as the JAX modules do. mixup and mixup_loss are
held given JAX's lam and index.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.nn import loss as jloss
from asv_subtools_tpu.nn import tdnn as jtdnn
from asv_subtools_tpu_torch.nn import cross_entropy, mixup_loss
from asv_subtools_tpu_torch.nn import tdnn as ptdnn
from asv_subtools_tpu_torch.weights import load_variables, state_dict_to_variables

B, T, D, H = 3, 17, 6, 5


class _F64Gru(fnn.Module):
    """GruAffine's flax cell and scan, with float64 parameters and carry."""

    @fnn.compact
    def __call__(self, x):
        return fnn.RNN(fnn.GRUCell(H, param_dtype=jnp.float64, name="cell"), name="rnn")(x)


# name -> (JAX module, port module, port layout [B, D, T])
LAYERS = {
    "adaptive_pcmn": (lambda: jtdnn.AdaptivePCMN(), lambda: ptdnn.AdaptivePCMN(D), True),
    "softmax_affine_log": (lambda: jtdnn.SoftmaxAffineLayer(H), lambda: ptdnn.SoftmaxAffineLayer(D, H), False),
    "softmax_affine": (lambda: jtdnn.SoftmaxAffineLayer(H, log=False),
                       lambda: ptdnn.SoftmaxAffineLayer(D, H, log=False), False),
    "gru_affine": (lambda: jtdnn.GruAffine(H), lambda: ptdnn.GruAffine(D, H), False),
    "important_scale": (lambda: jtdnn.ImportantScale(), lambda: ptdnn.ImportantScale(D), False),
    "multi_affine": (lambda: jtdnn.MultiAffine(H, num_affine=3), lambda: ptdnn.MultiAffine(D, H, num_affine=3), False),
    "multi_affine_linear": (lambda: jtdnn.MultiAffine(H, activation=None),
                            lambda: ptdnn.MultiAffine(D, H, activation=None), False),
    "chunk_separation": (lambda: jtdnn.ChunkSeparationAffine(H), lambda: ptdnn.ChunkSeparationAffine(D, H), False),
}


def _variables(module, x, seed):
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64) + 0.2 * rng.normal(size=a.shape), v)


# T = 17 is odd; an even T as well where the layer splits or windows the time axis
CASES = [(n, d, T) for n in LAYERS for d in ("float64", "float32")] + [
    (n, d, 16) for n in ("adaptive_pcmn", "chunk_separation") for d in ("float64", "float32")]


@pytest.mark.parametrize("name,dtype,t", CASES)
def test_layer_matches_jax(name, dtype, t):
    make_jax, make_port, tdnn_layout = LAYERS[name]
    x = np.random.default_rng(1).normal(size=(B, t, D))
    jm = _F64Gru() if (name == "gru_affine" and dtype == "float64") else make_jax()
    v = _variables(jm, x, seed=2)
    with jax.enable_x64(dtype == "float64"):
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v)
        ref = np.asarray(jm.apply(jv, jnp.asarray(x, dtype)), np.float64)
    port = make_port().to(getattr(torch, dtype))
    load_variables(port, v)
    xin = torch.as_tensor(x.transpose(0, 2, 1) if tdnn_layout else x, dtype=getattr(torch, dtype))
    with torch.no_grad():
        got = port(xin).double().numpy()
    if tdnn_layout:
        got = got.transpose(0, 2, 1)
    assert got.shape == ref.shape
    tol = 1e-10 if dtype == "float64" else 1e-5
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1.0), np.abs(got - ref).max()


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_weights_round_trip(name):
    """The port's state_dict -> JAX's variable tree -> the port, bit for bit,
    and the tree has JAX's leaves and shapes."""
    make_jax, make_port, _ = LAYERS[name]
    x = np.zeros((B, T, D))
    v = _variables(make_jax(), x, seed=3)
    port = load_variables(make_port().double(), v)
    back = state_dict_to_variables(port.state_dict())
    flat = lambda t: {jax.tree_util.keystr(k): a for k, a in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(back), flat({"params": v["params"], "batch_stats": {}})
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_gru_has_no_hidden_bias_on_r_and_z():
    """torch's GRU would add a trainable hidden bias to the r and z gates;
    the port's cell has only flax's leaves, and a gradient reaches each."""
    gru = ptdnn.GruAffine(D, H).double()
    names = {k for k, _ in gru.named_parameters()}
    assert names == {"cell.ir.weight", "cell.ir.bias", "cell.iz.weight", "cell.iz.bias", "cell.in.weight",
                     "cell.in.bias", "cell.hr.weight", "cell.hz.weight", "cell.hn.weight", "cell.hn.bias"}
    gru(torch.randn(B, T, D, dtype=torch.float64)).sum().backward()
    assert all(float(p.grad.abs().sum()) > 0 for p in gru.parameters())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mixup_and_mixup_loss_match_jax(monkeypatch, dtype):
    """Given JAX's lam and index (through the draw the port's mixup goes
    through), the mixed batch and the mixed loss equal JAX's."""
    x = np.random.default_rng(4).normal(size=(B, T, D))
    with jax.enable_x64(dtype == "float64"):
        ref, lam, index = jtdnn.mixup(jnp.asarray(x, dtype), jax.random.PRNGKey(5), 0.4)
        lam, index = float(lam), np.array(index)
        logits = np.random.default_rng(6).normal(size=(B, 7))
        targets = np.array([1, 6, 3])
        jce = lambda lg, t: jnp.mean(-jnp.take_along_axis(jax.nn.log_softmax(lg), t[:, None], -1))
        ref_loss = float(jloss.mixup_loss(jce, jnp.asarray(logits, dtype), jnp.asarray(targets), lam,
                                          jnp.asarray(index)))
    seen = []

    def draw(batch, alpha, generator, device, dt):
        seen.append((batch, alpha))
        return torch.tensor(lam, dtype=dt), torch.as_tensor(index)

    monkeypatch.setattr(ptdnn, "mixup_draw", draw)
    tdt = getattr(torch, dtype)
    got, plam, pindex = ptdnn.mixup(torch.as_tensor(x, dtype=tdt), torch.Generator().manual_seed(0), 0.4)
    assert seen == [(B, 0.4)] and got.dtype == tdt
    tol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    loss = mixup_loss(cross_entropy, torch.as_tensor(logits, dtype=tdt), torch.as_tensor(targets), plam, pindex)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=tol)


def test_mixup_draw_is_seeded_beta_and_a_permutation():
    """lam in (0, 1) from Beta(alpha, alpha) (the mean of many draws at
    alpha 2 near 1/2, their variance near 1/20), the index a permutation,
    the same seed the same draw; bf16 input mixes in f32 and comes back
    bf16. JAX's mixup returns f32 for bf16 input (an f32 lam promotes it),
    so its train step's forward runs in f32 under mixup; the port keeps
    the compute type (a difference on purpose, ROADMAP Queue 3)."""
    lams = []
    gen = torch.Generator().manual_seed(7)
    for _ in range(2000):
        lam, index = ptdnn.mixup_draw(8, 2.0, gen, torch.device("cpu"), torch.float32)
        assert lam.dim() == 0 and sorted(index.tolist()) == list(range(8))
        lams.append(float(lam))
    lams = np.array(lams)
    assert (lams > 0).all() and (lams < 1).all()
    assert abs(lams.mean() - 0.5) < 0.02 and abs(lams.var() - 0.05) < 0.01
    a = ptdnn.mixup(torch.ones(4, 3, dtype=torch.bfloat16), torch.Generator().manual_seed(1), 1.0)
    b = ptdnn.mixup(torch.ones(4, 3, dtype=torch.bfloat16), torch.Generator().manual_seed(1), 1.0)
    assert a[0].dtype == torch.bfloat16 and a[1].dtype == torch.float32
    assert jtdnn.mixup(jnp.ones((4, 3), jnp.bfloat16), jax.random.PRNGKey(1))[0].dtype == jnp.float32
    assert float(a[1]) == float(b[1]) and torch.equal(a[2], b[2])
