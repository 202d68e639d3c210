"""Gradient centralisation (gc) on real nets' weights and the train states
of the reference's own optimizers, against the JAX package's.

gc subtracts each gradient's mean over every axis but its output axis,
which the port's layout moves: it is held, over 10 adamW steps on a
schedule, on the weights of a small ECAPA-TDNN (whose pooling's
_SplitGlobalConv kernel keeps JAX's [1, 3C, K]) and of a small Conformer
(whose pos_bias_u/v keep [H, Dh]), carried both ways by weights.py's
rules, at 1e-10 of each leaf's scale in float64 (the weights are the
port nets' seeded ones in JAX's layout: no JAX init is compiled). A JAX train state on
each new optimizer (and on gc and lookahead around them) of a small
SnowdarXvector loads into the port, round-trips bit for bit, and one
more update from it equals JAX's at 1e-10; novograd's per-leaf scalar
second moments map by their parameters' names and raise on a leaf no
rule takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.train.optim import get_optimizer as jax_get_optimizer
from asv_subtools_tpu_torch.models import ConformerXvector, SpeakerNet
from asv_subtools_tpu_torch.train import get_optimizer
from asv_subtools_tpu_torch.weights import (init_weights_, state_dict_to_variables, train_state_from_variables,
                                            train_state_to_variables, variables_to_state_dict)
from test_torch_optimizers import _assert_close, _jax_run, _port_run
from test_torch_train_step import AAM, C, D, _randomize, port_net
from test_torch_xvector import _nets


def _flat(tree):
    return variables_to_state_dict({"params": tree})


def port_variables(net, seed=0):
    """The JAX-layout f64 variables of a port net's seeded weights (weights.py
    carries them; their JAX trees are held bit for bit in the model
    tests), with biases, BN affines and running statistics randomised as
    test_torch_train_step's init_variables does: a JAX net of the same
    configuration takes them as they are, with no JAX init to compile."""
    v = state_dict_to_variables(init_weights_(net, seed).double().state_dict())
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float64), v)
    _randomize(v, np.random.default_rng(seed))
    return v


@pytest.fixture(scope="module")
def net_params():
    conformer = SpeakerNet(ConformerXvector(D, num_blocks=1, attention_dim=32, attention_heads=2, linear_units=64,
                                            embd_dim=16, out_dim=48, device="cpu"), AAM[0], AAM[1], num_targets=C)
    return {"ecapa": port_variables(port_net())["params"], "conformer": port_variables(conformer)["params"]}


@pytest.fixture(scope="module")
def snowdar():
    """(a maker of the port's net, its variables) of a small SnowdarXvector."""
    make = lambda: _nets("snowdar")[1]
    return make, port_variables(make())


@pytest.mark.parametrize("family", ["ecapa", "conformer"])
def test_gc_on_a_net_matches_jax(net_params, family):
    """adamW with gc on a net's weights: the port's leaves in its layout
    (weights.py), each centralised over every axis but its output axis."""
    params = net_params[family]
    if family == "ecapa":  # _SplitGlobalConv's [1, 3C, K]
        att = params["backbone"]["stats"]
        assert att["att1"]["kernel"].shape[1] == 3 * att["att2"]["kernel"].shape[2]
    else:
        assert params["backbone"]["transformer"]["block_0"]["self_attn"]["pos_bias_u"].shape == (2, 16)
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape), params) for _ in range(10)]
    kw = dict(name="adamW", gc=True, weight_decay=0.05)
    ref = _jax_run(kw, "schedule", params, grads, "float64")
    got, state = _port_run(kw, "schedule", _flat(params), [_flat(g) for g in grads], "float64")
    for i in range(len(grads)):
        _assert_close(got[i], {k: v.numpy() for k, v in _flat(ref[i]).items()}, 1e-10, f"step {i}")
    assert state[0] == {} and int(state[1]["count"]) == 10
    # centralising is not a no-op: the same run without gc differs
    plain, _ = _port_run(dict(kw, gc=False), "schedule", _flat(params), [_flat(g) for g in grads], "float64")
    assert max(np.abs(plain[-1][k] - got[-1][k]).max() for k in got[-1]) > 1e-6


def _literal(state):
    """An optax state as the numpy trees weights.py reads: a NamedTuple as
    the dict of its fields (``inner`` a state again), an EmptyState as {},
    a chain as a tuple."""
    if isinstance(state, optax.EmptyState):
        return {}
    if hasattr(state, "_fields"):
        return {f: _literal(v) if f == "inner" else jax.tree_util.tree_map(np.asarray, v)
                for f, v in zip(state._fields, state)}
    return tuple(_literal(s) for s in state)


STATES = {
    "ralamb": dict(name="ralamb", weight_decay=0.01),
    "adamod": dict(name="adamod"),
    "novograd": dict(name="novograd", weight_decay=0.01),
    "eve": dict(name="eve"),
    "gc_ralamb": dict(name="ralamb", gc=True),
    "lookahead_eve": dict(name="eve", lookahead=True, lookahead_k=2),
    "gc_lookahead_novograd": dict(name="novograd", gc=True, lookahead=True, lookahead_k=2),
}


@pytest.mark.parametrize("name", list(STATES))
def test_train_state_round_trip_and_next_update(snowdar, name):
    """A JAX train state after two updates -> the port (every leaf
    consumed) -> back, bit for bit and type for type; the third update
    from the loaded state equals JAX's."""
    make_port, variables = snowdar
    params = variables["params"]
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape), params) for _ in range(3)]
    with jax.enable_x64():
        tx = jax_get_optimizer(learning_rate=0.01, **STATES[name])
        p = jax.tree_util.tree_map(jnp.asarray, params)
        s = tx.init(p)
        update = jax.jit(tx.update)
        for g in grads[:2]:
            u, s = update(jax.tree_util.tree_map(jnp.asarray, g), s, p)
            p = optax.apply_updates(p, u)
        tree = {"step": np.asarray(2, np.int32), "params": jax.tree_util.tree_map(np.asarray, p),
                "batch_stats": variables["batch_stats"], "opt_state": _literal(s)}
        u, _ = update(jax.tree_util.tree_map(jnp.asarray, grads[2]), s, p)
        ref = state_dict_to_variables({k: torch.as_tensor(np.asarray(v))
                                       for k, v in _flat(optax.apply_updates(p, u)).items()})["params"]
    state = train_state_from_variables(make_port(), tree, device="cpu")
    back = train_state_to_variables(state)
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(back), flat(tree)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
    ptx = get_optimizer(learning_rate=0.01, **STATES[name])
    u, _ = ptx.update({k: torch.as_tensor(np.asarray(v)) for k, v in _flat(grads[2]).items()}, state.opt_state,
                      state.params)
    got = {k: (state.params[k] + u[k]).numpy() for k in state.params}
    _assert_close(got, {k: v.numpy() for k, v in _flat(ref).items()}, 1e-10, name)


@pytest.mark.parametrize("fault", ["missing scalar", "extra scalar", "scalar of a buffer"])
def test_novograd_state_raises_on_unconsumed_or_missing_leaves(snowdar, fault):
    make_port, variables = snowdar
    params = variables["params"]
    nu = jax.tree_util.tree_map(lambda a: np.asarray(0.5), params)
    if fault == "missing scalar":
        del nu["backbone"]["tdnn7_affine"]["bias"]
    elif fault == "extra scalar":
        nu["backbone"]["tdnn7_affine"]["extra"] = np.asarray(1.0)
    else:
        nu["backbone"]["tdnn5"]["act_bn"] = {"bn": {"mean": np.asarray(1.0)}}
    tree = {"step": 0, "params": params, "batch_stats": variables["batch_stats"],
            "opt_state": {"count": 0, "mu": params, "nu": nu}}
    with pytest.raises(ValueError):
        train_state_from_variables(make_port(), tree, device="cpu")
