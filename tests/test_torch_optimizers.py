"""The reference's own optimizers and the lookahead wrapper against the
JAX package's (asv_subtools_tpu/train/optim.py): ralamb, adamod,
novograd, eve, and lookahead over sgd and adamod at k=3.

The same 10 seeded gradients go through the port's get_optimizer and
JAX's (optax) from the same parameters; after every step the parameters
agree within 1e-10 of their scale in float64 (with a schedule and with a
constant rate) and 1e-6 in float32 (with a schedule), with weight decay
on and off. The
leaves include a 0-dim and a one-element one (eve clamps those). Two
quirks of JAX's kept: the four read the schedule at the advanced count,
and they take no decay_kernels_only mask. Gradient centralisation, which
depends on each leaf's layout, and the train states are in
tests/test_torch_optimizer_states.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asv_subtools_tpu.train import lr_scheduler as jax_sched
from asv_subtools_tpu.train.optim import get_optimizer as jax_get_optimizer
from asv_subtools_tpu_torch.train import get_optimizer
from asv_subtools_tpu_torch.train import lr_scheduler as port_sched

SHAPES = {"conv.weight": (5, 3, 4), "fc.weight": (4, 6), "fc.bias": (6,), "bn.scale": (6,), "norm.eps": (),
          "gate.scale": (1,)}
SCHEDULE = dict(base_lr=1e-3, max_lr=0.1, step_size_up=3)
NEW = {
    "ralamb": dict(name="ralamb"),
    "adamod": dict(name="adamod"),
    "novograd": dict(name="novograd"),
    "eve": dict(name="eve"),
    "lookahead_sgd": dict(name="sgd", lookahead=True, lookahead_k=3),
    "lookahead_adamod": dict(name="adamod", lookahead=True, lookahead_k=3, lookahead_alpha=0.3),
}


def _grads(shapes, seed, steps=10):
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(size=s) * 10 ** rng.uniform(-3, 1) for k, s in shapes.items()} for _ in range(steps)]


def _jax_run(kw, lr, params, grads, dtype):
    """JAX's parameters after each update of ``grads`` (flat dicts or trees)."""
    with jax.enable_x64(dtype == "float64"):
        tx = jax_get_optimizer(learning_rate=jax_sched.cyclic(**SCHEDULE) if lr == "schedule" else 0.01, **kw)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
        p = cast(params)
        s = tx.init(p)
        # float64 jitted (fast); float32 op by op, as the port's eager ops
        # round: XLA's fusion moves an f32 leaf of one element by 1.1e-6
        update = jax.jit(tx.update) if dtype == "float64" else tx.update
        out = []
        for g in grads:
            u, s = update(cast(g), s, p)
            p = optax.apply_updates(p, u)
            out.append(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), p))
    return out


def _port_run(kw, lr, params, grads, dtype):
    tx = get_optimizer(learning_rate=port_sched.cyclic(**SCHEDULE) if lr == "schedule" else 0.01, **kw)
    cast = lambda d: {k: torch.as_tensor(np.asarray(v), dtype=getattr(torch, dtype)) for k, v in d.items()}
    p = cast(params)
    s = tx.init(p)
    out = []
    for g in grads:
        u, s = tx.update(cast(g), s, p)
        p = {k: p[k] + u[k] for k in p}
        out.append({k: v.double().numpy() for k, v in p.items()})
    return out, s


def _assert_close(got, ref, tol, what):
    for k in ref:
        err = np.abs(got[k] - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-300)
        assert err <= tol, f"{what} {k}: {err:.3e} of its scale"


# float64 at a constant rate and on a schedule; float32 on the schedule
# (JAX's f32 reference runs op by op, the slow part of this file)
CASES = [(n, d, lr, wd) for n in NEW for d, lr in (("float64", "float"), ("float64", "schedule"),
                                                     ("float32", "schedule")) for wd in (0.0, 0.05)]


@pytest.mark.parametrize("name,dtype,lr,weight_decay", CASES)
def test_trajectory_matches_jax(name, dtype, lr, weight_decay):
    kw = dict(NEW[name], weight_decay=weight_decay)
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s) for k, s in SHAPES.items()}
    params["norm.eps"] = np.asarray(1.5)  # eve's clamp to [-10, 2] engages
    grads = _grads(SHAPES, 1)
    ref = _jax_run(kw, lr, params, grads, dtype)
    got, state = _port_run(kw, lr, params, grads, dtype)
    for i in range(len(grads)):
        _assert_close(got[i], ref[i], 1e-10 if dtype == "float64" else 1e-6, f"step {i}")
    assert int(state["count"]) == len(grads)


@pytest.mark.parametrize("name,reads", [("ralamb", 1), ("adamod", 1), ("novograd", 1), ("eve", 1), ("adamW", 0),
                                        ("sgd", 0)])
def test_schedule_count_the_optimizer_reads(name, reads):
    """A quirk kept from JAX: its four own optimizers read the schedule at
    the advanced count (optim.py:71,121,188,237), optax's built-ins (and
    the port's sgd and adam) before it advances."""
    seen = {"port": [], "jax": []}

    def schedule(side):
        def fn(count):
            seen[side].append(int(count))
            return 0.01
        return fn

    params = {"w": np.ones((2, 3))}
    grads = {"w": np.full((2, 3), 0.5)}
    tx = get_optimizer(name, schedule("port"))
    tx.update({k: torch.as_tensor(v) for k, v in grads.items()}, tx.init({"w": torch.ones(2, 3, dtype=torch.float64)}),
              {"w": torch.ones(2, 3, dtype=torch.float64)})
    with jax.enable_x64():
        jtx = jax_get_optimizer(name, schedule("jax"))
        jp = {"w": jnp.asarray(params["w"])}
        jtx.update({"w": jnp.asarray(grads["w"])}, jtx.init(jp), jp)
    assert seen["port"] == seen["jax"] == [reads]


@pytest.mark.parametrize("name", ["ralamb", "adamod", "novograd", "eve"])
def test_decay_kernels_only_is_ignored_by_the_reference_optimizers(name):
    """A quirk kept from JAX: its factory hands these four no weight-decay
    mask (optim.py:321-331), so decay_kernels_only changes nothing; on
    adamW it does."""
    rng = np.random.default_rng(4)
    params = {k: rng.normal(size=s) for k, s in SHAPES.items()}
    grads = _grads(SHAPES, 5, steps=3)
    for kw in (dict(name=name, weight_decay=0.05), dict(name="adamW", weight_decay=0.05)):
        on, _ = _port_run(dict(kw, decay_kernels_only=True), "float", params, grads, "float64")
        off, _ = _port_run(kw, "float", params, grads, "float64")
        ref = _jax_run(dict(kw, decay_kernels_only=True), "float", params, grads, "float64")
        _assert_close(on[-1], ref[-1], 1e-10, kw["name"])
        same = all(np.array_equal(on[-1][k], off[-1][k]) for k in params)
        assert same == (kw["name"] != "adamW")


