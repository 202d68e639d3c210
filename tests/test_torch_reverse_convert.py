"""Reverse conversion (the port's state_dict -> ASV-Subtools) against JAX's
ReverseConverter, family by family.

The reference-format state_dicts come from test_torch_convert.py's
``reference_state_dict``. The port's weights are the converted ones moved
by a seeded perturbation (as weights trained here would be); JAX's
ReverseConverter gets the same weights as a JAX tree
(``weights.state_dict_to_variables``). The two exports must be equal key
for key, dtype for dtype and bit for bit, and so must ``uncovered``. All
numpy: no JAX jit.
"""

import numpy as np
import pytest
import torch

from asv_subtools_tpu import reverse_convert as jrev
from asv_subtools_tpu_torch import reverse_convert as rev
from asv_subtools_tpu_torch.weights import state_dict_to_variables
from test_torch_convert import FAMILIES, _family, assert_state_dicts_equal

torch.set_num_threads(2)


def _moved(state_dict, seed=1):
    """The converted weights moved off the reference's values."""
    gen = torch.Generator().manual_seed(seed)
    return {k: v + 0.01 * torch.randn(v.shape, generator=gen).to(v.dtype) for k, v in state_dict.items()}


def _freeze(name):
    return (lambda k: k.endswith("_scale")) if name == "reconformer" else None


def _exports(name):
    _, sd, port_convert, jax_convert = _family(name)
    weights = _moved(port_convert(sd))
    variables = state_dict_to_variables(weights)
    want_rc = jrev.ReverseConverter(jax_convert, sd, freeze=_freeze(name))
    got_rc = rev.ReverseConverter(port_convert, sd, freeze=_freeze(name))
    return sd, weights, port_convert, got_rc, got_rc(weights), want_rc, want_rc(variables["params"],
                                                                                 variables["batch_stats"])


@pytest.mark.parametrize("name", FAMILIES)
def test_reverse_matches_jax_bit_for_bit(name):
    sd, weights, port_convert, got_rc, got, want_rc, want = _exports(name)
    assert_state_dicts_equal(got, want)
    assert got_rc.uncovered == want_rc.uncovered
    assert got_rc.shared == want_rc.shared == {}
    # the export converts forward to the same weights
    back = port_convert({k: v.reshape(sd[k].shape) for k, v in got.items()})
    assert_state_dicts_equal(back, weights)


def test_uncovered_are_the_masked_taps_and_the_batch_counters():
    sd, _, _, got_rc, got, _, _ = _exports("ecapa")
    h = sd["layer2.res2net_block.blocks.0.affine.weight"].shape[0]
    masked = {f"layer{li}.res2net_block.blocks.{b}.affine.weight": h * h * (2 * li + 1 - 3)
              for li in (2, 3, 4) for b in range(7)}
    counters = {k: 1 for k in sd if k.endswith("num_batches_tracked")}
    assert got_rc.uncovered == {**masked, **counters, "loss.weight": sd["loss.weight"].numel()}
    w = got["layer3.res2net_block.blocks.4.affine.weight"]
    assert torch.count_nonzero(w[:, :, [1, 2, 4, 5]]) == 0 and torch.count_nonzero(w[:, :, [0, 3, 6]]) > 0


def test_reconformer_exports_folded_weights_with_zero_scales():
    sd, weights, _, _, got, _, _ = _exports("reconformer")
    scales = [k for k in sd if k.endswith("_scale")]
    assert scales and all(torch.count_nonzero(got[k]) == 0 for k in scales)
    assert torch.equal(got["transformer.encoders.0.feed_forward.w_1.weight"],
                       weights["transformer.block_0.ff.w1.weight"])


def test_folding_without_freeze_raises():
    _, sd, port_convert, _ = _family("reconformer")
    with pytest.raises(ValueError, match="not a pure reindexing"):
        rev.ReverseConverter(port_convert, sd)


def test_tied_positions_warn_and_are_counted():
    _, sd, port_convert, _ = _family("ecapa")

    def tied(s):
        out = port_convert(s)
        out["tied.weight"] = out["layer1.affine.conv.weight"].clone()
        return out

    with pytest.warns(UserWarning, match="weight tying"):
        rc = rev.ReverseConverter(tied, sd)
    with pytest.warns(UserWarning, match="weight tying"):
        jrc = jrev.ReverseConverter(_jax_tied, sd)
    assert rc.shared == jrc.shared == {"layer1.affine.weight": sd["layer1.affine.weight"].numel()}


def _jax_tied(s):
    from asv_subtools_tpu.convert import convert_ecapa_state_dict

    params, stats = convert_ecapa_state_dict(s)
    params["tied"] = {"kernel": params["layer1"]["affine"]["conv"]["kernel"].copy()}
    return params, stats


def test_a_varying_structure_raises():
    _, sd, port_convert, _ = _family("ecapa")
    calls = []

    def varying(s):
        calls.append(1)
        out = port_convert(s)
        if len(calls) > 1:
            out.pop("fc2_bn.var")
        return out

    with pytest.raises(ValueError, match="structure varied"):
        rev.ReverseConverter(varying, sd)


def test_a_missing_leaf_raises_key_error():
    _, sd, port_convert, _ = _family("ecapa")
    weights = port_convert(sd)
    weights.pop("mfa.act_bn.bn.mean")
    with pytest.raises(KeyError, match="mfa.act_bn.bn.mean"):
        rev.ReverseConverter(port_convert, sd)(weights)


def test_export_to_reference_with_the_margin_head_matches_jax():
    _, sd, port_convert, jax_convert = _family("ecapa")
    weights = _moved(port_convert(sd))
    loss_w = torch.from_numpy(np.random.default_rng(5).normal(size=(11, 8)).astype(np.float32))
    got = rev.export_to_reference(weights, port_convert, sd, loss_state={"loss.weight": loss_w},
                                  loss_reverse=rev.margin_loss_reverse)
    v = state_dict_to_variables(weights)
    want = jrev.export_to_reference(v["params"], v["batch_stats"], jax_convert, sd,
                                    loss_tree={"loss": {"weight": loss_w.numpy()}},
                                    loss_reverse=jrev.margin_loss_reverse)
    assert_state_dicts_equal(got, want)
    assert tuple(got["loss.weight"].shape) == (11, 8, 1)

