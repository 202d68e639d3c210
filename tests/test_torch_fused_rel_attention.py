"""The fused relative-position attention (K5, nn/fused_rel_attention.py)
on the CPU: its plain version against the module's unfused chain in
float32, the zero rows of padded frames, and the module's dispatch, which
takes the kernel only at inference in bf16 or fp16 with the plain
softmax, Dh 64 and a padding-only mask. A CPU tensor stands in for a
card's (``attention._on_card`` patched), so the fused path runs the
kernel's plain version; the kernel itself runs in tests/test_torch_cuda.py.
"""

import pytest
import torch

from asv_subtools_tpu_torch.nn import fused_rel_attention, fused_rel_attention_plain
from asv_subtools_tpu_torch.nn.conformer import (ConformerEncoder, RelPositionMultiHeadedAttention, make_pad_mask,
                                                 position_table)
from asv_subtools_tpu_torch.nn.conformer import attention
from asv_subtools_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _module(dim=128, heads=2, seed=0, dtype=torch.float32, **options):
    torch.manual_seed(seed)
    mod = RelPositionMultiHeadedAttention(dim, heads, **options).eval()
    with torch.no_grad():  # biases away from zero, so that q+u and q+v differ
        mod.pos_bias_u.normal_(0.0, 0.5)
        mod.pos_bias_v.normal_(0.0, 0.5)
    return mod.to(dtype)


def _inputs(b, t, dim, lengths, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, dim), generator=g).to(dtype)
    pad = make_pad_mask(torch.as_tensor(lengths), t)
    return x, pad, pad[:, None, None, :] & pad[:, None, :, None]


def _projections(mod, x):
    t, d = x.shape[1], x.shape[2]
    return mod.qkv(x), mod.pos(position_table(t, d, x.device).to(x.dtype))


# random lengths with a full row and a 1-frame row
CASES = [(3, 37, [37, 1, 20]), (4, 64, [64, 64, 9, 1]), (2, 130, [1, 130]), (5, 71, [71, 1, 44, 70, 2])]


@pytest.mark.parametrize("b,t,lengths", CASES, ids=[f"t{c[1]}" for c in CASES])
@pytest.mark.parametrize("heads", [2, 4])
def test_plain_matches_the_module_chain_in_f32(b, t, lengths, heads):
    mod = _module(64 * heads, heads)
    x, pad, att = _inputs(b, t, 64 * heads, lengths, seed=b + t)
    with torch.no_grad():
        want = mod(x, att)  # on the CPU: the unfused chain
        qkv, p = _projections(mod, x)
        got = mod.project(fused_rel_attention_plain(qkv, p, mod.pos_bias_u, mod.pos_bias_v, heads, pad))
    assert float((got - want).abs().max()) <= 1e-5


def test_plain_matches_the_chain_without_a_mask():
    mod = _module()
    x, _, _ = _inputs(2, 50, 128, [50, 50])
    with torch.no_grad():
        qkv, p = _projections(mod, x)
        got = mod.project(fused_rel_attention_plain(qkv, p, mod.pos_bias_u, mod.pos_bias_v, 2))
        assert float((got - mod(x)).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_padded_rows_are_zero_and_the_cpu_wrapper_is_the_plain_version(dtype):
    mod = _module(dtype=dtype)
    lengths = [40, 1, 17]
    x, pad, _ = _inputs(3, 40, 128, lengths, dtype=dtype)
    with torch.no_grad():
        qkv, p = _projections(mod, x)
        out = fused_rel_attention(qkv, p, mod.pos_bias_u, mod.pos_bias_v, 2, pad)
        plain = fused_rel_attention_plain(qkv, p, mod.pos_bias_u, mod.pos_bias_v, 2, pad)
    assert out.dtype == dtype and out.shape == (3, 40, 128)
    assert torch.equal(out, plain)
    assert bool(torch.isfinite(out).all())
    for row, n in enumerate(lengths):
        assert bool((out[row, n:] == 0).all()) and bool((out[row, :n] != 0).any())


@pytest.fixture
def card(monkeypatch):
    """A CPU tensor stands in for a card's; returns the counts of fused and
    plain calls of the block run under it."""
    monkeypatch.setattr(attention, "_on_card", lambda x: True)

    def counts(run):
        with profiling.tracing():
            run()
            got = profiling.totals()
        return got.get("conformer.attention_fused", 0), got.get("conformer.attention_plain", 0)

    return counts


def test_inference_on_the_card_takes_the_kernel(card):
    mod = _module(dtype=torch.bfloat16)
    x, pad, att = _inputs(3, 40, 128, [40, 1, 17], dtype=torch.bfloat16)
    with torch.inference_mode():
        assert card(lambda: mod(x, att, pad_mask=pad)) == (1, 0)
        assert card(lambda: mod(x)) == (1, 0)  # no mask at all
        fused = mod(x, att, pad_mask=pad)
    with torch.no_grad():
        assert card(lambda: mod(x, att, pad_mask=pad)) == (1, 0)
    mod.requires_grad_(False)
    assert card(lambda: mod(x, att, pad_mask=pad)) == (1, 0)  # grad on, nothing requires it
    chain = mod.float()(x.float(), att)
    # the fused path in bf16 (the kernel's plain version) against the f32 chain
    assert float((fused.float() - chain).abs().max()) <= 5e-2 * float(chain.abs().max())


FALLBACKS = {
    "training": (dict(dropout_rate=0.1), "train"),
    "grad_enabled": ({}, "grad"),
    "chunk_mask": ({}, "no_pad_mask"),
    "extra_score": ({}, "extra"),
    "rel_shift": (dict(rel_shift=True), None),
    "relu_plus": (dict(norm_method="relu_plus"), None),
    "softmax_plus": (dict(norm_method="softmax_plus"), None),
    "scale_adapt": (dict(scale_adapt=True), None),
    "g_sa": (dict(g_sa=True), None),
    "diag_mask": (dict(diag_mask=True), None),
    "float32": ({}, "f32"),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_every_excluded_call_keeps_the_chain(card, case):
    options, how = FALLBACKS[case]
    dtype = torch.float32 if how == "f32" else torch.bfloat16
    mod = _module(dtype=dtype, **options)
    x, pad, att = _inputs(2, 24, 128, [24, 11], dtype=dtype)
    kw = {} if how == "no_pad_mask" else {"pad_mask": pad}
    if how == "extra":
        kw["extra_score"] = torch.zeros((1, 1, 24, 24), dtype=dtype)
    if how == "train":  # active dropout, no gradient
        mod.train()
    if how == "grad":
        assert card(lambda: mod(x, att, **kw)) == (0, 1)
    else:
        with torch.inference_mode():
            assert card(lambda: mod(x, att, **kw)) == (0, 1)


def test_other_head_widths_keep_the_chain(card):
    mod = _module(dim=128, heads=4, dtype=torch.bfloat16)  # Dh 32
    x, pad, att = _inputs(2, 24, 128, [24, 11], dtype=torch.bfloat16)
    with torch.inference_mode():
        assert card(lambda: mod(x, att, pad_mask=pad)) == (0, 1)


def _encoder(**options):
    torch.manual_seed(3)
    return ConformerEncoder(40, attention_dim=128, attention_heads=2, linear_units=64, num_blocks=2,
                            input_layer="conv2d2", **options).eval().to(torch.bfloat16)


@pytest.mark.parametrize("options,fused", [({}, True), ({"static_chunk_size": 4}, False),
                                           ({"use_dynamic_chunk": True}, True)],
                         ids=["padding_only", "static_chunk", "dynamic_chunk_eval"])
def test_the_encoder_hands_the_padding_mask_over_only_without_a_chunk_mask(card, options, fused):
    enc = _encoder(**options)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, 60, 40), generator=g).to(torch.bfloat16)
    mask = make_pad_mask(torch.tensor([60, 33, 9]), 60)
    with torch.inference_mode():
        assert card(lambda: enc(x, mask)) == ((2, 0) if fused else (0, 2))


def test_the_encoder_agrees_fused_and_unfused(card, monkeypatch):
    """The encoder's bf16 output with the fused path (the kernel's plain
    version) against its own chain, both in bf16: the two round at other
    places."""
    enc = _encoder()
    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 60, 40), generator=g).to(torch.bfloat16)
    mask = make_pad_mask(torch.tensor([60, 33, 9]), 60)
    with torch.inference_mode():
        fused, sub = enc(x, mask)
        monkeypatch.setattr(attention, "_on_card", lambda x: False)
        chain, _ = enc(x, mask)
    valid = sub[..., None].expand_as(fused)
    err = (fused.float() - chain.float())[valid].abs().max()
    assert float(err) <= 5e-2 * float(chain.float()[valid].abs().max())
