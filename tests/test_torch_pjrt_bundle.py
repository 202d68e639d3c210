"""Native-runtime bundles (export.py export_pjrt_bundle /
export_pjrt_embed_bundles) against JAX's.

On the CPU: on JAX's two format cases (``x @ w`` with w baked; a bf16
leaf and a pred leaf, tests/test_pjrt_bundle.py:38-82) the port's bundle
writes the same ``arg`` and ``params`` lines and the same params.bin,
byte for byte; the header and the ``package`` line are the port's. The
bf16 and int8 feature wires declare JAX's argument layouts, and the int8
package, fed JAX's C++-style quantization, reaches cosine 0.999 against
JAX's f32 embedding. The schema literals of runtime/ops.cc equal the
Python ops' schemas as strings. This file compiles four AOTInductor
packages (about 15 s each here); the f32 embed bundles, the C++ build
and the binaries are in tests/test_torch_native_runtime.py.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu.export import export_pjrt_bundle as jax_export_pjrt_bundle
from asv_subtools_tpu.models import SpeakerNet as JaxSpeakerNet
from asv_subtools_tpu.models import Xvector as JaxXvector
from asv_subtools_tpu_torch.export import BUNDLE_HEADER, PACKAGE_FILE, export_pjrt_bundle, export_pjrt_embed_bundles
from asv_subtools_tpu_torch.models import SpeakerNet, Xvector
from asv_subtools_tpu_torch.weights import init_weights_, state_dict_to_variables

torch.set_num_threads(2)

OPS_CC = os.path.join(os.path.dirname(__file__), "..", "asv_subtools_tpu_torch", "runtime", "ops.cc")


def parse_manifest(path):
    """(file lines, arg tuples) of a manifest, as JAX's test parses it."""
    files, args = {}, []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if parts[0] == "arg":
            idx, dtype, source, off, nbytes, ndim = parts[1:7]
            dims = [int(d) for d in parts[7:]]
            assert len(dims) == int(ndim)
            args.append((int(idx), dtype, source, int(off), int(nbytes), dims))
        else:
            files[parts[0]] = parts[1]
    return files, args


def tiny_nets(seed=0):
    """JAX's tiny SpeakerNet(Xvector(16, 8)) (tests/test_pjrt_bundle.py:146-164)
    and the port's, the JAX variables carried over from the port's seeded
    weights by weights.py."""
    net = init_weights_(SpeakerNet(Xvector(input_dim=16, num_frame_channels=16, embd_dim=8, device="cpu"),
                                   "softmax", {}, num_targets=4), seed).eval()
    sd = net.state_dict()
    with torch.no_grad():  # BN running statistics away from (0, 1)
        for k, v in sd.items():
            if k.endswith(".mean"):
                v.copy_(torch.linspace(-0.2, 0.2, v.numel()).reshape(v.shape))
            elif k.endswith(".var"):
                v.copy_(torch.linspace(0.5, 1.5, v.numel()).reshape(v.shape))
    jnet = JaxSpeakerNet(backbone=JaxXvector(num_frame_channels=16, embd_dim=8), loss_name="softmax",
                         loss_params={}, num_targets=4)
    jvars = jax.tree_util.tree_map(jnp.asarray, state_dict_to_variables(sd))
    stats = set(k for k in sd if k.endswith((".mean", ".var")))
    variables = {"params": {k: v for k, v in sd.items() if k not in stats},
                 "batch_stats": {k: v for k, v in sd.items() if k in stats}}
    return net, variables, jnet, jvars


def jax_embed(jnet, jvars, x, mask):
    out = jnet.apply(jvars, jnp.asarray(x), mask=jnp.asarray(mask), method=jnet.embed)
    return np.asarray(out, np.float32)


def _xw():
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    x = np.ones((2, 3), np.float32)
    return (lambda w, x: x @ w), (lambda w, x: x @ w), (w, x)


def _bf16_pred():
    w = np.ones((2, 2), np.float32)
    m = np.asarray([[True, False]])
    jfn = lambda w, m: jnp.where(m, 1.0, 0.0).sum() + w.astype(jnp.float32).sum()  # noqa: E731
    pfn = lambda w, m: torch.where(m, 1.0, 0.0).sum() + w.float().sum()  # noqa: E731
    return jfn, pfn, (w, m)


@pytest.mark.parametrize("case", ["xw", "bf16_pred"])
def test_bundle_format_equals_jax(tmp_path, case):
    jfn, pfn, (w, other) = _xw() if case == "xw" else _bf16_pred()
    jw = jnp.asarray(w, jnp.bfloat16) if case == "bf16_pred" else w
    pw = torch.from_numpy(w).to(torch.bfloat16) if case == "bf16_pred" else torch.from_numpy(w)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_export_pjrt_bundle(jfn, (jw, other), jdir, baked=[True, False], platform="cpu")
    export_pjrt_bundle(pfn, (pw, torch.from_numpy(other)), pdir, baked=[True, False], device="cpu")

    def lines(d):
        return [ln.rstrip("\n") for ln in open(os.path.join(d, "manifest.txt")) if ln.startswith(("arg ", "params "))]

    assert lines(pdir) == lines(jdir)
    assert open(os.path.join(pdir, "params.bin"), "rb").read() == open(os.path.join(jdir, "params.bin"), "rb").read()
    head = open(os.path.join(pdir, "manifest.txt")).read().splitlines()[:2]
    assert head == [BUNDLE_HEADER, f"package {PACKAGE_FILE}"]
    files, args = parse_manifest(os.path.join(pdir, "manifest.txt"))
    assert "mlir" not in files and "compile_options" not in files
    if case == "xw":
        assert args[0] == (0, "f32", "param", 0, 48, [3, 4])
        run = torch._inductor.aoti_load_package(os.path.join(pdir, PACKAGE_FILE))
        x = torch.randn(2, 3)
        torch.testing.assert_close(run(pw, x), x @ pw, atol=0, rtol=0)
    else:
        assert args[0][1] == "bf16" and args[0][4] == 8 and args[1][1] == "pred" and args[1][4] == 2


def test_bf16_wire_declares_a_bf16_x(tmp_path):
    net, variables, _, _ = tiny_nets()
    export_pjrt_embed_bundles(net, variables, 16, str(tmp_path / "embb"), bucket_lengths=(64,), device="cpu",
                              feats_dtype=torch.bfloat16)
    _, args = parse_manifest(str(tmp_path / "embb" / "t64" / "manifest.txt"))
    assert len(args) == 3
    assert args[1][1] == "bf16" and args[1][2] == "runtime"
    assert args[1][4] == 64 * 16 * 2  # half of f32
    assert args[1][5] == [1, 64, 16]
    assert args[2][1] == "pred" and args[2][5] == [1, 64]


def test_int8_wire_matches_jax_f32_embedding(tmp_path):
    """4 args (flat params, s8 x, f32 per-row per-channel scale, pred mask);
    fed the C++ extractor's quantization (JAX tests/test_pjrt_bundle.py:200-220),
    the package's on-device dequantization reaches JAX's f32 embedding."""
    net, variables, jnet, jvars = tiny_nets()
    out = tmp_path / "embq"
    export_pjrt_embed_bundles(net, variables, 16, str(out), bucket_lengths=(64,), device="cpu", feats_dtype="int8")
    _, args = parse_manifest(str(out / "t64" / "manifest.txt"))
    assert len(args) == 4
    assert args[1][1] == "s8" and args[1][5] == [1, 64, 16]
    assert args[2][1] == "f32" and args[2][5] == [1, 16]
    assert args[3][1] == "pred" and args[3][5] == [1, 64]

    xv = np.random.default_rng(1).normal(size=(1, 64, 16)).astype(np.float32)
    scale = np.maximum(np.abs(xv).max(axis=1), 1e-12) / 127.0
    q = xv / scale[:, None, :]
    xq = np.where(q >= 0, q + 0.5, q - 0.5).astype(np.int8)
    mask = np.ones((1, 64), bool)
    flat = torch.from_numpy(np.fromfile(out / "params.bin", np.float32))
    run = torch._inductor.aoti_load_package(str(out / "t64" / PACKAGE_FILE))
    got = run(flat, torch.from_numpy(xq), torch.from_numpy(scale.astype(np.float32)),
              torch.from_numpy(mask)).numpy().ravel()
    ref = jax_embed(jnet, jvars, xv, mask).ravel()
    cos = float(np.dot(got, ref) / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.999, cos


def test_ops_cc_schemas_equal_the_python_ops():
    import asv_subtools_tpu_torch.nn  # noqa: F401  (registers the ops)

    text = open(OPS_CC).read()
    literals = {}
    for name, body in re.findall(r"constexpr const char\* (k\w+Schema) =\s*((?:\"[^\"]*\"\s*)+);", text):
        literals[name] = "".join(re.findall(r"\"([^\"]*)\"", body))
    assert len(literals) == 3, literals
    for op in ("fused_attentive_stats_pool", "fused_res2_chain", "fused_stats_pooling"):
        want = str(getattr(torch.ops.asv_subtools_tpu_torch, op).default._schema)
        assert want in literals.values(), (op, want, literals)
