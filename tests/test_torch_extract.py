"""Port extraction service, io and backend against the JAX package, plus the
port's isolation from JAX and its device rule.

The same seeded waves and weights go through the JAX
make_wave_embed_fn + Extractor (fused fbank kernel in interpret mode) and
the port's (plain fbank version on CPU). Per-utterance cosine >= 0.9999:
both sides round the DFT operands to bf16 and sum in f32, in other orders.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu import extract as jex
from asv_subtools_tpu.backend.metrics import compute_eer as jax_compute_eer
from asv_subtools_tpu.backend.score_norm import cosine_score_matrix as jax_cosine
from asv_subtools_tpu.features import FbankOptions as JaxFbankOptions
from asv_subtools_tpu.io import read_vec_flt_scp
from asv_subtools_tpu.io.wav import read_wav as jax_read_wav
from asv_subtools_tpu.io.wav import write_wav
from asv_subtools_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from asv_subtools_tpu.models.framework import chunk_utterance as jax_chunk_utterance
from asv_subtools_tpu.models.framework import l2_norm as jax_l2_norm
from asv_subtools_tpu.models.resnet_xvector import ResNetXvector as JaxResNetXvector
from asv_subtools_tpu_torch import extract as tex
from asv_subtools_tpu_torch.backend import compute_eer, cosine_score_matrix
from asv_subtools_tpu_torch.device import resolve_device
from asv_subtools_tpu_torch.features import FbankOptions
from asv_subtools_tpu_torch.io import read_wav
from asv_subtools_tpu_torch.models import EcapaTdnn, ResNetXvector, chunk_utterance, l2_norm
from asv_subtools_tpu_torch.weights import load_ecapa_variables, load_variables

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(channels=64, mfa_conv=96, embd_dim=16)
# buckets and max_chunk in samples: utt 3 (50000 samples) is chunked
LENGTHS = (9000, 20000, 31000, 50000, 14000)
CONFIG = dict(buckets=(16000, 32000), default_batch=2, max_chunk=24000)


def _waves(seed=0):
    rng = np.random.default_rng(seed)
    return [(f"u{i}", (rng.standard_normal(n) * 1000).astype(np.float32)) for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    waves = _waves()
    jm = JaxEcapa(**SMALL)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.ones((1, 50, 23)), train=False)
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.default_rng(1)
    for name in ("bn_stats", "fc2_bn"):
        v["batch_stats"][name]["mean"] = rng.normal(size=v["batch_stats"][name]["mean"].shape).astype(np.float32) * 0.1
    jax_embed = jex.make_wave_embed_fn(lambda x, m: jm.apply(v, x, mask=m, train=False), JaxFbankOptions())
    ref = jex.Extractor(jax_embed, jex.ExtractConfig(**CONFIG)).extract_all(iter(waves))

    port = EcapaTdnn(input_dim=23, device="cpu", **SMALL)
    load_ecapa_variables(port, v)
    embed = tex.make_wave_embed_fn(lambda x, m: port(x, m), FbankOptions())
    ex = tex.Extractor(embed, tex.ExtractConfig(**CONFIG), device="cpu")
    out = tmp_path_factory.mktemp("ark")
    stats = ex.extract_to_ark(iter(waves), str(out / "x.ark"), str(out / "x.scp"))
    got = ex.extract_all(iter(waves))
    return ref, got, stats, out


def test_extractor_matches_jax(extracted):
    ref, got, _, _ = extracted
    assert set(got) == set(ref) == {f"u{i}" for i in range(len(LENGTHS))}
    for key in ref:
        a, b = got[key], np.asarray(ref[key])
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos >= 0.9999, (key, cos)


RESNET_SMALL = dict(layers=(1, 1, 1, 1), base_planes=8, embd_dim=16)


@pytest.fixture(scope="module")
def extracted_resnet():
    """End to end: the same wavs and weights through the JAX
    Extractor and the port's, with the ResNet x-vector behind
    make_wave_embed_fn, the pooling unfused and fused."""
    waves = _waves(2)
    jm = JaxResNetXvector(**RESNET_SMALL)
    v = jm.init({"params": jax.random.PRNGKey(1)}, jnp.ones((1, 50, 23)), mask=jnp.ones((1, 50), bool), train=False)
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.default_rng(2)
    bn = v["batch_stats"]["head"]["fc2_bn"]
    bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32) * 0.1
    jax_embed = jex.make_wave_embed_fn(lambda x, m: jm.apply(v, x, mask=m, train=False), JaxFbankOptions())
    ref = jex.Extractor(jax_embed, jex.ExtractConfig(**CONFIG)).extract_all(iter(waves))
    got = {}
    for fused in (False, True):
        port = ResNetXvector(23, device="cpu", pooling_params={"fused_inference": fused}, **RESNET_SMALL)
        load_variables(port, v)
        embed = tex.make_wave_embed_fn(lambda x, m: port(x, m), FbankOptions())
        got[fused] = tex.Extractor(embed, tex.ExtractConfig(**CONFIG), device="cpu").extract_all(iter(waves))
    return ref, got


@pytest.mark.parametrize("fused", [False, True])
def test_resnet_extractor_matches_jax(extracted_resnet, fused):
    ref, got = extracted_resnet
    assert set(got[fused]) == set(ref) == {f"u{i}" for i in range(len(LENGTHS))}
    for key in ref:
        a, b = got[fused][key], np.asarray(ref[key])
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos >= 0.9999, (key, cos)


def test_ark_scp_reads_back_through_jax_io(extracted):
    _, got, stats, out = extracted
    back = dict(read_vec_flt_scp(str(out / "x.scp")))
    assert set(back) == set(got)
    for key, emb in back.items():
        assert emb.dtype == np.float32
        np.testing.assert_array_equal(emb, got[key].astype(np.float32))
    assert stats["utts"] == len(LENGTHS) and stats["device_s"] > 0


def test_chunked_utterance_was_split():
    chunks, weights = tex._chunk(np.zeros(50000, np.float32), CONFIG["max_chunk"])
    assert len(chunks) == 4 and abs(sum(weights) - 1.0) < 1e-12


@pytest.mark.parametrize("t", [30, 100, 250, 251])
def test_chunking_matches_jax(t):
    feats = np.arange(t * 2, dtype=np.float32).reshape(t, 2)
    a, wa = tex._chunk(feats, 100)
    b, wb = jex._chunk(feats, 100)
    assert wa == wb and all(np.array_equal(x, y) for x, y in zip(a, b))
    ca, cwa = chunk_utterance(feats, 100)
    cb, cwb = jax_chunk_utterance(feats, 100)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(cwa, cwb)
    for length in (1, 16000, 16001, 99999999):
        assert tex._bucket_for(length, tex.WAVE_BUCKETS) == jex._bucket_for(length, jex.WAVE_BUCKETS)


def test_scoring_and_eer_match_jax():
    rng = np.random.default_rng(3)
    e = rng.normal(size=(6, 16)).astype(np.float32)
    t = rng.normal(size=(9, 16)).astype(np.float32)
    got = cosine_score_matrix(torch.from_numpy(e), torch.from_numpy(t)).numpy()
    ref = np.asarray(jax_cosine(jnp.asarray(e), jnp.asarray(t)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    raw = cosine_score_matrix(torch.from_numpy(e), torch.from_numpy(t), normalize=False).numpy()
    np.testing.assert_allclose(raw, e @ t.T, rtol=1e-5)
    labels = rng.integers(0, 2, size=got.size)
    assert compute_eer(got.ravel(), labels) == jax_compute_eer(got.ravel(), labels)
    np.testing.assert_allclose(l2_norm(torch.from_numpy(e)).numpy(),
                               np.asarray(jax_l2_norm(jnp.asarray(e))), atol=1e-7)


@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_matches_jax(tmp_path, channels):
    rng = np.random.default_rng(4)
    samples = np.round(rng.normal(size=(channels, 3000)) * 3000).astype(np.float32)
    path = str(tmp_path / "a.wav")
    write_wav(path, samples[0] if channels == 1 else samples, 16000)
    got, sr = read_wav(path)
    ref, sr_ref = jax_read_wav(path)
    assert sr == sr_ref == 16000
    np.testing.assert_array_equal(got, ref)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(read_wav(f.read())[0], ref)


@pytest.mark.parametrize("t", [80, 250, 401])
def test_extract_embedding_chunked_matches_jax(t):
    """A narrow SnowdarXvector on the same weights: the chunks of a [t, 24]
    utterance embedded in one call and averaged by their frame weights
    (max_chunk 100: one chunk, three, and four with the overlapping tail),
    within 1e-5 of JAX's."""
    from asv_subtools_tpu.models.framework import extract_embedding_chunked as jax_chunked
    from asv_subtools_tpu.models.xvector import SnowdarXvector as JaxSnowdar
    from asv_subtools_tpu_torch.models import SnowdarXvector, extract_embedding_chunked

    feats = np.random.default_rng(t).normal(size=(t, 24)).astype(np.float32)
    jm = JaxSnowdar(num_frame_channels=16, embd_dim=8)
    v = jax.tree_util.tree_map(np.array, jm.init({"params": jax.random.PRNGKey(1)}, jnp.ones((1, 50, 24)),
                                                 train=False))
    ref = np.asarray(jax_chunked(lambda x, m: jm.apply(v, x, mask=m, train=False), jnp.asarray(feats), 100))
    pm = load_variables(SnowdarXvector(24, 16, 8, device="cpu"), v)
    calls = []

    def embed(x, m):
        calls.append(tuple(x.shape))
        return pm(x, m)

    with torch.no_grad():
        got = extract_embedding_chunked(embed, torch.from_numpy(feats), 100, device="cpu")
    n = 1 if t <= 100 else -(-t // 100) + (t % -(-t // 100) > 0)
    assert calls == [(n, t if t <= 100 else t // -(-t // 100), 24)]
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_batch_sizes_give_jax_batches():
    """ExtractConfig.batch_sizes: a batch size for each bucket (the rest at
    default_batch). The port's Extractor flushes the batches JAX's does:
    the same embeddings in the same completion order and the same batch
    count, each batch as large as its bucket's size allows."""
    rng = np.random.default_rng(4)
    lengths = [30, 90, 150, 60, 20, 170, 190, 80, 45, 120, 10, 200]
    items = [(f"u{i}", rng.normal(size=(n, 3)).astype(np.float32)) for i, n in enumerate(lengths)]
    cfg = dict(buckets=(50, 100, 200), default_batch=3, batch_sizes={50: 2, 200: 4})

    def jax_embed(x, m):
        m = m.astype(x.dtype)[..., None]
        return jnp.sum(x * m, axis=1) / jnp.maximum(jnp.sum(m, axis=1), 1.0)

    shapes = []

    def port_embed(x, m):
        shapes.append(tuple(x.shape[:2]))
        mf = m.to(x.dtype)[..., None]
        return (x * mf).sum(1) / torch.clamp_min(mf.sum(1), 1.0)

    jex_ = jex.Extractor(jax_embed, jex.ExtractConfig(**cfg))
    ref = list(jex_.extract_iter(iter(items)))
    pex = tex.Extractor(port_embed, tex.ExtractConfig(**cfg), device="cpu")
    got = list(pex.extract_iter(iter(items)))
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    assert pex._stats["batches"] == jex_._stats["batches"] == len(shapes)
    full = {50: 2, 100: 3, 200: 4}
    assert all(b <= full[bucket] for b, bucket in shapes) and (2, 50) in shapes and (4, 200) in shapes


def _stats_embed_port(x, m):
    """[B, T(, D)] -> [B, D + 1]: the masked mean of each row and its
    valid count."""
    x = x.reshape(x.shape[0], x.shape[1], -1)
    mf = m.to(x.dtype)[..., None]
    n = mf.sum(1)
    return torch.cat([(x * mf).sum(1) / torch.clamp_min(n, 1.0), n], 1)


def _stats_embed_jax(x, m):
    x = x.reshape(x.shape[0], x.shape[1], -1)
    mf = m.astype(x.dtype)[..., None]
    n = jnp.sum(mf, axis=1)
    return jnp.concatenate([jnp.sum(x * mf, axis=1) / jnp.maximum(n, 1.0), n], 1)


@pytest.mark.parametrize("tail", [(), (3,)], ids=["wave", "features"])
def test_pipelined_batches_match_jax_across_buckets(tail):
    """One batch in flight: over seven batches across two buckets, with a
    partial tail in each and an utterance chunked over a batch boundary,
    the port yields JAX's keys in JAX's order with its embeddings, in wave
    mode ([S] items) and feature mode ([T, D] items)."""
    rng = np.random.default_rng(5)
    lengths = [40, 150, 90, 1, 200, 470, 100, 60, 180, 30, 120, 75, 199, 10, 160]
    items = [(f"u{i}", rng.normal(size=(n,) + tail).astype(np.float32)) for i, n in enumerate(lengths)]
    cfg = dict(buckets=(100, 200), default_batch=3, max_chunk=200)
    shapes = []

    def port_embed(x, m):
        shapes.append(tuple(x.shape[:2]))
        return _stats_embed_port(x, m)

    ref = list(jex.Extractor(_stats_embed_jax, jex.ExtractConfig(**cfg)).extract_iter(iter(items)))
    pex = tex.Extractor(port_embed, tex.ExtractConfig(**cfg), device="cpu")
    got = list(pex.extract_iter(iter(items)))
    assert [k for k, _ in got] == [k for k, _ in ref] and len(got) == len(items)
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    assert len(shapes) == pex._stats["batches"] >= 3
    assert {b for _, b in shapes} == {100, 200} and {(2, 100), (1, 200)} <= set(shapes)


def test_embed_fn_returning_a_view_of_its_input():
    """An embed_fn whose answer is a view of the batch it was given (the
    slab itself on the CPU) stays right while the two slabs are reused:
    each utterance's answer is its first four samples, a chunked one's the
    weighted sum of its chunks' first four."""
    rng = np.random.default_rng(6)
    lengths = [30, 12, 50, 47, 8, 50, 21, 130, 44, 9, 50, 33]
    items = [(f"u{i}", rng.normal(size=n).astype(np.float32)) for i, n in enumerate(lengths)]
    ex = tex.Extractor(lambda x, m: x[:, :4], tex.ExtractConfig(buckets=(50,), default_batch=2, max_chunk=50),
                       device="cpu")
    got = dict(ex.extract_iter(iter(items)))
    assert ex._stats["batches"] >= 6 and len(ex._staging) == 1
    for key, wave in items:
        chunks, weights = tex._chunk(wave, 50)
        np.testing.assert_allclose(got[key], sum(w * c[:4] for c, w in zip(chunks, weights)), rtol=1e-6)


@pytest.mark.parametrize("lengths", [(1, 37, 1, 64, 5), (100, 3, 100, 99, 100), (250, 101, 30, 1)],
                         ids=["one-sample rows", "full-bucket rows", "chunked rows"])
def test_mask_from_lengths_equals_the_host_mask(lengths):
    """The mask built from the lengths after the copy-in is the bool
    ``arange(bucket) < lens[:, None]`` the host used to build, row for row:
    rows of one sample, rows that fill the bucket, the chunks of utterances
    longer than max_chunk; and the batch's padding is zero."""
    rng = np.random.default_rng(7)
    items = [(f"u{i}", rng.uniform(1.0, 2.0, size=n).astype(np.float32)) for i, n in enumerate(lengths)]
    seen = []

    def embed(x, m):
        seen.append((x.clone(), m.clone()))
        return x[:, :1]

    ex = tex.Extractor(embed, tex.ExtractConfig(buckets=(100,), default_batch=4, max_chunk=100), device="cpu")
    dict(ex.extract_iter(iter(items)))
    lens = [c.shape[0] for _, w in items for c in tex._chunk(w, 100)[0]]
    assert [m.shape[0] for _, m in seen] == [len(lens[i:i + 4]) for i in range(0, len(lens), 4)]
    for i, (x, m) in enumerate(seen):
        want = np.arange(100)[None, :] < np.asarray(lens[4 * i:4 * i + 4])[:, None]
        assert m.dtype == torch.bool and np.array_equal(m.numpy(), want)
        assert np.array_equal(x.numpy() != 0, want)


def _port_modules():
    pkg = REPO / "asv_subtools_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    )


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, pulls in
    neither JAX nor the JAX package, nor the JAX gates' top-level
    ``recipes`` and ``tools`` scripts (the port keeps its own copies)."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'asv_subtools_tpu', 'recipes', 'tools')\n"
        "           or m in ('quality_gate', 'roadmap_gate', 'antispoof_gate', 'adaptation_gate',\n"
        "                    'demo_synthetic', 'repvgg_deploy_gate', 'make_synth_datadir'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('asv_subtools_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= len(_port_modules())


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "optax", "asv_subtools_tpu"}, names


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        EcapaTdnn(input_dim=23, **SMALL)
    with pytest.raises(RuntimeError):
        ResNetXvector(23, **RESNET_SMALL)
    with pytest.raises(RuntimeError):
        tex.Extractor(lambda x, m: x)
    assert resolve_device("cpu") == torch.device("cpu")
