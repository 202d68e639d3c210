"""The native runtime (asv_subtools_tpu_torch/runtime) on the CPU, against
JAX.

``build_runtime()`` builds the CPU-only variant here (no CUDA torch, no
nvcc). One export of the tiny SpeakerNet(Xvector(16, 8)) of JAX's
tests/test_pjrt_bundle.py:146-164 (variables carried over by weights.py)
at buckets t64 and t128 (two AOTInductor packages) serves every test:
its layout is JAX's (one shared params.bin, three arguments, a flat
vector of JAX's ravel_pytree size); the package loaded in Python matches
JAX's embed at 1e-5; ``bundle_runner --device=cpu`` on --feed files
equals the Python-loaded package bit for bit; without --device the runner
wants the card and exits non-zero naming the cause; neither binary links
libpython; the port's extractor, per utterance and with --streams 2, on
three seeded wavs matches JAX's embed of the same features at 1e-4 (fbank
from the same runtime/frontend code through features/native.py, JAX's
compute_vad_energy and submean, the extractor's bucket rule).
"""

import os
import subprocess
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from asv_subtools_tpu.features.functional import compute_vad_energy
from asv_subtools_tpu_torch.export import PACKAGE_FILE, export_pjrt_embed_bundles
from asv_subtools_tpu_torch.kernels._build import RUNTIME_BINARIES, build_runtime, runtime_binary, runtime_has_cuda
from asv_subtools_tpu_torch.runtime import parse_fields, read_embeddings, run_bundle, run_extractor
from test_torch_pjrt_bundle import jax_embed, parse_manifest, tiny_nets

torch.set_num_threads(2)

BUCKETS = (64, 128)
NUM_BINS = 16


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    net, variables, jnet, jvars = tiny_nets(seed=3)
    out = tmp_path_factory.mktemp("bundles")
    paths = export_pjrt_embed_bundles(net, variables, NUM_BINS, str(out), bucket_lengths=BUCKETS, device="cpu")
    return net, jnet, jvars, out, paths


@pytest.fixture(scope="module")
def built():
    build_runtime()


def _feats(t, valid, seed):
    x = np.random.default_rng(seed).normal(size=(1, t, NUM_BINS)).astype(np.float32)
    mask = np.arange(t)[None, :] < valid
    return x, mask


def test_embed_bundles_share_one_blob_in_jax_layout(exported):
    _, _, jvars, out, paths = exported
    assert set(paths) == set(BUCKETS)
    assert os.path.exists(out / "params.bin")
    assert not os.path.exists(out / "t64" / "params.bin")
    files, args = parse_manifest(out / "t64" / "manifest.txt")
    assert files == {"package": PACKAGE_FILE, "params": "../params.bin"}
    assert len(args) == 3  # flat params + x + mask
    assert args[0][2] == "param" and len(args[0][5]) == 1
    assert args[1][2] == "runtime" and args[1][5] == [1, 64, NUM_BINS]
    assert args[2][1] == "pred" and args[2][5] == [1, 64]
    flat_jax, _ = ravel_pytree(jvars)
    assert args[0][5] == [flat_jax.size]  # the state_dict holds no leaf JAX lacks
    assert os.path.getsize(out / "params.bin") == 4 * flat_jax.size


@pytest.mark.parametrize("t,valid", [(64, 64), (128, 91)])
def test_loaded_package_matches_jax(exported, t, valid):
    _, jnet, jvars, out, paths = exported
    x, mask = _feats(t, valid, seed=t)
    flat = torch.from_numpy(np.fromfile(out / "params.bin", np.float32))
    run = torch._inductor.aoti_load_package(os.path.join(paths[t], PACKAGE_FILE))
    got = run(flat, torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, jax_embed(jnet, jvars, x, mask), atol=1e-5, rtol=0)


@pytest.mark.parametrize("t,valid", [(64, 40), (128, 128)])
def test_runner_on_the_cpu_equals_the_loaded_package(exported, built, t, valid):
    _, jnet, jvars, out, paths = exported
    x, mask = _feats(t, valid, seed=7 + t)
    proc, outs = run_bundle(paths[t], {1: torch.from_numpy(x), 2: torch.from_numpy(mask)}, device="cpu", iters=2)
    assert proc.returncode == 0, proc.stderr
    assert "execute:" in proc.stdout and "device: cpu" in proc.stdout
    assert parse_fields(proc.stdout, "ops per call:") == {"fused_attentive_stats_pool": 0,
                                                          "fused_res2_chain": 0, "fused_stats_pooling": 0}
    got = np.frombuffer(outs[0], np.float32).reshape(1, 8)
    flat = torch.from_numpy(np.fromfile(out / "params.bin", np.float32))
    run = torch._inductor.aoti_load_package(os.path.join(paths[t], PACKAGE_FILE))
    want = run(flat, torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got, jax_embed(jnet, jvars, x, mask), atol=1e-5, rtol=0)


def test_binaries_default_to_the_card_and_refuse_without_one(exported, built, tmp_path):
    if runtime_has_cuda():
        pytest.skip("the CUDA variant is built here: the card's refusals are in test_torch_cuda.py")
    proc, outs = run_bundle(exported[4][64], {})
    assert proc.returncode != 0 and not outs
    assert "built without CUDA" in proc.stderr, proc.stderr
    scp = tmp_path / "wav.scp"
    scp.write_text("")
    proc = run_extractor(str(scp), str(exported[3]), str(tmp_path / "emb.txt"))
    assert proc.returncode != 0 and "built without CUDA" in proc.stderr, proc.stderr


def test_binaries_link_no_python(built):
    for name in RUNTIME_BINARIES:
        libs = subprocess.run(["ldd", str(runtime_binary(name))], stdout=subprocess.PIPE, text=True,
                              check=True).stdout
        assert "libtorch" in libs
        assert "libpython" not in libs, libs


def _write_wav(path, samples):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(np.round(samples), -32768, 32767).astype(np.int16).tobytes())


def _reference_feats(path):
    """The extractor's features: fbank with the raw log-energy in column
    0 (runtime/frontend through features/native.py), JAX's energy VAD, the
    voiced frames, submean."""
    from asv_subtools_tpu_torch.features import native

    with wave.open(str(path), "rb") as w:
        samples = np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float32)
    lib = native.load()
    feats = native._call(lib.asvtpu_fbank, samples, NUM_BINS + 1, 160, NUM_BINS, 16000.0, 1, 1, 1)
    voiced = np.asarray(compute_vad_energy(jnp.asarray(feats[:, 0]))) > 0
    sel = feats[voiced, 1:] if voiced.any() else feats[:, 1:]
    return sel - sel.mean(axis=0, dtype=np.float64).astype(np.float32)


@pytest.mark.parametrize("mode", ["per_utterance", "streams2"])
def test_extractor_matches_jax_embed(exported, built, tmp_path, mode):
    _, jnet, jvars, out, _ = exported
    rng = np.random.default_rng(11)
    lines = []
    for i, (loud, quiet) in enumerate(((4000, 1600), (9600, 3200), (24000, 4800))):  # t64, t128 and cut to t128
        wav = np.concatenate([rng.normal(size=loud) * 1000.0, rng.normal(size=quiet) * 2.0,
                              rng.normal(size=loud // 2) * 3000.0])
        path = tmp_path / f"utt{i}.wav"
        _write_wav(path, wav)
        lines.append(f"utt{i} {path}")
    scp = tmp_path / "wav.scp"
    scp.write_text("\n".join(lines) + "\n")
    emb_path = tmp_path / "emb.txt"
    args = ["--num_bins", str(NUM_BINS)] + (["--streaming", "--streams", "2", "--block_ms", "150"]
                                             if mode == "streams2" else [])
    proc = run_extractor(str(scp), str(out), str(emb_path), args, device="cpu")
    assert proc.returncode == 0, proc.stderr
    total = parse_fields(proc.stdout, "TOTAL")
    assert total["utts"] == 3
    if mode == "streams2":
        assert parse_fields(proc.stdout, "STREAMING")["streams"] == 2
    else:  # the VAD drops the quiet stretch of every utterance
        kept = [tuple(map(int, w.split("=")[1].split("/"))) for w in proc.stdout.split() if w.startswith("frames=")]
        assert len(kept) == 3 and all(0 < k < t for k, t in kept), proc.stdout
    got = read_embeddings(str(emb_path))
    assert sorted(got) == ["utt0", "utt1", "utt2"]
    embedded = cut = 0
    for i in range(3):
        feats = _reference_feats(tmp_path / f"utt{i}.wav")
        t = len(feats)
        bucket = next((b for b in BUCKETS if b >= t), BUCKETS[-1])
        embedded += min(t, bucket)
        cut += t > bucket
        x = np.zeros((1, bucket, NUM_BINS), np.float32)
        x[0, :min(t, bucket)] = feats[:bucket]
        mask = np.arange(bucket)[None, :] < min(t, bucket)
        np.testing.assert_allclose(got[f"utt{i}"], jax_embed(jnet, jvars, x, mask)[0], atol=1e-4, rtol=0)
    # the TOTAL line counts the audio embedded (10 ms frames, cut to t128) apart from the audio read
    assert cut == 1 and total["cut"] == cut
    assert total["embedded_s"] == pytest.approx(embedded * 0.01, abs=1e-9) and total["embedded_s"] < total["wav_s"]
