"""The embedding server: the port's against JAX's, and the C++ client.

Both servers hold the same converted ECAPA (an ASV-Subtools state_dict
from test_torch_convert.py's ``reference_state_dict``, through each
package's converter), f32 on the CPU. Replies to requests below, at and above the last bucket (cut to
it, JAX's rule) agree at 1e-5; a bad magic gets the error reply E = 0. The
C++ client (runtime/bin/asv_extractor_main.cc) talks to the port's server
end to end; if its binary is absent it is built with cmake and ninja into
a temporary directory.
"""

import os
import socket
import struct
import subprocess

import numpy as np
import pytest
import torch

from asv_subtools_tpu import convert as jconvert
from asv_subtools_tpu.models import EcapaTdnn as JaxEcapa
from asv_subtools_tpu.serving import EmbeddingServer as JaxServer
from asv_subtools_tpu.serving import embed_request as jax_embed_request
from asv_subtools_tpu_torch import convert
from asv_subtools_tpu_torch.features import FbankOptions, MelOptions, VadOptions, compute_fbank, compute_vad_energy
from asv_subtools_tpu_torch.io.wav import read_wav, write_wav
from asv_subtools_tpu_torch.models import EcapaTdnn
from asv_subtools_tpu_torch.serving import MAGIC, EmbeddingServer, embed_request
from test_torch_convert import ecapa_rule, reference_state_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENT = os.path.join(REPO, "runtime", "build", "asv_extractor_main")
BINS = 80
BUCKETS = (64, 128)


@pytest.fixture(scope="module")
def served():
    shape = dict(channels=16, mfa_conv=24, embd_dim=8)
    sd = reference_state_dict(EcapaTdnn(input_dim=BINS, device="cpu", **shape), ecapa_rule, loss_dim=8)
    model = EcapaTdnn(input_dim=BINS, device="cpu", **shape)
    model.load_state_dict(convert.convert_ecapa_state_dict(sd))
    jmodel = JaxEcapa(**shape)
    params, stats = jconvert.convert_ecapa_state_dict(sd)
    v = {"params": params, "batch_stats": stats}
    server = EmbeddingServer(lambda x, m: model(x, m), buckets=BUCKETS, device="cpu")
    jserver = JaxServer(lambda x, m: jmodel.apply(v, x, mask=m, train=False), buckets=BUCKETS)
    server.start()
    jserver.start()
    yield server, jserver
    server.stop()
    jserver.stop()


@pytest.mark.parametrize("frames", [40, 128, 200])
def test_replies_match_jax(served, frames):
    server, jserver = served
    feats = np.random.default_rng(frames).normal(size=(frames, BINS)).astype(np.float32)
    got = embed_request("127.0.0.1", server.port, feats)
    want = jax_embed_request("127.0.0.1", jserver.port, feats)
    assert got.shape == want.shape == (8,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, server.embed(feats), atol=0, rtol=0)
    if frames > BUCKETS[-1]:  # cut to the last bucket
        np.testing.assert_array_equal(got, server.embed(feats[: BUCKETS[-1]]))


def test_two_requests_on_one_connection_and_a_bad_magic(served):
    server, _ = served
    feats = np.random.default_rng(0).normal(size=(50, BINS)).astype(np.float32)
    with socket.create_connection(("127.0.0.1", server.port)) as sock:
        for _ in range(2):
            sock.sendall(struct.pack("<III", MAGIC, 50, BINS) + feats.tobytes())
            magic, e = struct.unpack("<II", _recv(sock, 8))
            assert (magic, e) == (MAGIC, 8)
            np.testing.assert_array_equal(np.frombuffer(_recv(sock, 32), "<f4"), server.embed(feats))
    with socket.create_connection(("127.0.0.1", server.port)) as sock:
        sock.sendall(struct.pack("<III", 0x12345678, 50, BINS))
        assert struct.unpack("<II", _recv(sock, 8)) == (MAGIC, 0)


def test_an_error_gets_the_empty_reply(served):
    server, _ = served
    bad = np.zeros((30, BINS + 3), np.float32)  # the model takes 80 bins
    with pytest.raises(RuntimeError, match="embedding server error"):
        embed_request("127.0.0.1", server.port, bad)


def test_embed_runs_in_inference_mode_in_any_thread(served):
    server, _ = served
    seen = []
    fn = server._fn
    server._fn = lambda x, m: (seen.append((torch.is_inference_mode_enabled(), x.device.type)), fn(x, m))[1]
    try:
        embed_request("127.0.0.1", server.port, np.ones((20, BINS), np.float32))
    finally:
        server._fn = fn
    assert seen == [(True, "cpu")]


def _recv(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk
        buf += chunk
    return buf


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    if os.path.exists(CLIENT):
        return CLIENT
    build = tmp_path_factory.mktemp("runtime_build")
    try:
        subprocess.run(["cmake", "-S", os.path.join(REPO, "runtime"), "-B", str(build), "-G", "Ninja"], check=True,
                       capture_output=True)
        subprocess.run(["ninja", "-C", str(build), "asv_extractor_main"], check=True, capture_output=True)
    except FileNotFoundError as e:
        pytest.skip(f"native toolchain unavailable: {e}")
    path = os.path.join(build, "asv_extractor_main")
    assert os.path.exists(path), "the runtime build produced no binary"
    return path


def test_cpp_client_end_to_end(served, client, tmp_path):
    server, _ = served
    rng = np.random.default_rng(1)
    lines = []
    for i in range(3):
        wav = (rng.normal(size=16000 + 4000 * i) * 2000).astype(np.float32)
        path = tmp_path / f"u{i}.wav"
        write_wav(str(path), wav, 16000)
        lines.append(f"u{i} {path}")
    scp = tmp_path / "wav.scp"
    scp.write_text("\n".join(lines) + "\n")
    out = tmp_path / "emb.txt"
    res = subprocess.run([client, "--wav_scp", str(scp), "--port", str(server.port), "--output", str(out),
                          "--num_bins", str(BINS)], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "TOTAL utts=3 failures=0" in res.stdout
    embs = {p[0]: np.asarray([float(v) for v in p[1:]]) for p in (ln.split() for ln in out.read_text().splitlines())}
    assert set(embs) == {"u0", "u1", "u2"}
    assert all(e.shape == (8,) and np.all(np.isfinite(e)) for e in embs.values())
    # u0 against the port's Python twin of the C++ front end: fbank + energy, VAD, mean removal
    wav0, _ = read_wav(str(tmp_path / "u0.wav"))
    opts = FbankOptions(mel_opts=MelOptions(num_bins=BINS), use_energy=True)
    feats = compute_fbank(torch.as_tensor(np.asarray(wav0), dtype=torch.float32), opts).numpy()
    voiced = compute_vad_energy(torch.from_numpy(feats[:, 0]), VadOptions()).numpy()
    sel = feats[voiced > 0.5, 1:]
    ref = server.embed((sel - sel.mean(axis=0, keepdims=True)).astype(np.float32))
    cos = float(embs["u0"] @ ref / (np.linalg.norm(embs["u0"]) * np.linalg.norm(ref)))
    assert cos > 0.999, f"C++ against the Python front end: cosine {cos}"
