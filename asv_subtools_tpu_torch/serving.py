"""Embedding service: a TCP socket server around an embed function
(counterpart: asv_subtools_tpu/serving.py:1-119).

The production split of the reference's C++ runtime: the host-side C++
front end (runtime/) decodes wavs and computes features and VAD; this
service owns the card and answers embedding requests. The C++ client is
runtime/bin/asv_extractor_main.cc; the wire format is JAX's byte for byte,
so it talks to either server.

Wire protocol (little-endian):
  request:  u32 magic=0x41535631 ("ASV1"), u32 num_frames, u32 dim,
            num_frames*dim f32 features
  response: u32 magic, u32 embed_dim, embed_dim f32 embedding
            (embed_dim == 0: an error)

Each utterance is padded to the smallest bucket that holds it (the last
bucket cuts a longer one, as JAX's server does) and runs as a batch of
one. ``socketserver.ThreadingTCPServer`` serves each connection in its own
thread, and ``torch.inference_mode`` is thread-local, so ``embed`` enters
it itself; every tensor goes to the server's device.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device

MAGIC = 0x41535631


class EmbeddingServer:
    """Serve ``embed_fn(x [1, T, D], mask [1, T]) -> [1, E]`` over a socket,
    on ``device`` (the CUDA card unless ``device="cpu"``)."""

    def __init__(self, embed_fn: Callable, buckets: Sequence[int] = (200, 400, 800, 1600, 3200, 6400, 10000),
                 host: str = "127.0.0.1", port: int = 0, device: Any = None):
        self._fn = embed_fn
        self.buckets = tuple(buckets)
        self.device = resolve_device(device)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                while True:
                    header = _recv_exact(sock, 12)
                    if header is None:
                        return
                    magic, t, d = struct.unpack("<III", header)
                    if magic != MAGIC:
                        sock.sendall(struct.pack("<II", MAGIC, 0))
                        return
                    data = _recv_exact(sock, t * d * 4)
                    if data is None:
                        return
                    feats = np.frombuffer(data, "<f4").reshape(t, d)
                    try:
                        emb = outer.embed(feats)
                        sock.sendall(struct.pack("<II", MAGIC, emb.shape[0]) + emb.astype("<f4").tobytes())
                    except Exception:  # the wire's one error reply, as JAX's server gives it
                        sock.sendall(struct.pack("<II", MAGIC, 0))

        self._server = socketserver.ThreadingTCPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def embed(self, feats: np.ndarray) -> np.ndarray:
        """feats [T, D] -> embedding [E] (float32 numpy)."""
        t, d = feats.shape
        bucket = next((b for b in self.buckets if b >= t), self.buckets[-1])
        x = np.zeros((1, bucket, d), np.float32)
        x[0, : min(t, bucket)] = feats[:bucket]
        mask = np.arange(bucket)[None, :] < min(t, bucket)
        with torch.inference_mode():
            out = self._fn(torch.from_numpy(x).to(self.device), torch.from_numpy(mask).to(self.device))
            return out.float().cpu().numpy()[0]

    def start(self) -> int:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def embed_request(host: str, port: int, feats: np.ndarray) -> np.ndarray:
    """Python client (the protocol's twin of the C++ one)."""
    with socket.create_connection((host, port)) as sock:
        t, d = feats.shape
        sock.sendall(struct.pack("<III", MAGIC, t, d) + feats.astype("<f4").tobytes())
        header = _recv_exact(sock, 8)
        magic, e = struct.unpack("<II", header)
        if magic != MAGIC or e == 0:
            raise RuntimeError("embedding server error")
        data = _recv_exact(sock, e * 4)
        return np.frombuffer(data, "<f4").copy()
