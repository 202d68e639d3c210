"""The native runtime's binaries, driven from Python (tests, chip_smoke).

The C++ sources beside this file (``bundle.{h,cc}``, ``cuda_executor.{h,cc}``,
``ops.cc``, ``bin/*.cc``) serve native-runtime bundles with no Python in
the process; ``kernels/_build.py`` :func:`build_runtime` builds them into
``build/runtime/``. The helpers here only start those binaries and read
what they write: the raw files ``--feed`` takes, the ``--dump`` outputs,
the runner's timing and op-count lines, the extractor's text embeddings.
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..export import raw_bytes
from ..kernels._build import build_runtime, runtime_binary


RUNNER_TIMEOUT_S = 600  # a bundle_runner process (load, warm-up, timed calls)
EXTRACTOR_TIMEOUT_S = 900  # an asv_extractor_main process over a wav.scp


def parse_fields(text: str, head: str) -> Dict[str, float]:
    """``key=value`` numbers of the first line that starts with ``head``:
    the extractor's ``TOTAL``, ``BREAKDOWN``, ``STREAMING`` and ``OPS``
    (launches over the run), the runner's ``ops per call:`` and ``ops
    total:`` (launches over the process, warm-up included)."""
    for line in text.splitlines():
        if line.startswith(head):
            return {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.eE+-]+)", line)}
    return {}


def run_bundle(bundle: str, feeds: Dict[int, torch.Tensor], device: Optional[str] = None, iters: int = 1,
               warmup: int = 0, runner: Optional[Path] = None) -> Tuple[subprocess.CompletedProcess, List[bytes]]:
    """Run ``bundle_runner`` on ``bundle`` with ``feeds`` ({argument index:
    tensor}) and return (the finished process, each output's raw bytes).
    ``device`` None leaves the runner's default (the card); ``runner``
    names another build's binary (default: :func:`build_runtime`'s)."""
    if runner is None:
        build_runtime()
        runner = runtime_binary("bundle_runner")
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [str(runner), f"--bundle={bundle}", f"--iters={iters}", f"--warmup={warmup}",
               f"--dump={tmp}/out"]
        if device is not None:
            cmd.append(f"--device={device}")
        for idx, t in feeds.items():
            path = os.path.join(tmp, f"feed{idx}.bin")
            with open(path, "wb") as f:
                f.write(raw_bytes(t))
            cmd.append(f"--feed={idx}:{path}")
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              timeout=RUNNER_TIMEOUT_S)
        outs = []
        i = 0
        while os.path.exists(f"{tmp}/out{i}.bin"):
            with open(f"{tmp}/out{i}.bin", "rb") as f:
                outs.append(f.read())
            i += 1
    return proc, outs


def run_extractor(wav_scp: str, bundles: str, output: str, args: Sequence[str] = (),
                  device: Optional[str] = None) -> subprocess.CompletedProcess:
    """Run the port's ``asv_extractor_main`` over ``wav_scp`` with the
    bundles of ``bundles`` (t<N>/ directories), writing text embeddings to
    ``output``; ``args`` are further flags (``--streaming``, ``--streams
    N``, ``--threads N``, ``--num_bins N``)."""
    build_runtime()
    cmd = [str(runtime_binary("asv_extractor_main")), "--wav_scp", wav_scp, "--bundles", bundles,
           "--output", output, *args]
    if device is not None:
        cmd += ["--device", device]
    return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=EXTRACTOR_TIMEOUT_S)


def read_embeddings(path: str) -> Dict[str, np.ndarray]:
    """The extractor's text embeddings: ``key v1 v2 ...`` a line."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = np.asarray([float(v) for v in parts[1:]], np.float32)
    return out
