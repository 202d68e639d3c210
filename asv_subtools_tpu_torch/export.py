"""Model export for serving (counterpart: asv_subtools_tpu/export.py:26-57,
257-295; parity: pipeline/export_jit_model.sh + onestep/export_jit.py:26-58
and the nnet.config blueprint idiom, utils.py:189-202).

Two artifacts, as the reference's jit ``.pt`` and ``nnet.config``:

  <dir>/model_b{B}_t{T}.pt2  — a ``torch.export`` program of the embed
                               function for one (batch, bucket) shape,
                               loadable without the model's Python class;
  <dir>/nnet_config.yaml     — model name + constructor params + checkpoint,
                               so Python consumers can rebuild the module.

An exported program holds the card's kernels K2, K3 and K4 as custom ops
(``asv_subtools_tpu_torch::fused_*``, nn/fused_*.py); a process that loads
one must have the ops registered first: importing this module (or
``asv_subtools_tpu_torch.nn``) registers them, as ``load_embed_fn`` does.
A program is exported for one device and runs there.

Native-runtime bundles (counterpart: asv_subtools_tpu/export.py:61-254):
:func:`export_pjrt_bundle` and :func:`export_pjrt_embed_bundles` write a
directory that the C++ binaries of ``asv_subtools_tpu_torch/runtime``
(``bundle_runner``, ``asv_extractor_main``) serve with no Python in the
process. A bundle is

  <dir>/manifest.txt  — JAX's manifest grammar for the arguments
                        (``arg <idx> <dtype> param|runtime <offset>
                        <nbytes> <ndim> <dims...>``, JAX's dtype tags) and
                        the ``params`` line;
  <dir>/model.pt2     — an AOTInductor package of the function, compiled
                        for the device (``torch.export`` +
                        ``torch._inductor.aoti_compile_and_package``),
                        named by a ``package model.pt2`` line;
  <params>            — the baked arguments stored verbatim (bf16 as raw
                        16-bit words), shareable between bundles.

The header reads ``# asv_subtools_tpu_torch-aoti-bundle v1``. It differs
from JAX's v1 in one place: the ``mlir`` and ``compile_options`` lines
become the ``package`` line, because on CUDA the program is compiled ahead
of time for the card and loaded by libtorch's
``AOTIModelPackageLoader``; there is no PJRT plugin to compile StableHLO
at load time and so no ``CompileOptionsProto``. A package runs only under
the libtorch that compiled it. Kernels K2-K4 stay custom-op nodes in a
package; the C++ binaries register them from ``runtime/ops.cc``.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch import nn

from . import nn as _kernels  # noqa: F401  (registers the kernels' custom ops for torch.export.load)
from .device import resolve_device
from .utils import load_yaml, save_yaml


class _EmbedModule(nn.Module):
    """A module around an embed function, for torch.export (tensors the
    function closes over become the program's constants)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.fn(x, mask)


def export_embed_fn(
    embed_fn: Callable,
    feat_dim: int,
    out_dir: str,
    bucket_lengths: Sequence[int] = (200, 400, 800, 1600, 3200, 6400, 10000),
    batch_sizes: Sequence[int] = (1, 8, 32),
    device: Any = None,
) -> Dict[str, str]:
    """Export ``embed_fn(x [B, T, D] f32, mask [B, T] bool) -> [B, E]`` (a
    module or a function) for every (bucket, batch) shape on ``device``
    (the CUDA card unless ``device="cpu"``); returns {shape key: path}."""
    dev = resolve_device(device)
    module = embed_fn if isinstance(embed_fn, nn.Module) else _EmbedModule(embed_fn)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for t in bucket_lengths:
        for b in batch_sizes:
            example = (torch.zeros((b, t, feat_dim), dtype=torch.float32, device=dev),
                       torch.ones((b, t), dtype=torch.bool, device=dev))
            with torch.no_grad():
                program = torch.export.export(module, example)
            key = f"b{b}_t{t}"
            path = os.path.join(out_dir, f"model_{key}.pt2")
            torch.export.save(program, path)
            paths[key] = path
    return paths


def load_embed_fn(path: str, device: Any = None) -> Callable:
    """Load an exported embed function; returns ``fn(x, mask) -> [B, E]``
    running on ``device`` (the CUDA card unless ``device="cpu"``), which
    must be the device the program was exported for. The kernels' custom
    ops are registered by this module's import."""
    dev = resolve_device(device)
    program = torch.export.load(path)
    module = program.module()
    held = {t.device.type for t in list(program.state_dict.values()) + list(program.constants.values())
            if isinstance(t, torch.Tensor)}
    if held - {dev.type}:
        raise ValueError(f"{path} holds tensors on {sorted(held)}; it cannot run on {dev}")

    def fn(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(x.to(dev), mask.to(dev))

    return fn


_PJRT_DTYPES = {
    "float32": "f32",
    "bfloat16": "bf16",
    "float16": "f16",
    "float64": "f64",
    "int32": "s32",
    "int64": "s64",
    "uint8": "u8",
    "uint32": "u32",
    "int8": "s8",
    "bool": "pred",
}
BUNDLE_HEADER = "# asv_subtools_tpu_torch-aoti-bundle v1"
PACKAGE_FILE = "model.pt2"
# Fused bf16 arithmetic rounds its intermediates where eager rounds them, so
# that a package reproduces the eager model; no autotuning (compile time).
INDUCTOR_CONFIGS = {"emulate_precision_casts": True, "max_autotune": False}
# A CUDA package holds no CPU kernel: skip inductor's probe of the host's
# vector ISA (test programs built and loaded at a process's first compile;
# on an H100's host that compile took 126-148 s with the probe, 49 s
# without).
CUDA_INDUCTOR_CONFIGS = {"cpp.vec_isa_ok": False}


@functools.lru_cache(maxsize=None)
def openmp_cxx() -> str:
    """The C++ compiler AOTInductor builds a package with: ``$CXX`` when it
    links an ``-fopenmp`` program (inductor passes that flag), else the
    first of ``g++`` and ``c++`` on PATH that does. A toolchain can ship a
    compiler without OpenMP's spec file; inductor would fail on it deep in
    the compile. Raises when no compiler here takes ``-fopenmp``."""
    import shutil
    import subprocess
    import tempfile

    tried = []
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(name) if name else None
        if path is None or path in tried:
            continue
        tried.append(path)
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "omp.cc")
            with open(src, "w") as f:
                f.write("int main() { return 0; }\n")
            proc = subprocess.run([path, "-fopenmp", src, "-o", os.path.join(tmp, "omp")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if proc.returncode == 0:
            return path
    raise RuntimeError(f"no C++ compiler here links an -fopenmp program (tried {tried}); AOTInductor needs one")


class _LeafModule(nn.Module):
    """``fn`` over the flattened leaves of its arguments, for torch.export."""

    def __init__(self, fn: Callable, spec):
        super().__init__()
        self.fn, self.spec = fn, spec

    def forward(self, *leaves):
        return self.fn(*pytree.tree_unflatten(list(leaves), self.spec))


def _dtype_tag(i: int, t: torch.Tensor) -> str:
    tag = _PJRT_DTYPES.get(str(t.dtype).removeprefix("torch."))
    if tag is None:
        raise ValueError(f"arg {i}: unsupported dtype {t.dtype}")
    return tag


def raw_bytes(t: torch.Tensor) -> bytes:
    """A tensor's bytes as a bundle holds them (bf16 as raw 16-bit words):
    the params blob's baked leaves and the runner's --feed files."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)  # raw 16-bit words, as JAX stores them
    return t.numpy().tobytes()


def export_pjrt_bundle(
    fn: Callable,
    example_args: Sequence[Any],
    out_dir: str,
    *,
    baked: Optional[Sequence[bool]] = None,
    device: Any = None,
    params_ref: str = "params.bin",
) -> str:
    """Export ``fn(*args)`` as a native-runtime bundle for
    ``runtime/bin/bundle_runner_main.cc`` and the port's extractor.

    The function is traced by ``torch.export`` over the flattened leaves
    of ``example_args`` (each leaf one argument of the package, in
    ``torch.utils._pytree`` order) and compiled by AOTInductor for
    ``device`` (the CUDA card unless ``device="cpu"``) into
    ``model.pt2``. Leaves flagged in ``baked`` are stored verbatim in the
    params blob and uploaded once by the executor; the others are fed at
    run time. ``params_ref`` is the blob's path relative to ``out_dir``
    ("../params.bin" shares one blob between per-bucket bundles).
    Returns ``out_dir``.
    """
    from torch._inductor import aoti_compile_and_package

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    leaves, spec = pytree.tree_flatten(tuple(example_args))
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    baked = [False] * len(leaves) if baked is None else list(baked)
    if len(baked) != len(leaves):
        raise ValueError(f"baked has {len(baked)} flags for {len(leaves)} leaves")

    manifest = [BUNDLE_HEADER, f"package {PACKAGE_FILE}", f"params {params_ref}"]
    blob = bytearray()
    for i, (leaf, is_baked) in enumerate(zip(leaves, baked)):
        tag = _dtype_tag(i, leaf)
        dims = " ".join(str(d) for d in leaf.shape)
        if is_baked:
            raw = raw_bytes(leaf)
            manifest.append(f"arg {i} {tag} param {len(blob)} {len(raw)} {leaf.dim()} {dims}".rstrip())
            blob += raw
        else:
            nbytes = leaf.numel() * leaf.element_size()
            manifest.append(f"arg {i} {tag} runtime 0 {nbytes} {leaf.dim()} {dims}".rstrip())

    with torch.no_grad():
        program = torch.export.export(_LeafModule(fn, spec), tuple(leaf.to(dev) for leaf in leaves))
    configs = {**INDUCTOR_CONFIGS, "cpp.cxx": (None, openmp_cxx())}
    if dev.type == "cuda":
        configs.update(CUDA_INDUCTOR_CONFIGS)
    aoti_compile_and_package(program, package_path=os.path.join(out_dir, PACKAGE_FILE), inductor_configs=configs)
    with open(os.path.normpath(os.path.join(out_dir, params_ref)), "wb") as f:
        f.write(bytes(blob))
    with open(os.path.join(out_dir, "manifest.txt"), "w") as f:
        f.write("\n".join(manifest) + "\n")
    return out_dir


class _Embed(nn.Module):
    """The embedding of ``net``: its ``embed`` where it has one, else its forward."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        embed = getattr(self.net, "embed", None)
        return embed(x, mask) if callable(embed) else self.net(x, mask)


def _state_leaves(model: nn.Module, variables: Dict) -> List[Tuple[str, torch.Tensor]]:
    """``variables`` ({"params", "batch_stats"} keyed by state_dict names)
    as (name, tensor) in ``model.state_dict()``'s order. Names may carry
    the ``backbone.`` prefix of a SpeakerNet when ``model`` is its
    backbone, as ``load_model_from_config`` returns them; the head's
    ``loss.*`` leaves are then not the module's and are left out."""
    tree = {**variables.get("params", {}), **variables.get("batch_stats", {})}
    expected = model.state_dict()
    if not set(expected) <= set(tree):
        prefixed = {k[len("backbone."):]: v for k, v in tree.items() if k.startswith("backbone.")}
        if set(expected) <= set(prefixed):
            tree = prefixed
    missing = sorted(set(expected) - set(tree))
    unexpected = sorted(set(tree) - set(expected))
    if missing or unexpected:
        raise ValueError(f"variables do not match the model: missing {missing}, unconsumed {unexpected}")
    leaves = []
    for name, want in expected.items():
        value = torch.as_tensor(tree[name])
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(want.shape)}")
        leaves.append((name, value.detach()))
    return leaves


def export_pjrt_embed_bundles(
    model: nn.Module,
    variables: Dict,
    feat_dim: int,
    out_dir: str,
    bucket_lengths: Sequence[int] = (200, 400, 800, 1600, 3200),
    compute_dtype: Optional[torch.dtype] = None,
    device: Any = None,
    batch: int = 1,
    feats_dtype: Any = None,
) -> Dict[int, str]:
    """Export the embedding as one native-runtime bundle per bucket length
    (``<out_dir>/t<N>/``) for the port's extractor, all reading one shared
    ``<out_dir>/params.bin``.

    Each bundle computes ``embed(flat, x [B, T, D] f32, mask [B, T] bool)
    -> [B, E] f32`` (B = ``batch``). ``flat`` is argument 0, baked: the
    module's state_dict, in its own order and torch layout, raveled into
    one vector of the leaves' common type (JAX's ``ravel_pytree``,
    export.py:207-211). The graph cuts it back with static ``torch.split``
    sizes and views and runs the module by ``torch.func.functional_call``,
    so a package holds no weights and every bucket reads the one blob.
    ``model`` is the module on ``device`` (the CUDA card unless
    ``device="cpu"``), in eval mode; its ``embed`` is called where it has
    one. ``variables`` is ``{"params", "batch_stats"}`` keyed by state_dict
    names, as ``load_model_from_config`` returns them.

    ``compute_dtype=torch.bfloat16`` casts the floating leaves (and x)
    before the ravel. ``feats_dtype=torch.bfloat16`` declares a bf16 ``x``
    (the extractor rounds its f32 features to nearest even when packing).
    ``feats_dtype="int8"`` gives ``embed_q(flat, x_q s8 [B, T, D], scale
    f32 [B, D], mask)``, which dequantizes on the device
    (``x = x_q * scale[:, None, :]``); the extractor quantizes each row and
    channel symmetrically, ``scale = max|x[:, d]| / 127``.
    Returns {bucket length: bundle directory}.
    """
    dev = resolve_device(device)
    held = {t.device.type for t in model.state_dict().values()}
    if held - {dev.type}:
        raise ValueError(f"the model lies on {sorted(held)}; move it to {dev} first")
    leaves = _state_leaves(model, variables)
    if compute_dtype is not None:
        leaves = [(n, v.to(compute_dtype) if v.is_floating_point() else v) for n, v in leaves]
    flat_dtype = functools.reduce(torch.promote_types, (v.dtype for _, v in leaves))
    flat = torch.cat([v.reshape(-1).to(flat_dtype) for _, v in leaves])
    names = [n for n, _ in leaves]
    sizes = [v.numel() for _, v in leaves]
    shapes = [tuple(v.shape) for _, v in leaves]
    dtypes = [v.dtype for _, v in leaves]
    net = _Embed(model).eval()
    x_type = compute_dtype if compute_dtype is not None else flat_dtype

    def embed(flat_v, x, mask):
        parts = torch.split(flat_v, sizes)
        state = {f"net.{n}": p.view(s).to(d) for n, p, s, d in zip(names, parts, shapes, dtypes)}
        out = torch.func.functional_call(net, state, (x.to(x_type), mask))
        return out.to(torch.float32)

    def embed_q(flat_v, x_q, scale, mask):
        dq = compute_dtype if compute_dtype is not None else torch.float32
        return embed(flat_v, x_q.to(dq) * scale[:, None, :].to(dq), mask)

    int8_wire = isinstance(feats_dtype, str) and feats_dtype == "int8"
    x_dtype = torch.float32 if feats_dtype is None or int8_wire else feats_dtype
    paths: Dict[int, str] = {}
    for t in bucket_lengths:
        b, t = int(batch), int(t)
        m = torch.ones((b, t), dtype=torch.bool)
        d = os.path.join(out_dir, f"t{t}")
        if int8_wire:
            args = (flat, torch.zeros((b, t, feat_dim), dtype=torch.int8),
                    torch.ones((b, feat_dim), dtype=torch.float32), m)
            export_pjrt_bundle(embed_q, args, d, baked=[True, False, False, False], device=dev,
                               params_ref="../params.bin")
        else:
            args = (flat, torch.zeros((b, t, feat_dim), dtype=x_dtype), m)
            export_pjrt_bundle(embed, args, d, baked=[True, False, False], device=dev,
                               params_ref="../params.bin")  # one blob shared by the buckets
        paths[t] = d
    return paths


def write_nnet_config(out_dir: str, model_name: str, model_params: Dict, checkpoint_path: str,
                      feat_config: Optional[Dict] = None) -> str:
    """Blueprint + creation-string equivalent: enough to rebuild the model
    and reload its weights (the reference's config/nnet.config), with the
    keys of JAX's ``nnet_config.yaml``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "nnet_config.yaml")
    save_yaml({"model_name": model_name, "model_params": model_params,
               "checkpoint": os.path.abspath(checkpoint_path), "feat_config": feat_config or {}}, path)
    return path


def load_model_from_config(config_path: str, device: Any = None):
    """Rebuild ``(module, variables, cfg)`` from nnet_config.yaml: the
    module from the port's ``MODELS`` on ``device`` (the CUDA card unless
    ``device="cpu"``), ``variables = {"params", "batch_stats"}`` from the
    checkpoint (train/checkpoint.py: state_dict names, ``backbone.*`` for
    the module's), as JAX's returns its trees. A port checkpoint and a JAX
    checkpoint are different files: this reads the port's."""
    from .models import MODELS
    from .train.checkpoint import load_checkpoint

    cfg = load_yaml(config_path)
    module = MODELS[cfg["model_name"]](**cfg.get("model_params", {}), device=device)
    payload = load_checkpoint(cfg["checkpoint"], device=device)
    variables = {"params": payload["params"], "batch_stats": payload.get("batch_stats", {})}
    return module, variables, cfg
