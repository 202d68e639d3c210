"""The device mesh over processes (counterpart: asv_subtools_tpu/parallel/mesh.py).

One process drives one device (a GPU, or the CPU in the tests); the
processes join through ``torch.distributed`` (NCCL on the card, gloo on
the CPU), and the mesh is a ``DeviceMesh`` with dims ``("data",
"model")``. The batch is split over ``"data"``; ``"model"`` holds the
margin head's classifier rows. The functions keep JAX's names:

* :func:`initialize_multihost` joins the group (JAX's arguments, or
  torchrun's environment), :func:`make_mesh` builds the mesh over it.
* :func:`shard_batch` keeps this rank's rows of a global batch,
  :func:`replicate` broadcasts a tree from rank 0.
* Partition rules map ``(name, leaf) -> spec``: None (replicated),
  :data:`DATA_AXIS` (ZeRO-3: the leaf's row-major elements split into
  equal contiguous chunks, one a data rank) or :data:`MODEL_AXIS` (rows
  split over the model ranks). :func:`partition_params` applies them and
  checks divisibility; :func:`opt_state_shardings` gives each optimizer
  moment its parameter's spec.
* :class:`Placement` carries a state between its full form and this
  rank's shards, and runs the step's collectives.

ZeRO-3's shard is flat, not a dim: JAX prefers the last dim for a reason
of XLA's SPMD partitioner (its mesh.py:122-131) that has no counterpart
here, and a flat chunk of the row-major elements is dim 0's split
wherever dim 0 divides, while it needs no choice of dim. Which leaves are
sharded is JAX's rule: at least ``min_size`` elements and some dim that
divides by the data size; smaller leaves stay replicated.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import local_index
from .comm import Axis

DATA_AXIS = "data"
MODEL_AXIS = "model"

Rules = Callable[[str, torch.Tensor], Optional[str]]


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join the process group (the torch twin of JAX's
    ``jax.distributed.initialize``): ``coordinator_address`` "host:port"
    with ``num_processes`` and ``process_id``, or with no arguments
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    ``backend`` defaults to NCCL where CUDA is available, else gloo; under
    NCCL the process's card is ``device.local_index()``, the one
    ``resolve_device()`` returns."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs: Dict[str, Any] = {"backend": backend}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        kwargs.update(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                      rank=int(process_id))
    else:
        kwargs["init_method"] = "env://"
    dist.init_process_group(**kwargs)
    if backend == "nccl":
        torch.cuda.set_device(local_index())


def make_mesh(num_data: Optional[int] = None, num_model: int = 1):
    """A ``(data, model)`` DeviceMesh over every process of the group
    (default: model 1). Raises when the sizes do not multiply to the world
    size, as JAX's does for its devices."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_multihost (or run under torchrun)")
    n = dist.get_world_size()
    if num_data is None:
        if n % num_model:
            raise ValueError(f"{n} processes not divisible by model={num_model}")
        num_data = n // num_model
    if num_data * num_model != n:
        raise ValueError(f"mesh {num_data}x{num_model} != {n} processes")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (num_data, num_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_axis(mesh, name: str) -> Axis:
    """The group, size and this process's index of one mesh dim."""
    return Axis(group=mesh.get_group(name), size=int(mesh.size(mesh.mesh_dim_names.index(name))),
                rank=int(mesh.get_local_rank(name)))


def _map(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, (torch.Tensor, np.ndarray)) else tree


def shard_batch(mesh, tree: Any) -> Any:
    """This rank's rows of a global batch (tensors or numpy arrays of one
    dim or more; scalars pass through). Raises when a batch does not
    divide by the data size."""
    d = mesh_axis(mesh, DATA_AXIS)

    def rows(x):
        if x.ndim == 0:
            return x
        if x.shape[0] % d.size:
            raise ValueError(f"batch of {x.shape[0]} rows does not divide by the data size {d.size}")
        n = x.shape[0] // d.size
        return x[d.rank * n:(d.rank + 1) * n]

    return _map(tree, rows)


def replicate(mesh, tree: Any) -> Any:
    """The tree as rank 0 holds it, on every rank (a broadcast of each
    tensor in place; the mesh's whole group)."""

    def bcast(x):
        if isinstance(x, torch.Tensor):
            dist.broadcast(x, src=0)
        return x

    return _map(tree, bcast)


def is_classifier(name: str, leaf: torch.Tensor) -> bool:
    """The margin heads' classifier ``[num_targets * sub_k, D]``: a 2-dim
    ``weight`` directly under a ``loss`` module."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-1] == "weight" and parts[-2] == "loss" and leaf.dim() == 2


def classifier_partition_rules(name: str, leaf: torch.Tensor) -> Optional[str]:
    """The margin head's class rows over ``"model"``; everything else
    replicated (the one parameter that grows with the speaker inventory)."""
    return MODEL_AXIS if is_classifier(name, leaf) else None


def make_fsdp_rules(mesh, min_size: int = 8192) -> Rules:
    """ZeRO-3 rules: a leaf of at least ``min_size`` elements with some dim
    that divides by the data size is sharded over ``"data"`` (a flat
    chunk); smaller leaves stay replicated, and with a data size of 1
    every leaf does. With a model size above 1 the classifier keeps its
    rows on ``"model"``."""
    n = int(mesh.size(mesh.mesh_dim_names.index(DATA_AXIS)))
    model_n = int(mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS)))

    def rules(name: str, leaf: torch.Tensor) -> Optional[str]:
        shape = tuple(leaf.shape)
        if model_n > 1 and is_classifier(name, leaf):
            return MODEL_AXIS
        if not shape or int(np.prod(shape)) < min_size or n <= 1:
            return None
        return DATA_AXIS if any(s % n == 0 for s in shape) else None

    return rules


def partition_params(mesh, params: Dict[str, torch.Tensor], rules: Optional[Rules] = classifier_partition_rules
                     ) -> Dict[str, Optional[str]]:
    """Each parameter's spec from ``rules``; raises when a model-sharded
    leaf's rows (``num_targets * sub_k`` for the classifier) do not divide
    by the model size."""
    model_n = int(mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS)))
    specs = {k: (rules(k, p) if rules is not None else None) for k, p in params.items()}
    for k, spec in specs.items():
        if spec == MODEL_AXIS and params[k].shape[0] % model_n:
            raise ValueError(f"{k}: {params[k].shape[0]} rows (num_targets * sub_k) do not divide by the model "
                             f"size {model_n}")
    return specs


def opt_state_shardings(mesh, opt_state: Any, params: Dict[str, torch.Tensor],
                        param_specs: Dict[str, Optional[str]]) -> Any:
    """The optimizer state's tree with each leaf's spec: a moment keyed by
    a parameter's name, of that parameter's shape, follows it; the step
    counters and anything else stay replicated (None)."""

    def walk(node: Any, key: Optional[str]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, None) for v in node)
        if key in params and isinstance(node, torch.Tensor) and node.shape == params[key].shape:
            return param_specs[key]
        return None

    return walk(opt_state, None)


def host_local_slice(num_items: int, *, epoch: int = 0, shuffle_seed: int = 1024) -> np.ndarray:
    """This process's share of a global index set: the permutation of
    ``shuffle_seed + epoch``, every world-size-th item from the rank (the
    reference's DistributedSampler split, egs_online.py:67-128)."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    idx = np.random.default_rng(shuffle_seed + epoch).permutation(num_items)
    return idx[rank::world]


class Placement:
    """A train state's layout on the mesh and the step's collectives.

    ``specs`` maps each parameter to None, DATA_AXIS or MODEL_AXIS
    (``partition_params``). At rest a data-sharded leaf is this rank's
    flat chunk, a model-sharded leaf its rows; BatchNorm statistics and
    the step are replicated. The step gathers the data-sharded leaves at
    use (one all-gather), averages the gradients over ``"data"`` (one
    all-reduce for the rest, one reduce-scatter for the sharded leaves,
    both the list forms that gloo and NCCL take) and reduces its scalars
    in one all-reduce over the world. A collective over a group of one
    process is skipped: on one process the step is the plain step."""

    def __init__(self, mesh, specs: Dict[str, Optional[str]], shapes: Dict[str, torch.Size]):
        self.mesh = mesh
        self.specs = specs
        self.shapes = shapes
        self.data = mesh_axis(mesh, DATA_AXIS)
        self.model = mesh_axis(mesh, MODEL_AXIS)
        self.world = self.data.size * self.model.size
        self.sharded = [k for k, s in specs.items() if s == DATA_AXIS]

    # -- layout --------------------------------------------------------------
    def _cut(self, spec: Optional[str], full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole leaf under ``spec``."""
        if spec == DATA_AXIS:
            n = full.numel() // self.data.size
            return full.reshape(-1)[self.data.rank * n:(self.data.rank + 1) * n]
        if spec == MODEL_AXIS:
            n = full.shape[0] // self.model.size
            return full[self.model.rank * n:(self.model.rank + 1) * n]
        return full

    def shard_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self._cut(self.specs.get(k), v).clone() for k, v in params.items()}

    def shard_tree(self, tree: Any, specs: Any) -> Any:
        """A full optimizer state cut to this rank (specs from
        :func:`opt_state_shardings`, with parameter names as keys)."""
        if isinstance(tree, dict):
            return {k: self.shard_tree(v, specs[k]) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.shard_tree(v, s) for v, s in zip(tree, specs))
        if specs is None or not isinstance(tree, torch.Tensor):
            return tree
        return self._cut(specs, tree).clone()

    def _gather_flat(self, names: List[str], local: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
        """One all-gather over "data" of the chunks of ``names``: each
        leaf whole, in ``dtype``, shaped as its parameter."""
        if not names:
            return []
        if self.data.size == 1:
            return [v.to(dtype).view(self.shapes[k]) for k, v in zip(names, local)]
        flat = torch.cat([v.reshape(-1).to(dtype) for v in local])
        parts = [torch.empty_like(flat) for _ in range(self.data.size)]
        dist.all_gather(parts, flat, group=self.data.group)
        out, off = [], 0
        for k, v in zip(names, local):
            n = v.numel()
            out.append(torch.cat([p[off:off + n] for p in parts]).view(self.shapes[k]))
            off += n
        return out

    def gather_params(self, params: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """The parameters as the forward uses them: every data-sharded leaf
        gathered whole in ``dtype`` (the compute type: ZeRO-3's at-use
        gather), model-sharded rows and replicated leaves as they are."""
        full = dict(params)
        full.update(zip(self.sharded, self._gather_flat(self.sharded, [params[k] for k in self.sharded], dtype)))
        return full

    def _gather_model(self, x: torch.Tensor) -> torch.Tensor:
        if self.model.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.model.size)]
        dist.all_gather(parts, x.contiguous(), group=self.model.group)
        return torch.cat(parts, 0)

    def full_tree(self, tree: Any, specs: Any, key: Optional[str] = None) -> Any:
        """The whole tree from this rank's shards (every rank takes part;
        checkpoints are written from it). A leaf keyed by a parameter's
        name takes that parameter's shape."""
        if isinstance(tree, dict):
            return {k: self.full_tree(v, specs[k], k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.full_tree(v, s) for v, s in zip(tree, specs))
        if specs is None or not isinstance(tree, torch.Tensor):
            return tree
        if specs == MODEL_AXIS:
            return self._gather_model(tree)
        if self.data.size == 1:
            return tree.view(self.shapes[key])
        parts = [torch.empty_like(tree) for _ in range(self.data.size)]
        dist.all_gather(parts, tree.contiguous(), group=self.data.group)
        return torch.cat(parts).view(self.shapes[key])

    # -- the step's reductions -----------------------------------------------
    def mean_grads(self, names: Sequence[str], grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients' mean over "data": data-sharded leaves (whole in
        ``grads``) reduce-scattered to this rank's chunk, the rest
        all-reduced in one flat bucket."""
        d = self.data.size
        if d == 1:
            return [g.reshape(-1) if self.specs.get(k) == DATA_AXIS else g for k, g in zip(names, grads)]
        out: List[Optional[torch.Tensor]] = [None] * len(names)
        rest = [i for i, k in enumerate(names) if self.specs.get(k) != DATA_AXIS]
        if rest:
            flat = torch.cat([grads[i].reshape(-1) for i in rest])
            dist.all_reduce(flat, group=self.data.group)
            flat = flat / d
            off = 0
            for i in rest:
                n = grads[i].numel()
                out[i] = flat[off:off + n].view_as(grads[i])
                off += n
        shard = [i for i, k in enumerate(names) if self.specs.get(k) == DATA_AXIS]
        if shard:
            inputs = [torch.cat([grads[i].reshape(-1)[r * (grads[i].numel() // d):(r + 1) * (grads[i].numel() // d)]
                                 for i in shard]) for r in range(d)]
            mine = torch.empty_like(inputs[0])
            dist.reduce_scatter(mine, inputs, group=self.data.group)
            mine = mine / d
            off = 0
            for i in shard:
                n = grads[i].numel() // d
                out[i] = mine[off:off + n]
                off += n
        return out  # type: ignore[return-value]

    def sq_norm_parts(self, names: Sequence[str], grads: List[torch.Tensor]) -> torch.Tensor:
        """This rank's share of the global squared norm, weighted so that a
        sum over the world counts every element once: replicated leaves
        over the world, model rows over "data", data chunks over
        "model"."""
        weight = {None: 1.0 / self.world, MODEL_AXIS: 1.0 / self.data.size, DATA_AXIS: 1.0 / self.model.size}
        norms = torch._foreach_norm(grads)
        total = 0.0
        for spec, w in weight.items():
            mine = [n for n, k in zip(norms, names) if self.specs.get(k) == spec]
            if mine:
                total = total + (torch.stack(mine) ** 2).sum() * w
        return total

    def world_sum(self, values: torch.Tensor) -> torch.Tensor:
        """The sum over every process of the mesh (one all-reduce)."""
        if self.world == 1:
            return values
        values = values.clone()
        dist.all_reduce(values)
        return values

    def gather_leaf(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """One data-sharded leaf whole (every data rank takes part)."""
        return self._gather_flat([name], [local], local.dtype)[0]

    def local_chunk(self, name: str, full: torch.Tensor) -> torch.Tensor:
        return self._cut(self.specs.get(name), full)
