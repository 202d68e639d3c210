"""The collective audit of a mesh train step, from the profiler
(counterpart: asv_subtools_tpu/parallel/audit.py).

JAX compiles the step and reads the collectives out of the HLO. Here the
step is eager, so the audit runs it: ``audit_train_step`` takes N steps
under ``torch.profiler`` and reads the trace's communication events. Each
collective the program issues is one ``c10d::*`` dispatcher op (whatever
the backend), whose recorded input shapes give its element counts. Its
element type comes from the backend's own event for that op (a ``gloo:*``
or ``nccl:*`` host event, ``record_param_comms``): the first one, at or
after the op's start in the same process, that states a type for the
op's element count and is not yet taken by an earlier op. The backend
runs the ops in the order the program issues them, so two ops of one
size in two types (ZeRO-3's all-gather in the compute type and its
reduce-scatter in the master type) each read their own. The
report keeps JAX's interface: ``counts``, ``bytes_by_op``,
``total_bytes`` and ``table``, per step, under XLA's op names
(all-reduce, all-gather, reduce-scatter, all-to-all, broadcast, ...).

Bytes are the tensor each op names on this rank: an all-reduce's
tensor, an all-gather's input shard, a reduce-scatter's output shard
(JAX counts the result, which for an all-gather is the shard times the
group's size).

XLA's "involuntary full rematerialization" count has no counterpart in an
eager step (there is no partitioner to reshard behind the program's
back): ``involuntary_remats`` is None.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "float": 4, "float32": 4, "double": 8, "float64": 8, "c10::bfloat16": 2, "bfloat16": 2, "c10::half": 2,
    "half": 2, "float16": 2, "long int": 8, "int64": 8, "int": 4, "int32": 4, "bool": 1, "unsigned char": 1,
    "byte": 1, "char": 1, "int8": 1, "uint8": 1, "long": 8, "bfloat": 2,
}

_OPS = {
    "allreduce": "all-reduce", "allreducecoalesced": "all-reduce",
    "allgather": "all-gather", "allgatherbase": "all-gather", "allgatherintotensorcoalesced": "all-gather",
    "allgathercoalesced": "all-gather",
    "reducescatter": "reduce-scatter", "reducescatterbase": "reduce-scatter",
    "reducescattertensorcoalesced": "reduce-scatter",
    "alltoall": "all-to-all", "alltoallbase": "all-to-all",
    "broadcast": "broadcast", "reduce": "reduce", "gather": "gather", "scatter": "scatter",
    "send": "collective-permute", "recv": "collective-permute", "recvanysource": "collective-permute",
}


def _op_name(raw: str) -> Optional[str]:
    key = raw.split("::")[-1].split(":")[-1].replace("_", "").lower()
    return _OPS.get(key)


def _numel(dims: Any) -> int:
    """Elements of one recorded shape, or of every shape of a list."""
    if not isinstance(dims, list):
        return 0
    if dims and all(isinstance(d, int) for d in dims):
        n = 1
        for d in dims:
            n *= d
        return n
    return sum(_numel(d) for d in dims)


@dataclasses.dataclass
class CollectiveAudit:
    """The collectives of ``steps`` steps: one dict per collective (op,
    elements, dtype, bytes). The counts and bytes are per step."""

    collectives: List[Dict[str, Any]]
    steps: int = 1
    involuntary_remats: Optional[int] = None

    def counts(self) -> Dict[str, int]:
        c = Counter(x["op"] for x in self.collectives)
        return {op: n // self.steps for op, n in sorted(c.items())}

    def bytes_by_op(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for x in self.collectives:
            out[x["op"]] = out.get(x["op"], 0) + x["bytes"]
        return {op: b // self.steps for op, b in sorted(out.items())}

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op().values())

    def table(self) -> str:
        """Markdown table for PERF.md."""
        lines = ["| collective | count | bytes/step |", "|---|---|---|"]
        counts, by_op = self.counts(), self.bytes_by_op()
        for op in counts:
            lines.append(f"| {op} | {counts[op]} | {by_op[op] / 1e6:.2f} MB |")
        lines.append(f"| **total** | {sum(counts.values())} | **{self.total_bytes / 1e6:.2f} MB** |")
        lines.append("\nInvoluntary full rematerializations: not applicable (eager step)")
        return "\n".join(lines)


def _backend_counts(e: Dict[str, Any]) -> List[Tuple[int, str]]:
    """(element count, type) pairs a backend event states: a ``gloo:*`` or
    ``nccl:*`` event's input shapes and types, a ``record_param_comms``
    event's message sizes and dtype."""
    a, name = e["args"], e.get("name", "")
    out = []
    if name.startswith(("gloo:", "nccl:")):
        out += [(_numel(d), t) for t, d in zip(a.get("Input type", []), a.get("Input Dims", [])) if t and _numel(d)]
    if "dtype" in a:
        out += [(a[k], str(a["dtype"])) for k in ("In msg nelems", "Out msg nelems", "In split size")
                if isinstance(a.get(k), int) and a[k] > 0]
    return out


def audit_trace(trace: Dict[str, Any], steps: int = 1) -> CollectiveAudit:
    """A CollectiveAudit from a chrome trace (``export_chrome_trace``'s
    JSON) of ``steps`` steps."""
    events = sorted((e for e in trace.get("traceEvents", []) if isinstance(e, dict) and "args" in e
                     and e.get("cat") in (None, "cpu_op", "user_annotation")), key=lambda e: e.get("ts", 0))
    # the host events that state a type (device kernels run late and are left out)
    backend = [(e.get("ts", 0), e.get("pid"), _backend_counts(e)) for e in events]
    backend = [b for b in backend if b[2]]
    taken = [False] * len(backend)
    collectives = []
    for e in events:
        name = e.get("name", "")
        if not name.startswith("c10d::") or e.get("ph") != "X":
            continue
        op = _op_name(name)
        if op is None:
            continue
        a = e["args"]
        # the first tensor list: an all-reduce's tensors, an all-gather's
        # inputs (its output lists carry no shapes), a reduce-scatter's
        # outputs
        dims = [d for d, t in zip(a.get("Input Dims", []), a.get("Input type", [])) if t == "TensorList"]
        tensors = dims[0] if dims else []
        elements = _numel(tensors)
        wanted = {elements, *(_numel(t) for t in tensors)}
        dtype = None
        for i, (ts, pid, counts) in enumerate(backend):
            if taken[i] or ts < e.get("ts", 0) or pid != e.get("pid"):
                continue
            dtype = next((t for n, t in counts if n in wanted), None)
            if dtype is not None:
                taken[i] = True
                break
        if dtype is None:
            raise ValueError(f"{name}: no backend event states the type of {elements} elements")
        size = _DTYPE_BYTES.get(dtype.lower())
        if size is None:
            raise ValueError(f"{name}: unknown element type {dtype!r}")
        collectives.append({"op": op, "elements": elements, "dtype": dtype, "bytes": elements * size})
    return CollectiveAudit(collectives=collectives, steps=steps)


def audit_train_step(run_step: Callable[[], Any], steps: int = 2) -> CollectiveAudit:
    """Run ``run_step()`` ``steps`` times under torch.profiler (CPU and,
    where there is one, CUDA activity) and audit the collectives it
    issued. Every rank of the mesh must run it (the steps are
    collective)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        for _ in range(steps):
            run_step()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return audit_trace(trace, steps)
