"""The harness: finds a cell's files by name, runs its driver once, and
builds the result line.

Everything that belongs to one configuration, traffic mix, entry kind
or per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives:

- a configuration: the ``file`` of its ``configs`` entry;
- a traffic mix: ``traffic/<mix>.json``; its ``driver`` names the entry
  kind, ``drivers/<driver>.py``;
- a cell's correctness limits: ``limits/<workload>.json``, one limit a
  number that decides ``correct`` (a driver reads more numbers than it
  compares);
- a per-layer metric: ``layer_metrics/<metric>.py``, whose ``read(result)``
  returns the number or None.

A driver's ``run(ctx)`` returns a :class:`Result`. It must not import
the JAX package or JAX: :data:`FORBIDDEN` is checked by whole top-level
names once the window has closed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "asv_subtools_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    driver: ModuleType
    end_to_end: List[dict]
    per_layer: List[Tuple[dict, ModuleType]]


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, where to run."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float  # host clock at process start
    faults: Sequence[str] = ()  # planted faults (tests and calibration only)
    control: bool = False  # also read the lower-precision control (calibration only)


@dataclasses.dataclass
class Result:
    setup_s: float
    window_s: float
    end_to_end: Dict[str, float]
    counters: Dict[str, float]
    compared: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None  # tracing.TraceSummary of the traced stretch
    control: Optional[Dict[str, float]] = None
    config: Optional[dict] = None  # the cell's configuration, for the per-layer readers
    notes: List[str] = dataclasses.field(default_factory=list)  # what the check saw, for standard error


def load_spec(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """A module from its file; the file's name may hold dots."""
    key = "benchmark_file_" + re.sub(r"\W", "_", str(path.resolve()))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def resolve(spec: dict, name: str, repo: Path = REPO, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` with its files, from the benchmark folder ``root``
    (``benchmark/`` beside ``BENCHMARK.json`` by default)."""
    root = root or repo / "benchmark"
    w = _named(spec["workloads"], name, "workload")
    config = json.loads((repo / _named(spec["configs"], w["config"], "configuration")["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = root / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, workload=w, config=config, traffic=traffic, limits=limits,
                driver=load_module(root / "drivers" / f"{traffic['driver']}.py"), end_to_end=e2e,
                per_layer=[(m, load_module(root / "layer_metrics" / f"{m['name']}.py")) for m in layer])


def correct(result: Result, limits: Dict[str, float]) -> bool:
    """Every number that has a limit read, finite and at or under it;
    something attempted and nothing failed. The run's other readings
    are reported, not compared."""
    if not limits or not set(limits) <= set(result.compared):
        return False
    return (result.attempted > 0 and result.failed == 0
            and all(math.isfinite(result.compared[k]) and result.compared[k] <= v for k, v in limits.items()))


def result_line(cell: Cell, result: Result, device: dict, trace: bool) -> dict:
    """The last line of a run: the keys the contract fixes, the compared
    numbers beside their limits last."""
    metrics: Dict[str, dict] = {}
    if not trace:
        values = {"setup_s": result.setup_s, **result.end_to_end}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m, reader in cell.per_layer:
            v = reader.read(result)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": correct(result, cell.limits), "attempted": result.attempted, "failed": result.failed,
            "metrics": metrics, "device": dict(device)}
    if trace and result.trace is not None:
        line["device"].update(busy_s=result.trace.busy_s, window_s=result.trace.window_s)
        line["breakdown"] = {"device_ops": [list(x) for x in result.trace.device_ops()],
                             "idle_gaps": [list(x) for x in result.trace.idle_gaps]}
    line["compared"] = {k: {"value": result.compared.get(k), "limit": v} for k, v in cell.limits.items()}
    return line


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(ctx: Context) -> Result:
    result = ctx.cell.driver.run(ctx)
    result.config = ctx.cell.config
    return result
