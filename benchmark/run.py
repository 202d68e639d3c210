"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``. It loads and
warms up the cell (``setup_s``, from process start to the first timed
item), measures for ``--seconds``, checks the window's outputs against
the plain reference, prints each compared number beside its limit on
standard error and, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``compared`` last.

It exits non-zero and prints no result without enough CUDA cards, or
when a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
CACHE = HERE / ".cache"
# every cache of the program and its libraries at a fixed path in the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
sys.path.insert(0, str(REPO))


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import harness

    cell = harness.resolve(harness.load_spec(REPO), args.workload, REPO)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.execute(harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                                             trace=bool(args.trace), device="cuda", t_start=T_START))
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": result.memory_peak_bytes}
    line = harness.result_line(cell, result, device, bool(args.trace))
    print(f"card: {_card_line()}; setup_s {result.setup_s}, window_s {result.window_s}", file=sys.stderr)
    for note in result.notes:
        print(f"check: {note}", file=sys.stderr)
    for name, value in result.compared.items():
        if name not in cell.limits:
            print(f"check: {name} {value} (read, not compared)", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
