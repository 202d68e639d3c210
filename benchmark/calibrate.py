"""Readings for a cell's correctness limits: the program's numbers over
many seeds, the lower-precision control's, and the planted faults',
in one process (the benchmark's own runs never run this).

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,... \\
        [--seconds 4] [--control] [--faults half_batch,state_unchanged] [--fault-seeds 21,22,23] \\
        [--dtype float32 --no-tf32]

Each run prints one JSON line: the seed, what was planted, the compared
numbers, the control's (with ``--control``: the reference computed with
float8 e4m3 products put in the program's place), the end-to-end
readings and what the check saw. ``--dtype`` runs the program in
another compute type, as a second witness beside the reference.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--dtype", default="", help="run the program in this compute type instead (a witness)")
    parser.add_argument("--no-tf32", action="store_true", help="the program's float32 products without TF32")
    args = parser.parse_args(argv)

    from benchmark import harness
    import torch

    cell = harness.resolve(harness.load_spec(REPO), args.workload, REPO)
    if args.dtype:
        cell.config = dict(cell.config, dtype=args.dtype)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if args.no_tf32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    runs = [(int(s), ()) for s in args.seeds.split(",") if s]
    runs += [(int(s), (f,)) for f in args.faults.split(",") if f for s in args.fault_seeds.split(",") if s]
    for seed, faults in runs:
        t0 = time.perf_counter()
        r = harness.execute(harness.Context(cell=cell, seed=seed, seconds=args.seconds, trace=False, device=device,
                                            t_start=t0, faults=faults, control=args.control and not faults))
        print(json.dumps({"seed": seed, "faults": list(faults), "compared": r.compared, "control": r.control,
                          "end_to_end": r.end_to_end, "setup_s": r.setup_s, "attempted": r.attempted,
                          "failed": r.failed, "notes": r.notes, "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
