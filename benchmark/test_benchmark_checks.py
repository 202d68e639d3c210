"""The check that decides ``correct``, seen to fail: each fault a cell
can have, planted under a run that skips the look for a chip, and the
lower-precision control put in the program's place. On the CPU the
cells run narrow and short (the program in float32, the real limits);
on the card (``-m cuda``) at their own sizes.

    python -m pytest benchmark/ -q
    python -m pytest benchmark/test_benchmark_checks.py -m cuda -q   # on the card
"""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness

REPO = Path(__file__).resolve().parent.parent
SPEC = harness.load_spec(REPO)


def _narrow(name: str) -> harness.Cell:
    cell = copy.copy(harness.resolve(SPEC, name))
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["dtype"] = "float32"
    if cell.traffic["driver"] == "extract":
        small = {"channels": 64, "mfa_conv": 96, "embd_dim": 16}
        cell.traffic = dict(cell.traffic, batch=4, check_sample=64, check_block=8, noise_s=4, pool=64,
                            length={"dist": "shifted_exponential", "min_s": 0.5, "mean_extra_s": 0.5, "cap_s": 2.0},
                            buckets=[8000, 16000, 32000])
    else:
        small = {"layers": [1, 1, 1, 1], "base_planes": 8, "embd_dim": 16}
        cell.config["head"]["num_targets"] = 50
        cell.traffic = dict(cell.traffic, batch=8, pool_batches=4, length={"dist": "fixed", "s": 0.5})
    cell.config["model"].update(small)
    cell.config["port"]["kwargs"].update(small)
    return cell


def _run(cell, faults=(), control=False, seed=2 ** 31 + 99, device="cpu", seconds=1.0):
    result = harness.execute(harness.Context(cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                                             t_start=time.perf_counter(), faults=faults, control=control))
    return result, harness.correct(result, cell.limits)


FAULTS = {"ecapa_c1024.extract_vox1": ("half_batch", "answer_altered"),
          "resnet34.train_vox2": ("state_unchanged", "half_batch", "answer_altered")}


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_a_sound_narrow_run_is_correct(workload):
    result, ok = _run(_narrow(workload))
    assert ok, result.compared


@pytest.mark.parametrize("workload,fault", [(w, f) for w in sorted(FAULTS) for f in FAULTS[w]])
def test_a_planted_fault_comes_out_not_correct(workload, fault):
    result, ok = _run(_narrow(workload), faults=(fault,))
    assert not ok, result.compared


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_the_float8_control_fails_a_limit(workload):
    cell = _narrow(workload)
    result, _ = _run(cell, control=True)
    assert any(result.control[k] > v for k, v in cell.limits.items()), result.control


def test_a_run_loads_no_jax_nor_the_jax_package():
    code = ("import sys, time, json\nsys.path.insert(0, '.')\n"
            "from benchmark import test_benchmark_checks as t, harness\n"
            "t._run(t._narrow('ecapa_c1024.extract_vox1'), seconds=0.5)\n"
            "print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_the_control_fails_and_the_program_passes_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size")
    cell = harness.resolve(SPEC, workload)
    result, ok = _run(cell, control=True, device="cuda", seconds=4.0)
    assert ok, result.compared
    assert any(result.control[k] > v for k, v in cell.limits.items()), result.control



@pytest.mark.parametrize("scale,turned,want", [(1.0, False, 0.0), (0.37, False, 0.0), (1.0, True, 2 ** 0.5)])
def test_the_head_gradient_error_takes_out_the_clips_factor(scale, turned, want):
    from benchmark import checks

    g = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0, 0.0]), "trunk": torch.ones(1000)}
    got = {k: v * scale for k, v in g.items()}
    if turned:  # the head's gradient at right angles to the reference's
        got["a"], got["b"] = torch.tensor([-4.0, 3.0]) * scale, torch.tensor([0.0, -1.0]) * scale
    params0 = {k: torch.zeros_like(v) for k, v in g.items()}
    run = lambda grad: {"losses": [1.0, 1.0, 1.0], "grad1": grad, "params3": {k: v + 1 for k, v in params0.items()}}
    out = checks.train_gaps(run(got), run(g), params0, head=["a", "b"])
    assert out["head_grad_err"] == pytest.approx(want, abs=1e-12)
