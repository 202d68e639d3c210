"""Profiling helpers (counterpart: asv_subtools_tpu/utils/profiling.py):
a trace for Perfetto or chrome://tracing, a FLOP count (the reference's
thop/print_model equivalent: pytorch/libs/nnet/count_rules_for_thop.py,
bin/print_model.py), a timed loop that waits for the card, and parameter
counts by top-level module.

torch's flop counter counts the FLOPs of the matrix products and
convolutions a call runs; it has no counterpart of XLA's "bytes accessed"
and "transcendentals", which read -1.0 and 0.0 here (JAX's values when
XLA reports neither).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Union

import torch
from torch import nn


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the CPU, and CUDA when there is a
    card); ``log_dir/trace.json`` is written at its end, a Chrome trace
    that Perfetto opens. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def flops_estimate(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """The FLOPs of one call of ``fn(*args, **kwargs)`` by
    ``torch.utils.flop_counter.FlopCounterMode`` (the call runs once);
    ``bytes_accessed`` -1.0 and ``transcendentals`` 0.0: torch counts
    neither."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": -1.0, "transcendentals": 0.0}


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 2, **kwargs) -> Dict[str, float]:
    """Steady-state wall time of ``fn`` per call: the card synchronized
    before and after the timed loop; TFLOP/s from :func:`flops_estimate`
    where it counts any."""
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args, **kwargs)
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        _sync()
    dt = (time.perf_counter() - t0) / iters
    stats = {"seconds_per_call": dt}
    flops = flops_estimate(fn, *args, **kwargs)["flops"]
    if flops > 0:
        stats["tflops_per_second"] = flops / dt / 1e12
    return stats


def param_count(params: Union[nn.Module, Dict[str, torch.Tensor]]) -> Dict[str, int]:
    """Parameter counts by top-level module (the first part of each
    state_dict name) and their ``total``, of a module's parameters or of a
    {name: tensor} dict."""
    named = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    out: Dict[str, int] = {}
    for name, p in named:
        top = name.split(".", 1)[0]
        out[top] = out.get(top, 0) + p.numel()
    out["total"] = sum(out.values())
    return out
