"""Profiling helpers (counterpart: asv_subtools_tpu/utils/profiling.py):
a trace for Perfetto or chrome://tracing, named spans inside the port, a
FLOP count (the reference's thop/print_model equivalent:
pytorch/libs/nnet/count_rules_for_thop.py, bin/print_model.py), a timed
loop that waits for the card, and parameter counts by top-level module.

Spans (:func:`span`, :func:`add`, :func:`totals`) mark the port's own
stretches of work. They record only while a torch profiler records, or
inside :func:`tracing`; otherwise a span costs one check of the
profiler's state. An on span is a ``record_function`` range, so the
Chrome trace that :func:`trace` exports shows it on the host's timeline
above the kernels it launched, and it adds its host seconds (and, given
a CUDA tensor, the card's seconds between two events on that tensor's
stream) to an in-memory registry that starts afresh with each profiled
session. The port's spans and counters, and the per-layer metric each
is for:

- ``extract.input``: each ``next`` of the caller's items
  (``extract.input_share``);
- ``extract.assemble``: per item the chunking and bucket placement, per
  batch the padded wave and lengths written into a staging slab before
  the card and the chunks' weighted sums after it
  (``extract.assemble_share``), with the counters
  ``extract.overlap_batches`` (batches whose assembly began while the
  batch before was still on the card) and ``extract.staging_allocs``
  (slab pairs allocated or grown), which no metric reads yet;
- ``extract.copy_in``: the enqueue of the slab's copy to the device and
  the mask built there from the lengths (``extract.copy_in_share``), with
  the counter ``extract.copy_in_bytes``, the wave's and lengths' bytes
  (``extract.copy_in_gbps``: since the copy is asynchronous, a rate of
  enqueue, not of PCIe);
- ``extract.launch``: the embed call, the host's enqueue of the fbank,
  CMVN and the model, and of the answers' copy to pinned memory
  (``extract.launch_share``);
- ``extract.copy_out``: the wait for the batch before's answers, the
  host's wait for the card (``extract.copy_out_share``);
- ``train.front_end``, ``train.forward`` (with the margin head and the
  loss), ``train.backward``, ``train.optimizer`` (the global norm, the
  clip, the update, semi-orth and the non-finite choice), each with the
  card's time (``train.<phase>_device_ms``);
- ``conformer.subsample``: the Conformer encoder's input subsampling and
  the positions' scale, once a call (``conformer.subsample_share``);
- ``conformer.attention``: ``RelPositionMultiHeadedAttention.forward``,
  once a block (``conformer.attention_share``,
  ``conformer.attention_roofline``), with the counters
  ``conformer.attention_fused`` and ``conformer.attention_plain`` (calls
  on the card that took the fused kernel K5, or the unfused chain),
  which no metric reads;
- ``conformer.conv_module``: the convolution module, once a block;
- ``conformer.pooling``: the Conformer x-vector's ``transform_out``
  through ``fc2``, once a call. These two, each with the card's time,
  no metric reads yet.

torch's flop counter counts the FLOPs of the matrix products and
convolutions a call runs; it has no counterpart of XLA's "bytes accessed"
and "transcendentals", which read -1.0 and 0.0 here (JAX's values when
XLA reports neither).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

# span name -> [count, host s, device s or None]; counter name -> total
_registry: Dict[str, Union[list, float]] = {}
# (span name, start event, end event) whose device time is not folded in yet
_pending: list = []
_FOLD_AT = 1024  # pending event pairs that make a span fold in those resolved
_forced = 0  # depth of open tracing() blocks
_session = False  # the registry holds the spans of the current on stretch


def reset() -> None:
    """Clear every span and counter."""
    _registry.clear()
    _pending.clear()


def _on() -> bool:
    """Whether spans record now. The first span or counter that finds them
    on after a span, a counter or :func:`totals` found them off starts the
    registry afresh."""
    global _session
    if _forced or _profiler_enabled():
        if not _session:
            reset()
            _session = True
        return True
    _session = False
    return False


def _fold(wait: bool) -> None:
    """Add the device seconds of the pending event pairs, oldest first:
    all of them, waiting for the card where one is unresolved, or up to
    the first unresolved."""
    done = 0
    for name, start, end in _pending:
        if not wait and not end.query():
            break
        end.synchronize()
        entry = _registry[name]
        entry[2] = (entry[2] or 0.0) + start.elapsed_time(end) * 1e-3
        done += 1
    del _pending[:done]


class _Span:
    __slots__ = ("name", "stream", "t0", "range", "start")

    def __init__(self, name: str, device: Optional[torch.Tensor]):
        self.name = name
        on_card = device is not None and device.is_cuda
        self.stream = torch.cuda.current_stream(device.device) if on_card else None

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.range = record_function(self.name)
        self.range.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            _pending.append((self.name, self.start, end))
        self.range.__exit__(*exc)
        t1 = time.perf_counter()
        entry = _registry.get(self.name)
        if entry is None:
            entry = _registry[self.name] = [0, 0.0, None if self.stream is None else 0.0]
        entry[0] += 1
        entry[1] += t1 - self.t0
        if len(_pending) > _FOLD_AT:
            _fold(wait=False)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device: Optional[torch.Tensor] = None):
    """A context manager that marks a named stretch of the port's work.

    Off (no profiler recording, no :func:`tracing` block) it is a null
    context and records nothing. On, it enters
    ``torch.profiler.record_function(name)`` and adds one count and its
    host seconds to the registry; given a CUDA tensor as ``device`` (one
    the stretch works on) it also records a pair of CUDA events on that
    tensor's current stream, whose interval (the card's time between the
    two markers, idle inside included) :func:`totals` adds as device
    seconds. Without one, or with a CPU tensor: device seconds None."""
    return _Span(name, device) if _on() else _OFF


def add(name: str, n: float) -> None:
    """Add ``n`` to the counter ``name`` where a span would record."""
    if _on():
        _registry[name] = _registry.get(name, 0) + n


def totals() -> Dict[str, Union[Tuple[int, float, Optional[float]], float]]:
    """``{span: (count, host s, device s or None)}`` and ``{counter: n}``
    of the current (or last) on stretch. Waits for the card only where a
    span's end event is unresolved. Read with spans off, it closes the
    stretch: the next span that records starts the registry afresh."""
    _on()
    if _pending:
        _fold(wait=True)
    return {k: tuple(v) if isinstance(v, list) else v for k, v in _registry.items()}


@contextlib.contextmanager
def tracing():
    """Spans record inside the block, with no profiler needed (tests and
    operators); the registry starts afresh at its first span."""
    global _forced, _session
    _session = False
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1
        _session = False


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the CPU, and CUDA when there is a
    card); ``log_dir/trace.json`` is written at its end, a Chrome trace
    that Perfetto opens. Yields the profiler.

    The port's spans (the module's docstring lists them) record inside the
    block: the exported trace shows each as a range on the host's
    timeline above the kernels it launched, and :func:`totals` sums them
    over the block."""
    from torch.profiler import ProfilerActivity, profile

    global _session
    _session = False
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
