"""The traced stretch: ``torch.profiler`` over a bounded run of work,
reduced in memory (no trace file) to what the per-layer metrics read.

The profiler records the card's activity: its kernels, copies and
memsets, and the host's CUDA runtime calls. The stretch's window runs
from the first event to the last on either side. The card is busy where
any kernel, copy or memset runs: the union of their intervals. Each idle
gap is named by the innermost host event that covers its middle (a CUDA
runtime call, such as a blocking copy or a synchronize) or ``host (no
CUDA call)``: Python and the program's host code.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]  # device seconds by kernel name
    idle_gaps: List[Tuple[str, float]]  # seconds by what the host was doing, longest first
    work: list  # shapes run in the stretch, as ``fn`` recorded them

    def time_of(self, kernels: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds one of ``kernels``
        as a whole word (the profiler's names carry templates and
        arguments)."""
        return sum(s for name, s in self.kernel_s.items() if any(_holds(name, k) for k in kernels))

    def device_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]


def _holds(name: str, word: str) -> bool:
    i = name.find(word)
    while i >= 0:
        before = name[i - 1] if i > 0 else " "
        after = name[i + len(word)] if i + len(word) < len(name) else " "
        if not (before.isalnum() or before == "_") and not (after.isalnum() or after == "_"):
            return True
        i = name.find(word, i + 1)
    return False


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _innermost(host, starts, t: float, reach: int = 4096) -> str:
    """The latest-starting host event that covers time t (host sorted by
    start)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host (no CUDA call)"


def reduce(events: List[Tuple[str, bool, float, float]], work: list) -> Optional[TraceSummary]:
    """events: (name, on the device, start us, end us). None when the card
    ran nothing."""
    device = [(s, e, n) for n, dev, s, e in events if dev and e > s]
    host = [(s, e, n) for n, dev, s, e in events if not dev and e >= s]
    if not device:
        return None
    start = min([s for s, _, _ in host] + [s for s, _, _ in device])
    end = max([e for _, e, _ in host] + [e for _, e, _ in device])
    busy = _union([(s, e) for s, e, _ in device])
    kernel_s: Dict[str, float] = {}
    for s, e, n in device:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) * 1e-6
    host.sort()
    starts = [s for s, _, _ in host]
    gaps, prev = {}, start
    for a, b in busy + [(end, end)]:
        if a > prev:
            name = _innermost(host, starts, 0.5 * (a + prev))
            gaps[name] = gaps.get(name, 0.0) + (a - prev) * 1e-6
        prev = max(prev, b)
    return TraceSummary(window_s=(end - start) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                        kernel_s=kernel_s, idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
                        work=work)


def profile(torch, fn: Callable[[list], None]) -> Optional[TraceSummary]:
    """Run ``fn(work)`` under the profiler (host and card), wait for the
    card, and reduce. ``fn`` appends what it ran to ``work``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    # the card's activity alone (kernels, copies, and the host's CUDA runtime
    # calls): recording every aten op on the host slows a launch-heavy step
    # enough to make the card wait on the profiler
    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    work: list = []
    with _profile(activities=activities) as prof:
        fn(work)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    # a span the benchmark marks (record_function) also shows on the card's
    # timeline as an annotation: not work, so it is left out there
    events = [(e.name, e.device_type == DeviceType.CUDA, float(e.time_range.start), float(e.time_range.end))
              for e in prof.events()
              if not (e.device_type == DeviceType.CUDA and getattr(e, "is_user_annotation", False))]
    return reduce(events, work)
