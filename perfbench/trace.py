"""The traced window: torch.profiler over the card and the benchmark's own
spans, kept in memory and reduced to what the per-layer readers need.

The benchmark marks its calls into the program with `span(name)`
(`perfbench.<what>`, a `record_function` region: a no-op when nothing
records). `Trace.from_profile` keeps, from the profile, every device
operation (kernels, copies, sets) as (start, end, name) in seconds and
every span of the benchmark's own (the spans' shadows on the device's
timeline left out); `window` is the span named
`perfbench.window`, which encloses the timed window up to its final sync.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch

WINDOW = "perfbench.window"


def span(name: str):
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled():
    """Yields a profiler recording the CPU's ops and the card's operations."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False, with_stack=False) as prof:
        yield prof


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if end <= reach:
            continue
        total += end - max(start, reach)
        reach = end
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """(start, end) of every stretch of [lo, hi] that no interval covers."""
    gaps, reach = [], lo
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, end)
    if hi > reach:
        gaps.append((reach, hi))
    return gaps


def _annotation(name: str, is_user_annotation) -> bool:
    """A span's shadow on the device's timeline, which is no operation."""
    return name.startswith("perfbench.") or bool(is_user_annotation and is_user_annotation())


@dataclasses.dataclass
class Trace:
    ops: list      # (start_s, end_s, name) of each device operation
    spans: list    # (start_s, end_s, name) of each span of the benchmark's

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        ops, spans = [], []
        for e in prof.profiler.kineto_results.events():
            t = (e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9, e.name())
            if e.device_type() != DeviceType.CUDA:
                if t[2].startswith("perfbench."):
                    spans.append(t)
            elif not _annotation(t[2], getattr(e, "is_user_annotation", None)):
                ops.append(t)
        return cls(ops, spans)

    @property
    def window(self):
        (lo, hi), = [(s, e) for s, e, n in self.spans if n == WINDOW]
        return lo, hi

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def busy_s(self) -> float:
        return union_seconds([(s, e) for s, e, _ in self.ops], *self.window)

    def op_seconds(self, match) -> float:
        """Summed time of the device operations inside the window whose name
        satisfies match(name)."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for s, e, n in self.ops
                   if e > lo and s < hi and match(n))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and the
        longest idle gaps, each named by the innermost span of the
        benchmark's that was open when it began."""
        lo, hi = self.window
        by_name = defaultdict(float)
        for s, e, n in self.ops:
            if e > lo and s < hi:
                by_name[n[:160]] += min(e, hi) - max(s, lo)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        inner = [t for t in self.spans if t[2] != WINDOW]
        longest = sorted(idle_gaps([(s, e) for s, e, _ in self.ops], lo, hi),
                         key=lambda g: g[0] - g[1])[:top]
        gaps = []
        for start, end in longest:
            open_ = [t for t in inner if t[0] <= start < t[1]]
            name = min(open_, key=lambda t: t[1] - t[0])[2] if open_ else "outside spans"
            gaps.append([name, end - start])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}
