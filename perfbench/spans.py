"""The program's own spans: the benchmark's one door to the span log of
`cmgan_torch.utils` (`recorded()`), as an architecture's `launches()`
is to its counters.

The program records a span only while a profiler records, so in a
`--trace 1` run its log holds what the window ran. A span has a name
(`cmgan.<layer>.<what>`), a host interval in ns on the profiler's clock
(the clock of `Trace`'s stamps), the ids of its parent and of its root
(the outermost span: one a step, tick or call) and its device extent in
ms (None without CUDA). `units` keeps the units whose root lies inside
the traced window and groups their spans by root. A program without the
log (an older checkout), or a log that overflowed, gives None, and so
does every reader built on it.
"""

from __future__ import annotations

import bisect
import statistics

from perfbench.trace import idle_gaps


def program_spans():
    """The program's recorded spans, or None where it keeps none."""
    try:
        from cmgan_torch.utils import recorded
    except ImportError:
        return None
    return recorded()


def units(reading, root: str):
    """The spans of each unit of the window whose root span is named
    `root`: a list a unit, or None where the run gives none."""
    tr = reading.trace
    spans = program_spans() if tr is not None else None
    if not spans:
        return None
    lo, hi = tr.window
    roots = {s.id for s in spans if s.id == s.root and s.name == root and s.end_ns is not None
             and lo <= s.start_ns * 1e-9 and s.end_ns * 1e-9 <= hi}
    groups = {}
    for s in spans:
        if s.root in roots:
            groups.setdefault(s.root, []).append(s)
    return list(groups.values()) or None


def device_ms(unit, *names):
    """The summed device extents of the unit's spans of these names; None
    where it has none, or one without an extent."""
    ext = [s.device_ms for s in unit if s.name in names]
    return sum(ext) if ext and None not in ext else None


def host_ms(unit, *names):
    """The summed host durations of the unit's spans of these names; None
    where the unit ran on no device (its root has no device extent), since
    the host's time is then the work itself, not the host's part beside
    the card."""
    root = next(s for s in unit if s.id == s.root)
    ms = [(s.end_ns - s.start_ns) * 1e-6 for s in unit if s.name in names]
    return sum(ms) if ms and root.device_ms is not None else None


def unit_median(reading, root: str, value):
    """The median over the window's units of value(unit), leaving out the
    units that give None; None where none gives a number."""
    values = [value(u) for u in units(reading, root) or []]
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def idle_share(reading, root: str, phases, among):
    """% of the traced window that the card spent idle in gaps that began
    while the host was inside a span named in `phases`, the innermost
    open span among the span names `among` (which never nest in each
    other) deciding."""
    tr = reading.trace
    us = units(reading, root)
    if tr is None or not tr.ops or not us:
        return None
    marks = sorted((s.start_ns * 1e-9, s.end_ns * 1e-9, s.name) for u in us for s in u
                   if s.name in among)
    if not marks:
        return None
    starts = [m[0] for m in marks]
    idle = 0.0
    for start, end in idle_gaps([(s, e) for s, e, _ in tr.ops], *tr.window):
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < marks[i][1] and marks[i][2] in phases:
            idle += end - start
    return 100.0 * idle / tr.window_s
