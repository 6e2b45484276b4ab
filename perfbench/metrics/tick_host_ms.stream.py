"""tick_host_ms.stream: the host's own part of a streaming tick, in ms: the
median over the window's ticks of the host durations of the program's
`cmgan.stream.prep` (window slide, running RMS, scales) and
`cmgan.stream.emit` (WOLA, the result) spans."""

from perfbench import spans


def read(reading):
    return spans.unit_median(reading, "cmgan.stream.tick",
                             lambda u: spans.host_ms(u, "cmgan.stream.prep", "cmgan.stream.emit"))
