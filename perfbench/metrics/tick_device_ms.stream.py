"""tick_device_ms.stream: the device part of a streaming tick, in ms: the
median over the window's ticks of the device extent of the program's
`cmgan.stream.device` span (the copy in, the generator, the copy out)."""

from perfbench import spans


def read(reading):
    return spans.unit_median(reading, "cmgan.stream.tick",
                             lambda u: spans.device_ms(u, "cmgan.stream.device"))
