"""tick_p50_ms.stream: the median tick of the window, in ms, each tick from
the call of StreamBatcher.step to its outputs on the host."""

import statistics


def read(reading):
    ticks = reading.measured.get("tick_s")
    return 1e3 * statistics.median(ticks) if ticks else None
