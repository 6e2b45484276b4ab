"""layernorm_ms.stream: LayerNorm's device time a streaming tick, in ms: the
summed device time, inside the traced window, of the LayerNorm kernels
(ATen's `layer_norm` kernels and the program's fused `layernorm_regs`,
`_span` and `_long`), over the window's ticks."""

import re

KERNELS = re.compile(r"layer_?norm", re.IGNORECASE)


def read(reading):
    tr, units = reading.trace, reading.measured.get("units")
    if tr is None or not units:
        return None
    seconds = tr.op_seconds(lambda name: bool(KERNELS.search(name)))
    return 1e3 * seconds / units if seconds > 0 else None
