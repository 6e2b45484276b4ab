"""d_ms.train: the D phase's device time a training step, in ms: the median
over the window's steps of the device extent of the program's
`cmgan.train.d` span (the snapshot, the D update, the select-back)."""

from perfbench import spans


def read(reading):
    return spans.unit_median(reading, "cmgan.train.step",
                             lambda u: spans.device_ms(u, "cmgan.train.d"))
