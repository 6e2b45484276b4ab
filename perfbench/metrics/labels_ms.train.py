"""labels_ms.train: the PESQ labels' device time a training step, in ms: the
median over the window's steps of the device extent of the program's
`cmgan.train.labels` span."""

from perfbench import spans


def read(reading):
    return spans.unit_median(reading, "cmgan.train.step",
                             lambda u: spans.device_ms(u, "cmgan.train.labels"))
