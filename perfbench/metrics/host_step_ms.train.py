"""host_step_ms.train: the host's time in a training step, in ms: the median
over the window's steps of the host duration of the program's
`cmgan.train.step` span, what launching a step costs the host."""

from perfbench import spans


def read(reading):
    return spans.unit_median(reading, "cmgan.train.step",
                             lambda u: spans.host_ms(u, "cmgan.train.step"))
