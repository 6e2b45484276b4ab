"""idle_d_share.train: % of the traced window the card spent idle in gaps
that began while the host was labelling or in the D phase (the program's
`cmgan.train.labels` or `cmgan.train.d` span open)."""

from perfbench import spans

PHASES = ("cmgan.train.g", "cmgan.train.labels", "cmgan.train.d")


def read(reading):
    return spans.idle_share(reading, "cmgan.train.step",
                            {"cmgan.train.labels", "cmgan.train.d"}, PHASES)
