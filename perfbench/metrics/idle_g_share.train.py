"""idle_g_share.train: % of the traced window the card spent idle in gaps
that began while the host was in the G phase (the program's
`cmgan.train.g` span, the innermost of `cmgan.train.{g,labels,d}` open)."""

from perfbench import spans

PHASES = ("cmgan.train.g", "cmgan.train.labels", "cmgan.train.d")


def read(reading):
    return spans.idle_share(reading, "cmgan.train.step", {"cmgan.train.g"}, PHASES)
