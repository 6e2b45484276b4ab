"""time_conformer_ms.enhance: the time conformers' device time an enhancement
call, in ms: the median over the window's calls of the summed device
extents of the call's `cmgan.model.time_conformer` spans (one a TSCB)."""

from perfbench import spans


def read(reading):
    return spans.unit_median(reading, "cmgan.enhance.call",
                             lambda u: spans.device_ms(u, "cmgan.model.time_conformer"))
