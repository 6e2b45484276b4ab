"""freq_mamba_ms.enhance: the frequency Mamba layers' device time an
enhancement call, in ms: the median over the window's calls of the summed
device extents of the call's `cmgan.model.freq_mamba` spans (one a
TF-Mamba block: both directions along frequency and the linear that joins
them)."""

from perfbench import spans


def read(reading):
    return spans.unit_median(reading, "cmgan.enhance.call",
                             lambda u: spans.device_ms(u, "cmgan.model.freq_mamba"))
