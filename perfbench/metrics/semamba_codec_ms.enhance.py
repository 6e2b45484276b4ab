"""semamba_codec_ms.enhance: SEMamba's codec device time an enhancement
call, in ms: the median over the window's calls of the summed device
extents of the call's `cmgan.model.encoder`, `.mask_decoder` and
`.phase_decoder` spans (MP-SENet's dense encoder and its magnitude and
phase decoders). None in a call without a phase decoder, such as
CMGAN's."""

from perfbench import spans

CODEC = ("cmgan.model.encoder", "cmgan.model.mask_decoder", "cmgan.model.phase_decoder")


def _codec_ms(unit):
    if not any(s.name == "cmgan.model.phase_decoder" for s in unit):
        return None
    return spans.device_ms(unit, *CODEC)


def read(reading):
    return spans.unit_median(reading, "cmgan.enhance.call", _codec_ms)
