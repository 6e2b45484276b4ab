"""codec_ms.enhance: the encoder's and both decoders' device time an
enhancement call, in ms: the median over the window's calls of the summed
device extents of the call's `cmgan.model.encoder`, `.mask_decoder` and
`.complex_decoder` spans."""

from perfbench import spans

CODEC = ("cmgan.model.encoder", "cmgan.model.mask_decoder", "cmgan.model.complex_decoder")


def read(reading):
    return spans.unit_median(reading, "cmgan.enhance.call", lambda u: spans.device_ms(u, *CODEC))
