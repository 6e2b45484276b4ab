from cmgan_torch.dsp.stft import (
    frame_signal,
    hamming_window,
    istft,
    power_compress,
    power_uncompress,
    rms_normalize,
    stft,
)

__all__ = [
    "frame_signal",
    "hamming_window",
    "istft",
    "power_compress",
    "power_uncompress",
    "rms_normalize",
    "stft",
]
