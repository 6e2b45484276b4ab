from cmgan_torch.dsp.stft import (
    analysis_window,
    frame_signal,
    hamming_window,
    hann_window,
    istft,
    mag_pha_compress,
    mag_pha_uncompress,
    power_compress,
    power_uncompress,
    rms_normalize,
    stft,
)

__all__ = [
    "analysis_window",
    "frame_signal",
    "hamming_window",
    "hann_window",
    "istft",
    "mag_pha_compress",
    "mag_pha_uncompress",
    "power_compress",
    "power_uncompress",
    "rms_normalize",
    "stft",
]
