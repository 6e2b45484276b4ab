"""WAV file I/O in pure numpy (RIFF PCM 16/24/32-bit and float32/64).

The reference reads audio through torchaudio's sox backend and writes
through soundfile/libsndfile (reference: src/data/dataloader.py:28-29,
src/evaluation.py:56). Neither wheel is a build dependency here; VCTK-
DEMAND is plain 16-bit PCM RIFF, which this module parses directly.
Output matches torchaudio.load's float32 normalization (int / 2^(bits-1)).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a RIFF WAV file -> (float32 samples [channels, n], sample_rate).

    Integer PCM is scaled to [-1, 1) by 2^(bits-1), matching
    torchaudio.load / soundfile.read defaults.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    payload = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            payload = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        # SubFormat GUID's first two bytes carry the actual format code.
        raise ValueError(f"{path}: WAVE_FORMAT_EXTENSIBLE not supported")

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x << 8) >> 8  # sign-extend
            x = x.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (
                np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0
            ) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(payload, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")

    if channels > 1:
        x = x.reshape(-1, channels).T
    else:
        x = x.reshape(1, -1)
    return np.ascontiguousarray(x), sample_rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int, subtype: str = "PCM_16"):
    """Write float samples ([n] or [channels, n]) as WAV.

    subtype: 'PCM_16' (default, matching soundfile's wav default) or 'FLOAT'.
    """
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[None, :]
    channels, n = x.shape
    interleaved = x.T.reshape(-1)

    if subtype == "PCM_16":
        fmt_code, bits = _WAVE_FORMAT_PCM, 16
        clipped = np.clip(interleaved, -1.0, 32767.0 / 32768.0)
        payload = (np.round(clipped * 32768.0).astype("<i2")).tobytes()
    elif subtype == "FLOAT":
        fmt_code, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        payload = interleaved.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_code, channels, sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
