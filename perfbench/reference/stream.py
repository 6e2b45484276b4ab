"""Streaming enhancement with weighted overlap-add, plainly: what one
stream of a slot-based server emits at a tick, worked out from the
chunks that stream was fed.

A stream's analysis window is the last left_context + chunk + lookahead
samples it was fed (zeros before its first chunk). Its level scale is
1 / sqrt of a running mean square of the chunks (the first chunk's, then
decay * old + (1 - decay) * new). Each tick enhances the scaled window,
undoes the scale, and adds the window's last chunk + lookahead samples
under raised-cosine ramps of min(chunk, lookahead) samples into an
accumulator; the first chunk samples, divided by the summed weight, are
emitted, the stream's first `lookahead` emitted samples dropped.
"""

from __future__ import annotations

import numpy as np
import torch


def wola_weights(chunk: int, lookahead: int) -> np.ndarray:
    ramp = min(chunk, lookahead)
    w = np.ones(chunk + lookahead)
    rise = 0.5 - 0.5 * np.cos(np.pi * (np.arange(ramp) + 0.5) / ramp)
    w[:ramp] = rise
    w[len(w) - ramp:] = rise[::-1]
    return w


def level_scales(chunks: np.ndarray, decay: float) -> np.ndarray:
    """[ticks, chunk] -> the scale of each tick."""
    ms = np.mean(chunks.astype(np.float64) ** 2, axis=1)
    out = np.empty(len(ms))
    run = max(ms[0], 1e-8)
    for i, m in enumerate(ms):
        run = run if i == 0 else decay * run + (1 - decay) * m
        out[i] = 1.0 / np.sqrt(max(run, 1e-8))
    return out


def emitted(model, enhance, cfg: dict, feeds, samples, device) -> list:
    """enhance(model, x, cfg): the reference's signal path, windows [N, L]
    in, enhanced audio out; feeds(stream, ticks) -> [ticks, chunk] the
    chunks a stream was fed from its first tick; samples: (stream, tick)
    pairs. Returns what each stream emitted at that tick, float64 numpy."""
    chunk, left, look = cfg["chunk"], cfg["left_context"], cfg["lookahead"]
    size, tail = left + chunk + look, chunk + look
    back = -(-tail // chunk)  # windows whose tails reach a tick's emission
    w = wola_weights(chunk, look)
    jobs, windows, scales = [], [], []
    for stream, tick in samples:
        fed = feeds(stream, tick + 1)
        c = level_scales(fed, cfg["rms_decay"])
        flat = np.concatenate([np.zeros(size), fed.reshape(-1).astype(np.float64)])
        ticks = list(range(max(0, tick - back + 1), tick + 1))
        for j in ticks:
            end = size + (j + 1) * chunk
            windows.append(flat[end - size:end] * c[j])
            scales.append(c[j])
        jobs.append((tick, ticks))
    x = torch.as_tensor(np.stack(windows), dtype=torch.float32, device=device)
    with torch.no_grad():
        est = enhance(model, x, cfg).double().cpu().numpy() / np.asarray(scales)[:, None]
    out, row = [], 0
    for tick, ticks in jobs:
        acc, wacc = np.zeros(tail), np.zeros(tail)
        for j in ticks:
            off = (tick - j) * chunk
            acc[:tail - off] += w[off:] * est[row, size - tail + off:]
            wacc[:tail - off] += w[off:]
            row += 1
        own = est[row - 1, size - tail:size - tail + chunk]
        den = wacc[:chunk]
        emit = np.where(den > 1e-3, acc[:chunk] / np.maximum(den, 1e-3), own)
        out.append(emit[max(0, min(chunk, look - tick * chunk)):])
    return out
