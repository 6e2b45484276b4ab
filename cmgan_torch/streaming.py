"""Streaming (chunked, low-latency) enhancement: the JAX package's
`streaming.py`, ported.

A rolling analysis window slides over the input; each step enhances
[left_context | chunk | lookahead] through STFT -> TSCNet -> iSTFT and
emits the chunk region, blended with the neighbouring windows' estimates
('wola') or cross-faded with the previous emission over `crossfade`
samples ('crossfade').

Algorithmic latency = chunk + lookahead (+ compute). The time attention
and dilated convs see `left_context` samples of past context. Level
normalization uses a running RMS of the input (the offline whole-track
RMS is unavailable causally), inverted on emission.

A window of W samples is W/100 + 1 frames. The default window (24000 +
8000 + 4000 samples) is 361 frames and runs dense attention; from 51100
samples, for instance `left_context=48000` (601 frames),
`attention_impl='auto'` takes the flash-attention kernel once per TSCB a
tick, at G = 404 x S groups for S streams.

The generator is put on the device once (`inference.load_generator`):
every StreamingEnhancer and StreamBatcher built from the same TSCNet
shares its parameters, so a new server connection copies no weights.
Each tick makes one host-to-device copy (the windows and their level
scales) and one device-to-host read (the estimate), the delivery itself.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from cmgan_torch.config import CMGANConfig, DSPConfig
from cmgan_torch.inference import enhance_tensor, load_generator
from cmgan_torch.utils.profiling import span


def _window_fn(model, windows: torch.Tensor, c: torch.Tensor, dsp: DSPConfig) -> torch.Tensor:
    """windows [S, W] float32 and per-stream level scales c [S] on the
    model's device -> the enhanced windows [S, W] float32.

    Inference mode is entered here, not by the caller: it is thread-local,
    and the server calls this from its tick thread and its handler threads.
    """
    with torch.inference_mode():
        # dft_impl threaded through: a config trained with 'matmul' streams
        # through the same DFT
        return enhance_tensor(model, dsp, windows * c[:, None], dsp.dft_impl) / c[:, None]


def _enhance_windows(model, dsp: DSPConfig, device, windows: np.ndarray,
                     c: np.ndarray) -> np.ndarray:
    """One tick on the device: windows [S, W] and c [S] (host) -> [S, W]
    (host). The scales ride as one more column, so the tick makes one copy
    each way."""
    host = np.concatenate([windows, c[:, None]], axis=1)
    packed = torch.from_numpy(host).to(device)
    return _window_fn(model, packed[:, :-1], packed[:, -1], dsp).cpu().numpy()


def _check_args(dsp: DSPConfig, chunk: int, left_context: int, lookahead: int,
                crossfade: int, emit: str) -> str:
    """Validate the window layout; returns the emission mode in effect."""
    for name, value in (("chunk", chunk), ("left_context", left_context),
                        ("lookahead", lookahead)):
        if value < 0 or value % dsp.hop:
            raise ValueError(f"{name} {value} must be a non-negative multiple of hop {dsp.hop}")
    if chunk == 0 or not 0 <= crossfade <= chunk:
        raise ValueError(f"need chunk > 0 and 0 <= crossfade <= chunk, got {chunk}, {crossfade}")
    if emit not in ("wola", "crossfade"):
        raise ValueError(f"unknown emit {emit!r}")
    return "crossfade" if emit == "wola" and lookahead == 0 else emit  # no tail to blend


def _wola_weights(chunk: int, lookahead: int) -> np.ndarray:
    """Weights over [chunk + lookahead]: raised-cosine half-ramps over
    min(chunk, lookahead) samples at both ends, rise(o) + fall(o) == 1, so
    the total weight across overlapping windows is continuous."""
    ramp = min(chunk, lookahead)
    length = chunk + lookahead
    w = np.ones(length, np.float32)
    t = (np.arange(ramp, dtype=np.float32) + 0.5) / ramp
    rise = 0.5 - 0.5 * np.cos(np.pi * t)
    w[:ramp] = rise
    w[length - ramp :] = rise[::-1]
    return w


class StreamingEnhancer:
    """Push-based streaming enhancer with fixed compute shape.

    Usage:
        s = StreamingEnhancer(cfg, weights)
        for block in audio_blocks:              # arbitrary block sizes
            out.append(s.push(block))
        out.append(s.flush())

    `weights`: a TSCNet in eval mode already on `device` (shared, not
    copied), a reference-layout state_dict (loaded with strict=True), or
    None (torch-default weights from seed 0). The default device is the
    GPU; without CUDA, pass device="cpu" explicitly.

    `num_streams > 1` runs that many independent streams in lockstep as
    one device batch: push/flush then take and return `[num_streams, n]`
    blocks. Per-stream state (normalization, crossfade tails) stays
    independent.

    `emit` selects seam handling:
      - "wola" (default): weighted overlap-add over window estimates. Each
        window also estimates the `lookahead` samples beyond the emitted
        chunk; they are blended with the next windows' estimates under a
        weight profile that ramps 0->1 over the first min(chunk, lookahead)
        samples and mirrors down over the last, so every emitted sample is
        a smooth mixture of up to 1 + ceil(lookahead/chunk) estimates, at
        no extra compute or latency.
      - "crossfade": single-window emission with a `crossfade`-sample
        linear seam blend.
    """

    def __init__(
        self,
        cfg: CMGANConfig,
        weights,
        chunk: int = 8000,           # 0.5 s emission granularity
        left_context: int = 24000,   # 1.5 s past context
        lookahead: int = 4000,       # 0.25 s future context
        crossfade: int = 400,        # 25 ms seam blending
        dtype=None,
        rms_decay: float = 0.95,
        num_streams: int = 1,
        emit: str = "wola",
        device="cuda",
    ):
        emit = _check_args(cfg.dsp, chunk, left_context, lookahead, crossfade, emit)
        if num_streams < 1:
            raise ValueError(f"num_streams {num_streams} < 1")
        self.cfg = cfg
        self.chunk = chunk
        self.left_context = left_context
        self.lookahead = lookahead
        self.crossfade = crossfade
        self.window = left_context + chunk + lookahead
        self.rms_decay = rms_decay
        self.num_streams = num_streams
        self.emit = emit
        self.device = torch.device(device)
        self.model = load_generator(cfg, weights, dtype, self.device)
        if emit == "wola":
            self._wola_w = _wola_weights(chunk, lookahead)
        self.reset()

    def reset(self):
        s = self.num_streams
        self._in_buffer = np.zeros((s, self.window), np.float32)
        self._pending = np.zeros((s, 0), np.float32)
        self._prev_tail: Optional[np.ndarray] = None
        self._mean_sq = np.zeros(s)
        self._warm = False
        if self.emit == "wola":
            length = self.chunk + self.lookahead
            self._acc = np.zeros((s, length), np.float32)
            self._wacc = np.zeros((s, length), np.float32)
        # the first `lookahead` raw emitted samples precede stream index
        # 0 (zero padding); drop them so output index i == input index i
        self._skip = self.lookahead

    @property
    def latency_samples(self) -> int:
        """Algorithmic latency (excl. compute): chunk + lookahead."""
        return self.chunk + self.lookahead

    def _step(self, new_chunk: np.ndarray) -> np.ndarray:
        """Consume exactly [S, chunk] new samples, return [S, chunk]
        enhanced samples (delayed by `lookahead`)."""
        self._in_buffer = np.concatenate(
            [self._in_buffer[:, self.chunk :], new_chunk], axis=1
        )
        # running RMS from observed input (causal analog of the offline
        # whole-track normalization)
        block_ms = np.mean(new_chunk**2, axis=1)
        if not self._warm:
            self._mean_sq = np.maximum(block_ms, 1e-8)
            self._warm = True
        else:
            self._mean_sq = (
                self.rms_decay * self._mean_sq + (1 - self.rms_decay) * block_ms
            )
        c = (1.0 / np.sqrt(np.maximum(self._mean_sq, 1e-8))).astype(np.float32)

        est = _enhance_windows(self.model, self.cfg.dsp, self.device, self._in_buffer, c)
        # emission region: the chunk that now sits `lookahead` from the end
        start = self.window - self.lookahead - self.chunk

        if self.emit == "wola":
            region = est[:, start:]  # [S, chunk + lookahead]
            self._acc += self._wola_w * region
            self._wacc += self._wola_w
            num = self._acc[:, : self.chunk]
            den = self._wacc[:, : self.chunk]
            # den < 1 only in the first ramp of a fresh stream (no
            # predecessor window yet): fall back to the raw estimate
            out = np.where(
                den > 1e-3, num / np.maximum(den, 1e-3), region[:, : self.chunk]
            ).astype(np.float32)
            shift = self.chunk
            self._acc = np.concatenate(
                [self._acc[:, shift:], np.zeros((est.shape[0], shift), np.float32)],
                axis=1,
            )
            self._wacc = np.concatenate(
                [self._wacc[:, shift:], np.zeros((est.shape[0], shift), np.float32)],
                axis=1,
            )
            return out

        out = est[:, start : start + self.chunk].copy()
        if self.crossfade > 0:
            fade = np.linspace(0.0, 1.0, self.crossfade, dtype=np.float32)
            if self._prev_tail is not None:
                out[:, : self.crossfade] = (
                    fade * out[:, : self.crossfade]
                    + (1.0 - fade) * self._prev_tail
                )
            # stash this step's estimate of the NEXT chunk's head
            nxt = est[:, start + self.chunk : start + self.chunk + self.crossfade]
            self._prev_tail = (
                nxt.copy() if nxt.shape[1] == self.crossfade else None
            )
        return out

    def _emit(self, raw: np.ndarray) -> np.ndarray:
        if self._skip > 0:
            cut = min(self._skip, raw.shape[1])
            self._skip -= cut
            raw = raw[:, cut:]
        return raw

    def _coerce(self, samples: np.ndarray) -> np.ndarray:
        x = np.asarray(samples, np.float32)
        if self.num_streams == 1 and x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[0] != self.num_streams:
            raise ValueError(f"expected [{self.num_streams}, n] samples, got {x.shape}")
        return x

    def _deliver(self, out: np.ndarray) -> np.ndarray:
        return out[0] if self.num_streams == 1 else out

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed audio ([n] for one stream, [S, n] for S streams);
        returns whatever output is ready (same leading shape).

        Output sample i is the enhanced input sample i (the stream runs
        `latency_samples` behind the input in wall-clock terms).
        """
        self._pending = np.concatenate(
            [self._pending, self._coerce(samples)], axis=1
        )
        outs = []
        while self._pending.shape[1] >= self.chunk:
            outs.append(self._emit(self._step(self._pending[:, : self.chunk])))
            self._pending = self._pending[:, self.chunk :]
        out = (
            np.concatenate(outs, axis=1)
            if outs
            else np.zeros((self.num_streams, 0), np.float32)
        )
        return self._deliver(out)

    def flush(self) -> np.ndarray:
        """Emit the remainder (pads the stream tail with zeros)."""
        remainder = self._pending.shape[1]
        outs = []
        if remainder:
            pad = np.zeros((self.num_streams, self.chunk - remainder), np.float32)
            outs.append(
                self._emit(self._step(np.concatenate([self._pending, pad], axis=1)))
            )
        # push zeros to recover the lookahead-delayed tail
        tail_steps = -(-self.lookahead // self.chunk) + 1
        for _ in range(tail_steps):
            outs.append(
                self._emit(self._step(np.zeros((self.num_streams, self.chunk), np.float32)))
            )
        self._pending = np.zeros((self.num_streams, 0), np.float32)
        out = (
            np.concatenate(outs, axis=1)
            if outs
            else np.zeros((self.num_streams, 0), np.float32)
        )
        # aligned samples still owed: the remainder plus the lookahead-
        # delayed tail of the already-pushed chunks
        return self._deliver(out[:, : remainder + self.lookahead])

    def enhance_stream(
        self, blocks: Iterator[np.ndarray]
    ) -> Iterator[np.ndarray]:
        for block in blocks:
            out = self.push(block)
            if out.size:
                yield out
        tail = self.flush()
        if tail.size:
            yield tail


class StreamBatcher:
    """Slot-based batched streaming engine for serving.

    `StreamingEnhancer(num_streams=S)` batches S streams that advance in
    lockstep; a server's connections start, stall and end independently.
    StreamBatcher keeps S independent slots behind one fixed-shape batch
    (idle slots ride along as wasted lanes, masked out on the host):

        slot = b.open()                 # claim a slot (resets its state)
        out = b.step({slot: chunk})     # tick any subset of slots
        b.close(slot)                   # release

    Each `step` call consumes exactly `chunk` samples for every slot in
    the dict and returns the aligned enhanced samples per slot (empty
    rows while the slot's initial `lookahead` alignment skip drains).
    Slots not in the dict keep their analysis state frozen: their lane
    still flows through the device batch but the result is discarded,
    so a slot's output depends only on its own chunk sequence.

    End-of-stream is caller accounting (see cli/serve.py): pad the
    final partial chunk with zeros, feed ceil(lookahead/chunk)+1 zero
    chunks to drain the lookahead delay, and trim the delivered total
    to the real input length. `weights` and `device` as for
    StreamingEnhancer.
    """

    def __init__(
        self,
        cfg: CMGANConfig,
        weights,
        num_slots: int = 8,
        chunk: int = 8000,
        left_context: int = 24000,
        lookahead: int = 4000,
        crossfade: int = 400,
        dtype=None,
        rms_decay: float = 0.95,
        emit: str = "wola",
        device="cuda",
    ):
        emit = _check_args(cfg.dsp, chunk, left_context, lookahead, crossfade, emit)
        if num_slots < 1:
            raise ValueError(f"num_slots {num_slots} < 1")
        self.cfg = cfg
        self.chunk = chunk
        self.left_context = left_context
        self.lookahead = lookahead
        self.crossfade = crossfade
        self.window = left_context + chunk + lookahead
        self.rms_decay = rms_decay
        self.num_slots = num_slots
        self.emit = emit
        self.device = torch.device(device)
        self.model = load_generator(cfg, weights, dtype, self.device)
        if emit == "wola":
            self._wola_w = _wola_weights(chunk, lookahead)

        s = num_slots
        self._free = list(range(s))
        self._in_buffer = np.zeros((s, self.window), np.float32)
        self._mean_sq = np.zeros(s)
        self._warm = np.zeros(s, bool)
        self._skip = np.zeros(s, np.int64)
        if emit == "wola":
            length = chunk + lookahead
            self._acc = np.zeros((s, length), np.float32)
            self._wacc = np.zeros((s, length), np.float32)
        self._prev_tail = np.zeros((s, crossfade), np.float32)
        self._has_tail = np.zeros(s, bool)

    @property
    def latency_samples(self) -> int:
        return self.chunk + self.lookahead

    def open(self) -> int:
        """Claim a free slot and reset its per-stream state."""
        if not self._free:
            raise RuntimeError(f"all {self.num_slots} slots in use")
        i = self._free.pop(0)
        self._in_buffer[i] = 0.0
        self._mean_sq[i] = 0.0
        self._warm[i] = False
        self._skip[i] = self.lookahead
        if self.emit == "wola":
            self._acc[i] = 0.0
            self._wacc[i] = 0.0
        self._prev_tail[i] = 0.0
        self._has_tail[i] = False
        return i

    def close(self, slot: int):
        if slot in self._free:
            raise ValueError(f"slot {slot} is not open")
        self._free.append(slot)

    def step(self, blocks: dict) -> dict:
        """Tick: {slot: [chunk] float32} -> {slot: aligned output}.

        Every value must be exactly `chunk` samples. Returns per-slot
        aligned enhanced samples (may be shorter than `chunk`, or empty,
        while the slot's initial alignment skip drains).
        """
        if not blocks:
            return {}
        with span("cmgan.stream.tick"):
            with span("cmgan.stream.prep"):
                act, c = self._slide(blocks)
            with span("cmgan.stream.device"):
                est = _enhance_windows(self.model, self.cfg.dsp, self.device, self._in_buffer, c)
            with span("cmgan.stream.emit"):
                return self._emit(act, est)

    def _slide(self, blocks: dict):
        """Slide the ticked slots' windows by their blocks and update their
        running RMS; returns (the ticked slots, every lane's level scale)."""
        act = np.asarray(sorted(blocks), np.int64)
        new = np.stack([np.asarray(blocks[i], np.float32) for i in act])
        if new.shape != (act.size, self.chunk):
            raise ValueError(f"every block must be {self.chunk} samples, got {new.shape}")

        # slide active rows' analysis windows
        self._in_buffer[act] = np.concatenate(
            [self._in_buffer[act, self.chunk :], new], axis=1
        )
        block_ms = np.mean(new**2, axis=1)
        cold = ~self._warm[act]
        upd = np.where(
            cold,
            np.maximum(block_ms, 1e-8),
            self.rms_decay * self._mean_sq[act]
            + (1 - self.rms_decay) * block_ms,
        )
        self._mean_sq[act] = upd
        self._warm[act] = True

        c = (1.0 / np.sqrt(np.maximum(self._mean_sq, 1e-8))).astype(np.float32)
        return act, c

    def _emit(self, act: np.ndarray, est: np.ndarray) -> dict:
        """The ticked slots' outputs from the enhanced windows est [S, W]:
        WOLA or cross-fade, then each slot's alignment skip."""
        start = self.window - self.lookahead - self.chunk

        if self.emit == "wola":
            region = est[act, start:]
            self._acc[act] += self._wola_w * region
            self._wacc[act] += self._wola_w
            num = self._acc[act, : self.chunk]
            den = self._wacc[act, : self.chunk]
            out = np.where(
                den > 1e-3, num / np.maximum(den, 1e-3), region[:, : self.chunk]
            ).astype(np.float32)
            shift = self.chunk
            self._acc[act] = np.concatenate(
                [self._acc[act, shift:],
                 np.zeros((act.size, shift), np.float32)], axis=1,
            )
            self._wacc[act] = np.concatenate(
                [self._wacc[act, shift:],
                 np.zeros((act.size, shift), np.float32)], axis=1,
            )
        else:
            out = est[act, start : start + self.chunk].copy()
            if self.crossfade > 0:
                fade = np.linspace(0.0, 1.0, self.crossfade, dtype=np.float32)
                tails = self._prev_tail[act]
                blend = (
                    fade * out[:, : self.crossfade] + (1.0 - fade) * tails
                )
                out[:, : self.crossfade] = np.where(
                    self._has_tail[act][:, None],
                    blend,
                    out[:, : self.crossfade],
                )
                nxt = est[
                    act, start + self.chunk : start + self.chunk + self.crossfade
                ]
                if nxt.shape[1] == self.crossfade:
                    self._prev_tail[act] = nxt
                    self._has_tail[act] = True
                else:
                    self._has_tail[act] = False

        result = {}
        for row, i in enumerate(act):
            cut = int(min(self._skip[i], self.chunk))
            self._skip[i] -= cut
            result[int(i)] = out[row, cut:]
        return result
