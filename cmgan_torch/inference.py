"""End-to-end enhancement: wav -> STFT -> TSCNet -> iSTFT -> wav.

Track handling follows the CMGAN reference recipe: RMS-normalize from
the noisy track, wrap-pad to a hop multiple, and fold tracks longer than
`cut_len` into a batch of hop-aligned segments. Two length modes:
- exact:  segment shapes as they come (the reference's results);
- bucket: wrap-padding continues to the next whole second, so the
          conformer also attends over the padded tail. Not bit-identical
          to exact, but metric-neutral, and a handful of shapes cover
          every track.

With `attention_impl='auto'` the time conformer takes the fused kernel at
>= 512 frames: in bucket mode every track longer than 3 s.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from cmgan_torch.config import CMGANConfig
from cmgan_torch.dsp import istft, power_compress, power_uncompress, stft
from cmgan_torch.models import TSCNet
from cmgan_torch.models.layers import torch_default_init_


def segment_track(noisy: np.ndarray, hop: int, cut_len: int) -> Tuple[np.ndarray, int]:
    """Wrap-pad to a hop multiple and fold long tracks into a batch.

    noisy: [n] normalized track. Returns (segments [B, L], padded_len).
    When the folded segment length would not be a hop multiple, the wrap
    padding is extended so every segment is hop-aligned.
    """
    length = noisy.shape[-1]
    padded_len = int(math.ceil(length / hop)) * hop
    if padded_len > cut_len:
        batch_size = int(math.ceil(padded_len / cut_len))
        while hop % batch_size != 0:
            batch_size += 1
        seg_quantum = batch_size * hop
        padded_len = int(math.ceil(padded_len / seg_quantum)) * seg_quantum
    else:
        batch_size = 1
    reps = int(math.ceil(padded_len / length)) if padded_len > length else 1
    x = np.concatenate([noisy] * reps + [noisy[: max(padded_len - reps * length, 0)]])[
        :padded_len
    ]
    return x.reshape(batch_size, -1), padded_len


def bucket_pad(noisy: np.ndarray, hop: int, cut_len: int, bucket: int) -> np.ndarray:
    """Tile-extend a track so its padded length lands on a bucket boundary."""
    length = noisy.shape[-1]
    target = int(math.ceil(length / bucket)) * bucket
    reps = int(math.ceil(target / length))
    return np.tile(noisy, reps)[:target]


class Enhancer:
    """Offline enhancement with one TSCNet on one device.

    state_dict: a reference-layout generator state_dict (for example from
    `convert.state_dict_from_flax` or a `.pt`); None draws torch-default
    weights from `seed`. The default device is the GPU; without CUDA,
    pass device="cpu" explicitly (the CPU runs the kernels' plain versions).
    """

    def __init__(self, cfg: CMGANConfig, state_dict=None, dtype=torch.float32,
                 device="cuda", seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Enhancer: CUDA is not available; pass device='cpu' to run on the CPU"
            )
        self.cfg = cfg
        self.model = TSCNet(cfg.model, dtype=dtype)
        if state_dict is None:
            torch_default_init_(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    def _enhance_batch(self, segments: np.ndarray) -> np.ndarray:
        """segments [B, L], already RMS-normalized -> enhanced [B, L]."""
        dsp = self.cfg.dsp
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(segments, np.float32)).to(self.device)
            packed = power_compress(stft(x, dsp.n_fft, dsp.hop), dsp.compress_exponent)
            est_real, est_imag = self.model(packed)
            est_spec = power_uncompress(est_real, est_imag, dsp.compress_exponent)
            return istft(est_spec, dsp.n_fft, dsp.hop).cpu().numpy()

    def enhance_batch(self, tracks: list[np.ndarray], batch_cap: int = 16) -> list[np.ndarray]:
        """Enhance many tracks, batching same-bucket tracks together.

        In eval mode rows do not interact (InstanceNorm is per sample,
        BatchNorm uses running stats), so padding a batch with duplicate
        rows is exact. Tracks longer than cut_len take the single-track
        segmented path.
        """
        dsp, ev = self.cfg.dsp, self.cfg.eval
        bucket = dsp.sample_rate
        tracks = [np.asarray(t, np.float32).reshape(-1) for t in tracks]
        results: list[np.ndarray | None] = [None] * len(tracks)
        groups: dict[int, list[int]] = {}
        for i, t in enumerate(tracks):
            padded = int(math.ceil(t.shape[-1] / bucket)) * bucket
            if padded > ev.cut_len:
                results[i] = self.enhance(t, mode="bucket")
            else:
                groups.setdefault(padded, []).append(i)

        # rows per batch fall inversely with bucket length (~2M samples a
        # batch). The budget was sized for a 16 GB accelerator and is kept
        # as it is; it changes how tracks are grouped, not the results.
        budget_samples = 2_000_000
        for padded, idxs in groups.items():
            cap = max(1, min(batch_cap, budget_samples // padded))
            for lo in range(0, len(idxs), cap):
                part = idxs[lo : lo + cap]
                rows, scales = [], []
                for i in part:
                    t = tracks[i]
                    c = math.sqrt(t.size / float(np.sum(t * t)))
                    rows.append(bucket_pad(t * c, dsp.hop, ev.cut_len, bucket))
                    scales.append(c)
                batch = np.stack(rows)
                if batch.shape[0] < cap:
                    pad_rows = np.broadcast_to(batch[:1], (cap - batch.shape[0], padded))
                    batch = np.concatenate([batch, pad_rows])
                est = self._enhance_batch(batch)
                for row, i, c in zip(est, part, scales):
                    n = tracks[i].shape[-1]
                    results[i] = (row[:n] / c).astype(np.float32)
        return results  # type: ignore[return-value]

    def enhance(self, noisy: np.ndarray, mode: str = "bucket") -> np.ndarray:
        """Enhance one track [n] -> [n] (float32). mode: 'exact' or 'bucket'."""
        if mode not in ("exact", "bucket"):
            raise ValueError(f"unknown mode {mode!r}")
        noisy = np.asarray(noisy, np.float32).reshape(-1)
        length = noisy.shape[-1]
        dsp, ev = self.cfg.dsp, self.cfg.eval

        c = math.sqrt(length / float(np.sum(noisy * noisy)))
        x = noisy * c
        if mode == "bucket":
            x = bucket_pad(x, dsp.hop, ev.cut_len, dsp.sample_rate)
        segments, _ = segment_track(x, dsp.hop, ev.cut_len)

        est = self._enhance_batch(segments).reshape(-1)[:length] / c
        return est.astype(np.float32)
