"""End-to-end enhancement: wav -> STFT -> generator -> iSTFT -> wav.

The generator is the one the config's model names: CMGAN's TSCNet
(`ModelConfig`: compressed real and imaginary parts in and out) or SEMamba
(`SEMambaConfig`, models/semamba.py: compressed magnitude and phase in and
out). `enhance_tensor` takes the signal path from the model.

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
import torch.nn as nn

from cmgan_torch.config import CMGANConfig, DSPConfig, ModelConfig, SEMambaConfig
from cmgan_torch.dsp import (analysis_window, istft, mag_pha_compress, mag_pha_uncompress,
                             power_compress, power_uncompress, stft)
from cmgan_torch.models import TSCNet
from cmgan_torch.models.layers import torch_default_init_
from cmgan_torch.parallel import attach, collectives, shard_batch
from cmgan_torch.utils.profiling import span


# rows per enhance_batch call fall inversely with the bucket length: about
# this many samples a call. Sized for a 16 GB accelerator and kept as it
# is; it changes how tracks are grouped, not the results.
BATCH_BUDGET_SAMPLES = 2_000_000


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


def build_generator(model_cfg: ModelConfig | SEMambaConfig, dtype=None,
                    generator: torch.Generator | None = None) -> nn.Module:
    """The generator a model config names, on the CPU: its weights drawn
    from `generator` as its published code draws them (torch's defaults;
    SEMamba's A_log, D and dt_proj biases as Mamba-1 draws them), or as
    constructed where it is None. SEMamba's module is imported here, so a
    CMGAN run imports and builds nothing of it."""
    if isinstance(model_cfg, ModelConfig):
        model = TSCNet(model_cfg, dtype=dtype)
        if generator is not None:
            torch_default_init_(model, generator)
        return model
    if isinstance(model_cfg, SEMambaConfig):
        from cmgan_torch.models.semamba import SEMamba

        model = SEMamba(model_cfg, dtype=dtype)
        if generator is not None:
            model.seeded_init_(generator)
        return model
    raise TypeError(f"no generator for a model config of type {type(model_cfg).__name__}")


def load_generator(cfg: CMGANConfig, weights, dtype=None, device="cuda",
                   seed: int = 0) -> nn.Module:
    """The generator of `cfg.model` (`build_generator`) in eval mode on
    `device`, from `weights`:
    - a generator already there, in eval mode, with the config's model:
      returned as it is, so every caller given it shares its parameters
      (dtype and seed do not apply);
    - a reference-layout state_dict (for example from
      `convert.state_dict_from_flax` or a `.pt`): loaded with strict=True;
    - None: weights drawn from `seed` (`build_generator`).
    Raises without CUDA for a CUDA device: there is no fallback to the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if isinstance(weights, nn.Module):
        where = next(weights.parameters()).device
        if where.type != device.type or getattr(weights, "cfg", None) != cfg.model \
                or weights.training:
            raise ValueError(f"the {type(weights).__name__} must be in eval mode on {device} "
                             f"with the config's model; it is on {where}, "
                             f"training={weights.training}")
        return weights
    if weights is None:
        model = build_generator(cfg.model, dtype, torch.Generator().manual_seed(seed))
    else:
        model = build_generator(cfg.model, dtype)
        model.load_state_dict(weights, strict=True)
    return model.to(device).eval()


def enhance_tensor(model: nn.Module, dsp: DSPConfig, x: torch.Tensor,
                   dft_impl: str = "fft") -> torch.Tensor:
    """The device part of an enhancement call: segments x [B, L] (float32,
    on the model's device) -> enhanced [B, (T-1) * hop], L itself when hop
    divides it. STFT with `dsp.window`, the generator's signal path and the
    iSTFT, all on tensors: nothing is read back, so calls queue on the
    device and a CUDA graph can capture them. TSCNet: power compression,
    the generator, uncompression of its float32 outputs (the generator
    returns float32 under bf16 too, as the JAX pipeline casts them).
    SEMamba (`model.mag_pha`): the compressed magnitude and the phase in,
    [B, 2, T, F], magnitude and phase out. Callers pick the grad mode
    (`Enhancer` and streaming run it under `torch.inference_mode`)."""
    with span("cmgan.enhance.call"):
        window = analysis_window(dsp.window, dsp.n_fft, x.dtype, x.device)
        spec = stft(x, dsp.n_fft, dsp.hop, window, dft_impl=dft_impl)
        if getattr(model, "mag_pha", False):
            mag, pha = mag_pha_compress(spec, dsp.compress_exponent)
            mag, pha = model(torch.stack([mag, pha], dim=1))
            est = mag_pha_uncompress(mag.float(), pha.float(), dsp.compress_exponent)
        else:
            est_real, est_imag = model(power_compress(spec, dsp.compress_exponent))
            est = power_uncompress(est_real.float(), est_imag.float(), dsp.compress_exponent)
        window = analysis_window(dsp.window, dsp.n_fft, torch.float32, x.device)
        return istft(est, dsp.n_fft, dsp.hop, window, dft_impl=dft_impl)


class Enhancer:
    """Offline enhancement with one generator (the config's model).

    state_dict: a reference-layout generator state_dict (for example from
    `convert.state_dict_from_flax` or a `.pt`); None draws torch-default
    weights from `seed`. The default device is the GPU; without CUDA,
    pass device="cpu" explicitly (the CPU runs the kernels' plain versions).

    mesh: a `parallel.make_mesh` grid (its device is the Enhancer's).
    Every rank makes the same calls with the same tracks and gets the
    same results: the rows of each batch are split over `data` (padded
    with copies of row 0 to a multiple of the data ranks, exact in eval
    mode) and gathered back; a 'seq' config shards the time conformer's
    attention over `seq`. Required when cfg.model.attention_impl == 'seq'.
    """

    def __init__(self, cfg: CMGANConfig, state_dict=None, dtype=torch.float32,
                 device="cuda", seed: int = 0, mesh=None):
        self.device = torch.device(device) if mesh is None else mesh.device
        self.cfg = cfg
        self.mesh = mesh
        self.model = load_generator(cfg, state_dict, dtype, self.device, seed)
        if mesh is not None:
            attach(self.model, mesh)

    def _enhance_batch(self, segments: np.ndarray) -> np.ndarray:
        """segments [B, L], already RMS-normalized -> enhanced [B, L]."""
        rows = segments.shape[0]
        if self.mesh is not None:
            pad = np.repeat(segments[:1], -rows % self.mesh.data_size, axis=0)
            segments = shard_batch(self.mesh, np.concatenate([segments, pad]))
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(segments, np.float32)).to(self.device)
            out = enhance_tensor(self.model, self.cfg.dsp, x)
            if self.mesh is not None:
                out = collectives.gather_rows(out, self.mesh.data_group)[:rows]
            return out.cpu().numpy()

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

        for padded, idxs in groups.items():
            cap = max(1, min(batch_cap, BATCH_BUDGET_SAMPLES // padded))
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
