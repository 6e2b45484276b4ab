"""Typed configuration for the PyTorch port.

The port's own copy of the JAX package's dataclasses (same fields and
defaults), so that `cmgan_torch` imports nothing of `cmgan_tpu`. Every
knob lives here as a frozen dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DSPConfig:
    """STFT front-end / back-end parameters.

    torch.stft(n_fft=400, hop=100, hamming, onesided, center=True)
    semantics, as in the CMGAN reference recipe.
    """

    sample_rate: int = 16_000
    n_fft: int = 400
    hop: int = 100
    compress_exponent: float = 0.3
    # 'fft': torch.fft.{r,ir}fft. 'matmul' (the DFT as two matmuls) is
    # only needed by seq-sharded training and is not ported yet.
    dft_impl: str = "fft"

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        # center=True reflect padding adds n_fft//2 on both sides.
        return num_samples // self.hop + 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """TSCNet generator + metric discriminator hyperparameters.

    CMGAN's published widths: num_channel=64, num_features=201, 4 heads
    of dim 16, ff_mult=4, conv kernel 31, ndf=16.
    """

    num_channels: int = 64
    num_features: int = 201
    num_tscb_blocks: int = 4
    dense_depth: int = 4
    # Conformer
    attn_heads: int = 4
    ff_mult: int = 4
    conv_expansion_factor: int = 2
    conv_kernel_size: int = 31
    attn_dropout: float = 0.2
    ff_dropout: float = 0.2
    conv_dropout: float = 0.0
    max_rel_pos: int = 512
    # 'xla': dense logits; 'flash': the fused CUDA kernel
    # (ops/flash_attention.py); 'auto': flash for sequences >= 512 frames.
    attention_impl: str = "auto"
    # activation rematerialization in training (not used by inference)
    remat: bool = False
    # Discriminator
    ndf: int = 16
    disc_dropout: float = 0.3

    @property
    def dim_head(self) -> int:
        return self.num_channels // self.attn_heads


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """GAN training loop parameters (the training slice is not ported yet;
    kept so a CMGANConfig carries the same fields as the JAX package's)."""

    epochs: int = 120
    batch_size: int = 4
    log_interval: int = 500
    decay_epochs: int = 30
    init_lr: float = 5e-4
    disc_lr_mult: float = 2.0
    lr_gamma: float = 0.5
    cut_len: int = 16_000 * 2
    # [RI, magnitude, time, metric-GAN]
    loss_weights: Tuple[float, float, float, float] = (0.1, 0.9, 0.2, 0.05)
    data_dir: str = ""
    save_model_dir: str = "./saved_model"
    num_workers: int = 2
    seed: int = 0
    pesq_norm_offset: float = 1.0
    pesq_norm_scale: float = 3.5
    pesq_label_mode: str = "host"
    time_loss_domain: str = "reference"
    gen_ema_decay: float = 0.0
    loss_region: Optional[Tuple[int, int]] = None


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Inference / evaluation parameters: tracks longer than cut_len are
    folded into a batch of segments."""

    cut_len: int = 16_000 * 16
    save_tracks: bool = False
    save_dir: str = "./saved_tracks"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device layout for data / sequence parallelism (multi-GPU is not
    ported yet; kept for field parity)."""

    data_axis: str = "data"
    seq_axis: str = "seq"
    data_parallel: int = -1
    seq_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class CMGANConfig:
    dsp: DSPConfig = dataclasses.field(default_factory=DSPConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
