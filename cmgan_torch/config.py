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
    semantics, as in the CMGAN reference recipe. `window` names the
    periodic analysis and synthesis window: 'hamming' (CMGAN) or 'hann'
    (SEMamba).
    """

    sample_rate: int = 16_000
    n_fft: int = 400
    hop: int = 100
    compress_exponent: float = 0.3
    # 'fft': torch.fft.{r,ir}fft. 'matmul': the DFT as two products with
    # cached [n_fft, F] cos/sin matrices (dsp/stft.py), the JAX package's
    # choice for seq-sharded training; training and streaming take it from
    # here, offline enhancement always runs 'fft', as in the JAX package.
    dft_impl: str = "fft"
    window: str = "hamming"

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
    # (ops/flash_attention.py); 'auto': flash for sequences >= 512 frames;
    # 'seq' (a time axis sharded over devices) is not ported: the conformer raises.
    attention_impl: str = "auto"
    # rematerialize each TSCB in the backward pass of training
    remat: bool = False
    # Discriminator
    ndf: int = 16
    disc_dropout: float = 0.3

    @property
    def dim_head(self) -> int:
        return self.num_channels // self.attn_heads


@dataclasses.dataclass(frozen=True)
class SEMambaConfig:
    """The SEMamba generator (Chao et al., IEEE SLT 2024;
    github.com/RoyChao19477/SEMamba, recipes/SEMamba_advanced): MP-SENet's
    dense magnitude/phase codec around `num_tfmamba` TF-Mamba blocks, each
    a bidirectional Mamba-1 layer along time, then one along frequency.

    Published sizes: hid_feature 64, 4 blocks, d_state 16, d_conv 4,
    expand 4 (d_inner 256), dt_rank 'auto' (ceil(64 / 16) = 4), RMSNorm
    eps 1e-5, the magnitude mask's beta 2.0, 201 bins (n_fft 400).
    Enhancement only: it has no discriminator and no training recipe here.
    """

    hid_feature: int = 64
    num_features: int = 201
    num_tfmamba: int = 4
    dense_depth: int = 4
    d_state: int = 16
    d_conv: int = 4
    expand: int = 4
    dt_rank: int | str = "auto"
    norm_epsilon: float = 1e-5
    beta: float = 2.0
    input_channel: int = 2
    output_channel: int = 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.hid_feature

    @property
    def rank(self) -> int:
        """dt_rank, with Mamba-1's 'auto' resolved."""
        return -(-self.hid_feature // 16) if self.dt_rank == "auto" else int(self.dt_rank)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """GAN training loop parameters, the JAX package's fields and defaults.

    pesq_label_mode: 'host' scores each batch with the native C++ PESQ
    between the G and the D step; 'host_async' scores it in a background
    thread while the next G step runs, so the D update lands one step
    late; 'device' computes the labels on the GPU in one fused step.
    time_loss_domain: 'reference' compares est_audio with the raw clean
    waveform (the CMGAN reference's gain-suppressing quirk), 'normalized'
    with clean * c. gen_ema_decay > 0 keeps an EMA of the generator's
    parameters. loss_region = (start, end) restricts the RI, magnitude
    and time losses to those samples of the cut_len window.

    The default 2 s window is 321 frames, below the 512 from which
    `attention_impl='auto'` takes the flash kernels; cut_len 64000
    (641 frames) trains through them.
    """

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
    """A (data, seq) grid of ranks, one process a GPU (`cmgan_torch.parallel`).

    Batches are split over `data`; `seq` shards the time conformer's
    attention (attention_impl='seq'). data_parallel -1 takes every rank
    the seq axis leaves: world size // seq_parallel.
    """

    data_axis: str = "data"
    seq_axis: str = "seq"
    data_parallel: int = -1
    seq_parallel: int = 1

    def layout(self, world_size: int) -> Tuple[int, int]:
        """(data, seq) sizes over `world_size` ranks; raises ValueError
        unless their product is the world size."""
        sp = max(self.seq_parallel, 1)
        dp = self.data_parallel if self.data_parallel > 0 else world_size // sp
        if dp < 1 or dp * sp != world_size:
            raise ValueError(
                f"mesh data_parallel={self.data_parallel} x seq_parallel={self.seq_parallel} "
                f"does not fill {world_size} rank(s)"
            )
        return dp, sp


@dataclasses.dataclass(frozen=True)
class CMGANConfig:
    """The port's whole config. `model` names the generator that
    `inference.load_generator` builds: a ModelConfig for CMGAN's TSCNet,
    a SEMambaConfig for SEMamba (`semamba_16k()`)."""

    dsp: DSPConfig = dataclasses.field(default_factory=DSPConfig)
    model: ModelConfig | SEMambaConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def long_form_48k(
    num_tscb_blocks: int = 6,
    num_channels: int = 64,
    window_seconds: int = 30,
    seq_parallel: int = 1,
) -> CMGANConfig:
    """The 48 kHz long-form denoising preset, the JAX package's field by field.

    The 16 kHz config's frame rate at 48 kHz (n_fft 1200, hop 300: 6.25 ms,
    601 frequency bins), six TSCBs, and 30 s evaluation windows: 4801
    frames, which the time conformer runs through the flash-attention
    kernel ('auto' takes it from 512 frames) at G = 301 x heads groups a
    segment (the encoder halves 601 bins to 301). The training window,
    two seconds, is 321 frames and dense. seq_parallel > 1 picks the
    'matmul' DFT and the 'seq' attention of a time axis sharded over
    that many ranks of a `cmgan_torch.parallel` mesh.
    """
    dsp = DSPConfig(
        sample_rate=48_000, n_fft=1200, hop=300,
        dft_impl="matmul" if seq_parallel > 1 else "fft",
    )
    model = ModelConfig(
        num_channels=num_channels,
        num_features=dsp.num_freqs,
        num_tscb_blocks=num_tscb_blocks,
        attention_impl="seq" if seq_parallel > 1 else "auto",
    )
    train = TrainConfig(cut_len=dsp.sample_rate * 2)
    ev = EvalConfig(cut_len=dsp.sample_rate * window_seconds)
    mesh = MeshConfig(seq_parallel=seq_parallel)
    return CMGANConfig(dsp=dsp, model=model, train=train, eval=ev, mesh=mesh)


def semamba_16k() -> CMGANConfig:
    """SEMamba as published (recipes/SEMamba_advanced): 16 kHz, n_fft 400,
    hop 100, a periodic Hann window, compression 0.3, and the
    SEMambaConfig defaults. Enhancement and streaming only."""
    return CMGANConfig(dsp=DSPConfig(window="hann"), model=SEMambaConfig())
