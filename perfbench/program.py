"""What the benchmark takes from the program under test (`cmgan_torch`,
the PyTorch and CUDA port): its configuration built from a
configuration file of the benchmark's, and its counters. The traffic
drivers call the program's entry points themselves, looked up when a run
starts."""

from __future__ import annotations

import torch


def port_config(cfg: dict, **train):
    """The program's CMGANConfig for a configuration file, with the
    training fields given (batch_size, cut_len, pesq_label_mode, ...)."""
    from cmgan_torch.config import CMGANConfig, DSPConfig, ModelConfig, TrainConfig

    if cfg["num_channels"] != cfg["attn_heads"] * cfg["dim_head"]:
        raise ValueError("the program's heads are num_channels // attn_heads wide: "
                         f"{cfg['num_channels']} // {cfg['attn_heads']} != {cfg['dim_head']}")
    dsp = DSPConfig(sample_rate=cfg["sample_rate"], n_fft=cfg["n_fft"], hop=cfg["hop"],
                    compress_exponent=cfg["compress_exponent"])
    model = ModelConfig(
        num_channels=cfg["num_channels"], num_features=cfg["n_fft"] // 2 + 1,
        num_tscb_blocks=cfg["num_tscb_blocks"], dense_depth=cfg["dense_depth"],
        attn_heads=cfg["attn_heads"], ff_mult=cfg["ff_mult"],
        conv_expansion_factor=cfg["conv_expansion_factor"],
        conv_kernel_size=cfg["conv_kernel_size"], attn_dropout=cfg["attn_dropout"],
        ff_dropout=cfg["ff_dropout"], conv_dropout=cfg["conv_dropout"],
        max_rel_pos=cfg["max_rel_pos"], ndf=cfg["ndf"], disc_dropout=cfg["disc_dropout"],
        attention_impl="auto", remat=False)
    recipe = cfg.get("recipe", {})
    fields = {k: recipe[k] for k in ("init_lr", "disc_lr_mult", "lr_gamma", "decay_epochs",
                                     "pesq_norm_offset", "pesq_norm_scale") if k in recipe}
    if "loss_weights" in recipe:
        fields["loss_weights"] = tuple(recipe["loss_weights"])
    return CMGANConfig(dsp=dsp, model=model, train=TrainConfig(**fields, **train))


def reset_launches():
    from cmgan_torch.ops import flash_attention as fa

    fa.launches = fa.backward_launches = 0


def launches() -> dict:
    """The program's kernel counters: attention forward and backward launches."""
    from cmgan_torch.ops import flash_attention as fa

    return {"attn_fwd": fa.launches, "attn_bwd": fa.backward_launches}


def set_tf32(on: bool):
    """TF32 for cuBLAS's and cuDNN's float32 products: off as the
    configurations state, on for the lower-precision control."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
