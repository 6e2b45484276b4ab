"""CMGAN (Cao et al., Interspeech 2022): the TSCNet generator of the
plain reference (perfbench/reference/model.py), its signal path
(perfbench/reference/dsp.py), the program's CMGANConfig and its
attention counters."""

from __future__ import annotations

from perfbench.reference.dsp import enhance
from perfbench.reference.model import TSCNet, seeded_state

__all__ = ["check", "port_config", "generator", "seeded_state", "enhance", "reset_launches",
           "launches"]


def check(cfg: dict):
    """The program's heads are num_channels // attn_heads wide."""
    if cfg["num_channels"] != cfg["attn_heads"] * cfg["dim_head"]:
        raise ValueError("the program's heads are num_channels // attn_heads wide: "
                         f"{cfg['num_channels']} // {cfg['attn_heads']} != {cfg['dim_head']}")


def port_config(cfg: dict, **train):
    """The program's CMGANConfig for a configuration file, with the
    training fields given (batch_size, cut_len, pesq_label_mode, ...)."""
    from cmgan_torch.config import CMGANConfig, DSPConfig, ModelConfig, TrainConfig

    check(cfg)
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


def generator(cfg: dict):
    return TSCNet(cfg)


def reset_launches():
    from cmgan_torch.ops import flash_attention as fa

    fa.launches = fa.backward_launches = 0


def launches() -> dict:
    """Kernel #1's and kernel #2's launches: attention forward and backward."""
    from cmgan_torch.ops import flash_attention as fa

    return {"attn_fwd": fa.launches, "attn_bwd": fa.backward_launches}
