"""SEMamba (Chao et al., IEEE SLT 2024): the generator of the plain
reference (perfbench/reference/semamba.py) and its signal path, the
program's SEMambaConfig, its selective-scan launch counter, and the scan's
work counted by formula (`scan_work`, `scan_calls`) for
`scan_roofline.enhance`."""

from __future__ import annotations

from perfbench.reference.semamba import SEMamba, enhance, seeded_state

__all__ = ["check", "port_config", "generator", "seeded_state", "enhance", "reset_launches",
           "launches", "scan_kernels", "scan_work", "scan_calls", "scan_bound_seconds"]

# the H100 SXM's float32 rate outside the tensor cores (the data sheet): the
# scan is elementwise float32 work
SCAN_PEAK_FLOPS = 67e12


def check(cfg: dict):
    """d_inner is expand * hid_feature; the bins and the window are n_fft's."""
    if cfg["expand"] * cfg["hid_feature"] != cfg["d_inner"]:
        raise ValueError(f"d_inner {cfg['d_inner']} is not expand * hid_feature = "
                         f"{cfg['expand']} * {cfg['hid_feature']}")
    if cfg["freq_bins"] != cfg["n_fft"] // 2 + 1 or cfg["win_size"] != cfg["n_fft"]:
        raise ValueError(f"freq_bins {cfg['freq_bins']} and win_size {cfg['win_size']} do not "
                         f"match n_fft {cfg['n_fft']} (n_fft // 2 + 1 bins, a window of n_fft)")


def port_config(cfg: dict, **train):
    """The program's config for a configuration file: SEMambaConfig and a
    Hann-window DSPConfig (training fields, if any, go to TrainConfig)."""
    from cmgan_torch.config import CMGANConfig, DSPConfig, SEMambaConfig, TrainConfig

    check(cfg)
    dsp = DSPConfig(sample_rate=cfg["sample_rate"], n_fft=cfg["n_fft"], hop=cfg["hop"],
                    compress_exponent=cfg["compress_factor"], window="hann")
    model = SEMambaConfig(
        hid_feature=cfg["hid_feature"], num_features=cfg["freq_bins"],
        num_tfmamba=cfg["num_tfmamba"], dense_depth=cfg["dense_depth"], d_state=cfg["d_state"],
        d_conv=cfg["d_conv"], expand=cfg["expand"], dt_rank=cfg["dt_rank"],
        norm_epsilon=cfg["norm_epsilon"], beta=cfg["beta"], input_channel=cfg["input_channel"],
        output_channel=cfg["output_channel"])
    return CMGANConfig(dsp=dsp, model=model, train=TrainConfig(**train))


def generator(cfg: dict):
    return SEMamba(cfg)


def reset_launches():
    from cmgan_torch.ops import selective_scan

    selective_scan.launches = 0


def launches() -> dict:
    """The selective scan's launches."""
    from cmgan_torch.ops import selective_scan

    return {"scan": selective_scan.launches}


def scan_kernels() -> tuple:
    """The names of the program's scan kernels in a trace."""
    from cmgan_torch.ops import selective_scan

    return selective_scan.SCAN_KERNELS


def scan_work(rows: int, length: int, d_inner: int, d_state: int, elem_bytes: int) -> dict:
    """One direction's scan over [rows, length] at its operand boundary
    (mamba_ssm's selective_scan_fn): u, delta and z in (d_inner each a
    step), B and C in (d_state each), y out (d_inner); A [d_inner, d_state],
    D and delta's bias read once. flop: a (step, channel) takes d_state
    multiply-adds of the recurrence and d_state of the read-out, the decay's
    product and exponential and the input's product a state (6 a state),
    and 8 for softplus, the skip and the gate."""
    tokens = rows * length
    return {"bytes": elem_bytes * (tokens * (4 * d_inner + 2 * d_state)
                                   + d_inner * (d_state + 2)),
            "flop": tokens * d_inner * (6 * d_state + 8)}


def scan_calls(cfg: dict, batch: int, samples: int) -> list:
    """(rows, length) of every scan of one enhancement call on [batch,
    samples]: each block's two directions along time (batch * F' rows of T
    steps) and along frequency (batch * T rows of F'), F' the encoder's
    halved bins."""
    frames = samples // cfg["hop"] + 1
    bins = (cfg["freq_bins"] - 3) // 2 + 1
    block = [(batch * bins, frames)] * 2 + [(batch * frames, bins)] * 2
    return block * cfg["num_tfmamba"]


def scan_bound_seconds(cfg: dict, batch: int, samples: int) -> float:
    """The least time an H100 could take for a call's scans: each scan's
    bytes at 3.35 TB/s or its flop at SCAN_PEAK_FLOPS, whichever is longer."""
    from perfbench.work import H100_PEAK_BYTES

    elem = {"float32": 4, "bfloat16": 2}[cfg["dtype"]]
    total = 0.0
    for rows, length in scan_calls(cfg, batch, samples):
        w = scan_work(rows, length, cfg["d_inner"], cfg["d_state"], elem)
        total += max(w["bytes"] / H100_PEAK_BYTES, w["flop"] / SCAN_PEAK_FLOPS)
    return total
