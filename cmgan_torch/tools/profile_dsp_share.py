"""The DSP front and back end's share of an enhancement call on one NVIDIA
GPU. The counterpart of the root tools/profile_dsp_share.py.

At the bench's shape (batch 16, 2 s, the bf16 generator), times
  a) the full call, `inference.enhance_tensor` (STFT -> TSCNet -> iSTFT),
  b) the generator alone on a precomputed compressed spectrum,
  c) the DSP halves alone (STFT + compression, uncompression + iSTFT),
and reports the DSP's share of (a) and the most a free DSP could speed
the call up. Each is the mean of ITERS chained calls after a warm
one, by the host clock around a synchronized card.

    python3 -m cmgan_torch.tools.profile_dsp_share [--batch 16] [--seconds 2]
        [--fp32]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cmgan_torch.dsp import istft, power_compress, power_uncompress, stft
from cmgan_torch.inference import enhance_tensor
from cmgan_torch.tools import nvidia_smi, require_cuda

ITERS = 30   # timed calls a mean, as the root tool's


def mean_seconds(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def dsp_share(model, dsp, x: torch.Tensor, iters: int) -> dict:
    """The four times (ms) for segments x on the model's device, and the DSP's share."""
    def front():
        return power_compress(stft(x, dsp.n_fft, dsp.hop), dsp.compress_exponent)

    with torch.inference_mode():
        packed = front()
        est_real, est_imag = model(packed)
        t_full = mean_seconds(lambda: enhance_tensor(model, dsp, x), iters)
        t_model = mean_seconds(lambda: model(packed), iters)
        t_front = mean_seconds(front, iters)
        t_back = mean_seconds(lambda: istft(power_uncompress(est_real, est_imag,
                                                             dsp.compress_exponent),
                                            dsp.n_fft, dsp.hop), iters)
    dsp_s = t_front + t_back
    return {"full_ms": 1e3 * t_full, "model_ms": 1e3 * t_model,
            "stft_front_ms": 1e3 * t_front, "istft_back_ms": 1e3 * t_back,
            "dsp_share_of_full": dsp_s / t_full,
            "max_speedup_if_dsp_free": t_full / (t_full - dsp_s)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="The DSP's share of an enhancement call")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seconds", type=int, default=2)
    p.add_argument("--fp32", action="store_true", help="the fp32 generator (default bf16)")
    return p.parse_args(argv)


def main(argv=None):
    from cmgan_torch.cli import pin_fp32
    from cmgan_torch.config import CMGANConfig
    from cmgan_torch.inference import load_generator

    args = parse_args(argv)
    require_cuda("profile_dsp_share")
    pin_fp32()
    cfg = CMGANConfig()
    model = load_generator(cfg, None, None if args.fp32 else torch.bfloat16, "cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.1 * rng.standard_normal(
        (args.batch, cfg.dsp.sample_rate * args.seconds))).astype(np.float32)).cuda()
    print(json.dumps({"card": nvidia_smi(), "batch": args.batch, "seconds": args.seconds,
                      "dtype": "fp32" if args.fp32 else "bf16", "iters": ITERS,
                      **dsp_share(model, cfg.dsp, x, ITERS)}))


if __name__ == "__main__":
    main()
