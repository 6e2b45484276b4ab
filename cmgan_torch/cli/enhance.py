"""Single-file / directory enhancement CLI on the GPU.

    python -m cmgan_torch.cli.enhance --input noisy.wav --output clean.wav \
        --torch_ckpt generator.pt [--exact] [--device cuda]

--torch_ckpt is a generator state_dict in the CMGAN reference layout: the
reference's released checkpoint, or one written from a JAX checkpoint
with `cmgan_tpu.checkpoint.torch_import.save_torch_generator` (README).
"""

from __future__ import annotations

import argparse
import os

import torch

from cmgan_torch.config import CMGANConfig
from cmgan_torch.data import natsorted, read_wav, write_wav
from cmgan_torch.inference import Enhancer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Enhance wav file(s) with the PyTorch port")
    p.add_argument("--input", type=str, required=True, help="wav file or directory")
    p.add_argument("--output", type=str, required=True, help="wav file or directory")
    p.add_argument("--torch_ckpt", type=str, required=True,
                   help="reference-layout generator state_dict (.pt)")
    p.add_argument("--exact", action="store_true",
                   help="exact segment shapes instead of whole-second buckets")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = CMGANConfig()
    state_dict = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    enhancer = Enhancer(cfg, state_dict, device=args.device)
    mode = "exact" if args.exact else "bucket"

    if os.path.isdir(args.input):
        os.makedirs(args.output, exist_ok=True)
        names = natsorted(n for n in os.listdir(args.input) if n.lower().endswith(".wav"))
        for name in names:
            noisy, sr = read_wav(os.path.join(args.input, name))
            write_wav(os.path.join(args.output, name), enhancer.enhance(noisy[0], mode=mode), sr)
            print(name)
    else:
        noisy, sr = read_wav(args.input)
        write_wav(args.output, enhancer.enhance(noisy[0], mode=mode), sr)
        print(args.output)


if __name__ == "__main__":
    main()
