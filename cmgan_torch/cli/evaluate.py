"""Evaluation CLI on the GPU: the JAX package's `cli/evaluate.py`, ported.

    python -m cmgan_torch.cli.evaluate --test_dir <dir with noisy/ clean/> \
        --model_path <checkpoint> [--save_tracks --save_dir out/] [--exact] [--json]

Enhances every (natsorted) noisy track, scores the 6-metric suite
against clean, prints the aggregate line. The default bucketed mode pads
tracks to whole seconds and batches same-length tracks together
(`Enhancer.enhance_batch`); --exact (or --batch 1) enhances one track at a
time, --exact with the reference's segment shapes. Tracks longer than
3 s reach the flash-attention kernel (>= 512 frames); a 16 s chunk is
2561 frames. The metrics run on the host (numpy and the C++ PESQ).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from cmgan_torch.cli import pin_fp32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate CMGAN on a test set (PyTorch port)")
    p.add_argument("--model_path", type=str, default=None,
                   help="the port's checkpoint: a full train state (save_train_state; its "
                   "generator is evaluated) or a generator file (save_variables, for "
                   "instance the _ema file); random init if omitted")
    p.add_argument("--torch_ckpt", type=str, default=None,
                   help="a reference-layout generator state_dict (.pt) instead")
    p.add_argument("--test_dir", type=str, required=True)
    p.add_argument("--save_tracks", action="store_true")
    p.add_argument("--save_dir", type=str, default="./saved_tracks")
    p.add_argument("--exact", action="store_true",
                   help="reference-exact segment shapes, one track at a time")
    p.add_argument("--batch", type=int, default=8,
                   help="tracks per device batch (bucketed mode only)")
    p.add_argument("--chunk_seconds", type=int, default=16,
                   help="max segment length; 16 matches the reference, "
                   "2 matches the training context (equal quality, faster)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--limit", type=int, default=0, help="evaluate first N tracks only")
    p.add_argument("--json", action="store_true", help="emit one JSON line")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_state_dict(args):
    """The generator's state_dict from --torch_ckpt or --model_path, or None
    (a seeded random init)."""
    import torch

    from cmgan_torch.checkpoint import restore_variables

    if args.torch_ckpt:
        return torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    if args.model_path:
        raw = restore_variables(args.model_path)  # ONE read for either kind
        if "gen" in raw and "disc_opt" in raw:
            # a full train state (Trainer.save_checkpoint): its generator half
            return raw["gen"]
        return raw
    return None


def main(argv=None):
    pin_fp32()
    import dataclasses

    import numpy as np
    import torch

    from cmgan_torch.config import CMGANConfig, EvalConfig
    from cmgan_torch.data import natsorted, read_wav, write_wav
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.metrics import compute_metrics

    args = parse_args(argv)
    cfg = CMGANConfig()
    cfg = dataclasses.replace(
        cfg,
        eval=EvalConfig(
            cut_len=cfg.dsp.sample_rate * args.chunk_seconds,
            save_tracks=args.save_tracks,
            save_dir=args.save_dir,
        ),
    )

    enhancer = Enhancer(cfg, load_state_dict(args),
                        dtype=torch.bfloat16 if args.bf16 else torch.float32,
                        device=args.device)

    noisy_dir = os.path.join(args.test_dir, "noisy")
    clean_dir = os.path.join(args.test_dir, "clean")
    names = natsorted(os.listdir(noisy_dir))
    if args.limit:
        names = names[: args.limit]
    if args.save_tracks:
        os.makedirs(args.save_dir, exist_ok=True)

    sr = cfg.dsp.sample_rate

    def read(directory, name):
        x, rate = read_wav(os.path.join(directory, name))
        if rate != sr:
            raise ValueError(f"{name}: {rate} Hz, expected {sr}")
        return x[0]

    totals = np.zeros(6)
    audio_seconds = 0.0
    t0 = time.time()
    if args.exact or args.batch <= 1:
        ests = [enhancer.enhance(read(noisy_dir, name), mode="exact" if args.exact else "bucket")
                for name in names]
    else:
        ests = enhancer.enhance_batch([read(noisy_dir, name) for name in names],
                                      batch_cap=args.batch)
    enhance_wall = time.time() - t0

    for name, est in zip(names, ests):
        audio_seconds += est.size / sr
        if args.save_tracks:
            write_wav(os.path.join(args.save_dir, name), est, sr)
        clean = read(clean_dir, name)
        totals += np.array(compute_metrics(clean.astype(np.float64), est, sr, 0))
    wall = time.time() - t0

    avg = totals / max(len(names), 1)
    result = {
        "tracks": len(names),
        "pesq": round(avg[0], 6),
        "csig": round(avg[1], 6),
        "cbak": round(avg[2], 6),
        "covl": round(avg[3], 6),
        "ssnr": round(avg[4], 6),
        "stoi": round(avg[5], 6),
        "realtime_factor": round(audio_seconds / wall, 2),
        "enhance_realtime_factor": round(audio_seconds / max(enhance_wall, 1e-9), 2),
    }
    if args.json:
        print(json.dumps(result))
    else:
        print(
            "pesq: ", avg[0], "csig: ", avg[1], "cbak: ", avg[2],
            "covl: ", avg[3], "ssnr: ", avg[4], "stoi: ", avg[5],
        )
        print(f"[{len(names)} tracks, {result['realtime_factor']}x realtime]")
    return result


if __name__ == "__main__":
    main()
