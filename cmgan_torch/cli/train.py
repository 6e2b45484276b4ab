"""Training CLI, with the JAX package's flags.

    python -m cmgan_torch.cli.train --data_dir <VCTK-DEMAND root> \
        --save_model_dir ./saved_model [--cut_len 64000] [--device cuda]

Data parallel over N GPUs of one host, one process each:

    torchrun --nproc_per_node N -m cmgan_torch.cli.train --data_dir ...

Under torchrun (WORLD_SIZE set) every rank joins the process group and
lays out the mesh, then reads only its data rank's shard of each epoch,
--batch_size rows a batch, as the JAX package's loader shards by process
(the seq ranks of one data index read the same rows and crops). A step
takes --batch_size x data ranks rows over the world, and
cfg.train.batch_size holds that global batch, as in the JAX CLI; every
rank reads the test set whole in batches of that size. Rank 0 writes the
checkpoints.

The default 2 s window (--cut_len 32000, 321 frames) runs dense
attention; from 512 frames (--cut_len 64000 is 641) the time conformer
trains through the flash-attention kernels, forward and backward.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

from cmgan_torch.cli import pin_fp32
from cmgan_torch.config import CMGANConfig, MeshConfig, ModelConfig, TrainConfig


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train CMGAN on VCTK-DEMAND (PyTorch port)")
    d = TrainConfig()
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--batch_size", type=int, default=d.batch_size,
                   help="per-device batch size (reference: per-GPU batch); "
                   "under torchrun the rows each data rank reads of its shard")
    p.add_argument("--log_interval", type=int, default=d.log_interval)
    p.add_argument("--decay_epoch", type=int, default=d.decay_epochs)
    p.add_argument("--init_lr", type=float, default=d.init_lr)
    p.add_argument("--cut_len", type=int, default=d.cut_len)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--save_model_dir", type=str, default=d.save_model_dir)
    p.add_argument("--loss_weights", type=float, nargs=4,
                   default=list(d.loss_weights),
                   help="RI, magnitude, time, metric-GAN weights")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path to resume from")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (fp32 params)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize conformer blocks (bigger batches)")
    p.add_argument("--pesq_label_mode", type=str, default=d.pesq_label_mode,
                   choices=("host", "host_async", "device"),
                   help="PESQ label path: reference-faithful synchronous "
                   "host scorer, overlapped host scorer (D one step "
                   "stale), or fused on-device scorer")
    p.add_argument("--time_loss_domain", type=str, default=d.time_loss_domain,
                   choices=("reference", "normalized"),
                   help="time-L1 target: raw clean (reference quirk, "
                   "suppresses output gain) or clean*c (gain-consistent)")
    p.add_argument("--ema_decay", type=float, default=d.gen_ema_decay,
                   help="generator weight EMA decay (0 disables); the "
                   "smoothed weights are saved alongside each epoch "
                   "checkpoint as <save_model_dir>/..._ema")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    pin_fp32()
    import torch
    import torch.distributed as dist

    from cmgan_torch import parallel

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    mesh_cfg = MeshConfig()
    device, mesh = args.device, None
    launched = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if launched:
        device = parallel.init_from_env(args.device)
    if dist.is_initialized():
        mesh = parallel.make_mesh(mesh_cfg, device)
    data_ranks, data_rank = (mesh.data_size, mesh.data_rank) if mesh else (1, 0)
    cfg = CMGANConfig(
        model=ModelConfig(remat=args.remat),
        train=dataclasses.replace(
            TrainConfig(),
            epochs=args.epochs,
            batch_size=args.batch_size * data_ranks,
            log_interval=args.log_interval,
            decay_epochs=args.decay_epoch,
            init_lr=args.init_lr,
            cut_len=args.cut_len,
            data_dir=args.data_dir,
            save_model_dir=args.save_model_dir,
            loss_weights=tuple(args.loss_weights),
            seed=args.seed,
            pesq_label_mode=args.pesq_label_mode,
            time_loss_domain=args.time_loss_domain,
            gen_ema_decay=args.ema_decay,
        ),
        mesh=mesh_cfg,
    )

    from cmgan_torch.data.dataset import load_data
    from cmgan_torch.train import Trainer

    train_loader, test_loader = load_data(
        cfg.train.data_dir, args.batch_size, cfg.train.cut_len, cfg.train.seed,
        num_processes=data_ranks, process_index=data_rank,
    )
    trainer = Trainer(
        cfg,
        train_loader,
        test_loader,
        dtype=torch.bfloat16 if args.bf16 else None,
        device=device,
        mesh=mesh,
    )
    try:
        if args.resume:
            trainer.restore_checkpoint(args.resume)
        trainer.train()
    finally:
        if launched:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
