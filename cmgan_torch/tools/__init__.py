"""The port's measuring tools, counterparts of the root `tools/`
serving_bench.py, serve_e2e_bench.py and profile_dsp_share.py; each runs
as `python3 -m cmgan_torch.tools.<name>` on one NVIDIA GPU, and the bench
(`cmgan_torch.bench`) calls the first two for its serving cells. The
helpers below are the measurement's own, shared by the tools and the
bench."""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def require_cuda(what: str):
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures an NVIDIA GPU and CUDA is not available; "
                           "it times nothing on the CPU")


def stats(samples, unit: str) -> dict:
    """A metric's median, quartiles and sample count."""
    q1, median, q3 = np.percentile(np.asarray(samples, np.float64), [25, 50, 75])
    return {"unit": unit, "median": float(median), "q1": float(q1), "q3": float(q3),
            "n": len(samples)}


def load_weights(model_path: str | None):
    """The 16 kHz generator's state_dict from a port checkpoint (a train
    state or a generator file, as the CLIs' --model_path), or None."""
    from cmgan_torch.cli.evaluate import load_state_dict

    return load_state_dict(argparse.Namespace(torch_ckpt=None, model_path=model_path))
