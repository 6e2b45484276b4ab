"""What the benchmark takes from the program under test (`cmgan_torch`,
the PyTorch and CUDA port) that belongs to no architecture: its TF32
switch. The program's config and counters are the architecture's
(perfbench/archs/); the traffic drivers call the program's entry points
themselves, looked up when a run starts."""

from __future__ import annotations

import torch


def set_tf32(on: bool):
    """TF32 for cuBLAS's and cuDNN's float32 products: off as the
    configurations state, on for the lower-precision control."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
