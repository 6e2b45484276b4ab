"""cmgan-torch: the PyTorch/CUDA port of the CMGAN speech enhancer.

A second package beside the JAX one, for NVIDIA Hopper GPUs. Plain
tensor code is PyTorch; the fused Shaw relative-position attention is a
hand-written CUDA kernel (ops/csrc/). Public functions keep the JAX
package's layouts: spectrograms [B, T, F, 2], generator outputs
(re, im) each [B, T, F], attention [G, T, D].
"""

from cmgan_torch.config import (
    CMGANConfig,
    DSPConfig,
    EvalConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)

__version__ = "0.1.0"

__all__ = [
    "CMGANConfig",
    "DSPConfig",
    "EvalConfig",
    "MeshConfig",
    "ModelConfig",
    "TrainConfig",
]
