"""Command-line entry points of the port: enhance, evaluate, train, serve."""


def pin_fp32():
    """Run float32 as float32: TF32 off for cuDNN's convolutions and for
    matmuls. PyTorch's defaults take cuDNN's float32 convolutions in TF32
    on the GPU, which moves the enhanced audio by ~1e-3 (relative L2)
    from float32. Every CLI's `main()` calls this first."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
