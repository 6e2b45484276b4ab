from cmgan_torch.metrics.pesq_native import pesq, pesq_batch

__all__ = ["pesq", "pesq_batch"]
