from cmgan_torch.models.discriminator import MetricDiscriminator
from cmgan_torch.models.generator import TSCNet

__all__ = ["MetricDiscriminator", "TSCNet"]
