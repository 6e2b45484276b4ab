from cmgan_torch.models.conformer import ConformerBlock
from cmgan_torch.models.generator import TSCNet

__all__ = ["ConformerBlock", "TSCNet"]
