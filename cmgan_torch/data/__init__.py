from cmgan_torch.data.sorting import natsort_key, natsorted
from cmgan_torch.data.wav import read_wav, write_wav

__all__ = ["natsort_key", "natsorted", "read_wav", "write_wav"]
