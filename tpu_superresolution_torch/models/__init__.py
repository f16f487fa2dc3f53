"""Model zoo of the port.  Importing registers the model constructors."""

from tpu_superresolution_torch.models.dat import DAT, build_dat
from tpu_superresolution_torch.models.hat import HAT, build_hat
from tpu_superresolution_torch.models.swinir import SwinIR, build_swinir

__all__ = ["DAT", "HAT", "SwinIR", "build_dat", "build_hat", "build_swinir"]
