"""Model zoo of the port.  Importing registers the model constructors."""

from tpu_superresolution_torch.models.hat import HAT, build_hat
from tpu_superresolution_torch.models.swinir import SwinIR, build_swinir

__all__ = ["HAT", "SwinIR", "build_hat", "build_swinir"]
