"""Model zoo of the port.  Importing registers the model constructors."""

from tpu_superresolution_torch.models.swinir import SwinIR, build_swinir

__all__ = ["SwinIR", "build_swinir"]
