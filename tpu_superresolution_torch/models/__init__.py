"""Model zoo of the port.  Importing registers the model constructors."""

from tpu_superresolution_torch.models.dat import DAT, build_dat
from tpu_superresolution_torch.models.hat import HAT, build_hat
from tpu_superresolution_torch.models.msresunet import MSResUNet, build_msresunet
from tpu_superresolution_torch.models.swinir import SwinIR, build_swinir
from tpu_superresolution_torch.models.unet2d import UNet2D, build_unet2d

__all__ = ["DAT", "HAT", "MSResUNet", "SwinIR", "UNet2D", "build_dat", "build_hat",
           "build_msresunet", "build_swinir", "build_unet2d"]
