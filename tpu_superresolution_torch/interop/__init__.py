"""Checkpoint interop of the port: reference torch checkpoints and the
JAX package's variables -> the port's state dict."""

from tpu_superresolution_torch.interop.jax_bridge import (
    batch_stats_from_state_dict,
    dat_batch_stats_from_state_dict,
    dat_state_dict_from_jax,
    hat_state_dict_from_jax,
    msresunet_state_dict_from_jax,
    swinir_state_dict_from_jax,
    unet2d_state_dict_from_jax,
)
from tpu_superresolution_torch.interop.torch_convert import (
    CONFIG_INFERENCE,
    REFERENCE_BUFFER_SUFFIXES,
    extract_state_dict,
    infer_dat_config,
    infer_hat_config,
    infer_msresunet_config,
    infer_swinir_config,
    load_torch_checkpoint,
    strip_reference_buffers,
)

__all__ = [
    "CONFIG_INFERENCE",
    "REFERENCE_BUFFER_SUFFIXES",
    "batch_stats_from_state_dict",
    "dat_batch_stats_from_state_dict",
    "dat_state_dict_from_jax",
    "extract_state_dict",
    "hat_state_dict_from_jax",
    "infer_dat_config",
    "infer_hat_config",
    "infer_msresunet_config",
    "infer_swinir_config",
    "load_torch_checkpoint",
    "strip_reference_buffers",
    "msresunet_state_dict_from_jax",
    "swinir_state_dict_from_jax",
    "unet2d_state_dict_from_jax",
]
