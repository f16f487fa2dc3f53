from .config import (
    DATConfig,
    DataConfig,
    EvalConfig,
    ModelConfig,
    MSResUNetConfig,
    SwinIRConfig,
    TrainConfig,
    UNet2DConfig,
    build_model,
    config_from_dict,
    model_registry,
    register_model,
)
from .dtypes import COMPUTE_DTYPE, OUTPUT_DTYPE, PARAM_DTYPE, serving_dtype

__all__ = [
    "DATConfig",
    "DataConfig",
    "EvalConfig",
    "ModelConfig",
    "MSResUNetConfig",
    "SwinIRConfig",
    "TrainConfig",
    "UNet2DConfig",
    "build_model",
    "config_from_dict",
    "model_registry",
    "register_model",
    "COMPUTE_DTYPE",
    "OUTPUT_DTYPE",
    "PARAM_DTYPE",
    "serving_dtype",
]
