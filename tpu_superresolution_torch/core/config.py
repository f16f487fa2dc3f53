"""Config dataclasses + model registry (port of
``tpu_superresolution_tpu/core/config.py``).

The dataclasses keep the JAX package's field names and defaults, so a
``to_dict()`` from either package rebuilds through the other's
``config_from_dict``.  All five families are registered: the CNNs
``ms_resunet`` and ``unet2d`` (restoration nets on pre-upscaled input)
and the transformers ``swinir``, ``hat`` (with the ``hat_fast`` preset)
and ``dat``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Base class for model configs; `name` keys the registry."""

    name: str = "base"
    in_channels: int = 1
    out_channels: int = 1
    scale: int = 2

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["__model__"] = self.name
        return d

    @property
    def upsamples_internally(self) -> bool:
        """True if forward maps [B,H,W,C] -> [B,H*s,W*s,C]."""
        return False


@dataclass(frozen=True)
class MSResUNetConfig(ModelConfig):
    """RefineNet-style restoration CNN (reference modules/ms_resunet.py).

    `layers` = bottleneck counts per encoder stage; the published best is
    [3,4,3,3] (reference ms_resunet.py:263, results.ipynb cell 40).  It
    maps [B,H,W,1] -> [B,H,W,1]: the SR factor is the data pipeline's
    bicubic pre-upscale (``upsamples_internally`` False).
    """

    name: str = "ms_resunet"
    layers: Tuple[int, ...] = (3, 4, 3, 3)
    stem_channels: int = 32
    stage_planes: Tuple[int, ...] = (32, 64, 128, 256)
    refine_channels: int = 128
    use_batchnorm: bool = True


@dataclass(frozen=True)
class UNet2DConfig(ModelConfig):
    """Simple U-Net family (capabilities of the reference's missing
    unet2d.py, documented in notebooks/to_present/cnn.ipynb cells 31-34:
    UNetConfig(in_channels, out_channels, base_channels, depth, bilinear,
    norm, dropout)); a restoration net on pre-upscaled input."""

    name: str = "unet2d"
    base_channels: int = 64
    depth: int = 4
    bilinear: bool = True
    norm: str = "batch"  # "batch" | "none"
    dropout: float = 0.0
    residual: bool = False  # results.ipynb cell 13: residual-head variant


@dataclass(frozen=True)
class SwinIRConfig(ModelConfig):
    """SwinIR window-attention transformer (reference
    network_swinir.py:618-851).  Defaults = SwinIR-M x4."""

    name: str = "swinir"
    in_channels: int = 3
    out_channels: int = 3
    scale: int = 4
    img_size: int = 64
    window_size: int = 8
    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    upsampler: str = "pixelshuffle"  # pixelshuffle|pixelshuffledirect|nearest+conv|""
    resi_connection: str = "1conv"  # "1conv" | "3conv"
    ape: bool = False
    patch_norm: bool = True
    num_feat: int = 64
    img_range: float = 1.0
    use_remat: bool = False
    # Kept for dict round-trips with the JAX package; the port picks its
    # implementation from the tensors' device (see build_model's `impl`).
    attention_impl: str = "auto"
    # tanh-GELU is the serving default; torch checkpoints and --exact use
    # the reference's exact erf.
    gelu_approximate: bool = True
    drop_path_rate: float = 0.1
    # One composed conv + one pixel_shuffle for the linear reconstruction
    # tail (ops/fused_upsample.py); exact in the interior, a border ring
    # of up to 3*scale output pixels differs.
    fused_reconstruct: bool = True

    @property
    def upsamples_internally(self) -> bool:
        return True


@dataclass(frozen=True)
class HATConfig(ModelConfig):
    """HAT hybrid attention transformer (reference
    modules/hat_arch.py:710-994).  Defaults = HAT x4 as the reference's
    constructor builds it: embed 96, depths 6x4, ws 7."""

    name: str = "hat"
    in_channels: int = 3
    out_channels: int = 3
    scale: int = 4
    img_size: int = 64
    window_size: int = 7
    embed_dim: int = 96
    depths: Tuple[int, ...] = (6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    compress_ratio: int = 3
    squeeze_factor: int = 30
    conv_scale: float = 0.01
    overlap_ratio: float = 0.5
    upsampler: str = "pixelshuffle"
    resi_connection: str = "1conv"  # "1conv" | "identity"
    num_feat: int = 64
    img_range: float = 1.0
    use_remat: bool = False
    attention_impl: str = "auto"  # kept for dict round-trips, as SwinIRConfig's
    patch_norm: bool = True
    drop_path_rate: float = 0.1
    fused_reconstruct: bool = True  # see SwinIRConfig.fused_reconstruct
    # tanh-GELU in the HAB and OCAB MLPs (serving default); the CAB's
    # GELU is always the exact erf, as in the JAX package.
    gelu_approximate: bool = True

    @property
    def upsamples_internally(self) -> bool:
        return True


@dataclass(frozen=True)
class HATFastConfig(HATConfig):
    """The JAX package's fast-HAT preset: HAT at window_size=8 (its
    blocks run K1 instead of K6).  Official checkpoints use ``hat``."""

    name: str = "hat_fast"
    window_size: int = 8


@dataclass(frozen=True)
class DATConfig(ModelConfig):
    """DAT dual aggregation transformer (reference
    modules/dat_arch.py:699-859).  Defaults = DAT x4 as published
    (Chen et al., ICCV 2023): embed 180, depths 6x6, heads 6, split
    (8, 16), expansion 2.  Its GELUs are always the exact erf."""

    name: str = "dat"
    in_channels: int = 3
    out_channels: int = 3
    scale: int = 4
    img_size: int = 64
    embed_dim: int = 180
    split_size: Tuple[int, int] = (8, 16)
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    expansion_factor: float = 2.0
    qkv_bias: bool = True
    upsampler: str = "pixelshuffle"  # pixelshuffle | pixelshuffledirect
    resi_connection: str = "1conv"  # "1conv" | "3conv"
    num_feat: int = 64
    img_range: float = 1.0
    use_remat: bool = False
    attention_impl: str = "auto"  # kept for dict round-trips, as SwinIRConfig's
    drop_path_rate: float = 0.1  # training only
    fused_reconstruct: bool = True  # see SwinIRConfig.fused_reconstruct

    @property
    def upsamples_internally(self) -> bool:
        return True


@dataclass(frozen=True)
class DataConfig:
    """Paired LR/HR dataset config (the JAX package's DataConfig;
    reference modules/sr_datasets.py:31-73): the pre-upscale convention
    of the CNN families or the native-LR one of the transformers, the
    paired blur, and the (mean, std) normalization of both members."""

    data_root: str = ""
    dataset: str = "shuffled2D"
    scale: str = "X2"  # "X2" | "X4"
    convention: str = "pre_upscale"  # "pre_upscale" | "native_lr"
    patch_size: Optional[int] = 100  # HR-space patch for pre_upscale
    lr_patch: Optional[int] = 64  # LR-space patch for native_lr
    do_flips: bool = True
    do_blur: bool = False
    norm_mean: Optional[float] = None
    norm_std: Optional[float] = None
    grayscale: bool = True
    channels: int = 1

    @property
    def normalizes(self) -> bool:
        return self.norm_mean is not None and self.norm_std is not None

    @property
    def scale_int(self) -> int:
        return int(self.scale[1:])


@dataclass(frozen=True)
class TrainConfig:
    """Training config (the JAX package's TrainConfig without its
    TPU-only `remat`).  `bf16_compute`: on CUDA the model computes in
    bf16 with fp32 parameters and no loss scaling; on the CPU it always
    computes in fp32."""

    epochs: int = 5
    batch_size: int = 8
    loss: str = "mse"  # "mse" | "l1" | "l1_ssim"
    lr: float = 1e-4
    weight_decay: float = 0.0
    scheduler: str = "none"  # "onecycle" | "exponential" | "cosine" | "none"
    min_lr: float = 1e-7  # cosine floor (reference finetune_swinir.py:309)
    grad_clip_norm: float = 1.0
    seed: int = 42
    freeze_regex: Optional[str] = None  # matches state-dict names
    finetune: bool = False
    ft_lr: Optional[float] = None
    early_stop_patience: Optional[int] = None
    time_log_every: int = 0
    val_every: int = 1
    ema_decay: Optional[float] = None
    bf16_compute: bool = True
    # data-parallel shards: 0/1 = one device; N > 1 = a process group
    # of N ranks (parallel/), -1 = every rank
    dp_shards: int = 0


@dataclass(frozen=True)
class EvalConfig:
    batch_size: int = 4
    tile_size: Optional[int] = None  # None = whole image
    tile_overlap: int = 16
    # Cap on tiles per model call (None = all tiles in one batch).
    max_tile_batch: Optional[int] = None
    save_n: int = 0
    save_every: Optional[int] = None
    save_start: int = 0
    save_indices: Tuple[int, ...] = ()
    rescale_png: bool = False
    # x8 geometric self-ensemble: average over 4 rotations x 2 flips.
    self_ensemble: bool = False


model_registry: Dict[str, Tuple[type, Callable]] = {}


def register_model(name: str, config_cls: type, build_fn: Callable) -> None:
    model_registry[name] = (config_cls, build_fn)


def _ensure_registered() -> None:
    from tpu_superresolution_torch import models as _models  # noqa: F401


def build_model(config: ModelConfig, dtype=None, impl: str = "auto", device=None):
    """Build an ``nn.Module`` from a config via the registry.

    `dtype` is the compute dtype (parameters stay fp32; default fp32).
    `impl`: "auto" runs the kernels on CUDA tensors and their plain
    versions on CPU tensors; "plain" runs the plain versions on any
    device (the reference path the kernels are held against).  The model
    comes in eval mode; ``model.train()`` turns on its training-only
    behaviour (stochastic depth).
    """
    _ensure_registered()
    if config.name not in model_registry:
        raise KeyError(
            f"Unknown model '{config.name}'. Registered: {sorted(model_registry)}"
        )
    _, build_fn = model_registry[config.name]
    model = build_fn(config, dtype=dtype, impl=impl)
    return model if device is None else model.to(device)


def config_from_dict(d: Dict[str, Any]) -> ModelConfig:
    """Rebuild a config from its serialized dict (checkpoint round-trip)."""
    _ensure_registered()
    d = dict(d)
    name = d.pop("__model__", d.get("name"))
    if name not in model_registry:
        raise KeyError(f"Unknown model '{name}' in checkpoint config")
    config_cls, _ = model_registry[name]
    fields = {f.name for f in dataclasses.fields(config_cls)}
    kwargs = {k: v for k, v in d.items() if k in fields}
    # JSON round-trips tuples as lists; restore tuple-typed fields.
    for f in dataclasses.fields(config_cls):
        if f.name in kwargs and isinstance(kwargs[f.name], list):
            kwargs[f.name] = tuple(kwargs[f.name])
    return config_cls(**kwargs)
