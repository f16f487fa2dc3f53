"""Reference torch checkpoints -> the port (port of the
``extract_state_dict`` / ``infer_swinir_config`` / ``infer_hat_config``
/ ``infer_dat_config`` / ``infer_msresunet_config`` parts of
``tpu_superresolution_tpu/interop/torch_convert.py``).

The port's modules use the reference key names, so loading needs no key
conversion: unwrap the checkpoint, drop the buffers the reference
stores but the port computes from shapes (SwinIR's
``relative_position_index`` and ``attn_mask``, HAT's
``relative_position_index_SA`` / ``_OCA``, DAT's ``rpe_biases``,
``relative_position_index`` and ``attn_mask_0`` / ``_1``; MS_ResUNet's
vestigial ``up_ps*`` keys of the commented-out PixelShuffle variant),
and ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tpu_superresolution_torch.core.config import (
    DATConfig,
    HATConfig,
    MSResUNetConfig,
    SwinIRConfig,
)

_WRAPPER_KEYS = ("params_ema", "params", "state_dict", "model_state_dict", "model", "net", "generator")

# Buffers of reference checkpoints that the port derives from shapes.
REFERENCE_BUFFER_SUFFIXES = (".relative_position_index", ".attn_mask",
                             "relative_position_index_SA", "relative_position_index_OCA",
                             ".rpe_biases", ".attn_mask_0", ".attn_mask_1")
# Keys of reference MS_ResUNet checkpoints that no module has.
REFERENCE_VESTIGIAL_PREFIXES = ("up_ps",)


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """torch.load (tensors only) + unwrap + numpy-ify."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return extract_state_dict(ckpt)


def extract_state_dict(ckpt: Any) -> Dict[str, np.ndarray]:
    """Unwrap common checkpoint formats (wrapper keys
    params_ema/params/state_dict/model_state_dict/model/net/generator,
    DataParallel 'module.' prefix) to a flat {name: ndarray}."""
    sd = ckpt
    if isinstance(ckpt, Mapping) and not all(torch.is_tensor(v) for v in ckpt.values()):
        for k in _WRAPPER_KEYS:
            v = ckpt.get(k)
            if isinstance(v, Mapping):
                sd = v
                break
    out = {}
    for k, v in sd.items():
        if torch.is_tensor(v):
            k = k[len("module."):] if k.startswith("module.") else k
            out[k] = v.detach().cpu().numpy()
    return out


def strip_reference_buffers(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the reference's shape-derived buffers (and vestigial keys)
    before a strict load."""
    return {k: v for k, v in sd.items() if not k.endswith(REFERENCE_BUFFER_SUFFIXES)
            and not k.startswith(REFERENCE_VESTIGIAL_PREFIXES)}


def _depths_heads_swin(sd, prefix="layers.{i}.residual_group.blocks.{j}"):
    """Blocks per layer, and heads from each layer's first bias table."""
    depths, heads = [], []
    i = 0
    while prefix.format(i=i, j=0) + ".norm1.weight" in sd:
        j = 0
        while prefix.format(i=i, j=j) + ".norm1.weight" in sd:
            j += 1
        depths.append(j)
        heads.append(int(sd[prefix.format(i=i, j=0) + ".attn.relative_position_bias_table"].shape[1]))
        i += 1
    return tuple(depths), tuple(heads)


def _ws_from_rpb(rows: int, what: str) -> int:
    """Window size from a [(2ws-1)^2, nH] bias table row count."""
    side = int(round(rows ** 0.5))
    if side * side != rows or side % 2 != 1:
        raise ValueError(
            f"{what}: relative_position_bias_table has {rows} rows, which is not an "
            "odd perfect square (2*ws-1)^2 — unrecognized window geometry"
        )
    return (side + 1) // 2


def infer_swinir_config(sd: Mapping[str, np.ndarray], scale: int) -> SwinIRConfig:
    """A SwinIRConfig matching a reference network_swinir.py state dict
    (width / depth / heads / window / upsampler from tensor shapes)."""
    if "conv_first.weight" not in sd:
        raise ValueError(
            "not a SwinIR checkpoint: missing 'conv_first.weight' "
            f"(keys start: {sorted(sd)[:5]})"
        )
    embed_dim = int(sd["conv_first.weight"].shape[0])
    in_channels = int(sd["conv_first.weight"].shape[1])
    depths, heads = _depths_heads_swin(sd)
    if not depths:
        raise ValueError(
            "SwinIR checkpoint has no 'layers.*.residual_group.blocks.*' keys — wrong --model?"
        )
    b0 = "layers.0.residual_group.blocks.0"
    ws = _ws_from_rpb(sd[f"{b0}.attn.relative_position_bias_table"].shape[0], "SwinIR")
    mlp_ratio = sd[f"{b0}.mlp.fc1.weight"].shape[0] / embed_dim
    if "conv_up1.weight" in sd:
        upsampler = "nearest+conv"
        num_feat = int(sd["conv_up1.weight"].shape[0])
        out_channels = int(sd["conv_last.weight"].shape[0])
    elif "conv_before_upsample.0.weight" in sd:
        upsampler = "pixelshuffle"
        num_feat = int(sd["conv_before_upsample.0.weight"].shape[0])
        out_channels = int(sd["conv_last.weight"].shape[0])
    elif "upsample.0.weight" in sd:
        upsampler = "pixelshuffledirect"
        num_feat = 64
        out_channels = int(sd["upsample.0.weight"].shape[0]) // (scale * scale)
    else:
        upsampler = ""
        num_feat = 64
        out_channels = int(sd["conv_last.weight"].shape[0])
    return SwinIRConfig(
        scale=scale,
        in_channels=in_channels,
        out_channels=out_channels,
        window_size=ws,
        embed_dim=embed_dim,
        depths=depths,
        num_heads=heads,
        mlp_ratio=float(mlp_ratio),
        qkv_bias=f"{b0}.attn.qkv.bias" in sd,
        upsampler=upsampler,
        resi_connection="1conv" if "layers.0.conv.weight" in sd else "3conv",
        ape="absolute_pos_embed" in sd,
        patch_norm="patch_embed.norm.weight" in sd,
        num_feat=num_feat,
    )


def infer_hat_config(sd: Mapping[str, np.ndarray], scale: int) -> HATConfig:
    """A HATConfig matching a reference hat_arch.py state dict (see
    infer_swinir_config).  conv_scale is not a weight: the default 0.01."""
    if "layers.0.residual_group.overlap_attn.qkv.weight" not in sd:
        raise ValueError(
            "not a HAT checkpoint: missing "
            "'layers.0.residual_group.overlap_attn.qkv.weight' — wrong --model?"
        )
    embed_dim = int(sd["conv_first.weight"].shape[0])
    in_channels = int(sd["conv_first.weight"].shape[1])
    depths, heads = _depths_heads_swin(sd)
    b0 = "layers.0.residual_group.blocks.0"
    ws = _ws_from_rpb(sd[f"{b0}.attn.relative_position_bias_table"].shape[0], "HAT")
    # OCAB table rows = (ws + ows - 1)^2, ows = ws * (1 + overlap_ratio)
    # (hat_arch.py:381-382)
    orows = sd["layers.0.residual_group.overlap_attn.relative_position_bias_table"].shape[0]
    oside = int(round(orows ** 0.5))
    if oside * oside != orows:
        raise ValueError(f"HAT: OCAB bias table rows {orows} not a square")
    ows = oside + 1 - ws
    cab_mid = int(sd[f"{b0}.conv_block.cab.0.weight"].shape[0])
    sq_mid = int(sd[f"{b0}.conv_block.cab.3.attention.1.weight"].shape[0])
    return HATConfig(
        scale=scale,
        in_channels=in_channels,
        out_channels=int(sd["conv_last.weight"].shape[0]),
        window_size=ws,
        embed_dim=embed_dim,
        depths=depths,
        num_heads=heads,
        mlp_ratio=float(sd[f"{b0}.mlp.fc1.weight"].shape[0] / embed_dim),
        qkv_bias=f"{b0}.attn.qkv.bias" in sd,
        compress_ratio=max(1, round(embed_dim / cab_mid)),
        squeeze_factor=max(1, round(embed_dim / sq_mid)),
        overlap_ratio=ows / ws - 1.0,
        num_feat=int(sd["conv_before_upsample.0.weight"].shape[0]),
        resi_connection="1conv" if "layers.0.conv.weight" in sd else "identity",
        patch_norm="patch_embed.norm.weight" in sd,
    )


def infer_dat_config(sd: Mapping[str, np.ndarray], scale: int) -> DATConfig:
    """A DATConfig matching a reference dat_arch.py state dict (see
    infer_swinir_config).  The split size is not in the weights (the
    DynamicPosBias input is always 2-wide): the published (8, 16) is
    kept."""
    if "before_RG.1.weight" not in sd:
        raise ValueError("not a DAT checkpoint: missing 'before_RG.1.weight' — wrong --model?")
    embed_dim = int(sd["conv_first.weight"].shape[0])
    depths, heads = [], []
    i = 0
    while f"layers.{i}.blocks.0.norm1.weight" in sd:
        j = 0
        while f"layers.{i}.blocks.{j}.norm1.weight" in sd:
            j += 1
        depths.append(j)
        temp = f"layers.{i}.blocks.1.attn.temperature"  # channel blocks: [nH, 1, 1]
        if temp in sd:
            heads.append(int(sd[temp].shape[0]))
        else:  # a one-block group: twice a branch's DynamicPosBias heads
            heads.append(2 * int(sd[f"layers.{i}.blocks.0.attn.attns.0.pos.pos3.2.weight"].shape[0]))
        i += 1
    if not depths:
        raise ValueError("DAT checkpoint has no 'layers.*.blocks.*' keys")
    b0 = "layers.0.blocks.0"
    if "conv_before_upsample.0.weight" in sd:
        upsampler, num_feat = "pixelshuffle", int(sd["conv_before_upsample.0.weight"].shape[0])
        out_channels = int(sd["conv_last.weight"].shape[0])
    else:
        upsampler, num_feat = "pixelshuffledirect", 64
        out_channels = int(sd["upsample.0.weight"].shape[0]) // (scale * scale)
    return DATConfig(
        scale=scale,
        in_channels=int(sd["conv_first.weight"].shape[1]),
        out_channels=out_channels,
        embed_dim=embed_dim,
        depths=tuple(depths),
        num_heads=tuple(heads),
        expansion_factor=float(sd[f"{b0}.ffn.fc1.weight"].shape[0] / embed_dim),
        qkv_bias=f"{b0}.attn.qkv.bias" in sd,
        upsampler=upsampler,
        resi_connection="1conv" if "layers.0.conv.weight" in sd else "3conv",
        num_feat=num_feat,
    )


def infer_msresunet_config(sd: Mapping[str, np.ndarray], scale: int) -> MSResUNetConfig:
    """An MSResUNetConfig from a reference ms_resunet.py state dict: the
    bottlenecks of each encoder stage are counted; the stem width is
    checked against the published geometry, and a mismatch named."""
    if "conv1.weight" not in sd or "clf_conv2.weight" not in sd:
        raise ValueError("not an MS_ResUNet checkpoint: missing conv1/clf_conv2 — wrong --model?")
    layers = []
    for s in (1, 2, 3, 4):
        b = 0
        while f"layer{s}.{b}.conv1.weight" in sd:
            b += 1
        layers.append(b)
    if 0 in layers:
        raise ValueError(f"MS_ResUNet: empty encoder stage (counts {layers})")
    cfg = MSResUNetConfig(scale=scale, layers=tuple(layers))
    stem = int(sd["conv1.weight"].shape[0])
    if stem != cfg.stem_channels:
        raise ValueError(f"MS_ResUNet: conv1 out={stem}, expected {cfg.stem_channels} "
                         "(non-default width; pass a config explicitly)")
    return cfg


# --model name -> config inference from a reference checkpoint (UNet2D
# has no reference checkpoint format)
CONFIG_INFERENCE = {"ms_resunet": infer_msresunet_config, "swinir": infer_swinir_config,
                    "hat": infer_hat_config, "dat": infer_dat_config}
