"""The weight bridge: the JAX package's SwinIR parameter tree (a nested
dict of numpy arrays, ``variables["params"]``) -> the port's state dict.

The same mapping as the JAX package's
``interop/torch_export.py::export_swinir``, written here so the port
needs nothing of the JAX package:

- conv kernel [kh, kw, I, O] -> ``nn.Conv2d`` weight [O, I, kh, kw]
- dense kernel [I, O]        -> ``nn.Linear`` weight [O, I]
- LayerNorm scale / bias     -> weight / bias
- module names '_' -> '.' per the reference layout (layers_i ->
  layers.i.residual_group.blocks.j, patch_norm -> patch_embed.norm,
  the upsample chain's conv_k -> upsample.{0,2,4}).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


class _Tree:
    def __init__(self, root: Mapping):
        self.root = root or {}

    def has(self, *path) -> bool:
        node = self.root
        for p in path:
            if not isinstance(node, Mapping) or p not in node:
                return False
            node = node[p]
        return True

    def get(self, *path) -> np.ndarray:
        node = self.root
        for p in path:
            node = node[p]
        return np.asarray(node)


def swinir_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX SwinIR variables (or their "params" tree) -> reference-format
    state dict of numpy arrays, loadable into the port with strict=True."""
    p = _Tree(variables.get("params", variables))
    out: Dict[str, np.ndarray] = {}

    def ln(tname, *path):
        out[tname + ".weight"] = p.get(*path, "scale")
        out[tname + ".bias"] = p.get(*path, "bias")

    def conv(tname, *path):
        out[tname + ".weight"] = np.transpose(p.get(*path, "kernel"), (3, 2, 0, 1))
        if p.has(*path, "bias"):
            out[tname + ".bias"] = p.get(*path, "bias")

    def dense(tname, *path):
        out[tname + ".weight"] = p.get(*path, "kernel").T
        if p.has(*path, "bias"):
            out[tname + ".bias"] = p.get(*path, "bias")

    conv("conv_first", "conv_first")
    if p.has("patch_norm"):
        ln("patch_embed.norm", "patch_norm")
    if p.has("absolute_pos_embed"):
        ape = p.get("absolute_pos_embed")  # [side, side, C]
        out["absolute_pos_embed"] = ape.reshape(1, -1, ape.shape[-1])
    i = 0
    while p.has(f"layers_{i}"):
        lp, t = f"layers_{i}", f"layers.{i}"
        j = 0
        while p.has(lp, f"blocks_{j}"):
            bp = (lp, f"blocks_{j}")
            tb = f"{t}.residual_group.blocks.{j}"
            ln(f"{tb}.norm1", *bp, "norm1")
            ln(f"{tb}.norm2", *bp, "norm2")
            dense(f"{tb}.attn.qkv", *bp, "attn", "qkv")
            dense(f"{tb}.attn.proj", *bp, "attn", "proj")
            out[f"{tb}.attn.relative_position_bias_table"] = p.get(
                *bp, "attn", "relative_position_bias_table")
            dense(f"{tb}.mlp.fc1", *bp, "mlp", "fc1")
            dense(f"{tb}.mlp.fc2", *bp, "mlp", "fc2")
            j += 1
        if p.has(lp, "conv"):
            conv(f"{t}.conv", lp, "conv")
        else:
            for k in (0, 2, 4):
                conv(f"{t}.conv.{k}", lp, f"conv_{k}")
        i += 1
    ln("norm", "norm")
    if p.has("conv_after_body"):
        conv("conv_after_body", "conv_after_body")
    else:
        for k in (0, 2, 4):
            conv(f"conv_after_body.{k}", f"conv_after_body_{k}")
    if p.has("conv_before_upsample"):
        conv("conv_before_upsample.0", "conv_before_upsample")
        for k, t_idx in enumerate((0, 2, 4)):
            if p.has("upsample", f"conv_{k}"):
                conv(f"upsample.{t_idx}", "upsample", f"conv_{k}")
    elif p.has("upsample", "conv"):  # pixelshuffledirect
        conv("upsample.0", "upsample", "conv")
    for name in ("conv_last", "conv_up1", "conv_up2", "conv_hr"):
        if p.has(name):
            conv(name, name)
    return out
