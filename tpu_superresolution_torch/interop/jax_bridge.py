"""The weight bridge: the JAX package's SwinIR and HAT parameter trees (a
nested dict of numpy arrays, ``variables["params"]``) -> the port's
state dicts.

The same mappings as the JAX package's
``interop/torch_export.py::export_swinir`` / ``export_hat``, written
here so the port needs nothing of the JAX package:

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


class _Bridge:
    """Writes reference-named numpy entries read from a JAX param tree."""

    def __init__(self, variables: Mapping):
        self.p = _Tree(variables.get("params", variables))
        self.out: Dict[str, np.ndarray] = {}

    def ln(self, tname, *path):
        self.out[tname + ".weight"] = self.p.get(*path, "scale")
        self.out[tname + ".bias"] = self.p.get(*path, "bias")

    def conv(self, tname, *path):
        self.out[tname + ".weight"] = np.transpose(self.p.get(*path, "kernel"), (3, 2, 0, 1))
        if self.p.has(*path, "bias"):
            self.out[tname + ".bias"] = self.p.get(*path, "bias")

    def dense(self, tname, *path):
        self.out[tname + ".weight"] = self.p.get(*path, "kernel").T
        if self.p.has(*path, "bias"):
            self.out[tname + ".bias"] = self.p.get(*path, "bias")

    def swin_block(self, tb, *bp):
        """A Swin block's norms, attention and MLP (SwinIR's and HAT's)."""
        self.ln(f"{tb}.norm1", *bp, "norm1")
        self.ln(f"{tb}.norm2", *bp, "norm2")
        self.dense(f"{tb}.attn.qkv", *bp, "attn", "qkv")
        self.dense(f"{tb}.attn.proj", *bp, "attn", "proj")
        self.out[f"{tb}.attn.relative_position_bias_table"] = self.p.get(
            *bp, "attn", "relative_position_bias_table")
        self.dense(f"{tb}.mlp.fc1", *bp, "mlp", "fc1")
        self.dense(f"{tb}.mlp.fc2", *bp, "mlp", "fc2")

    def tail(self):
        """norm, the body's closing conv and the reconstruction."""
        p = self.p
        self.ln("norm", "norm")
        if p.has("conv_after_body"):
            self.conv("conv_after_body", "conv_after_body")
        elif p.has("conv_after_body_0"):
            for k in (0, 2, 4):
                self.conv(f"conv_after_body.{k}", f"conv_after_body_{k}")
        if p.has("conv_before_upsample"):
            self.conv("conv_before_upsample.0", "conv_before_upsample")
            for k, t_idx in enumerate((0, 2, 4)):
                if p.has("upsample", f"conv_{k}"):
                    self.conv(f"upsample.{t_idx}", "upsample", f"conv_{k}")
        elif p.has("upsample", "conv"):  # pixelshuffledirect
            self.conv("upsample.0", "upsample", "conv")
        for name in ("conv_last", "conv_up1", "conv_up2", "conv_hr"):
            if p.has(name):
                self.conv(name, name)


def swinir_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX SwinIR variables (or their "params" tree) -> reference-format
    state dict of numpy arrays, loadable into the port with strict=True."""
    e = _Bridge(variables)
    p = e.p
    e.conv("conv_first", "conv_first")
    if p.has("patch_norm"):
        e.ln("patch_embed.norm", "patch_norm")
    if p.has("absolute_pos_embed"):
        ape = p.get("absolute_pos_embed")  # [side, side, C]
        e.out["absolute_pos_embed"] = ape.reshape(1, -1, ape.shape[-1])
    i = 0
    while p.has(f"layers_{i}"):
        lp, t = f"layers_{i}", f"layers.{i}"
        j = 0
        while p.has(lp, f"blocks_{j}"):
            e.swin_block(f"{t}.residual_group.blocks.{j}", lp, f"blocks_{j}")
            j += 1
        if p.has(lp, "conv"):
            e.conv(f"{t}.conv", lp, "conv")
        else:
            for k in (0, 2, 4):
                e.conv(f"{t}.conv.{k}", lp, f"conv_{k}")
        i += 1
    e.tail()
    return e.out


def hat_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX HAT variables (or their "params" tree) -> reference-format
    state dict (the mapping of the JAX package's ``export_hat``: the
    CAB's conv1 / conv2 / SE convs -> ``conv_block.cab.{0,2,3.attention.
    1,3.attention.3}``, the OCAB -> ``residual_group.overlap_attn``)."""
    e = _Bridge(variables)
    p = e.p
    e.conv("conv_first", "conv_first")
    if p.has("patch_norm"):
        e.ln("patch_embed.norm", "patch_norm")
    i = 0
    while p.has(f"layers_{i}"):
        lp, t = f"layers_{i}", f"layers.{i}"
        j = 0
        while p.has(lp, f"blocks_{j}"):
            bp = (lp, f"blocks_{j}")
            tb = f"{t}.residual_group.blocks.{j}"
            e.swin_block(tb, *bp)
            e.conv(f"{tb}.conv_block.cab.0", *bp, "conv_block", "conv1")
            e.conv(f"{tb}.conv_block.cab.2", *bp, "conv_block", "conv2")
            e.conv(f"{tb}.conv_block.cab.3.attention.1", *bp, "conv_block", "ca", "fc1")
            e.conv(f"{tb}.conv_block.cab.3.attention.3", *bp, "conv_block", "ca", "fc2")
            j += 1
        to, op = f"{t}.residual_group.overlap_attn", (lp, "overlap_attn")
        e.ln(f"{to}.norm1", *op, "norm1")
        e.ln(f"{to}.norm2", *op, "norm2")
        e.dense(f"{to}.qkv", *op, "qkv")
        e.dense(f"{to}.proj", *op, "proj")
        e.out[f"{to}.relative_position_bias_table"] = p.get(*op, "relative_position_bias_table")
        e.dense(f"{to}.mlp.fc1", *op, "mlp", "fc1")
        e.dense(f"{to}.mlp.fc2", *op, "mlp", "fc2")
        if p.has(lp, "conv"):
            e.conv(f"{t}.conv", lp, "conv")
        i += 1
    e.tail()
    return e.out
