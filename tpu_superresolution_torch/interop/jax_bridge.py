"""The weight bridge: the JAX package's variables of every family (a
nested dict of numpy arrays: ``variables["params"]``, and for the
families with BatchNorm, DAT, MS_ResUNet and UNet2D, also
``variables["batch_stats"]``) -> the port's state dicts.

The same mappings as the JAX package's
``interop/torch_export.py::export_swinir`` / ``export_hat`` /
``export_dat`` / ``export_msresunet``, written here so the port needs
nothing of the JAX package; UNet2D, which has no exporter, maps its
module names '_' -> '.':

- conv kernel [kh, kw, I, O] -> ``nn.Conv2d`` weight [O, I, kh, kw]
- MS_ResUNet's torch-convention transposed-conv kernel [k, k, O, I] ->
  ``nn.ConvTranspose2d`` weight [I, O, k, k]; flax's ``ConvTranspose``
  kernel [k, k, I, O] (UNet2D) -> the same, spatially flipped
- dense kernel [I, O]        -> ``nn.Linear`` weight [O, I]
- LayerNorm scale / bias     -> weight / bias
- BatchNorm scale / bias and batch_stats mean / var -> weight / bias,
  running_mean / running_var (num_batches_tracked 0)
- module names '_' -> '.' per the reference layout (layers_i ->
  layers.i.residual_group.blocks.j, patch_norm -> patch_embed.norm,
  the upsample chain's conv_k -> upsample.{0,2,4}).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

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
        self.s = _Tree(variables.get("batch_stats", {}))
        self.out: Dict[str, np.ndarray] = {}
        self.bn_paths: Dict[str, Tuple[str, ...]] = {}

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

    def bn(self, tname, *path):
        self.out[tname + ".weight"] = self.p.get(*path, "scale")
        self.out[tname + ".bias"] = self.p.get(*path, "bias")
        self.out[tname + ".running_mean"] = self.s.get(*path, "mean")
        self.out[tname + ".running_var"] = self.s.get(*path, "var")
        self.out[tname + ".num_batches_tracked"] = np.asarray(0, np.int64)
        self.bn_paths[tname] = tuple(path)

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


def _dat_bridge(variables: Mapping) -> _Bridge:
    """The DAT mapping run over `variables`: its state dict in ``.out``,
    each BatchNorm's JAX path in ``.bn_paths``."""
    _need_stats(variables, "dat_state_dict_from_jax")
    e = _Bridge(variables)
    p = e.p
    e.conv("conv_first", "conv_first")
    e.ln("before_RG.1", "before_RG_norm")
    i = 0
    while p.has(f"layers_{i}"):
        lp, t = f"layers_{i}", f"layers.{i}"
        j = 0
        while p.has(lp, f"blocks_{j}"):
            bp = (lp, f"blocks_{j}")
            tb, ap = f"{t}.blocks.{j}", bp + ("attn",)
            e.ln(f"{tb}.norm1", *bp, "norm1")
            e.ln(f"{tb}.norm2", *bp, "norm2")
            e.dense(f"{tb}.attn.qkv", *ap, "qkv")
            e.dense(f"{tb}.attn.proj", *ap, "proj")
            e.conv(f"{tb}.attn.dwconv.0", *ap, "dwconv", "conv")
            e.bn(f"{tb}.attn.dwconv.1", *ap, "dwconv", "bn")
            e.conv(f"{tb}.attn.channel_interaction.1", *ap, "channel_interaction", "fc1")
            e.bn(f"{tb}.attn.channel_interaction.2", *ap, "channel_interaction", "bn")
            e.conv(f"{tb}.attn.channel_interaction.4", *ap, "channel_interaction", "fc2")
            e.conv(f"{tb}.attn.spatial_interaction.0", *ap, "spatial_interaction", "fc1")
            e.bn(f"{tb}.attn.spatial_interaction.1", *ap, "spatial_interaction", "bn")
            e.conv(f"{tb}.attn.spatial_interaction.3", *ap, "spatial_interaction", "fc2")
            if p.has(*ap, "temperature"):  # channel block
                e.out[f"{tb}.attn.temperature"] = p.get(*ap, "temperature")
            else:  # spatial block: the two branches' DynamicPosBias
                for idx in (0, 1):
                    pp, tpos = ap + (f"attns_{idx}", "pos"), f"{tb}.attn.attns.{idx}.pos"
                    e.dense(f"{tpos}.pos_proj", *pp, "pos_proj")
                    for n in (1, 2, 3):
                        e.ln(f"{tpos}.pos{n}.0", *pp, f"pos{n}_norm")
                        e.dense(f"{tpos}.pos{n}.2", *pp, f"pos{n}_fc")
            e.dense(f"{tb}.ffn.fc1", *bp, "ffn", "fc1")
            e.dense(f"{tb}.ffn.fc2", *bp, "ffn", "fc2")
            e.ln(f"{tb}.ffn.sg.norm", *bp, "ffn", "sg_norm")
            e.conv(f"{tb}.ffn.sg.conv", *bp, "ffn", "sg_conv")
            j += 1
        if p.has(lp, "conv"):
            e.conv(f"{t}.conv", lp, "conv")
        else:
            for k in (0, 2, 4):
                e.conv(f"{t}.conv.{k}", lp, f"conv_{k}")
        i += 1
    e.tail()
    return e


def dat_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX DAT variables ({"params", "batch_stats"}) -> reference-format
    state dict (the inverse of the JAX package's ``convert_dat``; the
    mapping of its ``export_dat``): the reference's Sequential indices
    dwconv.{0 conv, 1 BN}, channel_interaction.{1 conv, 2 BN, 4 conv},
    spatial_interaction.{0 conv, 1 BN, 3 conv}, DynamicPosBias
    pos{1,2,3}.{0 LN, 2 Linear}, before_RG.1, ffn.sg.{norm, conv}."""
    return _dat_bridge(variables).out


def _stats_tree(bridge: _Bridge, state_dict: Mapping) -> Dict:
    tree: Dict = {}
    for tname, path in bridge.bn_paths.items():
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        for leaf, suffix in (("mean", "running_mean"), ("var", "running_var")):
            t = state_dict[f"{tname}.{suffix}"]
            node[leaf] = np.asarray(t.detach().cpu() if hasattr(t, "detach") else t)
    return tree


def dat_batch_stats_from_state_dict(state_dict: Mapping, variables: Mapping) -> Dict:
    """The port's BatchNorm running statistics (``<name>.running_mean`` /
    ``.running_var`` of a DAT state dict) as a JAX ``batch_stats`` tree
    (nested dicts of numpy arrays, leaves ``mean`` / ``var``) of the
    shape `variables` has: the inverse of the statistics part of
    ``dat_state_dict_from_jax``, for comparing the two after a train
    step."""
    return _stats_tree(_dat_bridge(variables), state_dict)


def _need_stats(variables: Mapping, what: str) -> None:
    if not isinstance(variables, Mapping) or "batch_stats" not in variables:
        raise ValueError(f"{what} needs the variables' 'batch_stats' (BatchNorm running "
                         "statistics) beside 'params'")


def _msresunet_bridge(variables: Mapping) -> _Bridge:
    _need_stats(variables, "msresunet_state_dict_from_jax")
    e = _Bridge(variables)
    p = e.p
    e.conv("conv1", "conv1")
    e.bn("bn1", "bn1")
    for s in (1, 2, 3, 4):
        b = 0
        while p.has(f"layer{s}_{b}"):
            jm, tm = f"layer{s}_{b}", f"layer{s}.{b}"
            for idx in (1, 2, 3):
                e.conv(f"{tm}.conv{idx}", jm, f"conv{idx}")
                e.bn(f"{tm}.bn{idx}", jm, f"bn{idx}")
            if p.has(jm, "downsample_conv"):
                e.conv(f"{tm}.downsample.0", jm, "downsample_conv")
                e.bn(f"{tm}.downsample.1", jm, "downsample_bn")
            b += 1
    rcu = {1: "_conv", 2: "_conv_relu_varout_dimred"}
    for k in (1, 2, 3, 4):
        ref = f"refine{k}"
        e.conv(f"p_ims1d2_outl{k}_dimred", ref, "dimred")
        for sub, thead in (("adapt", f"adapt_stage{k}_b"), ("mflow", f"mflow_conv_g{k}_b")):
            i = 1
            while p.has(ref, sub, f"b{i}s1"):
                for j in (1, 2):
                    e.conv(f"{thead}.0.{i}{rcu[j]}", ref, sub, f"b{i}s{j}")
                i += 1
        if p.has(ref, "adapt_dimred"):
            e.conv(f"adapt_stage{k}_b2_joint_varout_dimred", ref, "adapt_dimred")
        i = 1
        while p.has(ref, "pool", f"conv{i}"):
            e.conv(f"mflow_conv_g{k}_pool.0.{i}_outvar_dimred", ref, "pool", f"conv{i}")
            i += 1
        if p.has(ref, "out_dimred"):
            e.conv(f"mflow_conv_g{k}_b3_joint_varout_dimred", ref, "out_dimred")
    for k in (2, 3, 4):  # ConvTranspose2dTorch: [k, k, O, I] -> [I, O, k, k]
        e.out[f"upCT{k}.weight"] = np.transpose(p.get(f"upCT{k}", "kernel"), (3, 2, 0, 1))
        e.out[f"upCT{k}.bias"] = p.get(f"upCT{k}", "bias")
    for name in ("clf_conv1", "clf_conv2"):
        e.conv(name, name)
    return e


def msresunet_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX MS_ResUNet variables ({"params", "batch_stats"}) -> the
    reference ms_resunet.py state dict (the mapping of the JAX package's
    ``export_msresunet``: its refine{k} submodules -> the reference's
    setattr-generated decoder names)."""
    return _msresunet_bridge(variables).out


def _unet2d_bridge(variables: Mapping) -> _Bridge:
    e = _Bridge(variables)
    p = e.p

    def double(t, *path):
        for c in ("c1", "c2"):
            e.conv(f"{t}.{c}.conv", *path, c, "conv")
            if p.has(*path, c, "bn"):
                e.bn(f"{t}.{c}.bn", *path, c, "bn")

    double("inc", "inc")
    depth = 0
    while p.has(f"down{depth + 1}"):
        depth += 1
        double(f"down{depth}", f"down{depth}")
    for k in range(1, depth + 1):
        if p.has(f"up{k}_reduce"):
            e.conv(f"up{k}.reduce", f"up{k}_reduce")
        else:  # flax ConvTranspose [k, k, I, O], taps in the other order
            kern = p.get(f"up{k}_ct", "kernel")[::-1, ::-1]
            e.out[f"up{k}.ct.weight"] = np.ascontiguousarray(np.transpose(kern, (2, 3, 0, 1)))
            e.out[f"up{k}.ct.bias"] = p.get(f"up{k}_ct", "bias")
        double(f"up{k}", f"up{k}")
    e.conv("outc", "outc")
    if e.bn_paths:
        _need_stats(variables, "unet2d_state_dict_from_jax")
    return e


def unet2d_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX UNet2D variables (with "batch_stats" when it has BatchNorm) ->
    the port's UNet2D state dict (module names '_' -> '.', ``upK_reduce``
    / ``upK_ct`` under ``upK``)."""
    return _unet2d_bridge(variables).out


def batch_stats_from_state_dict(model_name: str, state_dict: Mapping, variables: Mapping) -> Dict:
    """``dat_batch_stats_from_state_dict`` for any family with
    BatchNorm ("dat", "ms_resunet", "unet2d")."""
    bridges = {"dat": _dat_bridge, "ms_resunet": _msresunet_bridge, "unet2d": _unet2d_bridge}
    return _stats_tree(bridges[model_name](variables), state_dict)
