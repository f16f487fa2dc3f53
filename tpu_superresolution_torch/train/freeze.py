"""Regex freezing of parameters by state-dict name (port of
``tpu_superresolution_tpu/train/freeze.py``).

The regex is searched in the port's parameter names, which are the
reference's torch state-dict names (e.g.
``layers.0.residual_group.blocks.1.attn.qkv.weight``), as the
reference's own ``--freeze_regex`` matched them (train.py:291-296,
finetune_swinir.py:290-297).  A regex written for the JAX package
matches Flax paths such as ``layers_0/blocks_1/attn/qkv/kernel`` and has
to be rewritten for the port.  A frozen parameter gets
``requires_grad=False``: no gradient, no optimizer state, no update.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch.nn as nn


def apply_freeze(model: nn.Module, freeze_regex: Optional[str]) -> Dict[str, bool]:
    """Freeze every parameter whose name matches `freeze_regex` (searched,
    not anchored); returns {name: True if trainable}."""
    pat = re.compile(freeze_regex) if freeze_regex else None
    mask = {}
    for name, p in model.named_parameters():
        mask[name] = not (pat and pat.search(name))
        p.requires_grad_(mask[name])
    return mask
