"""Training checkpoints as one ``torch.save`` file (the counterpart of
``tpu_superresolution_tpu/train/checkpoint.py``, whose Orbax format is
still to port):

    {"params": state_dict, "ema": {parameter name: tensor} or None,
     "optimizer": optimizer.state_dict(), "step": int,
     "config": model_config.to_dict() or None, "extra": {...}}

Tensors are saved on the CPU.  "params" is the reference's state-dict
layout, so ``upscale`` / ``serve`` load the file like a reference
``.pth`` (``interop.extract_state_dict`` unwraps it).  Resume restores
the optimizer and step; a fine-tune start takes the weights only
(reference train.py:283-301, 335-342).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from tpu_superresolution_torch.core.config import ModelConfig, build_model, config_from_dict


def _cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_checkpoint(path: str, state, model_config: Optional[ModelConfig] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write `state` (a TrainState) atomically to `path`."""
    payload = {
        "params": _cpu(state.model.state_dict()),
        "ema": None if state.ema is None else _cpu(state.ema),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "config": None if model_config is None else model_config.to_dict(),
        "extra": dict(extra or {}, ema_decay=state.ema_decay),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The saved dictionary (tensors on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, state) -> Tuple[Any, Dict[str, Any]]:
    """Resume: restore parameters, EMA, optimizer state and step into
    `state` (in place).  Returns (state, extra)."""
    ckpt = read_checkpoint(path)
    state.model.load_state_dict(ckpt["params"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    if state.ema is not None:
        # a checkpoint without an EMA re-seeds it from the parameters; the
        # EMA covers parameters only (an older file's buffers are skipped)
        src = ckpt["ema"] if ckpt.get("ema") is not None else ckpt["params"]
        device = next(state.model.parameters()).device
        state.ema = {k: src[k].to(device).clone() for k, _ in state.model.named_parameters()}
    return state, ckpt.get("extra", {})


def model_config_from_checkpoint(path: str) -> Optional[ModelConfig]:
    cfg = read_checkpoint(path).get("config")
    return None if cfg is None else config_from_dict(cfg)


def load_weights_only(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Fine-tune start: (params state dict, extra), optimizer fresh
    (``checked_params``)."""
    ckpt = read_checkpoint(path)
    return checked_params(ckpt, path), ckpt.get("extra", {})


def checked_params(ckpt: Dict[str, Any], path: str) -> Dict[str, torch.Tensor]:
    """The params state dict of `ckpt`, the dictionary read from `path`.
    When the checkpoint names its model config, every parameter's name
    and shape is checked against that model first, so a wrong checkpoint
    fails here with the name of the first mismatch."""
    params = ckpt["params"]
    if ckpt.get("config") is not None:
        cfg = config_from_dict(ckpt["config"])
        want = {k: tuple(v.shape) for k, v in build_model(cfg).state_dict().items()}
        got = {k: tuple(v.shape) for k, v in params.items()}
        if sorted(want) != sorted(got):
            missing, unexpected = sorted(set(want) - set(got)), sorted(set(got) - set(want))
            raise ValueError(f"checkpoint params do not match model config '{cfg.name}' at "
                             f"{path}: missing {missing[:3]}, unexpected {unexpected[:3]}")
        for k, shape in want.items():
            if got[k] != shape:
                raise ValueError(f"checkpoint param {k} has shape {got[k]}, model config "
                                 f"'{cfg.name}' expects {shape} (at {path})")
    return params


def load_ema_params(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """The saved EMA ({parameter name: tensor}) or None when the run kept
    none.  It covers parameters only: buffers (DAT's BatchNorm running
    statistics) come from "params", as the live statistics serve the
    EMA weights in training."""
    return read_checkpoint(path).get("ema")
