"""The port stands alone: it imports no JAX and nothing of the JAX
package, and on CPU tensors no kernel is launched."""

import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import tpu_superresolution_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_superresolution_tpu"))
print(len(names), bad)
assert not bad, bad
for name in ("cli.train", "kernels.fused_ocab", "models.hat", "train.engine", "models.dat",
             "kernels.fused_rect_attn", "kernels.fused_channel_attn", "kernels.fused_datb_tail",
             "kernels.fused_attention", "kernels.cab_conv", "kernels.dwconv",
             "kernels.window_attention", "ops.resize", "evaluate.baseline", "cli.evaluate",
             "utils.trace", "utils.logging", "utils.flops", "utils.ablate", "utils.profiling",
             "cli.compare", "cli.mat_eval", "cli.export_torch", "interop.export",
             "kernels.custom_ops"):
    assert "tpu_superresolution_torch." + name in names, name
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


def test_cpu_forward_launches_no_kernel():
    """Neither a CPU forward nor a CPU train step (backward included)
    launches a kernel: the wrappers take the plain versions there."""
    from tpu_superresolution_torch.core.config import SwinIRConfig, TrainConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.train.engine import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    model = build_model(SwinIRConfig(embed_dim=24, depths=(2,), num_heads=(2,)))
    reset_counters()
    with torch.no_grad():
        y = model(torch.rand(1, 16, 16, 3))
    assert y.shape == (1, 64, 64, 3)
    none = {"K1": 0, "K1t": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K5r": 0, "K5w16": 0, "K6": 0,
            "K6b": 0, "K7": 0, "K8": 0, "K8b": 0, "K8w16": 0, "K8bw16": 0, "K9": 0, "K10": 0,
            "K11": 0, "K12": 0, "K14": 0, "K15": 0, "K16": 0}
    assert read_counters() == none
    opt, sched = build_optimizer(TrainConfig(loss="l1"), 1, model)
    state = create_train_state(model, opt, sched)
    step = make_train_step("l1", "native_lr", 4, 8, True)
    m = step(state, torch.rand(2, 16, 16, 3), torch.rand(2, 64, 64, 3),
             torch.Generator().manual_seed(0))
    assert bool(m["finite"]) and state.step == 1
    assert read_counters() == none


def test_cpu_hat_train_step_launches_no_kernel():
    """A CPU HAT train step (stochastic depth, the OCAB's training route,
    the blocks' backward) runs the plain versions only."""
    from tpu_superresolution_torch.core.config import HATConfig, TrainConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.train.engine import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    model = build_model(HATConfig(embed_dim=24, depths=(2,), num_heads=(2,), squeeze_factor=6,
                                  drop_path_rate=0.5))
    opt, sched = build_optimizer(TrainConfig(loss="l1"), 1, model)
    state = create_train_state(model, opt, sched)
    reset_counters()
    m = make_train_step("l1", "native_lr", 4, 7, True)(
        state, torch.rand(2, 14, 14, 3), torch.rand(2, 56, 56, 3), torch.Generator().manual_seed(0))
    assert bool(m["finite"]) and state.step == 1
    assert not any(read_counters().values())


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor on neither the CPU nor CUDA gets neither version."""
    from tpu_superresolution_torch.kernels.cab_conv import conv3x3
    from tpu_superresolution_torch.kernels.layernorm import layernorm

    x = torch.empty(1, 8, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        layernorm(x, torch.ones(16, device="meta"), torch.zeros(16, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        conv3x3(x, torch.empty(3, 3, 16, 16, device="meta"), torch.empty(16, device="meta"))


def test_window_attention_and_cab_wrappers_refuse_devices_without_a_kernel():
    """K7's and K12's wrappers likewise: a meta tensor gets neither the
    kernel nor the plain version."""
    from tpu_superresolution_torch.kernels.cab_conv import fused_ln_cab_convs
    from tpu_superresolution_torch.kernels.fused_attention import fused_window_attention

    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_window_attention(m(4, 36, 16), m(48, 16), m(48), m(16, 16), m(16), m(2, 36, 36),
                               None)
    with pytest.raises(ValueError, match="no kernel"):
        fused_ln_cab_convs(m(1, 8, 8, 16), m(16), m(16), m(3, 3, 16, 5), m(5), m(3, 3, 5, 16),
                           m(16))


def test_kernel_build_is_lazy():
    """Importing the kernels builds nothing; the library is keyed by a
    hash of the sources."""
    from tpu_superresolution_torch.kernels import _lib

    assert _lib.library.cache_info().currsize == 0
    name = _lib.library_path().name
    assert name.startswith("libsr_kernels_") and _lib.source_hash() in name
