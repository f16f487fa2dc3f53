"""A train step must invalidate what ``models.blocks.DerivedCache`` built
from the weights before it.  The cache keys on the parameters' and
buffers' version counters, and the fused AdamW (the one the port takes
on CUDA) writes the parameters without moving them, so
``train.engine.apply_gradients`` moves them itself.  Here, on the CPU
with AdamW fused and not: a no-grad forward (which fills the caches), a
train step, and the next no-grad forward bit-identical to that of a new
model loaded with the stepped state, for SwinIR (its convs' packed
weights) and DAT (BatchNorm folded into its fronts and tails)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _model(name):
    from tpu_superresolution_torch.core.config import DATConfig, SwinIRConfig, build_model

    cfg = {"swinir": SwinIRConfig(embed_dim=12, depths=(1,), num_heads=(2,), window_size=4,
                                  num_feat=8, drop_path_rate=0.0),
           "dat": DATConfig(embed_dim=60, depths=(2,), num_heads=(6,), drop_path_rate=0.0)}[name]
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return cfg, model


@pytest.mark.parametrize("fused", [False, True], ids=["foreach", "fused"])
@pytest.mark.parametrize("name", ["swinir", "dat"])
def test_forward_after_a_step_sees_the_step(name, fused):
    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.train.engine import TrainState, make_train_step

    cfg, model = _model(name)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((1, 16, 16, 3), np.float32))
    lr = rng.random((2, 8, 8, 3), np.float32)
    hr = rng.random((2, 32, 32, 3), np.float32)
    with torch.no_grad():
        before = model.eval()(x)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, fused=fused)
    state = TrainState(model=model, optimizer=opt, schedule=lambda step: 1e-2)
    versions = [p._version for p in model.parameters()]
    make_train_step("l1", "native_lr", 4, None, False)(state, lr, hr,
                                                       torch.Generator().manual_seed(0))
    assert all(p._version > v for p, v in zip(model.parameters(), versions))
    fresh = build_model(cfg)
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        after, want = model.eval()(x), fresh.eval()(x)
    assert not torch.equal(want, before)
    assert torch.equal(after, want)
