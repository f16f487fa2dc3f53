"""The port's ``interop/export.py`` (``torch.export`` programs), the
main path's kernels as ``tpu_sr::`` custom ops (``kernels/custom_ops.py``)
and ``utils/ablate.py`` / ``utils/profiling.py``, on the CPU:

- ``export_parity`` of a narrow SwinIR (plain path): max abs <= 1e-5,
  the bound of the JAX package's ``tests/test_interop_export.py``
  (here it is 0: the program runs the same ops);
- a ``.pt2`` file round trip, and a program holding the K2 / K3 / K4
  ops (their CPU bodies are the plain versions) saved and loaded back;
- each op's ``register_fake`` gives the shape and dtype of the plain
  version's output; the wrappers call the ops only while exporting;
- the A/B harness and the profiling helpers."""

import io
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _swinir(**kw):
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model

    model = build_model(SwinIRConfig(embed_dim=24, depths=(2,), num_heads=(2,), **kw))
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("kw,shape", [(dict(), (1, 16, 16, 3)),
                                      (dict(fused_reconstruct=False, scale=2), (2, 12, 20, 3))],
                         ids=["x4-composed", "x2-chain-padded"])
def test_export_parity_plain_path(kw, shape):
    from tpu_superresolution_torch.interop.export import export_parity

    max_abs, mean_abs = export_parity(_swinir(**kw), shape, seed=1)
    assert max_abs <= 1e-5 and mean_abs <= max_abs


def test_pt2_file_round_trip(tmp_path):
    from tpu_superresolution_torch.interop.export import export_model, load_exported

    model = _swinir()
    path = tmp_path / "m.pt2"
    blob = export_model(model, (1, 16, 16, 3), path=str(path))
    assert path.read_bytes() == blob
    x = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x)
    assert torch.equal(load_exported(str(path))(x), want)
    assert torch.equal(load_exported(blob)(x), want)
    with torch.no_grad():  # the export left the eager model's caches real
        assert torch.equal(model(x), want)


def _conv_inputs(kh=3, kw=3, cin=5, cout=7):
    g = torch.Generator().manual_seed(3)
    return (torch.randn(2, 6, 9, cin, generator=g), torch.randn(kh, kw, cin, cout, generator=g),
            torch.randn(cout, generator=g))


def test_ops_run_the_plain_versions_on_cpu_and_export():
    from tpu_superresolution_torch.kernels.cab_conv import conv_plain
    from tpu_superresolution_torch.kernels.layernorm import layernorm_plain

    x, k3, b3 = _conv_inputs()
    _, k5, b5 = _conv_inputs(5, 5, 5, 4)
    g, b = torch.rand(7) + 0.5, torch.rand(7)

    class Net(torch.nn.Module):
        def forward(self, x):
            y = torch.ops.tpu_sr.conv3x3_halo(x, k3, b3, None, True)
            y = torch.ops.tpu_sr.layernorm(y, g, b, 1e-5)
            return torch.ops.tpu_sr.conv_halo(y[..., :5], k5, b5, None, [2, 2, 1, 3])

    want = conv_plain(layernorm_plain(conv_plain(x, k3, b3, ((1, 1), (1, 1)), True), g, b)[
        ..., :5], k5, b5, ((2, 2), (1, 3)))
    assert torch.equal(Net()(x), want)
    program = torch.export.export(Net(), (x,), strict=False)
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"tpu_sr.conv3x3_halo.default", "tpu_sr.layernorm.default",
            "tpu_sr.conv_halo.default"} <= ops
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    assert torch.equal(torch.export.load(buf).module()(x), want)


def _fake(t):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    return mode, [mode.from_tensor(a) if torch.is_tensor(a) else a for a in t]


@pytest.mark.parametrize("op", ["layernorm", "conv3x3_halo", "conv_halo", "swin_block"])
def test_register_fake_matches_the_plain_output(op):
    from tpu_superresolution_torch.kernels import custom_ops
    from tpu_superresolution_torch.kernels.cab_conv import conv_plain
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles, swin_block_plain
    from tpu_superresolution_torch.kernels.layernorm import layernorm_plain
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    x, k, bias = _conv_inputs()
    if op == "layernorm":
        args = (x.bfloat16(), torch.ones(5), torch.zeros(5), 1e-5)
        want = layernorm_plain(*args)
    elif op == "conv3x3_halo":
        args = (x.bfloat16(), k.bfloat16(), bias, None, False)
        want = conv_plain(x.bfloat16(), k.bfloat16(), bias, ((1, 1), (1, 1)))
    elif op == "conv_halo":
        x, k, bias = _conv_inputs(5, 5, 5, 48)
        args = (x.bfloat16(), k.bfloat16(), bias, None, [2, 2, 2, 2])
        want = conv_plain(x.bfloat16(), k.bfloat16(), bias, ((2, 2), (2, 2)))
    else:
        block = _swinir().layers[0].residual_group.blocks[1]
        w = block.block_weights()
        xb = torch.rand(2, 16, 16, 24).bfloat16()
        with torch.no_grad():
            want = swin_block_plain(xb, w, 8, 4, shift_mask_tensor(16, 16, 8, 4, "cpu"), False)
        p = pack_block_tiles(w)
        args = (xb, p.tiles, p.bqkv, p.bproj, p.bfc1, p.bfc2, p.g1, p.b1, p.g2, p.b2, p.table,
                p.num_heads, p.hidden, 8, 4, True, False)
    fn = getattr(custom_ops, {"layernorm": "layernorm_op", "conv3x3_halo": "conv3x3_op",
                              "conv_halo": "conv_k_op", "swin_block": "swin_block_op"}[op])
    mode, fargs = _fake(args)
    with mode:
        got = fn(*fargs)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype
    assert got.is_contiguous()


def test_wrappers_call_the_ops_only_while_exporting(monkeypatch):
    """On a tensor off the CPU (here the meta device, whose kernels are
    the ops' fake functions) the wrappers call the custom ops while an
    export traces, and otherwise take the launch path, which refuses a
    device other than CUDA."""
    from tpu_superresolution_torch.kernels import _lib, cab_conv, fused_block, layernorm
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles

    meta = lambda t: t.to("meta")
    x = meta(torch.zeros(2, 16, 16, 24, dtype=torch.bfloat16))
    k = meta(torch.zeros(3, 3, 24, 24, dtype=torch.bfloat16))
    b = meta(torch.zeros(24))
    blk = _swinir().layers[0].residual_group.blocks[0]
    w = blk.block_weights()
    packed = pack_block_tiles(w)
    calls = {
        "layernorm": lambda: layernorm.layernorm(x, meta(torch.ones(24)), b),
        "conv3x3": lambda: cab_conv.conv3x3(x, k, b),
        "conv_k": lambda: cab_conv.conv_k(x, k, b, ((1, 1), (1, 1))),
        "block": lambda: fused_block.fused_windows_block(
            x, w, 8, 0, None, False,
            packed=type(packed)(**{f: meta(getattr(packed, f)) if torch.is_tensor(
                getattr(packed, f)) else getattr(packed, f) for f in packed.__dataclass_fields__})),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="no kernel or plain version"):
            call()
    monkeypatch.setattr(_lib, "exporting", lambda: True)
    for name, call in calls.items():
        y = call()
        assert y.device.type == "meta" and tuple(y.shape) == (2, 16, 16, 24), name
    with pytest.raises(NotImplementedError, match="K6"):
        fused_block.fused_windows_block(x, w, 7, 0, None, False)


def test_ablate_interleaves_and_reports():
    from tpu_superresolution_torch.utils.ablate import AblateResult, ablate, report

    order = []
    results = ablate({"a": lambda: order.append("a"), "b": lambda: order.append("b")},
                     inner=3, rounds=4, warmup=1, cuda=False)
    assert order == ["a", "b"] + (["a"] * 3 + ["b"] * 3) * 4
    assert [len(r.times_s) for r in results.values()] == [4, 4]
    r = AblateResult([2.0, 1.0, 4.0])
    assert (r.min_s, r.median_s, r.spread) == (1.0, 2.0, 3.0)
    lines = report({"slow": AblateResult([2e-3]), "fast": AblateResult([1e-3])}).splitlines()
    assert lines[1].split()[0] == "fast" and lines[2].split()[3] == "2.00"


def test_profiling_helpers(tmp_path):
    from tpu_superresolution_torch.utils.profiling import (
        DeviceSplit,
        StepTimer,
        device_memory_stats,
        trace_context,
    )

    with trace_context(None):
        pass
    with trace_context(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert len(list((tmp_path / "prof").glob("trace_*.json"))) == 1
    t = StepTimer()
    t.batch_loaded()
    t.step_done()
    assert t.n == 1 and t.mean_step_t >= 0.0
    assert device_memory_stats() == []  # no GPU here

    def ev(name, start, ms):
        return types.SimpleNamespace(name=name, device_time=ms * 1e3,
                                     time_range=types.SimpleNamespace(start=start, end=start + 1))

    split = DeviceSplit(wall_ms=10.0, events=[], kernels=[
        ev("conv_nhwc_kernel", 0, 1.0), ev("layernorm_bands", 5, 0.5),
        ev("gemm", 20, 2.0), ev("gemm", 40, 0.25)])
    assert split.busy_ms == 3.75
    assert split.by_name()["gemm"] == (2, 2.25)
    groups = split.group((("K3/K4", ("conv_nhwc",)), ("K2", ("layernorm",))), "other",
                         spans=[(15, 30, "fwd")], by_span=(("fwd", "forward ops"),))
    assert groups == {"K3/K4": 1.0, "K2": 0.5, "forward ops": 2.0, "other": 0.25}
    assert np.isclose(sum(groups.values()), split.busy_ms)
