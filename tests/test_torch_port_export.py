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
    fake = lambda a: mode.from_tensor(a) if torch.is_tensor(a) else a
    return mode, [[fake(b) for b in a] if isinstance(a, list) else fake(a) for a in t]


def _small(kind):
    """Small CPU models whose blocks give the ops' operands: SwinIR at ws
    8, 7 and 16 (the K7 route), HAT at ws 16 (its OCAB on K8w16's
    operands, its CAB on K12's), DAT at split (8, 8) (K9, K14, K10)."""
    from tpu_superresolution_torch.core.config import (
        DATConfig,
        HATConfig,
        SwinIRConfig,
        build_model,
    )

    cfgs = {"swinir": SwinIRConfig(embed_dim=24, depths=(2,), num_heads=(2,)),
            "swinir7": SwinIRConfig(embed_dim=24, depths=(2,), num_heads=(2,), window_size=7),
            "swinir16": SwinIRConfig(embed_dim=24, depths=(2,), num_heads=(2,), window_size=16),
            "hat16": HATConfig(embed_dim=24, depths=(2,), num_heads=(2,), squeeze_factor=6,
                               window_size=16),
            "dat": DATConfig(embed_dim=32, depths=(2,), num_heads=(2,), split_size=(8, 8),
                             num_feat=16)}
    model = build_model(cfgs[kind])
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.eval()


def _fake_case(op):
    """(the op, its arguments, the plain version's output) at a small
    shape for each op."""
    from tpu_superresolution_torch.kernels import cab_conv, custom_ops, dwconv, fused_attention
    from tpu_superresolution_torch.kernels import fused_block as fb
    from tpu_superresolution_torch.kernels import fused_channel_attn as fc
    from tpu_superresolution_torch.kernels import fused_datb_tail as ft
    from tpu_superresolution_torch.kernels import fused_ocab as fo
    from tpu_superresolution_torch.kernels import fused_rect_attn as fr
    from tpu_superresolution_torch.kernels import window_attention as wa
    from tpu_superresolution_torch.kernels.layernorm import layernorm_plain
    from tpu_superresolution_torch.ops.window import (
        overlap_windows,
        relative_position_bias,
        shift_mask_tensor,
        window_partition,
        window_reverse,
    )

    g = torch.Generator().manual_seed(4)
    rand = lambda *shape: torch.rand(*shape, generator=g)
    x, k, bias = _conv_inputs()
    if op == "layernorm":
        args = (x.bfloat16(), torch.ones(5), torch.zeros(5), 1e-5)
        return custom_ops.layernorm_op, args, layernorm_plain(*args)
    if op == "conv3x3_halo":
        args = (x.bfloat16(), k.bfloat16(), bias, None, False)
        want = cab_conv.conv_plain(x.bfloat16(), k.bfloat16(), bias, ((1, 1), (1, 1)))
        return custom_ops.conv3x3_op, args, want
    if op == "conv_halo":
        x, k, bias = _conv_inputs(5, 5, 5, 48)
        args = (x.bfloat16(), k.bfloat16(), bias, None, [2, 2, 2, 2])
        want = cab_conv.conv_plain(x.bfloat16(), k.bfloat16(), bias, ((2, 2), (2, 2)))
        return custom_ops.conv_k_op, args, want
    if op in ("swin_block", "swin_block_ws7_extra"):
        ws, hw, extra = (8, 16, None) if op == "swin_block" else (7, 14, rand(2, 14, 14, 24))
        block = _small("swinir" if ws == 8 else "swinir7").layers[0].residual_group.blocks[1]
        w = block.block_weights()
        xb = rand(2, hw, hw, 24).bfloat16()
        extra = None if extra is None else extra.bfloat16()
        with torch.no_grad():
            want = fb.swin_block_plain(xb, w, ws, ws // 2,
                                       shift_mask_tensor(hw, hw, ws, ws // 2, "cpu"), False,
                                       None, extra)
        p = fb.pack_block_tiles(w)
        args = (xb, p.tiles, p.bqkv, p.bproj, p.bfc1, p.bfc2, p.g1, p.b1, p.g2, p.b2, p.table,
                p.num_heads, p.hidden, ws, ws // 2, True, False, extra)
        return custom_ops.swin_block_op, args, want
    block = _small("swinir16").layers[0].residual_group.blocks[1]
    w = block.block_weights()
    if op.startswith("swin_block_tail"):
        route = op.rsplit("_", 1)[1]
        xb, extra = rand(1, 32, 32, 24).bfloat16(), rand(1, 32, 32, 24).bfloat16()
        attn = rand(4, 256, 24).bfloat16()
        with torch.no_grad():
            want = fb.swin_block_tail_plain(xb, attn, w, 16, 8, False, extra=extra)
            p = fb.pack_block_tail(w.g2, w.b2, w.wfc1, w.bfc1, w.wfc2, w.bfc2, route=route)
        packs = [p.tiles, p.vec] if route == "wgmma" else [p.wfc1, p.bfc1, p.wfc2, p.bfc2, p.g2,
                                                            p.b2]
        args = (xb, attn, extra, packs, route, p.hidden, 16, 8, False)
        return custom_ops.swin_block_tail_op, args, want
    if op == "window_block_attention":
        xw = rand(4, 256, 24).bfloat16()
        mask = shift_mask_tensor(32, 32, 16, 8, "cpu")
        rpb = relative_position_bias(w.table, 16)
        with torch.no_grad():
            want = fused_attention.window_attention_plain(xw, w.wqkv, w.bqkv, w.wproj, w.bproj,
                                                          rpb, mask, 12 ** -0.5)
            p = fused_attention.pack_window_attention(w.wqkv, w.bqkv, w.wproj, w.bproj, rpb)
        args = (xw, p.qkv.wp, p.qkv.b, p.proj.wp, p.proj.b, p.rpb, None, mask, None, 0, 2)
        return custom_ops.window_block_attention_op, args, want
    if op.startswith("window_attention"):
        nq, nk, counter = (49, 100, "K15") if op.endswith("k15") else (64, 64, "K16")
        q, kk, v = rand(8, 2, nq, 12).bfloat16(), rand(8, 2, nk, 12), rand(8, 2, nk, 12)
        kk, v = kk.bfloat16(), v.bfloat16()
        b = rand(2, nq, nk)
        mask = None if counter == "K15" else rand(4, nq, nk)
        args = (q, kk, v, b, mask, 0.25, counter == "K16", counter)
        return custom_ops.window_attention_op, args, wa.fused_window_attention_plain(
            q, kk, v, b, mask, 0.25)
    if op == "dwconv3x3":
        xb, taps, b = rand(2, 6, 9, 5).bfloat16(), rand(3, 3, 5), rand(5)
        return custom_ops.dwconv3x3_op, (xb, taps, b), dwconv.dwconv3x3_plain(xb, taps, b)
    if op in ("ln_cab_convs", "ocab16"):
        hat = _small("hat16")
        group = hat.layers[0].residual_group
        xb = rand(1, 32, 32, 24).bfloat16()
        if op == "ln_cab_convs":
            blk = group.blocks[0]
            conv1, conv2 = blk.conv_block.cab[0], blk.conv_block.cab[2]
            hwio = lambda t: t.detach().permute(2, 3, 1, 0).bfloat16().contiguous()
            cw = (blk.norm1.weight.detach(), blk.norm1.bias.detach(), hwio(conv1.weight),
                  conv1.bias.detach(), hwio(conv2.weight), conv2.bias.detach())
            p = cab_conv.pack_cab(*cw)
            args = (xb, p.w1, p.c1, p.w2, p.c2, p.g, p.b, p.mid)
            return custom_ops.ln_cab_convs_op, args, cab_conv.fused_ln_cab_convs_plain(xb, *cw)
        oc = group.overlap_attn
        with torch.no_grad():
            qkv = oc.qkv_map(xb, True, True)
            want = oc.fused_core(xb, qkv, True)
            ow = fo.OcabWeights(wproj=oc.proj.weight, bproj=oc.proj.bias, g2=oc.norm2.weight,
                                b2=oc.norm2.bias, wfc1=oc.mlp.fc1.weight, bfc1=oc.mlp.fc1.bias,
                                wfc2=oc.mlp.fc2.weight, bfc2=oc.mlp.fc2.bias, num_heads=2)
            p = fo.pack_ocab_tiles(ow)
            args = (qkv, xb, p.tiles, p.bproj, p.bfc1, p.bfc2, p.g2, p.b2, oc.bias_oca(), 2,
                    p.hidden, False)
        return custom_ops.ocab16_op, args, want
    dat = _small("dat")
    spatial, channel = dat.layers[0].blocks[0], dat.layers[0].blocks[1]
    xb = rand(2, 16, 24, 32).bfloat16()
    with torch.no_grad():
        if op == "rect_attention":
            fw = spatial.attn.front_weights(spatial.norm1)
            p = fr.pack_rect_weights(fw)
            args = (xb, p.wp, p.bqkv, p.tables, p.g1, p.b1, p.wdw, p.bdw, p.num_heads,
                    list(p.split), True)
            return custom_ops.rect_attention_op, args, fr.rect_attention_plain(xb, fw, True)
        if op == "channel_attention":
            fw = channel.attn.front_weights(channel.norm1)
            p = fc.pack_chan_weights(fw)
            args = (xb, p.wp, p.bqkv, p.temperature, p.g1, p.b1, p.wdw, p.bdw, p.num_heads)
            return custom_ops.channel_attention_op, args, fc.channel_attention_plain(xb, fw)
        tw = spatial.tail_weights()
        p = ft.pack_tail_weights(tw)
        u, w_px, gate = rand(2, 16, 24, 32).bfloat16(), rand(2, 16, 24, 32).bfloat16(), rand(2, 32)
        args = (xb, u, w_px, gate, p.tiles, p.vec, p.half)
        return custom_ops.datb_tail_op, args, ft.datb_tail_plain(xb, u, w_px, gate, tw)


FAKE_OPS = ["layernorm", "conv3x3_halo", "conv_halo", "swin_block", "swin_block_ws7_extra",
            "swin_block_tail_wgmma", "swin_block_tail_wmma", "window_block_attention",
            "window_attention_k15", "window_attention_k16", "ln_cab_convs", "ocab16",
            "rect_attention", "channel_attention", "datb_tail", "dwconv3x3"]


@pytest.mark.parametrize("op", FAKE_OPS)
def test_register_fake_matches_the_plain_output(op):
    """Each op's fake output (tuple or tensor) has the plain version's
    shape and dtype and is contiguous."""
    fn, args, want = _fake_case(op)
    mode, fargs = _fake(args)
    with mode:
        got = fn(*fargs)
    wants = want if isinstance(want, tuple) else (want,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(gots) == len(wants)
    for a, b in zip(gots, wants):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype, op
        assert a.is_contiguous(), op


def _meta(obj):
    """A tensor, or a (nested) dataclass of tensors, on the meta device."""
    import dataclasses

    if torch.is_tensor(obj):
        return obj.to("meta")
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _meta(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def test_wrappers_call_the_ops_only_while_exporting(monkeypatch):
    """On a tensor off the CPU (here the meta device, whose kernels are
    the ops' fake functions) every kernel wrapper of an inference forward
    calls its custom op while an export traces, and otherwise takes the
    launch path, which refuses a device other than CUDA."""
    from tpu_superresolution_torch.kernels import (
        _lib,
        cab_conv,
        dwconv,
        fused_attention,
        fused_block,
        fused_channel_attn,
        fused_datb_tail,
        fused_ocab,
        fused_rect_attn,
        layernorm,
        window_attention,
    )
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles

    meta = lambda t: t.to("meta")
    x = meta(torch.zeros(2, 16, 16, 24, dtype=torch.bfloat16))
    k = meta(torch.zeros(3, 3, 24, 24, dtype=torch.bfloat16))
    b = meta(torch.zeros(24))
    blk = _swinir().layers[0].residual_group.blocks[0]
    w = blk.block_weights()
    packed = pack_block_tiles(w)
    w16 = _small("swinir16").layers[0].residual_group.blocks[0].block_weights()
    x32 = meta(torch.zeros(1, 32, 32, 24, dtype=torch.bfloat16))
    xw = meta(torch.zeros(4, 256, 24, dtype=torch.bfloat16))
    pa = fused_attention.pack_window_attention(w16.wqkv, w16.bqkv, w16.wproj, w16.bproj,
                                               table=w16.table, ws=16)
    pt = fused_block.pack_block_tail(w16.g2, w16.b2, w16.wfc1, w16.bfc1, w16.wfc2, w16.bfc2)
    q = meta(torch.zeros(8, 2, 64, 12, dtype=torch.bfloat16))
    abias = meta(torch.zeros(2, 64, 64))
    hat = _small("hat16").layers[0].residual_group
    cab = hat.blocks[0].conv_block.cab
    hwio = lambda t: t.detach().permute(2, 3, 1, 0).bfloat16().contiguous()
    cw = (hat.blocks[0].norm1.weight.detach(), hat.blocks[0].norm1.bias.detach(),
          hwio(cab[0].weight), cab[0].bias.detach(), hwio(cab[2].weight), cab[2].bias.detach())
    oc = hat.overlap_attn
    ow = fused_ocab.OcabWeights(wproj=oc.proj.weight, bproj=oc.proj.bias, g2=oc.norm2.weight,
                                b2=oc.norm2.bias, wfc1=oc.mlp.fc1.weight, bfc1=oc.mlp.fc1.bias,
                                wfc2=oc.mlp.fc2.weight, bfc2=oc.mlp.fc2.bias, num_heads=2)
    dat = _small("dat").layers[0].blocks
    with torch.no_grad():
        rw = dat[0].attn.front_weights(dat[0].norm1)
        chw = dat[1].attn.front_weights(dat[1].norm1)
        tw = dat[0].tail_weights()
    xd = meta(torch.zeros(2, 16, 24, 32, dtype=torch.bfloat16))
    calls = {
        "layernorm": (lambda: layernorm.layernorm(x, meta(torch.ones(24)), b), x.shape),
        "conv3x3": (lambda: cab_conv.conv3x3(x, k, b), x.shape),
        "conv_k": (lambda: cab_conv.conv_k(x, k, b, ((1, 1), (1, 1))), x.shape),
        "block": (lambda: fused_block.fused_windows_block(x, w, 8, 0, None, False,
                                                          packed=_meta(packed)), x.shape),
        "tail": (lambda: fused_block.fused_block_tail(x32, xw, w16, 16, 8, False, extra=x32,
                                                      packed=_meta(pt)), x32.shape),
        "k7": (lambda: fused_attention.fused_window_attention(
            xw, w16.wqkv, w16.bqkv, w16.wproj, w16.bproj, None, None, packed=_meta(pa),
            codes=meta(torch.zeros(1, 256, dtype=torch.int32))), xw.shape),
        "k15": (lambda: window_attention.fused_window_attention(q, q, q, abias), q.shape),
        "k16": (lambda: window_attention.batched_window_attention(
            q, q, q, abias, meta(torch.zeros(4, 64, 64))), q.shape),
        "k12": (lambda: cab_conv.fused_ln_cab_convs(x32, *cw, packed=_meta(cab_conv.pack_cab(
            *cw))), x32.shape),
        "k8w16": (lambda: fused_ocab.fused_ocab_core_map(
            meta(torch.zeros(1, 32, 32, 72, dtype=torch.bfloat16)), x32, ow,
            meta(oc.bias_oca().detach()), False, _meta(fused_ocab.pack_ocab_tiles(ow))),
            x32.shape),
        "k9": (lambda: fused_rect_attn.rect_attention(
            xd, rw, True, _meta(fused_rect_attn.pack_rect_weights(rw)))[1], xd.shape),
        "k14": (lambda: fused_channel_attn.channel_attention(
            xd, chw, _meta(fused_channel_attn.pack_chan_weights(chw)))[0], xd.shape),
        "k10": (lambda: fused_datb_tail.datb_tail(
            xd, xd, xd, meta(torch.zeros(2, 32)), tw,
            _meta(fused_datb_tail.pack_tail_weights(tw))), xd.shape),
        "k11": (lambda: dwconv.dwconv3x3(x, meta(torch.zeros(3, 3, 24)), b), x.shape),
    }
    for name, (call, _) in calls.items():
        with pytest.raises(ValueError, match="no kernel or plain version"):
            call()
    monkeypatch.setattr(_lib, "exporting", lambda: True)
    for name, (call, shape) in calls.items():
        y = call()
        assert y.device.type == "meta" and tuple(y.shape) == tuple(shape), name
    # K6 with HAT's `extra` traces; branch scales (training only) do not
    w7 = _small("swinir7").layers[0].residual_group.blocks[1].block_weights()
    x7 = meta(torch.zeros(2, 14, 14, 24, dtype=torch.bfloat16))
    y = fused_block.fused_windows_block(x7, w7, 7, 3, meta(torch.zeros(4, 49, 49)), False,
                                        extra=x7, packed=_meta(pack_block_tiles(w7)))
    assert y.device.type == "meta" and tuple(y.shape) == (2, 14, 14, 24)
    with pytest.raises(NotImplementedError, match="branch scales"):
        fused_block.fused_windows_block(x7, w7, 7, 0, None, False,
                                        branch_scales=meta(torch.ones(2, 2)))


# the training-only kernels: no eval forward launches them, and they get no op
TRAINING_ONLY = {"K5", "K5r", "K5w16", "K6b", "K8", "K8b", "K8bw16"}


def test_exportable_is_every_inference_kernel():
    from tpu_superresolution_torch.kernels import COUNTERS
    from tpu_superresolution_torch.kernels.custom_ops import EXPORTABLE

    assert set(EXPORTABLE) == set(COUNTERS) - TRAINING_ONLY
    assert len(EXPORTABLE) == len(set(EXPORTABLE)) == 15


def _program_launches(program):
    """The kernel launches an exported program's ``tpu_sr`` nodes stand
    for, by counter key (``swin_block`` by its window, ``window_attention``
    by its counter argument)."""
    names = {"layernorm": "K2", "conv3x3_halo": "K3", "conv_halo": "K4",
             "swin_block_tail": "K1t", "window_block_attention": "K7", "ln_cab_convs": "K12",
             "ocab16": "K8w16", "rect_attention": "K9", "channel_attention": "K14",
             "datb_tail": "K10", "dwconv3x3": "K11"}
    counts = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if node.op != "call_function" or not target.startswith("tpu_sr."):
            continue
        op = target.split(".")[1]
        if op == "swin_block":
            key = {8: "K1", 7: "K6"}[node.args[13]]
        elif op == "window_attention":
            key = node.args[7]
        else:
            key = names[op]
        counts[key] = counts.get(key, 0) + 1
    return counts


def _meta_cases():
    from tpu_superresolution_torch.core.config import DATConfig, HATConfig, SwinIRConfig

    hat = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), squeeze_factor=6)
    return {
        # per HAB: K6 and K12; per OCAB: K15 and two K2; patch_norm, norm;
        # K3 per RHAG conv, conv_after_body, conv_before_upsample; K4 the
        # composed reconstruction
        "hat-ws7": (HATConfig(**hat), (1, 20, 20, 3),
                    dict(K6=4, K12=4, K15=2, K2=6, K3=4, K4=1)),
        # ws 16: each HAB K2 + K7 + K1t and K12; each OCAB its LN1 and K8w16
        "hat-ws16": (HATConfig(window_size=16, **hat), (1, 32, 32, 3),
                     dict(K1t=4, K7=4, K12=4, K8w16=2, K2=8, K3=4, K4=1)),
        # split (8, 8) within K9 / K14 / K10: a spatial and a channel block
        # a group
        "dat-kernels": (DATConfig(embed_dim=32, depths=(2, 2), num_heads=(2, 2),
                                  split_size=(8, 8), num_feat=16), (1, 16, 24, 3),
                        dict(K9=2, K14=2, K10=4, K2=2, K3=4, K4=1)),
        # C 240 past rect_ok's, chan_ok's and tail_ok's widths: the module
        # chain, K2 for LN1, LN2 and the gate's norm, K11 for the conv
        # branch and the gate's conv, K16 for each rect branch
        "dat-chain": (DATConfig(embed_dim=240, depths=(2,), num_heads=(6,), num_feat=16),
                      (1, 16, 32, 3), dict(K2=8, K11=4, K16=2, K3=3, K4=1)),
        # C 264 past K12's widths: each CAB on K2 + K3 (GELU epilogue) + K3
        # (cab_route "convs"), each HAB on the K7 route with the WMMA tail
        # (chip_smoke.py's WIDE_HAT_PER_CALL)
        "hat-cab-split": (HATConfig(embed_dim=264, depths=(2,), num_heads=(6,), conv_scale=0.3),
                          (1, 14, 14, 3), dict(K7=2, K1t=2, K2=8, K3=7, K4=1, K15=1)),
        # SwinIR-L's widths (C 240 past the block kernel's): K2 + K7 + K1t
        "swinir-l-widths": (SwinIRConfig(embed_dim=240, depths=(2,), num_heads=(8,)),
                            (1, 16, 16, 3), dict(K7=2, K1t=2, K2=4, K3=3, K4=1)),
    }


@pytest.mark.parametrize("case", ["hat-ws7", "hat-ws16", "dat-kernels", "dat-chain",
                                  "hat-cab-split", "swinir-l-widths"])
def test_meta_export_holds_one_op_node_a_launch(case, monkeypatch):
    """A model exported on the meta device (its kernels' ops traced by
    their fake functions): one ``tpu_sr`` node for each launch that the
    card's eager path counts at that configuration (chip_smoke.py's
    per-call tables at test depth).  An eager pass with the ops called
    first fills the shape-keyed caches with meta tensors, as
    ``export_model``'s warm-up does on the card."""
    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.kernels import _lib

    cfg, shape, want = _meta_cases()[case]
    with torch.device("meta"):
        model = build_model(cfg).eval()
    x = torch.empty(shape, device="meta")
    with monkeypatch.context() as m:
        m.setattr(_lib, "exporting", lambda: True)
        with torch.no_grad():
            model(x)
    with torch.no_grad():  # as export_model traces
        program = torch.export.export(model, (x,), strict=False)
    assert _program_launches(program) == want


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
