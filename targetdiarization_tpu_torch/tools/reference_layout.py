"""Seeded reference-layout inputs for checks of `runtime/port_rules.py` and
`runtime/onnx_io.py`; not an entry point.

`reference_state_dict(name, args, seed)` builds, for one of the eleven
architectures the rules read (`port_rules.RULES`) and its model arguments,
a dict of numpy arrays under the reference (look2hear) checkpoints' key
names and shapes: the keys the rules read, plus the deterministic buffers
they skip (MossFormer2's rotary `freqs` and `pos_enc.inv_freq`, Apollo's
`cos_freq` / `sin_freq`, TDANet's `pe`). The geometry is read from the
port class built on the meta device, so the dict matches the model of
those arguments. Values are drawn with numpy at the initializers' scales
(weights normal over sqrt(fan-in), norm scales near 1, PReLU slopes near
0.25, biases small), so a forward stays finite at any width.

`dnsmos_graph` and `sigmos_graph` build synthetic ONNX graphs in the
layout of the released DNSMOS (`sig_bak_ovr.onnx`, `model_v8.onnx`) and
SigMOS models, matching `train/mos.py::DNSMOSNet(n_out, ch)` and
`SigMOSNet(n_out, ch)`.
"""

from __future__ import annotations

import re

import numpy as np

_MM = "mask_net.mdl.intra_mdl.mossformerM"
_LSTM = re.compile(r"^(weight_ih|weight_hh|bias_ih|bias_hh)_l0(_reverse)?$")


def port_shapes(name: str, args: dict | None = None) -> dict:
    """The port model's state-dict shapes for `args` (built on the meta
    device: no memory, no values)."""
    import torch

    from ..runtime.registry import get_model_cls

    with torch.device("meta"):
        model = get_model_cls(name)(**(args or {}))
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


class _Spec:
    """Reference key -> (shape, kind), kind one of "w" (a weight), "b" (a
    bias), "s" (a norm scale), "a" (a PReLU slope), "o" (an offset scale's
    gamma) and "f" (a deterministic buffer)."""

    def __init__(self, shapes: dict):
        self.s, self.out = shapes, {}

    def put(self, key: str, shape, kind: str = "w") -> None:
        self.out[key] = (tuple(shape), kind)

    def same(self, key: str, port: str, kind: str = "w") -> None:
        self.put(key, self.s[port], kind)

    def conv1x1(self, stem: str, port: str, bias: bool = True, dims: int = 1) -> None:
        """A port Linear (O, I) read from a 1 x 1 Conv1d (dims 1) or Conv2d (2)."""
        self.put(f"{stem}.weight", self.s[f"{port}.weight"] + (1,) * dims)
        if bias:
            self.same(f"{stem}.bias", f"{port}.bias", "b")

    def linear(self, stem: str, port: str, bias: bool = True) -> None:
        self.same(f"{stem}.weight", f"{port}.weight")
        if bias:
            self.same(f"{stem}.bias", f"{port}.bias", "b")

    def depthwise(self, key: str, port: str, extra: tuple = ()) -> None:
        """The port's depthwise kernel (K, m, C) from a conv (C, m, K, ...)."""
        k, m, c = self.s[port]
        self.put(key, (c, m, k) + extra)

    def norm(self, stem: str, port: str, src=("weight", "bias")) -> None:
        self.same(f"{stem}.weight", f"{port}.{src[0]}", "s")
        self.same(f"{stem}.bias", f"{port}.{src[1]}", "b")

    def gln(self, stem: str, port: str, src=("gamma", "beta"), shape=lambda s: s) -> None:
        self.put(f"{stem}.gamma", shape(self.s[f"{port}.{src[0]}"]), "s")
        self.put(f"{stem}.beta", shape(self.s[f"{port}.{src[1]}"]), "b")

    def lstm(self, stem: str, port: str) -> None:
        for key, shape in self.s.items():
            if key.startswith(port + ".") and _LSTM.match(key[len(port) + 1:]):
                leaf = key[len(port) + 1:]
                self.put(f"{stem}.{leaf}", shape, "b" if leaf.startswith("bias") else "w")

    def convnorm(self, stem: str, port: str) -> None:
        """SuDoRM-RF / AFRCNN / TDANet ConvNorm(Act)."""
        self.same(f"{stem}.conv.weight", f"{port}.conv.weight")
        if f"{port}.conv.bias" in self.s:
            self.same(f"{stem}.conv.bias", f"{port}.conv.bias", "b")
        self.gln(f"{stem}.norm", f"{port}.norm")
        if f"{port}.act.alpha" in self.s:
            self.same(f"{stem}.act.weight", f"{port}.act.alpha", "a")

    def indices(self, pattern: str) -> list:
        return sorted({int(m.group(1)) for k in self.s if (m := re.match(pattern, k))})


def _ffconvm(p: _Spec, stem: str, port: str, scalenorm: bool) -> None:
    if scalenorm:
        p.same(f"{stem}.mdl.0.g", f"{port}.norm.g", "s")
    else:
        p.norm(f"{stem}.mdl.0", f"{port}.norm")
    p.linear(f"{stem}.mdl.1", f"{port}.proj")
    p.depthwise(f"{stem}.mdl.3.sequential.1.conv.weight", f"{port}.dwk")


def _mossformer2(p: _Spec) -> None:
    p.same("enc.conv1d.weight", "encoder.weight")
    p.same("dec.weight", "decoder.weight")
    p.norm("mask_net.norm", "mask_net.in_norm")
    p.conv1x1("mask_net.conv1d_encoder", "mask_net.bottleneck", bias=False)
    p.same("mask_net.pos_enc.scale", "mask_net.pos_scale", "s")
    p.put("mask_net.pos_enc.inv_freq", (p.s["mask_net.out_ln.weight"][0] // 2,), "f")
    p.norm("mask_net.mdl.intra_mdl.norm", "mask_net.out_ln")
    p.norm("mask_net.mdl.intra_norm", "mask_net.intra_norm")
    p.same("mask_net.prelu.weight", "mask_net.prelu", "a")
    p.conv1x1("mask_net.conv1d_out", "mask_net.spk_expand")
    p.conv1x1("mask_net.output.0", "mask_net.out_tanh")
    p.conv1x1("mask_net.output_gate.0", "mask_net.out_sig")
    p.conv1x1("mask_net.conv1_decoder", "mask_net.mask_proj", bias=False)
    for i in p.indices(r"mask_net\.layers\.(\d+)\."):
        src, port = f"{_MM}.layers.{i}", f"mask_net.layers.{i}.flash"
        p.put(f"{src}.rotary_pos_emb.freqs", (16,), "f")
        for ff in ("to_hidden", "to_qk", "to_out"):
            _ffconvm(p, f"{src}.{ff}", f"{port}.{ff}", scalenorm=True)
        p.same(f"{src}.qk_offset_scale.gamma", f"{port}.os_gamma", "o")
        p.same(f"{src}.qk_offset_scale.beta", f"{port}.os_beta", "b")
        src, port = f"{_MM}.fsmn.{i}", f"mask_net.layers.{i}.fsmn"
        p.conv1x1(f"{src}.conv1.0", f"{port}.conv1")
        p.same(f"{src}.conv1.1.weight", f"{port}.prelu", "a")
        p.conv1x1(f"{src}.conv2", f"{port}.conv2")
        p.norm(f"{src}.norm1", f"{port}.norm1")
        p.norm(f"{src}.norm2", f"{port}.norm2")
        for ff in ("to_u", "to_v"):
            _ffconvm(p, f"{src}.gated_fsmn.{ff}", f"{port}.{ff}", scalenorm=False)
        p.linear(f"{src}.gated_fsmn.fsmn.linear", f"{port}.fsmn.linear")
        p.linear(f"{src}.gated_fsmn.fsmn.project", f"{port}.fsmn.project", bias=False)
        ddn, dst = f"{port}.fsmn.ddn", f"{src}.gated_fsmn.fsmn.conv"
        for j in p.indices(rf"{re.escape(ddn)}\.conv_kernels\.(\d+)$"):
            p.depthwise(f"{dst}.conv{j + 1}.weight", f"{ddn}.conv_kernels.{j}", extra=(1,))
            p.same(f"{dst}.norm{j + 1}.weight", f"{ddn}.in_w.{j}", "s")
            p.same(f"{dst}.norm{j + 1}.bias", f"{ddn}.in_b.{j}", "b")
            p.same(f"{dst}.prelu{j + 1}.weight", f"{ddn}.prelu.{j}", "a")


def _apollo(p: _Spec) -> None:
    nu, _, d = p.s["uni_bn_w"]
    for i in range(nu):
        p.put(f"BN.{i}.0.weight", p.s["uni_norm_w"][1:], "s")
        p.put(f"BN.{i}.1.weight", (d, p.s["uni_bn_w"][1], 1))
        p.put(f"BN.{i}.1.bias", (d,), "b")
        p.put(f"output.{i}.0.weight", (d,), "s")
        p.put(f"output.{i}.1.weight", (p.s["uni_out_w"][2], d, 1))
        p.put(f"output.{i}.1.bias", p.s["uni_out_b"][1:], "b")
    p.same(f"BN.{nu}.0.weight", "tail_norm_w", "s")
    p.put(f"BN.{nu}.1.weight", (d, p.s["tail_bn_w"][0], 1))
    p.same(f"BN.{nu}.1.bias", "tail_bn_b", "b")
    p.put(f"output.{nu}.0.weight", (d,), "s")
    p.put(f"output.{nu}.1.weight", (p.s["tail_out_w"][1], d, 1))
    p.same(f"output.{nu}.1.bias", "tail_out_b", "b")
    for li in p.indices(r"bsnet_(\d+)\."):
        src, port = f"net.{li}", f"bsnet_{li}"
        rf, pf = f"{src}.band_net", f"{port}.band_net"
        p.same(f"{rf}.input_norm.weight", f"{pf}.in_norm.weight", "s")
        p.conv1x1(f"{rf}.weight", f"{pf}.qkv", bias=False)
        p.conv1x1(f"{rf}.output", f"{pf}.out", bias=False)
        p.same(f"{rf}.MLP.0.weight", f"{pf}.mlp_norm.weight", "s")
        p.conv1x1(f"{rf}.MLP.1", f"{pf}.mlp_in", bias=False)
        p.conv1x1(f"{rf}.MLP_output", f"{pf}.mlp_out", bias=False)
        hd = p.s[f"{pf}.qkv.weight"][0] // 24  # 8 heads of q, k, v
        p.put(f"{rf}.cos_freq", (hd,), "f")
        p.put(f"{rf}.sin_freq", (hd,), "f")
        for j in p.indices(rf"{port}\.icb_(\d+)\."):
            cf, cp = f"{src}.seq_net.blocks.{j}.conv", f"{port}.icb_{j}"
            p.depthwise(f"{cf}.0.weight", f"{cp}.dw.kernel")
            p.same(f"{cf}.0.bias", f"{cp}.dw.bias", "b")
            p.same(f"{cf}.1.weight", f"{cp}.norm.weight", "s")
            p.conv1x1(f"{cf}.2", f"{cp}.up")
            p.conv1x1(f"{cf}.4", f"{cp}.down")


def _convtasnet(p: _Spec) -> None:
    col = lambda s: s + (1,)  # noqa: E731 - gLN (C, 1)
    p.linear("encoder.encoder", "encoder")
    p.gln("encoder.norm", "in_norm", src=("w", "b"), shape=col)
    p.conv1x1("encoder.conv1x1", "bottleneck")
    for key in p.s:
        if m := re.fullmatch(r"tcn_(\d+)_(\d+)\.in1x1\.weight", key):
            src, port = f"separation.sep.{m[1]}.tcn.{m[2]}", f"tcn_{m[1]}_{m[2]}"
            p.conv1x1(f"{src}.conv1x1", f"{port}.in1x1")
            p.same(f"{src}.prelu1.weight", f"{port}.prelu1.alpha", "a")
            p.gln(f"{src}.norm1", f"{port}.gln1", src=("w", "b"), shape=col)
            p.depthwise(f"{src}.dwconv.weight", f"{port}.dwconv.kernel")
            p.same(f"{src}.dwconv.bias", f"{port}.dwconv.bias", "b")
            p.same(f"{src}.prelu2.weight", f"{port}.prelu2.alpha", "a")
            p.gln(f"{src}.norm2", f"{port}.gln2", src=("w", "b"), shape=col)
            p.conv1x1(f"{src}.sconv", f"{port}.out1x1")
    p.conv1x1("mask", "mask_out")
    p.linear("decoder.decoder", "decoder")


def _dprnn(p: _Spec) -> None:
    p.same("encoder.conv1d.weight", "encoder.weight")
    p.norm("separation.norm", "in_norm")
    p.conv1x1("separation.conv1d", "bottleneck", bias=False)
    for i in p.indices(r"dp_(\d+)\."):
        src, port = f"separation.dual_rnn.{i}", f"dp_{i}"
        for part in ("intra", "inter"):
            p.lstm(f"{src}.{part}_rnn", f"{port}.{part}_rnn")
            p.linear(f"{src}.{part}_linear", f"{port}.{part}_proj")
            p.norm(f"{src}.{part}_norm", f"{port}.{part}_norm")
    p.same("separation.prelu.weight", "prelu.alpha", "a")
    p.conv1x1("separation.conv2d", "spk_expand", dims=2)
    p.conv1x1("separation.output.0", "out_tanh")
    p.conv1x1("separation.output_gate.0", "out_sig")
    p.conv1x1("separation.end_conv1x1", "mask_proj", bias=False)
    p.same("decoder.weight", "decoder.weight")


def _dptnet(p: _Spec) -> None:
    mid = lambda s: (1,) + s + (1,)  # noqa: E731 - gLN (1, C, 1)
    p.same("encoder.conv1d.weight", "encoder.weight")
    p.gln("separator.enc_LN", "enc_ln", shape=mid)
    for i in p.indices(r"row_(\d+)\."):
        for part in ("row", "col"):
            src, port = f"separator.dptnet.{part}_transformer.{i}", f"{part}_{i}"
            p.same(f"{src}.self_attn.in_proj_weight", f"{port}.self_attn.in_w")
            p.same(f"{src}.self_attn.in_proj_bias", f"{port}.self_attn.in_b", "b")
            p.same(f"{src}.self_attn.out_proj.weight", f"{port}.self_attn.out_w")
            p.same(f"{src}.self_attn.out_proj.bias", f"{port}.self_attn.out_b", "b")
            p.gln(f"{src}.norm_attn", f"{port}.norm_attn", shape=mid)
            p.lstm(f"{src}.rnn", f"{port}.rnn")
            p.linear(f"{src}.feed_forward.2", f"{port}.ff")
            p.gln(f"{src}.norm_ff", f"{port}.norm_ff", shape=mid)
    p.same("separator.dptnet.output.0.weight", "prelu.alpha", "a")
    p.conv1x1("separator.dptnet.output.1", "spk_expand", dims=2)
    p.conv1x1("separator.output.0", "out_tanh")
    p.conv1x1("separator.output_gate.0", "out_sig")
    p.same("decoder.convtrans1d.weight", "decoder.weight")


def _bsrnn(p: _Spec) -> None:
    bands = p.indices(r"bn_(\d+)_norm\.")
    for i in bands:
        p.norm(f"BN.{i}.0", f"bn_{i}_norm", src=("gamma", "beta"))
        p.conv1x1(f"BN.{i}.1", f"bn_{i}_proj")
    for r in p.indices(r"sep_(\d+)_band_rnn\."):
        for part in ("band_rnn", "band_comm"):
            src, port = f"separator.{r}.{part}", f"sep_{r}_{part}"
            p.norm(f"{src}.norm", f"{port}.norm", src=("gamma", "beta"))
            p.lstm(f"{src}.rnn", f"{port}.rnn")
            p.linear(f"{src}.proj", f"{port}.proj")
    for i in bands:
        p.norm(f"mask.{i}.0", f"mask_{i}_norm", src=("gamma", "beta"))
        p.conv1x1(f"mask.{i}.1", f"mask_{i}_pre")
        for layer, g in ((3, "g1"), (5, "g2")):
            groups, n_in, n_out = p.s[f"mask_{i}_{g}.w"]
            p.put(f"mask.{i}.{layer}.weight", (groups * n_out, n_in, 1))
            p.put(f"mask.{i}.{layer}.bias", (groups * n_out,), "b")


def _encoder_head(p: _Spec) -> None:
    p.same("encoder.weight", "encoder.weight")
    p.gln("ln", "ln")
    p.conv1x1("bottleneck", "bottleneck")


def _mask_tail(p: _Spec, concat: bool) -> None:
    if concat:
        p.linear("sm.concat_block.0", "concat_conv")
        p.same("sm.concat_block.1.weight", "concat_act.alpha", "a")
    p.same("mask_net.0.weight", "mask_prelu.alpha", "a")
    p.conv1x1("mask_net.1", "mask_conv")
    p.same("decoder.weight", "decoder.weight")


def _sudormrf(p: _Spec) -> None:
    _encoder_head(p)
    for i in p.indices(r"sm_(\d+)\."):
        src, port = f"sm.{i}", f"sm_{i}"
        p.convnorm(f"{src}.proj_1x1", f"{port}.proj_1x1")
        for k in p.indices(rf"{port}\.spp_(\d+)\."):
            p.convnorm(f"{src}.spp_dw.{k}", f"{port}.spp_{k}")
        p.gln(f"{src}.final_norm.norm", f"{port}.final_norm")
        p.same(f"{src}.final_norm.act.weight", f"{port}.final_act.alpha", "a")
        p.conv1x1(f"{src}.res_conv", f"{port}.res_conv")
    _mask_tail(p, concat=False)


def _afrcnn(p: _Spec) -> None:
    _encoder_head(p)
    p.convnorm("sm.blocks.proj_1x1", "blocks.proj_1x1")
    for k in p.indices(r"blocks\.spp_(\d+)\."):
        p.convnorm(f"sm.blocks.spp_dw.{k}", f"blocks.spp_{k}")
    for i in p.indices(r"blocks\.fuse_(\d+)\."):
        p.convnorm(f"sm.blocks.fuse_layers.{i}.0", f"blocks.fuse_{i}")
    for i in p.indices(r"blocks\.concat_(\d+)\."):
        p.convnorm(f"sm.blocks.concat_layer.{i}", f"blocks.concat_{i}")
    p.convnorm("sm.blocks.last_layer.0", "blocks.last")
    p.conv1x1("sm.blocks.res_conv", "blocks.res_conv")
    _mask_tail(p, concat=True)


def _tdanet(p: _Spec) -> None:
    _encoder_head(p)
    u = "sm.unet"
    p.convnorm(f"{u}.proj_1x1", "unet.proj_1x1")
    for k in p.indices(r"unet\.spp_(\d+)\."):
        p.convnorm(f"{u}.spp_dw.{k}", f"unet.spp_{k}")
    for i in p.indices(r"unet\.fus_(\d+)\."):
        for part in ("local_embedding", "global_act"):
            p.convnorm(f"{u}.loc_glo_fus.{i}.{part}", f"unet.fus_{i}.{part}")
    for i in p.indices(r"unet\.last_(\d+)\."):
        for part in ("local_embedding", "global_act", "global_embedding"):
            p.convnorm(f"{u}.last_layer.{i}.{part}", f"unet.last_{i}.{part}")
    ga, pa = f"{u}.globalatt", "unet.globalatt"
    p.norm(f"{ga}.attn.attn_in_norm", f"{pa}.attn_in_norm")
    p.same(f"{ga}.attn.attn.in_proj_weight", f"{pa}.attn.in_w")
    p.same(f"{ga}.attn.attn.in_proj_bias", f"{pa}.attn.in_b", "b")
    p.same(f"{ga}.attn.attn.out_proj.weight", f"{pa}.attn.out_w")
    p.same(f"{ga}.attn.attn.out_proj.bias", f"{pa}.attn.out_b", "b")
    p.norm(f"{ga}.attn.norm", f"{pa}.attn_norm")
    p.put(f"{ga}.attn.pos_enc.pe", (1, 64, p.s[f"{pa}.attn.out_b"][0]), "f")
    p.convnorm(f"{ga}.mlp.fc1", f"{pa}.mlp_fc1")
    p.linear(f"{ga}.mlp.dwconv", f"{pa}.mlp_dwconv")
    p.convnorm(f"{ga}.mlp.fc2", f"{pa}.mlp_fc2")
    p.conv1x1(f"{u}.res_conv", "unet.res_conv")
    _mask_tail(p, concat=True)


def _skim(p: _Spec) -> None:
    mid = lambda s: (1,) + s + (1,)  # noqa: E731 - (1, C, 1)
    skim = "separation.skim"
    p.same("encoder.conv1d.weight", "encoder.weight")
    for i in p.indices(r"seg_(\d+)\."):
        src, port = f"{skim}.seg_lstms.{i}", f"seg_{i}"
        p.lstm(f"{src}.lstm", f"{port}.lstm")
        p.linear(f"{src}.proj", f"{port}.proj")
        p.gln(f"{src}.norm", f"{port}.norm", shape=mid)
    for i in p.indices(r"mem_(\d+)\."):
        src, port = f"{skim}.mem_lstms.{i}", f"mem_{i}"
        for net in ("h", "c"):
            if f"{port}.{net}_net.proj.weight" in p.s:
                p.lstm(f"{src}.{net}_net.rnn", f"{port}.{net}_net.lstm")
                p.linear(f"{src}.{net}_net.proj", f"{port}.{net}_net.proj")
                p.gln(f"{src}.{net}_norm", f"{port}.{net}_norm", shape=mid)
    p.same(f"{skim}.output_fc.0.weight", "out_prelu.alpha", "a")
    p.conv1x1(f"{skim}.output_fc.1", "out_conv")
    p.same("decoder.weight", "decoder.weight")


def _tfgridnet(p: _Spec) -> None:
    p.linear("conv.0", "conv")
    p.norm("conv.1", "conv_norm")
    for i in p.indices(r"block_(\d+)\."):
        src, port = f"blocks.{i}", f"block_{i}"
        for part in ("intra", "inter"):
            p.norm(f"{src}.{part}_norm", f"{port}.{part}_norm")
            p.lstm(f"{src}.{part}_rnn", f"{port}.{part}_rnn")
            p.linear(f"{src}.{part}_linear", f"{port}.{part}_linear")
        for head in ("Q", "K", "V"):
            stem, pn = f"{src}.attn_norm_{head}", f"{port}.attn_norm_{head}"
            p.conv1x1(f"{src}.attn_conv_{head}", f"{port}.attn_conv_{head}", dims=2)
            p.same(f"{stem}.act.weight", f"{pn}.alpha", "a")
            f, h, e = p.s[f"{pn}.gamma"]
            p.put(f"{stem}.gamma", (1, h, e, 1, f), "s")
            p.put(f"{stem}.beta", (1, h, e, 1, f), "b")
        p.conv1x1(f"{src}.attn_concat_proj.0", f"{port}.attn_proj", dims=2)
        p.same(f"{src}.attn_concat_proj.1.weight", f"{port}.attn_act.alpha", "a")
        f, c = p.s[f"{port}.attn_ln.gamma"]
        p.put(f"{src}.attn_concat_proj.2.gamma", (1, c, 1, f), "s")
        p.put(f"{src}.attn_concat_proj.2.beta", (1, c, 1, f), "b")
    p.linear("deconv", "deconv")


# the value each kind of leaf is drawn around
_CENTRE = {"s": 1.0, "a": 0.25, "o": 1.0, "b": 0.0}
_LAYOUTS = {"MossFormer2": _mossformer2, "Apollo": _apollo, "ConvTasNet": _convtasnet,
            "DPRNNTasNet": _dprnn, "DPTNet": _dptnet, "BSRNN": _bsrnn, "SuDORMRF": _sudormrf,
            "AFRCNN": _afrcnn, "TDANet": _tdanet, "SkiMNet": _skim, "TFGridNet": _tfgridnet}


def reference_shapes(name: str, args: dict | None = None) -> dict:
    """Reference key -> (shape, kind) of architecture `name` at `args`."""
    spec = _Spec(port_shapes(name, args))
    _LAYOUTS[name](spec)
    return spec.out


def reference_state_dict(name: str, args: dict | None = None, seed: int = 0) -> dict:
    """A seeded reference-layout state dict (numpy float32) of architecture
    `name` (a key of `port_rules.RULES`) at model arguments `args`."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, (shape, kind) in reference_shapes(name, args).items():
        if kind == "f":
            out[key] = rng.uniform(0.0, 1.0, shape).astype(np.float32)
            continue
        z = rng.standard_normal(shape, dtype=np.float32)
        if kind == "w":  # normal over sqrt(fan-in), plus 0.05 noise
            fan = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            out[key] = z * np.float32(np.sqrt(1.0 / fan + 0.05 ** 2))
        else:
            out[key] = np.float32(_CENTRE[kind]) + np.float32(0.02 if kind == "o" else 0.05) * z
    return out


# ---------------- synthetic MOS graphs ----------------


def _conv_node(g, name, cin_name, w, b, pads, strides=(1, 1)):
    from ..runtime.onnx_io import OnnxNode

    g.initializers[f"{name}_w"] = w
    g.initializers[f"{name}_b"] = b
    g.nodes.append(OnnxNode("Conv", [cin_name, f"{name}_w", f"{name}_b"], [name], name=name,
                            attrs={"kernel_shape": list(w.shape[2:]), "pads": list(pads),
                                   "strides": list(strides)}))
    return name


def _gemm_node(g, name, in_name, w, b):
    from ..runtime.onnx_io import OnnxNode

    g.initializers[f"{name}_w"] = w  # (out, in), transB = 1
    g.initializers[f"{name}_b"] = b
    g.nodes.append(OnnxNode("Gemm", [in_name, f"{name}_w", f"{name}_b"], [name], name=name,
                            attrs={"transB": 1}))
    return name


def _relu(g, name, in_name):
    from ..runtime.onnx_io import OnnxNode

    g.nodes.append(OnnxNode("Relu", [in_name], [name], name=name))
    return name


def _pool(g, i, h, kernel):
    from ..runtime.onnx_io import OnnxNode

    g.nodes.append(OnnxNode("MaxPool", [h], [f"pool{i}"], name=f"pool{i}",
                            attrs={"kernel_shape": list(kernel), "strides": list(kernel)}))
    return f"pool{i}"


def dnsmos_graph(rng: np.random.Generator, ch: int = 32, n_out: int = 3):
    """A synthetic graph in the layout of DNSMOS's `sig_bak_ovr.onnx`
    (n_out 3) or `model_v8.onnx` (n_out 1), matching DNSMOSNet(n_out, ch):
    4 x [Conv 3 x 3 SAME + Relu + MaxPool 2 x 2] -> mean -> fc1 -> fc2 -> head."""
    from ..runtime.onnx_io import OnnxGraph, OnnxNode

    g = OnnxGraph([], {}, ["input_1"], ["output_1"])
    h, cin = "input_1", 1
    for i, c in enumerate((ch, ch, ch * 2, ch * 2)):
        w = (rng.standard_normal((c, cin, 3, 3)) * 0.2).astype(np.float32)
        b = (rng.standard_normal(c) * 0.05).astype(np.float32)
        h = _relu(g, f"relu{i}", _conv_node(g, f"conv{i}", h, w, b, pads=(1, 1, 1, 1)))
        h, cin = _pool(g, i, h, (2, 2)), c
    g.nodes.append(OnnxNode("ReduceMean", [h], ["gap"], name="gap",
                            attrs={"axes": [2, 3], "keepdims": 0}))
    h = "gap"
    for name, n in (("fc1", 128), ("fc2", 64)):
        w = (rng.standard_normal((n, cin)) * 0.1).astype(np.float32)
        b = (rng.standard_normal(n) * 0.05).astype(np.float32)
        h, cin = _relu(g, f"{name}_relu", _gemm_node(g, name, h, w, b)), n
    w = (rng.standard_normal((n_out, cin)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(n_out) * 0.05).astype(np.float32)
    _gemm_node(g, "head", h, w, b)
    g.nodes[-1].outputs = ["output_1"]
    return g


def sigmos_graph(rng: np.random.Generator, ch: int = 32, n_out: int = 7):
    """A synthetic graph in SigMOS's layout, matching SigMOSNet(n_out, ch):
    3-channel input, 3 x [Conv 3 x 5 SAME + Relu + MaxPool 2 x 4] ->
    concat(mean, max) -> fc1 -> head."""
    from ..runtime.onnx_io import OnnxGraph, OnnxNode

    g = OnnxGraph([], {}, ["input_1"], ["output_1"])
    h, cin = "input_1", 3
    for i, c in enumerate((ch, ch * 2, ch * 2)):
        w = (rng.standard_normal((c, cin, 3, 5)) * 0.1).astype(np.float32)
        b = (rng.standard_normal(c) * 0.05).astype(np.float32)
        h = _relu(g, f"relu{i}", _conv_node(g, f"conv{i}", h, w, b, pads=(1, 2, 1, 2)))
        h, cin = _pool(g, i, h, (2, 4)), c
    for op, out in (("ReduceMean", "mean"), ("ReduceMax", "max")):
        g.nodes.append(OnnxNode(op, [h], [out], name=out, attrs={"axes": [2, 3], "keepdims": 0}))
    g.nodes.append(OnnxNode("Concat", ["mean", "max"], ["pooled"], name="concat",
                            attrs={"axis": 1}))
    w = (rng.standard_normal((128, cin * 2)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(128) * 0.05).astype(np.float32)
    h = _relu(g, "fc1_relu", _gemm_node(g, "fc1", "pooled", w, b))
    w = (rng.standard_normal((n_out, 128)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(n_out) * 0.05).astype(np.float32)
    _gemm_node(g, "head", h, w, b)
    g.nodes[-1].outputs = ["output_1"]
    return g
