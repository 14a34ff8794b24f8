"""Reference checkpoints -> the port's models: per-architecture rules that
read a reference (look2hear) torch state dict and return the port model's
`state_dict`.

Counterpart of targetdiarization_tpu/runtime/port_rules.py, one public
function per JAX function under the same name. Each rule maps the
reference's module names onto the JAX package's flax parameter tree (the
JAX rules' mapping, copied), then hands that tree to the port's own
converter of the architecture (`runtime/convert.py::CONVERTERS`), so the
result loads with `model.load_state_dict(sd, strict=True)` into the port
class of the same geometry:

    sd = torch.load("mossformer2.pth", map_location="cpu")
    model = MossFormer2(**args)
    model.load_state_dict(port_rules.convert_mossformer2(sd), strict=True)

The rules are strict: a reference key that no rule reads raises
`KeyError`. The deterministic buffers are skipped, as the JAX rules skip
them: MossFormer2's rotary `freqs` and `pos_enc.inv_freq`, Apollo's
`cos_freq` / `sin_freq`, TDANet's positional `pe`.

Layout quirks (see the JAX module for the full MossFormer2 name map):
- OffsetScale stores gamma; the models store gamma - 1 (`os_gamma`).
- MossFormer2's DilatedDenseNet Conv2d (C (j+1), C, (39, 1), groups C)
  -> the depthwise kernel (39, j+1, C) the dwconv kernel reads.
- torch ConvTranspose1d (in, out, k) -> flax ConvTranspose (k, in, out) with
  the spatial axis reversed (`convert_conv_transpose1d`).
- Apollo's Roformer packs qkv head-major ([q_h | k_h | v_h] per head); the
  model's Dense packs it selector-major (3, heads, hd).
"""

from __future__ import annotations

import re

import numpy as np

from .convert import (CONVERTERS, convert_conv1d, convert_conv2d, convert_linear, convert_norm,
                      to_numpy)


def _conv1x1_as_dense(weight, bias=None):
    """torch Conv1d(.., kernel_size=1) -> flax Dense params."""
    out = {"kernel": to_numpy(weight)[..., 0].T}
    if bias is not None:
        out["bias"] = to_numpy(bias)
    return out


def convert_conv_transpose1d(weight, bias=None):
    """torch ConvTranspose1d (in, out, k) -> flax ConvTranspose kernel
    (k, in, out), spatial axis reversed."""
    out = {"kernel": np.transpose(to_numpy(weight), (2, 0, 1))[::-1].copy()}
    if bias is not None:
        out["bias"] = to_numpy(bias)
    return out


def _set(tree: dict, path: str, leaf) -> None:
    node = tree
    keys = path.split("/")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = leaf


def _state_dict(name: str, tree: dict) -> dict:
    """The port's state dict of architecture `name` from the flax tree."""
    return CONVERTERS[name]({"params": tree})


class _Reader:
    """A reference state dict under conversion: `take` reads a key (as
    numpy) and marks it handled, the helpers write the flax tree, `result`
    raises `KeyError` on any key no rule read."""

    def __init__(self, state_dict: dict, rule: str):
        self.sd, self.rule = dict(state_dict), rule
        self.handled: set = set()
        self.tree: dict = {}

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def take(self, key: str) -> np.ndarray:
        self.handled.add(key)
        return to_numpy(self.sd[key])

    def set(self, path: str, leaf) -> None:
        _set(self.tree, path, leaf)

    def count(self, pattern: str) -> int:
        """1 + the largest index the regex group of `pattern` matches."""
        return 1 + max(int(m.group(1)) for k in self.sd if (m := re.match(pattern, k)))

    def dense(self, dst: str, stem: str, bias: bool = True) -> None:
        """Linear, or a 1 x 1 Conv1d / Conv2d, -> Dense."""
        w = self.take(f"{stem}.weight")
        w = w[..., 0, 0] if w.ndim == 4 else w[..., 0] if w.ndim == 3 else w
        self.set(f"{dst}/kernel", w.T)
        if bias:
            self.set(f"{dst}/bias", self.take(f"{stem}.bias"))

    def conv(self, dst: str, stem: str, bias: bool = True) -> None:
        """Conv1d -> Conv."""
        c = convert_conv1d(self.take(f"{stem}.weight"),
                           self.take(f"{stem}.bias") if bias else None)
        self.set(f"{dst}/kernel", c["kernel"])
        if bias:
            self.set(f"{dst}/bias", c["bias"])

    def conv_transpose(self, dst: str, stem: str, bias: bool = False) -> None:
        c = convert_conv_transpose1d(self.take(f"{stem}.weight"),
                                     self.take(f"{stem}.bias") if bias else None)
        self.set(f"{dst}/kernel", c["kernel"])
        if bias:
            self.set(f"{dst}/bias", c["bias"])

    def norm(self, dst: str, stem: str) -> None:
        """LayerNorm / GroupNorm affine -> flax {scale, bias}."""
        self.set(f"{dst}/scale", self.take(f"{stem}.weight"))
        self.set(f"{dst}/bias", self.take(f"{stem}.bias"))

    def gln(self, dst: str, stem: str, src=("gamma", "beta"), names=("gamma", "beta")) -> None:
        """A global / cumulative norm's affine pair, its singleton axes
        dropped ((C,), (C, 1) and (1, C, 1) all -> (C,))."""
        for s, n in zip(src, names):
            self.set(f"{dst}/{n}", self.take(f"{stem}.{s}").reshape(-1))

    def prelu(self, dst: str, key: str) -> None:
        self.set(f"{dst}/alpha", self.take(key))

    def lstm(self, dst: str, stem: str, bidirectional: bool | None = None) -> None:
        """torch LSTM -> {fwd,bwd}_{wi,wh,bi,bh}: weight_ih_l0 (4H, N) ->
        wi (N, 4H), weight_hh_l0 (4H, H) -> wh (H, 4H), the biases as they
        are, `_reverse` -> bwd (where present, or where `bidirectional`)."""
        if bidirectional is None:
            bidirectional = f"{stem}.weight_ih_l0_reverse" in self
        for name, suf in (("fwd", ""), ("bwd", "_reverse"))[:1 + bool(bidirectional)]:
            self.set(f"{dst}/{name}_wi", self.take(f"{stem}.weight_ih_l0{suf}").T)
            self.set(f"{dst}/{name}_wh", self.take(f"{stem}.weight_hh_l0{suf}").T)
            self.set(f"{dst}/{name}_bi", self.take(f"{stem}.bias_ih_l0{suf}"))
            self.set(f"{dst}/{name}_bh", self.take(f"{stem}.bias_hh_l0{suf}"))

    def convnorm(self, dst: str, stem: str, act: bool = False, bias: bool = True) -> None:
        """SuDoRM-RF / AFRCNN / TDANet ConvNorm(Act): conv, gLN, PReLU."""
        self.conv(f"{dst}/conv", f"{stem}.conv", bias=bias)
        self.gln(f"{dst}/norm", f"{stem}.norm")
        if act:
            self.prelu(f"{dst}/act", f"{stem}.act.weight")

    def result(self, skip=()) -> dict:
        unmatched = [k for k in self.sd if k not in self.handled and not any(s in k for s in skip)]
        if unmatched:
            raise KeyError(f"{self.rule}: unhandled keys {sorted(unmatched)[:8]}")
        return self.tree


# ---------------- MossFormer2 ----------------


def _group_weight_bias(state_dict: dict) -> dict:
    groups: dict = {}
    for key, tensor in state_dict.items():
        stem, _, leaf = key.rpartition(".")
        if leaf in ("weight", "bias", "g", "gamma", "beta", "scale", "freqs", "inv_freq"):
            groups.setdefault(stem, {})[leaf] = tensor
        else:
            groups.setdefault(key, {})["weight"] = tensor
    return groups


def _ffconvm(tree, src_stem, dst_prefix, parts_by_stem, norm_kind):
    """FFConvM: mdl.0 norm, mdl.1 linear, mdl.3 ConvModule dwconv."""
    p0 = parts_by_stem[f"{src_stem}.mdl.0"]
    if norm_kind == "scalenorm":
        _set(tree, f"{dst_prefix}/norm/g", to_numpy(p0["g"]))
    else:
        conv = convert_norm(p0.get("weight"), p0.get("bias"))
        _set(tree, f"{dst_prefix}/norm/scale", conv["scale"])
        _set(tree, f"{dst_prefix}/norm/bias", conv["bias"])
    p1 = parts_by_stem[f"{src_stem}.mdl.1"]
    lin = convert_linear(p1["weight"], p1.get("bias"))
    _set(tree, f"{dst_prefix}/proj/kernel", lin["kernel"])
    if "bias" in lin:
        _set(tree, f"{dst_prefix}/proj/bias", lin["bias"])
    pc = parts_by_stem[f"{src_stem}.mdl.3.sequential.1.conv"]
    _set(tree, f"{dst_prefix}/dwconv/kernel", convert_conv1d(pc["weight"])["kernel"])


def convert_mossformer2(state_dict: dict) -> dict:
    """Reference MossFormer2 state dict -> the state dict of
    `models.separation.MossFormer2` (same geometry)."""
    groups = _group_weight_bias(state_dict)
    tree: dict = {}
    handled = set()

    def take(stem):
        handled.add(stem)
        return groups[stem]

    _set(tree, "encoder/kernel", convert_conv1d(take("enc.conv1d")["weight"])["kernel"])
    _set(tree, "decoder/kernel", convert_conv_transpose1d(take("dec")["weight"])["kernel"])

    p = take("mask_net.norm")
    _set(tree, "mask_net/in_norm/weight", to_numpy(p["weight"]))
    _set(tree, "mask_net/in_norm/bias", to_numpy(p["bias"]))
    _set(tree, "mask_net/bottleneck/kernel",
         _conv1x1_as_dense(take("mask_net.conv1d_encoder")["weight"])["kernel"])
    _set(tree, "mask_net/pos_scale", to_numpy(take("mask_net.pos_enc")["scale"]))
    p = take("mask_net.mdl.intra_mdl.norm")
    n = convert_norm(p["weight"], p["bias"])
    _set(tree, "mask_net/out_ln/scale", n["scale"])
    _set(tree, "mask_net/out_ln/bias", n["bias"])
    p = take("mask_net.mdl.intra_norm")
    _set(tree, "mask_net/intra_norm/weight", to_numpy(p["weight"]))
    _set(tree, "mask_net/intra_norm/bias", to_numpy(p["bias"]))
    _set(tree, "mask_net/prelu", to_numpy(take("mask_net.prelu")["weight"]))
    for src, dst in (("mask_net.conv1d_out", "mask_net/spk_expand"),
                     ("mask_net.output.0", "mask_net/out_tanh"),
                     ("mask_net.output_gate.0", "mask_net/out_sig")):
        p = take(src)
        c = _conv1x1_as_dense(p["weight"], p.get("bias"))
        _set(tree, f"{dst}/kernel", c["kernel"])
        if "bias" in c:
            _set(tree, f"{dst}/bias", c["bias"])
    _set(tree, "mask_net/mask_proj/kernel",
         _conv1x1_as_dense(take("mask_net.conv1_decoder")["weight"])["kernel"])

    mm = "mask_net.mdl.intra_mdl.mossformerM"
    flash_ids = sorted({int(m.group(1)) for s in groups
                        if (m := re.match(rf"{re.escape(mm)}\.layers\.(\d+)\.", s + "."))})
    for i in flash_ids:
        src, dst = f"{mm}.layers.{i}", f"mask_net/flash_{i}"
        handled.add(f"{src}.rotary_pos_emb")  # deterministic buffer
        for ff in ("to_hidden", "to_qk", "to_out"):
            _ffconvm(tree, f"{src}.{ff}", f"{dst}/{ff}", groups, "scalenorm")
            handled.update({f"{src}.{ff}.mdl.0", f"{src}.{ff}.mdl.1",
                            f"{src}.{ff}.mdl.3.sequential.1.conv"})
        p = take(f"{src}.qk_offset_scale")
        _set(tree, f"{dst}/os_gamma", to_numpy(p["gamma"]) - 1.0)  # the models add 1 back
        _set(tree, f"{dst}/os_beta", to_numpy(p["beta"]))

    fsmn_ids = sorted({int(m.group(1)) for s in groups
                       if (m := re.match(rf"{re.escape(mm)}\.fsmn\.(\d+)\.", s + "."))})
    for i in fsmn_ids:
        src, dst = f"{mm}.fsmn.{i}", f"mask_net/fsmn_{i}"
        for conv in ("conv1", "conv2"):
            p = take(f"{src}.{conv}.0" if conv == "conv1" else f"{src}.{conv}")
            c = _conv1x1_as_dense(p["weight"], p.get("bias"))
            _set(tree, f"{dst}/{conv}/kernel", c["kernel"])
            _set(tree, f"{dst}/{conv}/bias", c["bias"])
        _set(tree, f"{dst}/prelu", to_numpy(take(f"{src}.conv1.1")["weight"]))
        for norm in ("norm1", "norm2"):
            p = take(f"{src}.{norm}")
            n = convert_norm(p["weight"], p["bias"])
            _set(tree, f"{dst}/{norm}/scale", n["scale"])
            _set(tree, f"{dst}/{norm}/bias", n["bias"])
        for ff in ("to_u", "to_v"):
            _ffconvm(tree, f"{src}.gated_fsmn.{ff}", f"{dst}/{ff}", groups, "layernorm")
            handled.update({f"{src}.gated_fsmn.{ff}.mdl.0", f"{src}.gated_fsmn.{ff}.mdl.1",
                            f"{src}.gated_fsmn.{ff}.mdl.3.sequential.1.conv"})
        p = take(f"{src}.gated_fsmn.fsmn.linear")
        lin = convert_linear(p["weight"], p["bias"])
        _set(tree, f"{dst}/fsmn/linear/kernel", lin["kernel"])
        _set(tree, f"{dst}/fsmn/linear/bias", lin["bias"])
        _set(tree, f"{dst}/fsmn/project/kernel",
             convert_linear(take(f"{src}.gated_fsmn.fsmn.project")["weight"])["kernel"])
        j = 0
        while f"{src}.gated_fsmn.fsmn.conv.conv{j + 1}" in groups:
            w = to_numpy(take(f"{src}.gated_fsmn.fsmn.conv.conv{j + 1}")["weight"])[..., 0]
            _set(tree, f"{dst}/fsmn/ddn/conv{j}/kernel", convert_conv1d(w)["kernel"])
            p = take(f"{src}.gated_fsmn.fsmn.conv.norm{j + 1}")
            _set(tree, f"{dst}/fsmn/ddn/in_w{j}", to_numpy(p["weight"]))
            _set(tree, f"{dst}/fsmn/ddn/in_b{j}", to_numpy(p["bias"]))
            _set(tree, f"{dst}/fsmn/ddn/prelu{j}",
                 to_numpy(take(f"{src}.gated_fsmn.fsmn.conv.prelu{j + 1}")["weight"]))
            j += 1

    unmatched = [s for s in groups if s not in handled and not s.endswith("rotary_pos_emb")
                 and not s.endswith("pos_enc")]
    if unmatched:
        raise KeyError(f"convert_mossformer2: unhandled keys {sorted(unmatched)[:8]}")
    return _state_dict("MossFormer2", tree)


# ---------------- Apollo ----------------


def convert_apollo(state_dict: dict, n_uniform: int = 79) -> dict:
    """Reference Apollo state dict -> the state dict of
    `models.restoration.Apollo`: the 79 per-band modules stacked into the
    model's banks (the ragged tail band keeps its own), the Roformer's
    head-major qkv permuted to selector-major."""
    r = _Reader(state_dict, "convert_apollo")
    bands = range(n_uniform)
    r.set("uni_norm_w", np.stack([r.take(f"BN.{i}.0.weight") for i in bands]))
    r.set("uni_bn_w", np.stack([r.take(f"BN.{i}.1.weight")[..., 0].T for i in bands]))
    r.set("uni_bn_b", np.stack([r.take(f"BN.{i}.1.bias") for i in bands]))
    r.set("tail_norm_w", r.take(f"BN.{n_uniform}.0.weight"))
    r.set("tail_bn_w", r.take(f"BN.{n_uniform}.1.weight")[..., 0].T)
    r.set("tail_bn_b", r.take(f"BN.{n_uniform}.1.bias"))

    li = 0
    while f"net.{li}.band_net.input_norm.weight" in r:
        src, dst = f"net.{li}", f"bsnet_{li}"
        rf = f"{src}.band_net"
        r.set(f"{dst}/band_net/in_norm/weight", r.take(f"{rf}.input_norm.weight"))
        qkv = r.take(f"{rf}.weight.weight")[..., 0]  # (3 H hd, d)
        d, heads = qkv.shape[1], 8
        hd = qkv.shape[0] // (3 * heads)
        qkv = qkv.reshape(heads, 3, hd, d).transpose(1, 0, 2, 3)
        r.set(f"{dst}/band_net/qkv/kernel", qkv.reshape(3 * heads * hd, d).T.copy())
        r.set(f"{dst}/band_net/out/kernel", r.take(f"{rf}.output.weight")[..., 0].T)
        r.set(f"{dst}/band_net/mlp_norm/weight", r.take(f"{rf}.MLP.0.weight"))
        r.set(f"{dst}/band_net/mlp_in/kernel", r.take(f"{rf}.MLP.1.weight")[..., 0].T)
        r.set(f"{dst}/band_net/mlp_out/kernel", r.take(f"{rf}.MLP_output.weight")[..., 0].T)
        for j in range(3):
            cf, cd = f"{src}.seq_net.blocks.{j}.conv", f"{dst}/icb_{j}"
            r.conv(f"{cd}/dw", f"{cf}.0")  # (C, 1, K) depthwise
            r.set(f"{cd}/norm/weight", r.take(f"{cf}.1.weight"))
            r.dense(f"{cd}/up", f"{cf}.2")
            r.dense(f"{cd}/down", f"{cf}.4")
        li += 1

    tail_norm = r.take(f"output.{n_uniform}.0.weight")
    r.set("out_norm/weight", np.stack([r.take(f"output.{i}.0.weight") for i in bands]
                                      + [tail_norm]))
    r.set("uni_out_w", np.stack([r.take(f"output.{i}.1.weight")[..., 0].T for i in bands]))
    r.set("uni_out_b", np.stack([r.take(f"output.{i}.1.bias") for i in bands]))
    r.set("tail_out_w", r.take(f"output.{n_uniform}.1.weight")[..., 0].T)
    r.set("tail_out_b", r.take(f"output.{n_uniform}.1.bias"))
    return _state_dict("Apollo", r.result(skip=("cos_freq", "sin_freq")))


# ---------------- the zoo ----------------


def convert_convtasnet(state_dict: dict) -> dict:
    """Reference ConvTasNet state dict (gLN norm) -> the state dict of
    `models.zoo.ConvTasNet`."""
    r = _Reader(state_dict, "convert_convtasnet")
    r.conv("encoder", "encoder.encoder")
    r.gln("in_norm", "encoder.norm", names=("w", "b"))
    r.dense("bottleneck", "encoder.conv1x1")
    for rep in range(r.count(r"separation\.sep\.(\d+)\.")):
        for i in range(r.count(r"separation\.sep\.0\.tcn\.(\d+)\.")):
            src, dst = f"separation.sep.{rep}.tcn.{i}", f"tcn_{rep}_{i}"
            r.dense(f"{dst}/in1x1", f"{src}.conv1x1")
            r.prelu(f"{dst}/prelu1", f"{src}.prelu1.weight")
            r.gln(f"{dst}/gln1", f"{src}.norm1", names=("w", "b"))
            r.conv(f"{dst}/dwconv", f"{src}.dwconv")
            r.prelu(f"{dst}/prelu2", f"{src}.prelu2.weight")
            r.gln(f"{dst}/gln2", f"{src}.norm2", names=("w", "b"))
            r.dense(f"{dst}/out1x1", f"{src}.sconv")
    r.dense("mask_out", "mask")
    r.conv_transpose("decoder", "decoder.decoder", bias=True)
    return _state_dict("ConvTasNet", r.result())


def convert_dprnn(state_dict: dict) -> dict:
    """Reference DPRNNTasNet state dict -> the state dict of
    `models.zoo.DPRNNTasNet` (torch's LSTM packing kept, `_reverse` the
    backward direction)."""
    r = _Reader(state_dict, "convert_dprnn")
    r.conv("encoder", "encoder.conv1d", bias=False)
    r.norm("in_norm", "separation.norm")
    r.dense("bottleneck", "separation.conv1d", bias=False)
    for i in range(r.count(r"separation\.dual_rnn\.(\d+)\.")):
        src, dst = f"separation.dual_rnn.{i}", f"dp_{i}"
        for part in ("intra", "inter"):
            r.lstm(f"{dst}/{part}_rnn", f"{src}.{part}_rnn")
            r.dense(f"{dst}/{part}_proj", f"{src}.{part}_linear")
            r.norm(f"{dst}/{part}_norm", f"{src}.{part}_norm")
    r.prelu("prelu", "separation.prelu.weight")
    r.dense("spk_expand", "separation.conv2d")
    r.dense("out_tanh", "separation.output.0")
    r.dense("out_sig", "separation.output_gate.0")
    r.dense("mask_proj", "separation.end_conv1x1", bias=False)
    r.conv_transpose("decoder", "decoder")
    return _state_dict("DPRNNTasNet", r.result())


def convert_dptnet(state_dict: dict) -> dict:
    """Reference DPTNetModel state dict -> the state dict of
    `models.zoo.DPTNet` (the packed MultiheadAttention kept)."""
    r = _Reader(state_dict, "convert_dptnet")
    r.conv("encoder", "encoder.conv1d", bias=False)
    r.gln("enc_ln", "separator.enc_LN")
    for i in range(r.count(r"separator\.dptnet\.row_transformer\.(\d+)\.")):
        for part in ("row", "col"):
            dst, stem = f"{part}_{i}", f"separator.dptnet.{part}_transformer.{i}"
            attn = f"{stem}.self_attn"
            r.set(f"{dst}/self_attn/in_w", r.take(f"{attn}.in_proj_weight"))
            r.set(f"{dst}/self_attn/in_b", r.take(f"{attn}.in_proj_bias"))
            r.set(f"{dst}/self_attn/out_w", r.take(f"{attn}.out_proj.weight"))
            r.set(f"{dst}/self_attn/out_b", r.take(f"{attn}.out_proj.bias"))
            r.gln(f"{dst}/norm_attn", f"{stem}.norm_attn")
            r.lstm(f"{dst}/rnn", f"{stem}.rnn")
            r.dense(f"{dst}/ff", f"{stem}.feed_forward.2")
            r.gln(f"{dst}/norm_ff", f"{stem}.norm_ff")
    r.prelu("prelu", "separator.dptnet.output.0.weight")
    r.dense("spk_expand", "separator.dptnet.output.1")
    r.dense("out_tanh", "separator.output.0")
    r.dense("out_sig", "separator.output_gate.0")
    r.conv_transpose("decoder", "decoder.convtrans1d")
    return _state_dict("DPTNet", r.result())


def convert_bsrnn(state_dict: dict) -> dict:
    """Reference BSRNN state dict -> the state dict of `models.zoo.BSRNN`:
    the grouped mask convs (groups out, in, 1) -> banks (groups, in, out),
    GroupNorm(1) affines -> gamma / beta."""
    r = _Reader(state_dict, "convert_bsrnn")

    def grouped(dst, stem, groups):
        w = r.take(f"{stem}.weight")[..., 0]  # (g out, in)
        out_per = w.shape[0] // groups
        r.set(f"{dst}/w", np.transpose(w.reshape(groups, out_per, -1), (0, 2, 1)))
        r.set(f"{dst}/b", r.take(f"{stem}.bias").reshape(groups, out_per))

    n_bands = r.count(r"BN\.(\d+)\.")
    for i in range(n_bands):
        r.gln(f"bn_{i}_norm", f"BN.{i}.0", src=("weight", "bias"))
        r.dense(f"bn_{i}_proj", f"BN.{i}.1")
    for rep in range(r.count(r"separator\.(\d+)\.")):
        for part in ("band_rnn", "band_comm"):
            stem = f"separator.{rep}.{part}"
            r.gln(f"sep_{rep}_{part}/norm", f"{stem}.norm", src=("weight", "bias"))
            r.lstm(f"sep_{rep}_{part}/rnn", f"{stem}.rnn")
            r.dense(f"sep_{rep}_{part}/proj", f"{stem}.proj")
    num_output = None
    for i in range(n_bands):
        r.gln(f"mask_{i}_norm", f"mask.{i}.0", src=("weight", "bias"))
        r.dense(f"mask_{i}_pre", f"mask.{i}.1")
        if num_output is None:
            n_out, n_feat = r.sd[f"mask.{i}.1.weight"].shape[:2]
            num_output = n_out // n_feat
        grouped(f"mask_{i}_g1", f"mask.{i}.3", num_output)
        grouped(f"mask_{i}_g2", f"mask.{i}.5", num_output)
    return _state_dict("BSRNN", r.result())


def _head(r: _Reader) -> None:
    """SuDoRM-RF / AFRCNN / TDANet: encoder, gLN and bottleneck."""
    r.conv("encoder", "encoder", bias=False)
    r.gln("ln", "ln")
    r.dense("bottleneck", "bottleneck")


def _tail(r: _Reader, concat: bool) -> None:
    """The mask head (with AFRCNN's / TDANet's concat block) and decoder."""
    if concat:
        r.conv("concat_conv", "sm.concat_block.0")
        r.prelu("concat_act", "sm.concat_block.1.weight")
    r.prelu("mask_prelu", "mask_net.0.weight")
    r.dense("mask_conv", "mask_net.1")
    r.conv_transpose("decoder", "decoder")


def convert_sudormrf(state_dict: dict) -> dict:
    """Reference SuDORMRF state dict -> the state dict of `models.zoo.SuDORMRF`."""
    r = _Reader(state_dict, "convert_sudormrf")
    _head(r)
    depth = r.count(r"sm\.0\.spp_dw\.(\d+)\.")
    for i in range(r.count(r"sm\.(\d+)\.")):
        src, dst = f"sm.{i}", f"sm_{i}"
        r.convnorm(f"{dst}/proj_1x1", f"{src}.proj_1x1", act=True)
        for k in range(depth):
            r.convnorm(f"{dst}/spp_{k}", f"{src}.spp_dw.{k}")
        r.gln(f"{dst}/final_norm", f"{src}.final_norm.norm")
        r.prelu(f"{dst}/final_act", f"{src}.final_norm.act.weight")
        r.dense(f"{dst}/res_conv", f"{src}.res_conv")
    _tail(r, concat=False)
    return _state_dict("SuDORMRF", r.result())


def convert_afrcnn(state_dict: dict) -> dict:
    """Reference AFRCNN state dict -> the state dict of `models.zoo.AFRCNN`.
    The Recurrent module's one shared Blocks maps once; the iteration count
    is a construction argument (num_blocks), not a weight."""
    r = _Reader(state_dict, "convert_afrcnn")
    _head(r)
    blk = "sm.blocks"
    depth = r.count(r"sm\.blocks\.spp_dw\.(\d+)\.")
    r.convnorm("blocks/proj_1x1", f"{blk}.proj_1x1", act=True)
    for k in range(depth):
        r.convnorm(f"blocks/spp_{k}", f"{blk}.spp_dw.{k}")
    for i in range(1, depth):
        r.convnorm(f"blocks/fuse_{i}", f"{blk}.fuse_layers.{i}.0")
    for i in range(depth):
        r.convnorm(f"blocks/concat_{i}", f"{blk}.concat_layer.{i}", act=True)
    r.convnorm("blocks/last", f"{blk}.last_layer.0", act=True)
    r.dense("blocks/res_conv", f"{blk}.res_conv")
    _tail(r, concat=True)
    return _state_dict("AFRCNN", r.result())


def convert_tdanet(state_dict: dict) -> dict:
    """Reference TDANet state dict -> the state dict of `models.zoo.TDANet`.
    The positional-encoding `pe` buffer is deterministic and skipped."""
    r = _Reader(state_dict, "convert_tdanet")
    _head(r)
    u = "sm.unet"
    depth = r.count(r"sm\.unet\.spp_dw\.(\d+)\.")
    r.convnorm("unet/proj_1x1", f"{u}.proj_1x1", act=True)
    for k in range(depth):
        r.convnorm(f"unet/spp_{k}", f"{u}.spp_dw.{k}")
    for i in range(depth):
        stem = f"{u}.loc_glo_fus.{i}"
        for part in ("local_embedding", "global_act"):
            r.convnorm(f"unet/fus_{i}/{part}", f"{stem}.{part}", bias=False)
    for i in range(depth - 1):
        stem = f"{u}.last_layer.{i}"
        for part in ("local_embedding", "global_act", "global_embedding"):
            r.convnorm(f"unet/last_{i}/{part}", f"{stem}.{part}", bias=False)
    ga = f"{u}.globalatt"
    r.norm("unet/globalatt/attn_in_norm", f"{ga}.attn.attn_in_norm")
    r.set("unet/globalatt/attn/in_w", r.take(f"{ga}.attn.attn.in_proj_weight"))
    r.set("unet/globalatt/attn/in_b", r.take(f"{ga}.attn.attn.in_proj_bias"))
    r.set("unet/globalatt/attn/out_w", r.take(f"{ga}.attn.attn.out_proj.weight"))
    r.set("unet/globalatt/attn/out_b", r.take(f"{ga}.attn.attn.out_proj.bias"))
    r.norm("unet/globalatt/attn_norm", f"{ga}.attn.norm")
    r.handled.add(f"{ga}.attn.pos_enc.pe")  # deterministic buffer
    r.convnorm("unet/globalatt/mlp_fc1", f"{ga}.mlp.fc1", bias=False)
    r.conv("unet/globalatt/mlp_dwconv", f"{ga}.mlp.dwconv")
    r.convnorm("unet/globalatt/mlp_fc2", f"{ga}.mlp.fc2", bias=False)
    r.dense("unet/res_conv", f"{u}.res_conv")
    _tail(r, concat=True)
    return _state_dict("TDANet", r.result())


def convert_skim(state_dict: dict) -> dict:
    """Reference SkiMNet state dict -> the state dict of `models.zoo.SkiMNet`
    (the SegLSTM / MemLSTM LSTMs in torch's packing; the SkiM norms'
    (1, C, 1) gamma / beta squeezed to (C,))."""
    r = _Reader(state_dict, "convert_skim")
    r.conv("encoder", "encoder.conv1d", bias=False)
    skim = "separation.skim"
    n_layers = r.count(rf"{re.escape(skim)}\.seg_lstms\.(\d+)\.")
    for i in range(n_layers):
        src = f"{skim}.seg_lstms.{i}"
        r.lstm(f"seg_{i}/lstm", f"{src}.lstm")
        r.dense(f"seg_{i}/proj", f"{src}.proj")
        r.gln(f"seg_{i}/norm", f"{src}.norm")
    for i in range(n_layers - 1):
        src = f"{skim}.mem_lstms.{i}"
        for net in ("h", "c"):
            if f"{src}.{net}_net.rnn.weight_ih_l0" in r:
                r.lstm(f"mem_{i}/{net}_net/lstm", f"{src}.{net}_net.rnn")
                r.dense(f"mem_{i}/{net}_net/proj", f"{src}.{net}_net.proj")
                r.gln(f"mem_{i}/{net}_norm", f"{src}.{net}_norm")
    r.prelu("out_prelu", f"{skim}.output_fc.0.weight")
    r.dense("out_conv", f"{skim}.output_fc.1")
    r.conv_transpose("decoder", "decoder")
    return _state_dict("SkiMNet", r.result())


def convert_tfgridnet(state_dict: dict) -> dict:
    """Reference TFGridNet state dict -> the state dict of
    `models.zoo.TFGridNet`: Conv2d (out, in, kh, kw) -> (kh, kw, in, out);
    the transposed convs also reverse their spatial axes; the 4-D
    attention norms' affines (1, H, E, 1, F) -> (F, H, E) and (1, C, 1, F)
    -> (F, C)."""
    r = _Reader(state_dict, "convert_tfgridnet")
    c = convert_conv2d(r.take("conv.0.weight"), r.take("conv.0.bias"))
    r.set("conv/kernel", c["kernel"])
    r.set("conv/bias", c["bias"])
    r.norm("conv_norm", "conv.1")
    for i in range(r.count(r"blocks\.(\d+)\.")):
        src, dst = f"blocks.{i}", f"block_{i}"
        for part in ("intra", "inter"):
            r.norm(f"{dst}/{part}_norm", f"{src}.{part}_norm")
            r.lstm(f"{dst}/{part}_rnn", f"{src}.{part}_rnn", bidirectional=True)
            if r.sd[f"{src}.{part}_linear.weight"].ndim == 3:  # ConvTranspose1d (emb_ks != emb_hs)
                r.conv_transpose(f"{dst}/{part}_linear", f"{src}.{part}_linear", bias=True)
            else:  # Linear (emb_ks == emb_hs)
                r.dense(f"{dst}/{part}_linear", f"{src}.{part}_linear")
        for head in ("Q", "K", "V"):
            r.dense(f"{dst}/attn_conv_{head}", f"{src}.attn_conv_{head}")
            stem = f"{src}.attn_norm_{head}"
            r.set(f"{dst}/attn_norm_{head}/alpha", r.take(f"{stem}.act.weight"))
            for leaf in ("gamma", "beta"):  # (1, H, E, 1, F) -> (F, H, E)
                r.set(f"{dst}/attn_norm_{head}/{leaf}",
                      np.transpose(r.take(f"{stem}.{leaf}")[0, :, :, 0], (2, 0, 1)))
        r.dense(f"{dst}/attn_proj", f"{src}.attn_concat_proj.0")
        r.prelu(f"{dst}/attn_act", f"{src}.attn_concat_proj.1.weight")
        for leaf in ("gamma", "beta"):  # (1, C, 1, F) -> (F, C)
            r.set(f"{dst}/attn_ln/{leaf}", r.take(f"{src}.attn_concat_proj.2.{leaf}")[0, :, 0].T)
    w = r.take("deconv.weight")  # (in, out, kh, kw)
    r.set("deconv/kernel", np.transpose(w, (2, 3, 0, 1))[::-1, ::-1].copy())
    r.set("deconv/bias", r.take("deconv.bias"))
    return _state_dict("TFGridNet", r.result())


# the rule of each architecture, by the port's model name
RULES = {"MossFormer2": convert_mossformer2, "Apollo": convert_apollo,
         "ConvTasNet": convert_convtasnet, "DPRNNTasNet": convert_dprnn, "DPTNet": convert_dptnet,
         "BSRNN": convert_bsrnn, "SuDORMRF": convert_sudormrf, "AFRCNN": convert_afrcnn,
         "TDANet": convert_tdanet, "SkiMNet": convert_skim, "TFGridNet": convert_tfgridnet}
