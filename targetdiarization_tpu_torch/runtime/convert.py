"""flax parameter trees -> the port's `state_dict`s.

The JAX package's parameters come as nested dicts of numpy arrays
(`runtime/params.py::load_checkpoint`, or a flax `init` moved to numpy).
Scanned stacks come in two layouts, both converted to the same state
dict: the shipped checkpoints' per-layer subtrees, and the stacked
subtree with a leading layer axis that the JAX model's `nn.scan` uses
(`runtime/params.py::upgrade_scan_layout` of the JAX package):
- MossFormer2: `mask_net/flash_{i}`, `mask_net/fsmn_{i}`, or
  `mask_net/layers/{flash,fsmn}`;
- Paraformer: `encoder/block_{i}` and `dec_{i}`, or
  `encoder/blocks/block` and `decoder_blocks/block`;
- SenseVoice: `encoder/block_{i}`, or `encoder/blocks/block`.

Layout rules:
- Dense kernel (in, out) -> Linear weight (out, in);
- MossFormer2 encoder Conv kernel (K, 1, N) -> conv1d weight (N, 1, K);
- MossFormer2 decoder ConvTranspose kernel (K, N, 1) -> flipped along K,
  then (N, 1, K) for conv_transpose1d (flax's transposed conv does not
  flip the kernel, PyTorch's does);
- the CIF predictor's Conv kernel (3, in, out) -> conv1d weight (out, in, 3);
- MultiHeadDotProductAttention query/key/value kernels (dim, h, hd) ->
  Linear weight (h*hd, dim), biases (h, hd) -> (h*hd,); out kernel
  (h, hd, dim) -> (dim, h*hd);
- Embed embedding -> weight; LayerNorm and GroupNorm scale -> weight;
- depthwise kernels keep the JAX layout (K, m, C);
- 2-D Conv kernel (kh, kw, in, out) -> conv2d weight (out, in, kh, kw),
  1-D Conv kernel (k, in, out) -> conv1d weight (out, in, k);
- ConvTranspose kernel (kh, kw, in, out) (flax's default
  `transpose_kernel=False`: the kernel is correlated with the
  stride-dilated input) -> flipped in both spatial axes, then
  conv_transpose2d's (in, out, kh, kw);
- BatchNorm: `params` scale/bias -> weight/bias, `batch_stats` mean/var
  -> running_mean/running_var;
- Apollo's band banks (`uni_bn_w` (79, 2 bw + 1, D), `uni_out_w`
  (79, D, 4 bw), the tail band's, their biases and norms) keep their
  layouts.
"""

from __future__ import annotations

import re
from functools import partial

import numpy as np
import torch


def flatten(tree: dict, prefix: str = "") -> dict:
    """{"a": {"b": leaf}} -> {"a/b": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


_STACKED = re.compile(r"^(.*?)layers/(flash|fsmn)/(.+)$")


def _unstack(flat: dict, pattern: re.Pattern, fmt: str) -> dict:
    """Split every leaf whose key matches `pattern` along its leading layer
    axis into keys `fmt.format(*groups[:-1], i, groups[-1])`."""
    out = {}
    for key, v in flat.items():
        m = pattern.fullmatch(key)
        if m is None:
            out[key] = v
            continue
        *head, rest = m.groups()
        for i in range(v.shape[0]):
            out[fmt.format(*head, i, rest)] = v[i]
    return out


def _unstack_layers(flat: dict) -> dict:
    """.../layers/{flash,fsmn}/... (L, ...) -> .../{flash,fsmn}_{i}/..."""
    return _unstack(flat, _STACKED, "{0}{1}_{2}/{3}")


def _to_tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _dense_rules(flat: dict, renames) -> dict:
    """Renames applied in order, then "/" -> "."; a 2-D `kernel` becomes a
    transposed Linear `weight`, `scale` and `embedding` become `weight`."""
    sd = {}
    for key, v in flat.items():
        v = np.asarray(v, np.float32)
        name = key
        for pat, rep in renames:
            name = pat.sub(rep, name)
        if name.endswith("/kernel") and v.ndim == 2:
            name, v = name[: -len("kernel")] + "weight", v.T
        name = re.sub(r"(^|/)(scale|embedding)$", r"\1weight", name)
        sd[name.replace("/", ".")] = v
    return sd


_RENAMES = (
    (re.compile(r"(^|/)(flash|fsmn)_(\d+)/"), r"\1layers/\3/\2/"),
    (re.compile(r"(^|/)dwconv/kernel$"), r"\1dwk"),
    (re.compile(r"(^|/)ddn/conv(\d+)/kernel$"), r"\1ddn/conv_kernels/\2"),
    (re.compile(r"(^|/)ddn/(in_w|in_b|prelu)(\d+)$"), r"\1ddn/\2/\3"),
    (re.compile(r"(^|/)scale$"), r"\1weight"),
)


def mossformer2_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.separation.MossFormer2` from a flax tree
    ({"params": ...} or bare), in either layer layout. The rules hold for
    any subtree too (a FlashBlock's, a GatedFsmnBlock's, ...)."""
    flat = _unstack_layers(flatten(tree.get("params", tree)))
    sd = {}
    for key, v in flat.items():
        v = np.asarray(v, np.float32)
        if key == "encoder/kernel":
            sd["encoder.weight"] = v.transpose(2, 1, 0)
            continue
        if key == "decoder/kernel":
            sd["decoder.weight"] = v[::-1].transpose(1, 2, 0)
            continue
        name = key
        for pat, rep in _RENAMES:
            name = pat.sub(rep, name)
        if name.endswith("/kernel"):  # Dense
            name = name[: -len("kernel")] + "weight"
            v = v.T
        sd[name.replace("/", ".")] = v
    return _to_tensors(sd)


_INVERSE_RENAMES = (
    (re.compile(r"^mask_net/layers/(\d+)/(flash|fsmn)/"), r"mask_net/\2_\1/"),
    (re.compile(r"/dwk$"), "/dwconv/kernel"),
    (re.compile(r"/ddn/conv_kernels/(\d+)$"), r"/ddn/conv\1/kernel"),
    (re.compile(r"/ddn/(in_w|in_b|prelu)/(\d+)$"), r"/ddn/\1\2"),
)
# MossFormer2's 1-D `weight`s that are not a flax LayerNorm's `scale`
_GLN = ("in_norm", "intra_norm")


def mossformer2_flat_params(state_dict: dict) -> dict[str, np.ndarray]:
    """The inverse of `mossformer2_state_dict`: a MossFormer2 state dict as
    the JAX package's flat `params.npz` names ("params/...") and layouts,
    in the per-layer layout (`flash_{i}`, `fsmn_{i}`) of the shipped
    checkpoints, which the JAX loader stacks for its scan."""
    flat = {}
    for key, t in state_dict.items():
        v = t.detach().float().cpu().numpy()
        name = key.replace(".", "/")
        if name == "encoder/weight":
            name, v = "encoder/kernel", v.transpose(2, 1, 0)
        elif name == "decoder/weight":
            name, v = "decoder/kernel", v.transpose(2, 0, 1)[::-1]
        else:
            for pat, rep in _INVERSE_RENAMES:
                name = pat.sub(rep, name)
            path = name.split("/")
            if path[-1] == "weight" and v.ndim == 2:
                path[-1], v = "kernel", v.T
            elif path[-1] == "weight" and path[-2] not in _GLN:
                path[-1] = "scale"
            name = "/".join(path)
        flat[f"params/{name}"] = np.ascontiguousarray(v, np.float32)
    return flat


_PARAFORMER_STACKED = re.compile(r"^(encoder/blocks|decoder_blocks)/block/(.+)$")
_PARAFORMER_RENAMES = (
    (re.compile(r"^encoder/block_(\d+)/"), r"encoder/blocks/\1/"),
    (re.compile(r"^dec_(\d+)/"), r"decoder_blocks/\1/"),
    (re.compile(r"/fsmn/kernel$"), r"/fsmn"),
)


def paraformer_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.asr.Paraformer`, from either layer layout."""
    flat = _unstack(flatten(tree.get("params", tree)), _PARAFORMER_STACKED, "{0}/{1}/{2}")
    conv = flat.pop("predictor/conv/kernel", None)
    sd = _dense_rules(flat, _PARAFORMER_RENAMES)
    if conv is not None:
        sd["predictor.conv.weight"] = np.asarray(conv, np.float32).transpose(2, 1, 0)
    return _to_tensors(sd)


def _attention_rules(flat: dict, prefix: str) -> dict:
    """MultiHeadDotProductAttention kernels under `prefix` as Linear
    layers: query/key/value (dim, h, hd) -> (h*hd, dim), biases (h, hd)
    -> (h*hd,), out (h, hd, dim) -> (dim, h*hd)."""
    out = {}
    for key in [k for k in flat if re.match(prefix, k)]:
        v = np.asarray(flat.pop(key), np.float32)
        if key.endswith("/out/kernel"):
            v = v.reshape(-1, v.shape[-1]).T
        elif key.endswith("/kernel"):
            v = v.reshape(v.shape[0], -1).T
        elif not key.endswith("/out/bias"):
            v = v.reshape(-1)
        out[key.replace("/kernel", "/weight")] = v
    flat.update(out)
    return flat


def cttransformer_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.punctuation.CTTransformerPunc`."""
    flat = _attention_rules(flatten(tree.get("params", tree)), r"^attn_\d+/")
    sd = _dense_rules(flat, ((re.compile(r"^(ln1|attn|ln2|ff1|ff2)_(\d+)/"),
                              r"layers/\2/\1/"),))
    return _to_tensors(sd)


def fsmn_vad_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.vad.FsmnVADNet`."""
    sd = _dense_rules(flatten(tree.get("params", tree)),
                      ((re.compile(r"^fsmn_(\d+)/"), r"blocks/\1/"),
                       (re.compile(r"/memory/kernel$"), r"/memory")))
    return _to_tensors(sd)


def _conv_rules(flat: dict, renames, transposed=()) -> dict:
    """`_dense_rules` for models with convolutions: Conv kernels to torch's
    layout (keys matching a pattern of `transposed` as ConvTranspose),
    then the dense rules."""
    convs, rest = {}, {}
    for key, v in flat.items():
        v = np.asarray(v, np.float32)
        if key.endswith("/kernel") and v.ndim == 4:
            if any(p.search(key) for p in transposed):
                v = v[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                v = v.transpose(3, 2, 0, 1)
        elif key.endswith("/kernel") and v.ndim == 3:
            v = v.transpose(2, 1, 0)
        else:
            rest[key] = v
            continue
        convs[key[: -len("kernel")] + "weight"] = v
    sd = _dense_rules(rest, renames)
    for key, v in convs.items():
        name = key
        for pat, rep in renames:
            name = pat.sub(rep, name)
        sd[name.replace("/", ".")] = np.ascontiguousarray(v)
    return sd


def tdfunet_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.denoise.TDFUNet`."""
    sd = _conv_rules(flatten(tree.get("params", tree)),
                     ((re.compile(r"^(enc|down|up|dec)_(\d+)/"), r"\1/\2/"),),
                     transposed=(re.compile(r"^up_\d+/"),))
    return _to_tensors(sd)


def segmentation_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.diarization.SegmentationNet`."""
    flat = _attention_rules(flatten(tree.get("params", tree)), r"^layer_\d+/attn/")
    sd = _conv_rules(flat, (
        (re.compile(r"^layer_(\d+)/"), r"layers/\1/"),
        (re.compile(r"/LayerNorm_0/"), r"/ln1/"), (re.compile(r"/LayerNorm_1/"), r"/ln2/"),
        (re.compile(r"/Dense_0/"), r"/ff1/"), (re.compile(r"/Dense_1/"), r"/ff2/"),
    ))
    return _to_tensors(sd)


_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _with_batch_stats(tree: dict) -> dict:
    """The flat `params` of a tree with `batch_stats`, the BatchNorm running
    statistics added as .../running_mean and .../running_var."""
    flat = flatten(tree["params"])
    for key, v in flatten(tree["batch_stats"]).items():
        head, leaf = key.rsplit("/", 1)
        flat[f"{head}/{_BN_STATS[leaf]}"] = v
    return flat


def eres2netv2_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.speaker.ERes2NetV2`, from a tree with both
    `params` and `batch_stats` (the BatchNorm running statistics)."""
    sd = _conv_rules(_with_batch_stats(tree), (
        (re.compile(r"^(stage\d+_block\d+)/"), r"blocks/\1/"),
        (re.compile(r"/(conv|bn)_(\d+)/"), r"/\1/\2/"),
    ))
    return _to_tensors(sd)


def campp_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.speaker.CAMPlusPlus`, from a tree with both
    `params` and `batch_stats`: the modules keep the JAX names, the FCM's
    2-D and the TDNNs' 1-D Conv kernels take torch's layouts, and the
    BatchNorms' statistics become their running averages."""
    return _to_tensors(_conv_rules(_with_batch_stats(tree), ()))


def sensevoice_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.asr.SenseVoice`, from either encoder layout
    (`encoder/block_{i}` or the stacked `encoder/blocks/block`): the SAN-M
    encoder's rules of `paraformer_state_dict`, the CTC and tag heads as
    Linear layers and `tag_queries` as stored."""
    return paraformer_state_dict(tree)


def whisper_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.whisper_style.WhisperStyleASR`: the attention
    layers' kernels as Linear layers (`_attention_rules`), the per-layer
    encoder modules `enc_<name>_<i>` and `dec_blocks_<i>` as list entries,
    the 1-D Conv kernels in torch's layout, `tok_embed` as an Embedding and
    `dec_pos` as stored."""
    flat = _attention_rules(flatten(tree.get("params", tree)),
                            r"^(enc_attn_\d+|dec_blocks_\d+/(self|cross)_attn)/")
    sd = _conv_rules(flat, ((re.compile(r"^(enc_[a-z0-9]+?|dec_blocks)_(\d+)/"), r"\1/\2/"),))
    return _to_tensors(sd)


def apollo_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.restoration.Apollo`: the modules keep the JAX
    names, Dense kernels become Linear weights, and the per-band banks
    (`uni_*`, `tail_*`), the RMSNorm weights and the depthwise kernels
    (K, 1, C) keep their layouts."""
    return _to_tensors(_dense_rules(flatten(tree.get("params", tree)), ()))


def flow_enhancer_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.enhancement.FlowEnhancer`: the modules keep the
    JAX names; `up1` and `up2` are ConvTranspose."""
    sd = _conv_rules(flatten(tree.get("params", tree)), (),
                     transposed=(re.compile(r"^up\d+/"),))
    return _to_tensors(sd)


def emotion_net_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of `models.emotion.EmotionNet`."""
    flat = _attention_rules(flatten(tree.get("params", tree)), r"^attn_\d+/")
    sd = _conv_rules(flat, ((re.compile(r"^(ln|attn)_(\d+)/"), r"\1/\2/"),))
    return _to_tensors(sd)


# ---------------- inverses of the dense rules ----------------


def _dense_flat_params(state_dict: dict, renames, keep_weight=(), scale: bool = True,
                       convs=()) -> dict[str, np.ndarray]:
    """The inverse of `_dense_rules` (and of `_to_tensors`): "." -> "/", the
    renames applied in order, a 2-D `weight` (a Linear's) back to a
    transposed `kernel` unless its module is in `keep_weight`, a 1-D
    `weight` to a flax norm's `scale` where `scale`; keys in `convs` are 1-D
    Conv weights (out, in, k) back to kernels (k, in, out)."""
    flat = {}
    for key, t in state_dict.items():
        v = t.detach().float().cpu().numpy()
        name = key.replace(".", "/")
        if key in convs:
            name, v = name[: -len("weight")] + "kernel", v.transpose(2, 1, 0)
        for pat, rep in renames:
            name = pat.sub(rep, name)
        path = name.split("/")
        if path[-1] == "weight" and v.ndim == 2 and path[-2] not in keep_weight:
            path[-1], v = "kernel", v.T
        elif path[-1] == "weight" and v.ndim == 1 and scale:
            path[-1] = "scale"
        flat["params/" + "/".join(path)] = np.ascontiguousarray(v, np.float32)
    return flat


_PARAFORMER_INVERSE = (
    (re.compile(r"^encoder/blocks/(\d+)/"), r"encoder/block_\1/"),
    (re.compile(r"^decoder_blocks/(\d+)/"), r"dec_\1/"),
    (re.compile(r"/fsmn$"), r"/fsmn/kernel"),
)


def paraformer_flat_params(state_dict: dict) -> dict[str, np.ndarray]:
    """The inverse of `paraformer_state_dict` (and of `sensevoice_state_dict`),
    in the shipped checkpoints' per-layer layout (`encoder/block_{i}`,
    `dec_{i}`)."""
    return _dense_flat_params(state_dict, _PARAFORMER_INVERSE, convs=("predictor.conv.weight",))


def fsmn_vad_flat_params(state_dict: dict) -> dict[str, np.ndarray]:
    """The inverse of `fsmn_vad_state_dict`."""
    return _dense_flat_params(state_dict, ((re.compile(r"^blocks/(\d+)/"), r"fsmn_\1/"),
                                           (re.compile(r"/memory$"), r"/memory/kernel")))


def apollo_flat_params(state_dict: dict) -> dict[str, np.ndarray]:
    """The inverse of `apollo_state_dict`: Apollo's norms are its own
    `weight`s (the banked `out_norm` 2-D), so only Linear weights change."""
    return _dense_flat_params(state_dict, (), keep_weight=("out_norm",), scale=False)


# ---------------- the separator zoo ----------------
#
# The zoo's modules keep the JAX names, so one set of layout rules serves
# all ten classes, both ways: Dense kernels are Linear weights transposed,
# Conv kernels torch's conv layouts, ConvTranspose kernels (the modules
# named in _ZOO_TRANSPOSED) flipped then transposed, LSTM `{fwd,bwd}_{wi,
# wh,bi,bh}` torch's `{weight,bias}_{ih,hh}_l0[_reverse]` (weights
# transposed), flax norms' `scale` a `weight`, and an FFConvM's depthwise
# kernel its `dwk`. ConvTasNet's depthwise kernels and every other leaf
# (gLN `w`/`b`, `gamma`/`beta`, PReLU `alpha`, the packed MHA, the grouped
# dense banks) keep name and layout.

ZOO_NAMES = ("ConvTasNet", "DPRNNTasNet", "DPTNet", "SuDORMRF", "SkiMNet", "BSRNN", "TDANet",
             "TFGridNet", "MossFormer", "AFRCNN")
_ZOO_TRANSPOSED = ("decoder", "deconv", "intra_linear", "inter_linear")
_FFCONVM = ("to_hidden", "to_qk", "to_out")
# 1-D `weight`s that are not a flax norm's `scale` (MossFormer's gLN)
_ZOO_KEEP_WEIGHT = {"MossFormer": ("in_norm",)}
_LSTM_JAX = re.compile(r"^(fwd|bwd)_(wi|wh|bi|bh)$")
_LSTM_TORCH = re.compile(r"^(weight_ih|weight_hh|bias_ih|bias_hh)_l0(_reverse)?$")
_LSTM_LEAVES = {"wi": "weight_ih", "wh": "weight_hh", "bi": "bias_ih", "bh": "bias_hh"}


def zoo_state_dict(tree: dict, name: str) -> dict[str, torch.Tensor]:
    """State dict of the zoo class `name` (`models/zoo.py`) from its flax tree."""
    if name not in ZOO_NAMES:
        raise KeyError(f"{name!r} is not a zoo class")
    sd = {}
    for key, v in flatten(tree.get("params", tree)).items():
        v = np.asarray(v, np.float32)
        path = key.split("/")
        leaf = path.pop()
        mod = path[-1] if path else ""
        lstm = _LSTM_JAX.fullmatch(leaf)
        if lstm:
            leaf = _LSTM_LEAVES[lstm[2]] + "_l0" + ("_reverse" if lstm[1] == "bwd" else "")
            v = v.T if v.ndim == 2 else v
        elif leaf == "kernel" and mod == "dwconv":
            if len(path) > 1 and path[-2] in _FFCONVM:
                path.pop()
                leaf = "dwk"
        elif leaf == "kernel":
            leaf = "weight"
            if v.ndim == 2:
                v = v.T
            elif mod in _ZOO_TRANSPOSED:
                v = v[::-1].transpose(1, 2, 0) if v.ndim == 3 else v[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                v = v.transpose(2, 1, 0) if v.ndim == 3 else v.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(path + [leaf])] = np.ascontiguousarray(v)
    return _to_tensors(sd)


def zoo_flat_params(state_dict: dict, name: str) -> dict[str, np.ndarray]:
    """The inverse of `zoo_state_dict`: a zoo model's state dict as the JAX
    package's flat `params.npz` names ("params/...") and layouts."""
    if name not in ZOO_NAMES:
        raise KeyError(f"{name!r} is not a zoo class")
    keep = _ZOO_KEEP_WEIGHT.get(name, ())
    flat = {}
    for key, t in state_dict.items():
        v = t.detach().float().cpu().numpy()
        path = key.split(".")
        leaf = path.pop()
        mod = path[-1] if path else ""
        lstm = _LSTM_TORCH.fullmatch(leaf)
        if lstm:
            short = {v_: k for k, v_ in _LSTM_LEAVES.items()}[lstm[1]]
            leaf = ("bwd_" if lstm[2] else "fwd_") + short
            v = v.T if v.ndim == 2 else v
        elif leaf == "dwk":
            path.append("dwconv")
            leaf = "kernel"
        elif leaf == "weight" and v.ndim == 1:
            leaf = "weight" if mod in keep else "scale"
        elif leaf == "weight":
            leaf = "kernel"
            if v.ndim == 2:
                v = v.T
            elif mod in _ZOO_TRANSPOSED:
                v = v.transpose(2, 0, 1)[::-1] if v.ndim == 3 else \
                    v.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                v = v.transpose(2, 1, 0) if v.ndim == 3 else v.transpose(2, 3, 1, 0)
        flat["/".join(["params", *path, leaf])] = np.ascontiguousarray(v, np.float32)
    return flat


CONVERTERS = {"MossFormer2": mossformer2_state_dict, "Paraformer": paraformer_state_dict,
              "CTTransformerPunc": cttransformer_state_dict, "FsmnVADNet": fsmn_vad_state_dict,
              "TDFUNet": tdfunet_state_dict, "SegmentationNet": segmentation_state_dict,
              "ERes2NetV2": eres2netv2_state_dict, "Apollo": apollo_state_dict,
              "FlowEnhancer": flow_enhancer_state_dict, "EmotionNet": emotion_net_state_dict,
              "CAMPlusPlus": campp_state_dict, "SenseVoice": sensevoice_state_dict,
              "WhisperStyleASR": whisper_state_dict,
              **{name: partial(zoo_state_dict, name=name) for name in ZOO_NAMES}}

# port state dict -> the JAX flat parameter names
INVERSE_CONVERTERS = {"MossFormer2": mossformer2_flat_params, "FsmnVADNet": fsmn_vad_flat_params,
                      "Apollo": apollo_flat_params, "Paraformer": paraformer_flat_params,
                      "SenseVoice": paraformer_flat_params,
                      **{name: partial(zoo_flat_params, name=name) for name in ZOO_NAMES}}
