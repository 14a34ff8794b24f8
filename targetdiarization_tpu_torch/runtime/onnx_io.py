"""Dependency-free ONNX model I/O: read and write the protobuf wire format,
evaluate the inference op subset in numpy, and load a graph's initializers
into the port's MOS estimators.

Counterpart of targetdiarization_tpu/runtime/onnx_io.py. The released
DNSMOS and SigMOS weights are `.onnx` files, and neither onnxruntime nor
the `onnx` package is installed, so the ModelProto wire format is parsed
directly (varint and length-delimited fields, the subset `protoc` emits).
The reader, the writer and the numpy evaluator are the JAX module's, byte
for byte and op for op; the evaluator stays numpy, as the oracle a
conversion is held against. `onnx_to_state_dict` maps a graph's Conv and
Gemm / MatMul initializers onto `train/mos.py::DNSMOSNet` or `SigMOSNet`:

    net = DNSMOSNet(n_out=3)
    onnx_to_state_dict(load_onnx("sig_bak_ovr.onnx"), net)
    net808 = DNSMOSNet(n_out=1)
    onnx_to_state_dict(load_onnx("model_v8.onnx"), net808)
    scores = MOSEstimator(net, net808)(audio)

Supported ops (the published MOS models' inference surface): Conv, Gemm,
MatMul, Add, Relu, Sigmoid, MaxPool, AveragePool, GlobalAveragePool,
ReduceMean, ReduceMax, Concat, Transpose, Reshape, Flatten, Squeeze,
Unsqueeze.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire format (the subset ONNX uses: varint=0, 64bit=1, bytes=2,
# 32bit=5)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message payload."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos: pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos: pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos: pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _field(fnum: int, wtype: int, payload: bytes | int) -> bytes:
    tag = _write_varint((fnum << 3) | wtype)
    if wtype == 0:
        return tag + _write_varint(payload)
    return tag + _write_varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# ONNX messages (field numbers from the public onnx.proto)
# ---------------------------------------------------------------------------

# TensorProto.data_type values
_DT_FLOAT, _DT_INT64, _DT_INT32, _DT_DOUBLE = 1, 7, 6, 11
_DT_NP = {_DT_FLOAT: np.float32, _DT_INT64: np.int64,
          _DT_INT32: np.int32, _DT_DOUBLE: np.float64}


@dataclass
class OnnxNode:
    op_type: str
    inputs: list
    outputs: list
    name: str = ""
    attrs: dict = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: list
    initializers: dict           # name -> np.ndarray
    inputs: list                 # graph input names (excluding initializers)
    outputs: list
    name: str = ""


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims, dtype, name = [], _DT_FLOAT, ""
    raw = None
    float_data, int64_data, int32_data, double_data = [], [], [], []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:  # dims
            if wtype == 0:
                dims.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif fnum == 2:
            dtype = val
        elif fnum == 4:  # float_data
            if wtype == 5:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data.extend(
                    struct.unpack(f"<{len(val)//4}f", val))
        elif fnum == 5:  # int32_data
            if wtype == 0:
                int32_data.append(val)
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int32_data.append(v)
        elif fnum == 7:  # int64_data
            if wtype == 0:
                int64_data.append(val)
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64_data.append(v)
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
        elif fnum == 10:  # double_data
            if wtype == 1:
                double_data.append(struct.unpack("<d", val)[0])
            else:
                double_data.extend(struct.unpack(f"<{len(val)//8}d", val))
    np_dt = _DT_NP.get(dtype)
    if np_dt is None:
        raise ValueError(f"tensor {name}: unsupported data_type {dtype}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dt)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    elif int32_data:
        arr = np.asarray(int32_data, np.int32)
    elif double_data:
        arr = np.asarray(double_data, np.float64)
    else:
        arr = np.zeros(0, np_dt)
    return name, arr.reshape(dims) if dims else arr


def _parse_attr(buf: bytes) -> tuple[str, object]:
    name, value = "", None
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:  # f
            value = struct.unpack("<f", val)[0]
        elif fnum == 3:  # i
            value = val
        elif fnum == 4:  # s
            value = val.decode(errors="replace")
        elif fnum == 5:  # t (tensor)
            value = _parse_tensor(val)[1]
        elif fnum == 7:  # floats
            if wtype == 5:
                value = (value or []) + [struct.unpack("<f", val)[0]]
            else:
                value = list(struct.unpack(f"<{len(val)//4}f", val))
        elif fnum == 8:  # ints
            if wtype == 0:
                value = (value or []) + [val]
            else:
                p, out = 0, []
                while p < len(val):
                    v, p = _read_varint(val, p)
                    out.append(v)
                value = (value if isinstance(value, list) else []) + out
    return name, value


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", [], [])
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            node.inputs.append(val.decode())
        elif fnum == 2:
            node.outputs.append(val.decode())
        elif fnum == 3:
            node.name = val.decode()
        elif fnum == 4:
            node.op_type = val.decode()
        elif fnum == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _value_info_name(buf: bytes) -> str:
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            return val.decode()
    return ""


def _parse_graph(buf: bytes) -> OnnxGraph:
    g = OnnxGraph([], {}, [], [])
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(val))
        elif fnum == 2:
            g.name = val.decode()
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            g.initializers[name] = arr
        elif fnum == 11:
            g.inputs.append(_value_info_name(val))
        elif fnum == 12:
            g.outputs.append(_value_info_name(val))
    g.inputs = [n for n in g.inputs if n not in g.initializers]
    return g


def load_onnx(path_or_bytes) -> OnnxGraph:
    """Parse a .onnx file (ModelProto) into an OnnxGraph."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 7:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError("no graph found in ONNX model")


# ---------------------------------------------------------------------------
# writer (enough to build fixtures / re-serialize converted graphs)
# ---------------------------------------------------------------------------


def _ser_tensor(name: str, arr: np.ndarray) -> bytes:
    dt = {np.dtype(np.float32): _DT_FLOAT, np.dtype(np.int64): _DT_INT64,
          np.dtype(np.int32): _DT_INT32,
          np.dtype(np.float64): _DT_DOUBLE}[arr.dtype]
    out = b"".join(_field(1, 0, int(d)) for d in arr.shape)
    out += _field(2, 0, dt)
    out += _field(8, 2, name.encode())
    out += _field(9, 2, np.ascontiguousarray(arr).tobytes())
    return out


def _ser_attr(name: str, value) -> bytes:
    out = _field(1, 2, name.encode())
    if isinstance(value, float):
        out += _field(2, 5, struct.pack("<f", value)) + _field(20, 0, 1)
    elif isinstance(value, int):
        out += _field(3, 0, value) + _field(20, 0, 2)
    elif isinstance(value, str):
        out += _field(4, 2, value.encode()) + _field(20, 0, 3)
    elif isinstance(value, (list, tuple)):
        for v in value:
            out += _field(8, 0, int(v))
        out += _field(20, 0, 7)  # INTS
    else:
        raise TypeError(f"attr {name}: {type(value)}")
    return out


def _ser_node(node: OnnxNode) -> bytes:
    out = b"".join(_field(1, 2, s.encode()) for s in node.inputs)
    out += b"".join(_field(2, 2, s.encode()) for s in node.outputs)
    if node.name:
        out += _field(3, 2, node.name.encode())
    out += _field(4, 2, node.op_type.encode())
    for k, v in node.attrs.items():
        out += _field(5, 2, _ser_attr(k, v))
    return out


def save_onnx(graph: OnnxGraph, path: str | None = None) -> bytes:
    """Serialize an OnnxGraph into ModelProto bytes (IR v7, opset 13)."""
    g = b"".join(_field(1, 2, _ser_node(n)) for n in graph.nodes)
    g += _field(2, 2, (graph.name or "graph").encode())
    for name, arr in graph.initializers.items():
        g += _field(5, 2, _ser_tensor(name, arr))
    for name in graph.inputs:
        g += _field(11, 2, _field(1, 2, name.encode()))
    for name in graph.outputs:
        g += _field(12, 2, _field(1, 2, name.encode()))
    model = _field(1, 0, 7)  # ir_version
    model += _field(8, 2, _field(2, 0, 13))  # opset_import {version: 13}
    model += _field(7, 2, g)
    if path is not None:
        with open(path, "wb") as f:
            f.write(model)
    return model


# ---------------------------------------------------------------------------
# numpy evaluator (onnxruntime-free oracle)
# ---------------------------------------------------------------------------


def _conv2d_nchw(x, w, b, pads, strides):
    bsz, cin, h, wid = x.shape
    cout, _cin, kh, kw = w.shape
    pt, pl, pb, pr = pads
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    sh, sw = strides
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    s = xp.strides
    win = np.lib.stride_tricks.as_strided(
        xp, (bsz, cin, oh, ow, kh, kw),
        (s[0], s[1], s[2] * sh, s[3] * sw, s[2], s[3]), writeable=False)
    out = np.einsum("bchwij,ocij->bohw", win, w, optimize=True)
    if b is not None:
        out = out + b[None, :, None, None]
    return out.astype(np.float32)


def _pool2d_nchw(x, kernel, strides, mode):
    kh, kw = kernel
    sh, sw = strides
    bsz, c, h, w = x.shape
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    s = x.strides
    win = np.lib.stride_tricks.as_strided(
        x, (bsz, c, oh, ow, kh, kw),
        (s[0], s[1], s[2] * sh, s[3] * sw, s[2], s[3]), writeable=False)
    return (win.max((-2, -1)) if mode == "max"
            else win.mean((-2, -1))).astype(np.float32)


def evaluate_onnx(graph: OnnxGraph, inputs: dict) -> dict:
    """Run the graph in numpy; returns {output_name: array}."""
    env = dict(graph.initializers)
    env.update(inputs)
    for node in graph.nodes:
        x = [env[n] if n else None for n in node.inputs]
        a = node.attrs
        op = node.op_type
        if op == "Conv":
            pads = a.get("pads", [0, 0, 0, 0])
            out = _conv2d_nchw(x[0], x[1], x[2] if len(x) > 2 else None,
                               (pads[0], pads[1], pads[2], pads[3]),
                               a.get("strides", [1, 1]))
        elif op == "Relu":
            out = np.maximum(x[0], 0)
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-x[0]))
        elif op == "MaxPool":
            out = _pool2d_nchw(x[0], a["kernel_shape"],
                               a.get("strides", a["kernel_shape"]), "max")
        elif op == "AveragePool":
            out = _pool2d_nchw(x[0], a["kernel_shape"],
                               a.get("strides", a["kernel_shape"]), "avg")
        elif op == "GlobalAveragePool":
            out = x[0].mean(axis=(2, 3), keepdims=True)
        elif op == "ReduceMean":
            out = x[0].mean(axis=tuple(a["axes"]),
                            keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceMax":
            out = x[0].max(axis=tuple(a["axes"]),
                           keepdims=bool(a.get("keepdims", 1)))
        elif op == "Gemm":
            w = x[1].T if a.get("transB", 0) else x[1]
            m = x[0].T if a.get("transA", 0) else x[0]
            out = m @ w * a.get("alpha", 1.0)
            if len(x) > 2 and x[2] is not None:
                out = out + a.get("beta", 1.0) * x[2]
        elif op == "MatMul":
            out = x[0] @ x[1]
        elif op == "Add":
            out = x[0] + x[1]
        elif op == "Concat":
            out = np.concatenate(x, axis=a["axis"])
        elif op == "Transpose":
            out = np.transpose(x[0], a["perm"])
        elif op == "Reshape":
            out = x[0].reshape([int(v) for v in x[1]])
        elif op == "Flatten":
            ax = a.get("axis", 1)
            out = x[0].reshape(int(np.prod(x[0].shape[:ax])), -1)
        elif op == "Squeeze":
            out = np.squeeze(x[0], axis=tuple(a["axes"]))
        elif op == "Unsqueeze":
            out = x[0]
            for ax in sorted(a["axes"]):
                out = np.expand_dims(out, ax)
        else:
            raise NotImplementedError(f"op {op}")
        env[node.outputs[0]] = np.asarray(out, np.float32)
    return {n: env[n] for n in graph.outputs}


# ---------------------------------------------------------------------------
# initializers -> the port's modules
# ---------------------------------------------------------------------------


def onnx_to_state_dict(graph: OnnxGraph, model) -> dict:
    """Load an ONNX model's Conv / Gemm / MatMul weights into `model` (a
    `DNSMOSNet` or `SigMOSNet`, strictly) and return its state dict.

    Counterpart of the JAX package's `onnx_to_flax_params`, with the same
    structural matching: the graph's Conv nodes, in graph order, map onto
    the model's Conv2d modules in name order, its Gemm / MatMul nodes with
    an initializer weight onto the Linear modules in name order with `head`
    last. Conv weights are OIHW in both; a Gemm's weight is (out, in) under
    `transB` and (in, out) otherwise, a MatMul's (in, out). A module that a
    node without bias fills keeps its bias. Raises `ValueError` when the
    graph's counts and the model's differ."""
    import torch
    from torch import nn

    mods = dict(model.named_children())
    conv_mods = sorted(k for k, m in mods.items() if isinstance(m, nn.Conv2d))
    dense_mods = sorted((k for k, m in mods.items() if isinstance(m, nn.Linear)),
                        key=lambda k: (k == "head", k))
    sd = {k: v.detach().cpu().float().clone() for k, v in model.state_dict().items()}
    ci = di = 0
    for node in graph.nodes:
        if node.op_type == "Conv":
            if ci == len(conv_mods):
                ci += 1
                break
            mod = conv_mods[ci]
            ci += 1
            sd[f"{mod}.weight"] = torch.from_numpy(
                np.array(graph.initializers[node.inputs[1]], np.float32))
            if len(node.inputs) > 2:
                sd[f"{mod}.bias"] = torch.from_numpy(
                    np.array(graph.initializers[node.inputs[2]], np.float32))
        elif node.op_type in ("Gemm", "MatMul"):
            w = graph.initializers.get(node.inputs[1])
            if w is None:
                continue
            if di == len(dense_mods):
                di += 1
                break
            mod = dense_mods[di]
            di += 1
            if not (node.op_type == "Gemm" and node.attrs.get("transB", 0)):
                w = w.T  # (in, out) -> (out, in)
            sd[f"{mod}.weight"] = torch.from_numpy(np.array(w, np.float32))
            if node.op_type == "Gemm" and len(node.inputs) > 2:
                sd[f"{mod}.bias"] = torch.from_numpy(
                    np.array(graph.initializers[node.inputs[2]], np.float32))
    if ci != len(conv_mods) or di != len(dense_mods):
        raise ValueError(f"graph/model mismatch: used {ci}/{len(conv_mods)} convs, "
                         f"{di}/{len(dense_mods)} denses")
    model.load_state_dict(sd, strict=True)
    return sd
