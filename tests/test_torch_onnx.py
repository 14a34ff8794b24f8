"""The port's ONNX route for the MOS estimators (`runtime/onnx_io.py`)
against the JAX package's, on synthetic graphs in the released DNSMOS and
SigMOS layouts (`tools/reference_layout.py::dnsmos_graph`, `sigmos_graph`).

The writer's bytes equal the JAX writer's, each package reads the other's
bytes, the numpy evaluators agree to the bit, the port's `DNSMOSNet` and
`SigMOSNet` loaded by `onnx_to_state_dict` score within 2e-4 of
`evaluate_onnx` and within 1e-4 of the JAX nets fed `onnx_to_flax_params`,
`MOSEstimator` scores finite values from converted nets, and a graph with a
Conv too many raises in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.runtime import onnx_io as jax_onnx
from targetdiarization_tpu.train import mos as jax_mos
from targetdiarization_tpu_torch.runtime import onnx_io
from targetdiarization_tpu_torch.tools.reference_layout import dnsmos_graph, sigmos_graph
from targetdiarization_tpu_torch.train import mos

torch.set_num_threads(2)  # beside the other test workers' threads

# (graph builder, net, n_out, ch, input shape) at a small width
GRAPHS = {"dnsmos": (dnsmos_graph, "DNSMOSNet", 3, 8, (2, 1, 24, 120)),
          "p808": (dnsmos_graph, "DNSMOSNet", 1, 8, (2, 1, 24, 120)),
          "sigmos": (sigmos_graph, "SigMOSNet", 7, 8, (1, 3, 20, 481))}


def _case(key: str, seed: int):
    build, net, n_out, ch, shape = GRAPHS[key]
    rng = np.random.default_rng(seed)
    graph = build(rng, ch=ch, n_out=n_out)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return graph, net, n_out, ch, x


def _same_graph(a, b) -> None:
    """`a`, read from bytes, holds `b` (the writer names an unnamed graph)."""
    assert (a.name, a.inputs, a.outputs) == (b.name or "graph", b.inputs, b.outputs)
    assert [(n.op_type, n.inputs, n.outputs, n.name, n.attrs) for n in a.nodes] == \
        [(n.op_type, n.inputs, n.outputs, n.name, n.attrs) for n in b.nodes]
    assert list(a.initializers) == list(b.initializers)
    for name, arr in a.initializers.items():
        assert arr.dtype == b.initializers[name].dtype
        np.testing.assert_array_equal(arr, b.initializers[name])


@pytest.mark.parametrize("key", list(GRAPHS))
def test_writer_bytes_equal_the_jax_writers(key, tmp_path):
    graph = _case(key, 1)[0]
    path = str(tmp_path / "model.onnx")
    ours = onnx_io.save_onnx(graph, path)
    assert ours == jax_onnx.save_onnx(graph)
    with open(path, "rb") as f:
        assert f.read() == ours


@pytest.mark.parametrize("key", list(GRAPHS))
def test_each_package_reads_the_others_bytes(key):
    graph = _case(key, 2)[0]
    _same_graph(onnx_io.load_onnx(jax_onnx.save_onnx(graph)), graph)
    _same_graph(jax_onnx.load_onnx(onnx_io.save_onnx(graph)), graph)
    _same_graph(onnx_io.load_onnx(bytearray(onnx_io.save_onnx(graph))), graph)


@pytest.mark.parametrize("key", list(GRAPHS))
def test_evaluator_equals_the_jax_evaluator(key):
    graph, _, _, _, x = _case(key, 3)
    ours = onnx_io.evaluate_onnx(graph, {"input_1": x})
    theirs = jax_onnx.evaluate_onnx(graph, {"input_1": x})
    assert list(ours) == list(theirs) == ["output_1"]
    np.testing.assert_array_equal(ours["output_1"], theirs["output_1"])


@pytest.mark.parametrize("key", list(GRAPHS))
def test_converted_net_matches_graph_and_jax_net(key):
    graph, net_name, n_out, ch, x = _case(key, 4)
    graph = onnx_io.load_onnx(onnx_io.save_onnx(graph))
    want = onnx_io.evaluate_onnx(graph, {"input_1": x})["output_1"]
    net = getattr(mos, net_name)(n_out=n_out, ch=ch)
    sd = onnx_io.onnx_to_state_dict(graph, net)
    assert set(sd) == set(net.state_dict())
    inp = x[:, 0] if net_name == "DNSMOSNet" else x  # DNSMOSNet takes (B, T, 120)
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(inp)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    jnet = getattr(jax_mos, net_name)(n_out=n_out, ch=ch)
    template = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(inp))
    params = jax_onnx.onnx_to_flax_params(graph, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), template))
    with jax.default_matmul_precision("highest"):
        jout = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(inp)))
    err = np.abs(got - jout).max() / np.abs(jout).max()
    assert err <= 1e-4, err


def test_mos_estimator_scores_from_converted_nets():
    """The drop-in path of the released DNSMOS weights: both nets at the
    class width from ONNX bytes, then `MOSEstimator` on 10 s of audio."""
    rng = np.random.default_rng(5)
    net, net808 = mos.DNSMOSNet(n_out=3), mos.DNSMOSNet(n_out=1)
    onnx_io.onnx_to_state_dict(onnx_io.load_onnx(onnx_io.save_onnx(dnsmos_graph(rng, n_out=3))),
                               net)
    onnx_io.onnx_to_state_dict(onnx_io.load_onnx(onnx_io.save_onnx(dnsmos_graph(rng, n_out=1))),
                               net808)
    est = mos.MOSEstimator(net, net808, device="cpu")
    out = est((rng.standard_normal(16000 * 10) * 0.1).astype(np.float32))
    for k in ("OVRL", "SIG", "BAK", "P808_MOS"):
        assert np.isfinite(out[k]), (k, out)


def test_a_conv_too_many_raises_in_both():
    graph = _case("dnsmos", 6)[0]
    extra = onnx_io.OnnxNode("Conv", ["pool3", "conv3_w", "conv3_b"], ["extra"], name="extra")
    graph.nodes.insert([n.name for n in graph.nodes].index("gap"), extra)
    with pytest.raises(ValueError, match="mismatch"):
        onnx_io.onnx_to_state_dict(graph, mos.DNSMOSNet(n_out=3, ch=8))
    template = jax.eval_shape(jax_mos.DNSMOSNet(n_out=3, ch=8).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 24, 120)))
    with pytest.raises(IndexError):
        jax_onnx.onnx_to_flax_params(graph, jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), template))
