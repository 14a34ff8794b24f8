"""Shared cases of the reference-checkpoint rules' parity tests
(`test_torch_port_rules*.py`).

The reference modules themselves need a source tree this repository does
not hold, so both packages' rules read the same seeded reference-layout
state dict (`tools/reference_layout.py`) at the tiny geometries of
tests/test_convert.py. Per case, built once a worker: the JAX rules' tree,
the JAX model's forward of it on one seeded batch (jitted, at full float32
matmul precision), and the port's rules.
"""

import functools

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import torch

from targetdiarization_tpu.models import zoo as jzoo
from targetdiarization_tpu.models.restoration import Apollo as JaxApollo
from targetdiarization_tpu.models.separation import MossFormer2 as JaxMossFormer2
from targetdiarization_tpu.runtime import port_rules as jax_rules
from targetdiarization_tpu.runtime.convert import verify_tree_shapes
from targetdiarization_tpu_torch.runtime import port_rules
from targetdiarization_tpu_torch.runtime.convert import CONVERTERS
from targetdiarization_tpu_torch.runtime.registry import get_model_cls
from targetdiarization_tpu_torch.tools.reference_layout import reference_state_dict

# case -> (JAX class, port class name, model args, samples) as tests/test_convert.py
CASES = {
    "MossFormer2": (JaxMossFormer2, "MossFormer2",
                    dict(dim=32, enc_channels=32, num_blocks=2, group_size=256, qk_dim=128,
                         fsmn_inner=256), (256 - 1) * 8 + 16),
    "Apollo": (JaxApollo, "Apollo", dict(sr=16000, win_ms=20, feature_dim=32, layer=1), 3200),
    "ConvTasNet": (jzoo.ConvTasNet, "ConvTasNet",
                   dict(enc_channels=16, bottleneck=8, hidden=16, kernel_size=16, n_blocks=2,
                        n_repeats=2, num_spks=2), 1600),
    "DPRNNTasNet": (jzoo.DPRNNTasNet, "DPRNNTasNet",
                    dict(enc_channels=16, dim=12, hidden=20, kernel_size=8, chunk=20,
                         n_layers=2, num_spks=2, bidirectional=True), 1600),
    "DPTNet": (jzoo.DPTNet, "DPTNet",
               dict(enc_channels=16, hidden=20, heads=4, kernel_size=16, stride=8, chunk=20,
                    n_layers=2, num_spks=2, bidirectional=True), 1600),
    "BSRNN": (jzoo.BSRNN, "BSRNN",
              dict(sample_rate=16000, win=2048, stride=512, feature_dim=8, num_repeat=1,
                   num_output=2, num_spks=2), 4096),
    "SuDORMRF": (jzoo.SuDORMRF, "SuDORMRF",
                 dict(out_channels=8, in_channels=16, num_blocks=2, upsampling_depth=2,
                      enc_kernel_size=5, enc_num_basis=16, num_sources=2), 1600),
    "AFRCNN": (jzoo.AFRCNN, "AFRCNN",
               dict(out_channels=8, in_channels=16, num_blocks=3, upsampling_depth=2,
                    enc_kernel_size=5, enc_num_basis=16, num_sources=2), 1600),
    "TDANet": (jzoo.TDANet, "TDANet",
               dict(out_channels=8, in_channels=16, num_blocks=2, upsampling_depth=2,
                    enc_kernel_size=2, num_sources=2), 1600),
    "SkiMNet causal": (jzoo.SkiMNet, "SkiMNet",
                       dict(enc_channels=8, hidden=8, kernel_size=4, chunk=10, n_layers=2,
                            num_spks=2, causal=True, nonlinear="relu", mem_type="hc",
                            seg_overlap=False), 804),
    "SkiMNet bidirectional overlap": (jzoo.SkiMNet, "SkiMNet",
                                      dict(enc_channels=8, hidden=8, kernel_size=4, chunk=10,
                                           n_layers=2, num_spks=2, causal=False,
                                           nonlinear="relu", mem_type="hc", seg_overlap=True),
                                      804),
    "TFGridNet unfold/deconv": (jzoo.TFGridNet, "TFGridNet",
                                dict(n_srcs=2, n_fft=32, stride=16, n_layers=2,
                                     lstm_hidden_units=8, attn_n_head=2, attn_approx_qk_dim=16,
                                     emb_dim=8, emb_ks=4, emb_hs=1), 803),
    "TFGridNet view/linear": (jzoo.TFGridNet, "TFGridNet",
                              dict(n_srcs=2, n_fft=32, stride=16, n_layers=2,
                                   lstm_hidden_units=8, attn_n_head=2, attn_approx_qk_dim=16,
                                   emb_dim=8, emb_ks=2, emb_hs=2), 803),
}
JAX_RULES = {"MossFormer2": jax_rules.convert_mossformer2, "Apollo": jax_rules.convert_apollo,
             "ConvTasNet": jax_rules.convert_convtasnet, "DPRNNTasNet": jax_rules.convert_dprnn,
             "DPTNet": jax_rules.convert_dptnet, "BSRNN": jax_rules.convert_bsrnn,
             "SuDORMRF": jax_rules.convert_sudormrf, "AFRCNN": jax_rules.convert_afrcnn,
             "TDANet": jax_rules.convert_tdanet, "SkiMNet": jax_rules.convert_skim,
             "TFGridNet": jax_rules.convert_tfgridnet}
RTOL = 1e-4  # of the output's peak, float32


def _seed(case: str) -> int:
    return list(CASES).index(case)


@functools.lru_cache(maxsize=None)
def jax_case(case: str) -> dict:
    """The seeded reference dict, the JAX rules' tree and the JAX forward."""
    cls, name, args, t = CASES[case]
    sd = reference_state_dict(name, args, seed=_seed(case))
    tree = JAX_RULES[name](sd)
    module = cls(**args)
    wav = (np.random.default_rng(100 + _seed(case)).standard_normal((2, t)) * 0.1
           ).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        out = np.asarray(jax.jit(module.apply)(jtu.tree_map(jnp.asarray, tree),
                                               jnp.asarray(wav)))
    return {"name": name, "args": args, "sd": sd, "tree": tree, "module": module, "wav": wav,
            "out": out}


def check_tree(case: str) -> None:
    """The dict passes the JAX rules with no unhandled key, and their tree
    is the JAX model's `init` tree, path for path and shape for shape."""
    c = jax_case(case)
    t = c["wav"].shape[1]
    template = jax.eval_shape(c["module"].init, jax.random.PRNGKey(0), jnp.zeros((2, t)))
    paths = {jtu.keystr(p) for p, _ in jtu.tree_leaves_with_path(template)}
    assert paths == {jtu.keystr(p) for p, _ in jtu.tree_leaves_with_path(c["tree"])}
    assert len(verify_tree_shapes(c["tree"], template)) == len(paths)


def port_state_dict(case: str) -> dict:
    c = jax_case(case)
    return port_rules.RULES[c["name"]](c["sd"])


def check_state_dict(case: str) -> None:
    """The port's rules give, to the bit, `CONVERTERS[name]` of the JAX
    rules' tree, and it loads strictly into the port class."""
    c = jax_case(case)
    got = port_state_dict(case)
    want = CONVERTERS[c["name"]](jtu.tree_map(np.asarray, c["tree"]))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    get_model_cls(c["name"])(**c["args"]).load_state_dict(got, strict=True)


def check_forward(case: str) -> None:
    """The port class from the port's rules, on the JAX forward's batch,
    within RTOL of the output's peak."""
    c = jax_case(case)
    model = get_model_cls(c["name"])(**c["args"])
    model.load_state_dict(port_state_dict(case), strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(c["wav"])).numpy()
    assert got.shape == c["out"].shape
    err = np.abs(got - c["out"]).max() / np.abs(c["out"]).max()
    assert err <= RTOL, (case, err)


def check_strict(case: str) -> None:
    """A reference key no rule reads raises KeyError in both packages."""
    import pytest

    c = jax_case(case)
    sd = dict(c["sd"], **{"unexpected.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unhandled keys"):
        JAX_RULES[c["name"]](sd)
    with pytest.raises(KeyError, match="unhandled keys"):
        port_rules.RULES[c["name"]](sd)
