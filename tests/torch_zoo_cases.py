"""Shared cases of the zoo's parity tests (`test_torch_zoo_*.py`).

The small configurations of tests/test_zoo.py (copied), one flax parameter
tree per class (`seeded_params`), and the JAX package's outputs on one
seeded 2000-sample batch: float32 without and with `lengths` (rows of 2000
and 1500 samples), and the JAX bf16 mode (params and input cast to bf16,
`lengths` given, as its engine runs). JAX runs at full float32 matmul
precision; each case is computed once a worker.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from targetdiarization_tpu.models import zoo as jzoo
from targetdiarization_tpu.runtime.precision import cast_params
from targetdiarization_tpu_torch.models import zoo as tzoo
from targetdiarization_tpu_torch.runtime.convert import INVERSE_CONVERTERS, zoo_state_dict
from targetdiarization_tpu_torch.runtime.precision import promote_after

TINY = {
    "ConvTasNet": dict(enc_channels=32, bottleneck=16, hidden=32,
                       n_blocks=2, n_repeats=1),
    "DPRNNTasNet": dict(enc_channels=16, dim=16, hidden=16, chunk=20,
                        n_layers=1),
    "DPTNet": dict(enc_channels=16, hidden=16, chunk=20, n_layers=1),
    "SkiMNet": dict(enc_channels=16, hidden=16, chunk=20, n_layers=2),
    "SuDORMRF": dict(out_channels=8, in_channels=16, num_blocks=1,
                     upsampling_depth=2, enc_kernel_size=5, enc_num_basis=16),
    "TDANet": dict(out_channels=8, in_channels=16, num_blocks=2,
                   upsampling_depth=2, enc_kernel_size=2),
    "BSRNN": dict(sample_rate=16000, win=2048, stride=512, feature_dim=8,
                  num_repeat=1, num_output=2, num_spks=2),
    "TFGridNet": dict(n_fft=32, stride=16, emb_dim=8, n_layers=1,
                      lstm_hidden_units=8, attn_n_head=2,
                      attn_approx_qk_dim=16),
    "MossFormer": dict(dim=32, enc_channels=32, num_blocks=1, group_size=64,
                       qk_dim=32),
    "AFRCNN": dict(out_channels=8, in_channels=16, num_blocks=2,
                   upsampling_depth=2, enc_kernel_size=5, enc_num_basis=16),
}
T = 2000
LENGTHS = np.array([T, 1500])
RTOL = 1e-4  # of the output's peak, float32
# bf16: the port's bf16 run lies within BF16_MARGIN times the JAX bf16
# mode's own departure from its float32 run (max over the output), and its
# departure from that float32 run points the JAX mode's way: the two
# departures' correlation is at least BF16_CORR. The first bound alone
# would pass a port that stayed in float32. Readings with each class's
# `reduced_modules()`: max err / departure ConvTasNet 1.25, MossFormer 0.75,
# TDANet 0.68, AFRCNN 0.60, SuDORMRF 0.44, TFGridNet 0.18, DPRNNTasNet
# 0.02, the rest 0; correlation MossFormer 0.67, ConvTasNet 0.77, TDANet
# 0.83, SuDORMRF 0.87, AFRCNN 0.89, the rest 1.00. The same classes run in
# float32 from unrounded weights, the estimate rounded to bf16: -0.05 to
# 0.08.
BF16_MARGIN = 1.5
BF16_CORR = 0.5

_BIASES = ("bias", "b", "beta", "os_beta", "in_b", "out_b")


def seeded_params(module, wav, seed: int = 0):
    """A parameter tree of `module` for input `wav`, drawn with numpy at the
    JAX initializers' scales plus 0.05 noise (no bias zero, no scale one):
    kernels normal over sqrt(fan-in) (flax's lecun_normal: every axis but
    the last), norm scales 1, PReLU slopes 0.25, biases 0. Only the shapes
    come from JAX (`eval_shape`), so no init program is compiled."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(seed), jnp.asarray(wav))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        noise = 0.05 * rng.standard_normal(shape)
        if name == "alpha":
            v = 0.25 + noise
        elif name == "os_gamma":
            v = 0.02 * rng.standard_normal(shape)
        elif name in _BIASES or name.endswith(("_bi", "_bh")):
            v = noise
        elif name in ("scale", "gamma", "g") or name in ("w", "weight") and len(shape) == 1:
            v = 1.0 + noise
        else:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1])) + noise
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def jax_case(name: str) -> dict:
    module = getattr(jzoo, name)(**TINY[name])
    wav = (np.random.default_rng(1).standard_normal((2, T)) * 0.1).astype(np.float32)
    params = seeded_params(module, wav)
    apply = jax.jit(module.apply)
    with jax.default_matmul_precision("highest"):
        f32 = np.asarray(apply(params, jnp.asarray(wav)))
        f32_len = np.asarray(apply(params, jnp.asarray(wav), jnp.asarray(LENGTHS)))
        bf16 = apply(cast_params(params, jnp.bfloat16), jnp.asarray(wav, jnp.bfloat16),
                     jnp.asarray(LENGTHS))
    return {"module": module, "params": params, "wav": wav, "f32": f32, "f32_len": f32_len,
            "bf16_len": np.asarray(bf16.astype(jnp.bfloat16).astype(jnp.float32))}


def port_model(name: str, params) -> torch.nn.Module:
    model = getattr(tzoo, name)(**TINY[name])
    model.load_state_dict(zoo_state_dict(params, name), strict=True)
    return model.eval()


def port_forward(model, wav, lengths=None, dtype=torch.float32) -> np.ndarray:
    with torch.inference_mode():
        x = torch.from_numpy(wav).to(dtype)
        lens = None if lengths is None else torch.from_numpy(np.asarray(lengths))
        return model(x, lens).to(dtype).float().numpy()


def check_forward(name: str, with_lengths: bool) -> None:
    c = jax_case(name)
    want = c["f32_len"] if with_lengths else c["f32"]
    got = port_forward(port_model(name, c["params"]), c["wav"],
                       LENGTHS if with_lengths else None)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL, (name, err)


def check_bf16(name: str) -> None:
    """The port's bf16 mode (the engine's: `reduced_modules()` in bf16, the
    rest in float32 from bf16-rounded weights, bf16 input, the estimate
    rounded to bf16) against the JAX bf16 mode."""
    c = jax_case(name)
    model = port_model(name, c["params"])
    promote_after(model, model.reduced_modules(), torch.bfloat16)
    got = port_forward(model, c["wav"], LENGTHS, torch.bfloat16)
    peak = np.abs(c["f32_len"]).max()
    theirs, ours = c["bf16_len"] - c["f32_len"], got - c["f32_len"]
    departure = np.abs(theirs).max() / peak
    err = np.abs(got - c["bf16_len"]).max() / peak
    assert err <= BF16_MARGIN * departure, (name, err, departure)
    corr = np.sum(ours * theirs) / np.sqrt(np.sum(ours ** 2) * np.sum(theirs ** 2))
    assert corr >= BF16_CORR, (name, corr)


def check_checkpoint(name: str, tmp_path) -> None:
    """A checkpoint the JAX package wrote loads with strict=True and gives
    the forward of the converted tree."""
    from targetdiarization_tpu.runtime.params import save_checkpoint
    from targetdiarization_tpu_torch.runtime.registry import from_pretrained

    c = jax_case(name)
    path = os.path.join(str(tmp_path), name)
    save_checkpoint(path, c["params"], name, TINY[name])
    loaded = from_pretrained(path)
    assert type(loaded).__name__ == name
    np.testing.assert_array_equal(port_forward(loaded, c["wav"], LENGTHS),
                                  port_forward(port_model(name, c["params"]), c["wav"], LENGTHS))


def check_inverse(name: str) -> None:
    """The inverse converter gives back the JAX init's flat names, shapes
    and values."""
    from targetdiarization_tpu_torch.runtime.convert import flatten

    c = jax_case(name)
    want = {f"params/{k}": v for k, v in flatten(c["params"]["params"]).items()}
    got = INVERSE_CONVERTERS[name](port_model(name, c["params"]).state_dict())
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v.astype(np.float32), err_msg=k)
