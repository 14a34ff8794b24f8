"""`bootstrap_enhancer` and `bootstrap_denoiser` against the JAX recipes, on
the CPU.

Each JAX recipe runs once per module (`tests/torch_recipe_cases.py::
run_both`), then the port's from the same initial parameters.

- The enhancer: FlowEnhancer 16 wide, 3 steps of 2 x 0.5 s. The JAX step
  draws its flow times and prior noise from jax.random inside the jitted
  step; the port draws them from a torch.Generator (`recipes_plain.
  _flow_draws`), which is handed JAX's draws for the same keys here
  (PRNGKey(seed + 7), split a step, then into the times' key and the
  noise's). The eval's `enhance` runs at tau 0 (no prior noise, which each
  package draws from its own generator) and at most 2 solver steps in both
  packages, to keep the CPU time small.
- The denoiser: TDFUNet 8/3/4 as shipped, 2 steps of 1 chunk, with both
  packages' MDX time frames `DIM_T` cut from 256 to 32 (a chunk of 31 hops
  of 1024 samples at 44.1 kHz, not 255).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_recipe_cases as cases
from targetdiarization_tpu.models import denoise as jdenoise
from targetdiarization_tpu.models import enhancement as jenhancement
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu_torch.models import denoise as tdenoise
from targetdiarization_tpu_torch.models import enhancement as tenhancement
from targetdiarization_tpu_torch.runtime.convert import CONVERTERS, INVERSE_CONVERTERS
from targetdiarization_tpu_torch.runtime.params import unflatten
from targetdiarization_tpu_torch.runtime.registry import from_pretrained
from targetdiarization_tpu_torch.train import recipes_plain

torch.set_num_threads(2)

ENH_SIZE = dict(steps=3, batch=2, seconds=0.5, ch=16)
DEN_SIZE = dict(steps=2, batch=1)
DIM_T = 32


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _enhancer_init():
    n = int(ENH_SIZE["seconds"] * 16000)
    frames, nf = n // jenhancement.HOP + 1, jenhancement.N_FFT // 2 + 1
    model = jenhancement.FlowEnhancer(ch=ENH_SIZE["ch"])
    tree = jax.jit(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, frames, nf)),
                                      jnp.zeros((1,)), jnp.zeros((1, frames, nf))))()
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_flow_draws(seed: int):
    """The port's `_flow_draws` giving the JAX recipe's draws, step by step."""
    state = {"key": jax.random.PRNGKey(seed + 7)}

    def draws(gen, b, shape):
        state["key"], sub = jax.random.split(state["key"])
        k1, k2 = jax.random.split(sub)
        t = jax.random.uniform(k1, (b,))
        return (torch.from_numpy(np.array(t)),
                torch.from_numpy(np.array(jax.random.normal(k2, shape))))

    return draws


def _few_steps_without_noise(cls):
    """`cls.enhance` at tau 0 and at most 2 solver steps."""
    orig = cls.enhance

    def enhance(self, audio, sr=16000, nfe=64, **kwargs):
        return orig(self, audio, sr=sr, nfe=min(nfe, 2), tau=0.0)

    return enhance


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return cases.fixture_dir(str(tmp_path_factory.mktemp("assets")))


@pytest.fixture(scope="module")
def enh_run(assets, tmp_path_factory):
    patches = ((recipes_plain, "_flow_draws", _jax_flow_draws(0)),
               (jenhancement.EnhancerEngine, "enhance",
                _few_steps_without_noise(jenhancement.EnhancerEngine)),
               (tenhancement.EnhancerEngine, "enhance",
                _few_steps_without_noise(tenhancement.EnhancerEngine)))
    return cases.run_both(str(tmp_path_factory.mktemp("enh")), assets, "bootstrap_enhancer",
                          ENH_SIZE, ENH_SIZE, jax_init=_enhancer_init, patches=patches)


@pytest.fixture(scope="module")
def den_run(assets, tmp_path_factory):
    patches = ((jdenoise, "DIM_T", DIM_T), (tdenoise, "DIM_T", DIM_T))
    return cases.run_both(str(tmp_path_factory.mktemp("den")), assets, "bootstrap_denoiser",
                          DEN_SIZE, DEN_SIZE, jax_cls=jdenoise.TDFUNet, patches=patches)


def test_enhancer_steps_match_jax(enh_run):
    """Every step's flow-matching loss within 1e-4 of JAX's on JAX's draws,
    and the parameters after them."""
    cases.check_logs_and_losses(enh_run, ENH_SIZE["steps"])
    cases.check_saved_params(enh_run, "FlowEnhancer")


def test_enhancer_metrics_match_jax(enh_run):
    """STOIs (rounded to 0.001) within 2e-3, SI-SDRs (to 0.01 dB) within
    0.02 dB: the eval enhances 6 held-out clips at nfe 1 and 2."""
    cases.check_metrics(enh_run, {"noisy_stoi": 0.0, "noisy_si_sdr": 0.0,
                                  "nfe1_stoi": 2e-3, "nfe64_stoi": 2e-3,
                                  "nfe1_si_sdr": 0.02, "nfe64_si_sdr": 0.02})


def test_enhancer_checkpoints_load_in_both_registries(enh_run):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 30, 257)).astype(np.float32)
    t = np.array([0.2, 0.7], np.float32)
    cond = np.abs(rng.standard_normal((2, 30, 257))).astype(np.float32)
    for who in ("port", "jax"):
        model, params = jax_from_pretrained(enh_run[who]["path"])
        want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                               jnp.asarray(cond)))
        with torch.no_grad():
            got = from_pretrained(enh_run[who]["path"])(
                torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond)).numpy()
        assert _rel(got, want) <= cases.FORWARD_RTOL, who


def test_denoiser_steps_match_jax(den_run):
    cases.check_logs_and_losses(den_run, DEN_SIZE["steps"])
    cases.check_saved_params(den_run, "TDFUNet")


def test_denoiser_metrics_match_jax(den_run):
    """SI-SDRs (rounded to 0.01 dB) of the fixture through each package's
    DenoiseEngine within 0.02 dB."""
    cases.check_metrics(den_run, {"noisy_si_sdr": 0.0, "denoised_si_sdr": 0.02})


def test_denoiser_checkpoints_load_in_both_registries(den_run, monkeypatch):
    monkeypatch.setattr(jdenoise, "DIM_T", DIM_T)
    monkeypatch.setattr(tdenoise, "DIM_T", DIM_T)
    spec = np.random.default_rng(6).standard_normal((1, 4, 3072, DIM_T)).astype(np.float32)
    for who in ("port", "jax"):
        model, params = jax_from_pretrained(den_run[who]["path"])
        want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(spec)))
        with torch.no_grad():
            got = from_pretrained(den_run[who]["path"])(torch.from_numpy(spec)).numpy()
        assert _rel(got, want) <= cases.FORWARD_RTOL, who


@pytest.mark.parametrize("name,ckpt", [("FlowEnhancer", "enh-bootstrap"),
                                       ("TDFUNet", "den-bootstrap")])
def test_inverse_converter_is_exact_on_the_shipped_checkpoint(name, ckpt):
    with np.load(os.path.join("checkpoints", ckpt, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    back = INVERSE_CONVERTERS[name](CONVERTERS[name](unflatten(flat)))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v), k


def test_flow_draws_come_from_the_generator():
    """Without a patch, the enhancer's draws are the generator's: times in
    [0, 1), one a row, and a standard normal of the spectrogram's shape."""
    gen = torch.Generator().manual_seed(7)
    t, z = recipes_plain._flow_draws(gen, 3, (3, 5, 257))
    assert t.shape == (3,) and bool(((t >= 0) & (t < 1)).all()) and z.shape == (3, 5, 257)
    again = recipes_plain._flow_draws(torch.Generator().manual_seed(7), 3, (3, 5, 257))
    assert torch.equal(t, again[0]) and torch.equal(z, again[1])
