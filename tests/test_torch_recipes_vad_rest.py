"""`bootstrap_vad` and `bootstrap_restorer` against the JAX recipes, on the CPU.

Each JAX recipe runs once per module (`tests/torch_recipe_cases.py::
run_both`), then the port's from the same initial parameters, at the JAX
test's sizes (VAD: FsmnVADNet's defaults, 3 steps of 4 x 1 s; Apollo 16
wide, one layer, 2 steps of 2 x 0.5 s) on the synthesized fixtures. Also
Apollo's spectrum output and the inverse converters of the four models
the recipes save.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_recipe_cases as cases
from targetdiarization_tpu.models.restoration import Apollo as JaxApollo
from targetdiarization_tpu.models.vad import FsmnVADNet as JaxFsmnVADNet
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu_torch.runtime.convert import CONVERTERS, INVERSE_CONVERTERS
from targetdiarization_tpu_torch.runtime.params import unflatten
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

REST_ARGS = dict(feature_dim=16, layer=1)
REST_SIZE = dict(steps=2, batch=2, seconds=0.5)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return cases.fixture_dir(str(tmp_path_factory.mktemp("assets")))


@pytest.fixture(scope="module")
def vad_run(assets, tmp_path_factory):
    torch.set_num_threads(2)
    size = dict(steps=3, batch=4, seconds=1.0)
    return cases.run_both(str(tmp_path_factory.mktemp("vad")), assets, "bootstrap_vad",
                          size, size, jax_cls=JaxFsmnVADNet)


def _apollo_init():
    n = int(REST_SIZE["seconds"] * 16000)
    model = JaxApollo(sr=16000, win_ms=20, **REST_ARGS)
    tree = jax.jit(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, n))))()
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def rest_run(assets, tmp_path_factory):
    torch.set_num_threads(2)
    kwargs = {**REST_SIZE, **REST_ARGS}
    return cases.run_both(str(tmp_path_factory.mktemp("rest")), assets, "bootstrap_restorer",
                          kwargs, kwargs, jax_init=_apollo_init)


def test_vad_steps_match_jax(vad_run):
    cases.check_logs_and_losses(vad_run, 3)
    cases.check_saved_params(vad_run, "FsmnVADNet")


def test_vad_metrics_match_jax(vad_run):
    """The self-eval's mean speech probabilities through each package's
    VADEngine (int16 round trip, bucketed) within 1e-3."""
    cases.check_metrics(vad_run, {"speech_mean_prob": 1e-3, "noise_mean_prob": 1e-3})


def test_vad_checkpoints_load_in_both_registries(vad_run):
    rng = np.random.default_rng(3)
    feats = (rng.standard_normal((2, 60, 80)) * 3).astype(np.float32)
    lengths = np.array([60, 41])
    for who in ("port", "jax"):
        model, params = jax_from_pretrained(vad_run[who]["path"])
        want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(feats), jnp.asarray(lengths)))
        with torch.no_grad():
            got = from_pretrained(vad_run[who]["path"])(torch.from_numpy(feats),
                                                        torch.from_numpy(lengths)).numpy()
        assert _rel(got, want) <= cases.FORWARD_RTOL, who


def test_restorer_steps_match_jax(rest_run):
    cases.check_logs_and_losses(rest_run, REST_SIZE["steps"])
    cases.check_saved_params(rest_run, "Apollo")


def test_restorer_metrics_match_jax(rest_run):
    """SI-SDRs (rounded to 0.01 dB) within 0.02 dB, STOIs (to 0.001) within
    0.002: the eval runs the trained models on 8 held-out clips."""
    cases.check_metrics(rest_run, {"noisy_si_sdr": 0.0, "restored_si_sdr": 0.02,
                                   "si_sdr_delta": 0.02, "noisy_stoi": 0.0,
                                   "restored_stoi": 0.002})


def test_restorer_checkpoints_load_in_both_registries(rest_run):
    wav = (np.random.default_rng(4).standard_normal((2, 6400)) * 0.1).astype(np.float32)
    apply = None
    for who in ("port", "jax"):
        model, params = jax_from_pretrained(rest_run[who]["path"])
        apply = apply or jax.jit(model.apply)
        want = np.asarray(apply(params, jnp.asarray(wav)))
        with torch.no_grad():
            got = from_pretrained(rest_run[who]["path"])(torch.from_numpy(wav)).numpy()
        assert _rel(got, want) <= cases.FORWARD_RTOL, who


def test_apollo_return_spec_matches_jax(rest_run):
    """The real/imaginary planes (B, F, frames, 2) the restorer's loss reads."""
    wav = (np.random.default_rng(5).standard_normal((2, 8000)) * 0.1).astype(np.float32)
    model, params = jax_from_pretrained(rest_run["jax"]["path"])
    want = np.asarray(jax.jit(lambda p, x: model.apply(p, x, return_spec=True))(
        params, jnp.asarray(wav)))
    with torch.no_grad():
        got = from_pretrained(rest_run["jax"]["path"])(torch.from_numpy(wav),
                                                       return_spec=True).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= cases.FORWARD_RTOL


@pytest.mark.parametrize("name,ckpt", [("FsmnVADNet", "vad"), ("Apollo", "rest"),
                                       ("Paraformer", "asr"), ("SenseVoice", "sv")])
def test_inverse_converter_is_exact_on_the_shipped_checkpoint(name, ckpt):
    """flat -> state dict -> flat gives every leaf back, bit for bit."""
    with np.load(f"checkpoints/{ckpt}-bootstrap/params.npz") as z:
        flat = {k: z[k] for k in z.files}
    back = INVERSE_CONVERTERS[name](CONVERTERS[name](unflatten(flat)))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v), k


def test_chip_smoke_trains_the_shipped_configurations():
    """chip_smoke.py's recipes phase trains each shipped checkpoint's
    configuration (its model.json), and the recipes' own arguments match."""
    import json

    import chip_smoke

    for name, args in chip_smoke.RECIPE_MODELS.items():
        with open(f"checkpoints/{name}-bootstrap/model.json") as f:
            assert json.load(f)["model_args"] == args, name
    for label, _, kwargs, config in chip_smoke.RECIPE_RUNS:
        args = chip_smoke.RECIPE_MODELS.get(config) or {}
        for key in set(kwargs) & set(args):
            assert kwargs[key] == args[key], (label, key)


def test_recipes_run_with_deterministic_cudnn():
    """Each recipe runs with cuDNN's deterministic algorithms (the same seed
    gives the same run on the card) and leaves the flag as it found it."""
    from targetdiarization_tpu_torch.train import recipes as port_recipes

    seen = port_recipes._reproducible(lambda: torch.backends.cudnn.deterministic)
    was = torch.backends.cudnn.deterministic
    assert seen() is True and torch.backends.cudnn.deterministic == was
    for name in ("bootstrap_vad", "bootstrap_separator", "bootstrap_restorer", "bootstrap_asr",
                 "bootstrap_sensevoice"):
        assert getattr(port_recipes, name).__wrapped__.__name__ == name
