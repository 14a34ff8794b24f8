"""`bootstrap_asr(device_synth=True)` against the JAX recipe on the CPU, and
the device synthesis (`train/synth_device.py`) against the JAX module.

The port's draws (`recipes._synth_draws`) are patched to return the JAX
recipe's draws for the same key path: the CMVN pass's PRNGKey(seed * 7919
+ ci) and each step's fold_in(PRNGKey(seed + 31337), step), each split into
render_batch's key and add_noise's (recipes.py's `synth_graph`). The
recipe runs at a 32-wide Paraformer, 2 steps of 2 x 1 s, one eval
utterance, without the denoiser (its preprocess chain runs in the isolation
test's dry run of chip_smoke.py's recipes phase, and on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_recipe_cases as cases
from targetdiarization_tpu.models.asr import Paraformer as JaxParaformer
from targetdiarization_tpu.train import synth_device as jsd
from targetdiarization_tpu_torch.train import recipes as trecipes
from targetdiarization_tpu_torch.train import synth_device as tsd

SMALL = dict(dim=32, enc_layers=1, dec_layers=1, ffn=64)
SIZE = dict(steps=2, batch=2, seconds=1.0, eval_utts=1, seed=0, device_synth=True)
FBANK_FLOOR = 2.3  # as tests/test_torch_recipes_asr.py


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def jax_render_draws(key, b: int, c: int) -> dict:
    """synth_device.render_batch's nine draws from `key`, as it makes them."""
    k_f0, k_ph, k_dur, k_gain, k_gap, k_lead, k_na, k_nph, k_tail = jax.random.split(key, 9)
    u = jax.random.uniform
    draws = {"dur": u(k_dur, (b, c), minval=0.9, maxval=1.1),
             "f0": u(k_f0, (b, c), minval=95.0, maxval=220.0),
             "phases": u(k_ph, (jsd.K_MAX, b, c), maxval=2 * np.pi),
             "u_na": u(k_na, (b, c, jsd.J_NOISE)),
             "nph": u(k_nph, (b, c, jsd.J_NOISE), maxval=2 * np.pi),
             "gain": u(k_gain, (b, c, 1), minval=0.25, maxval=0.6),
             "lead": u(k_lead, (b,), minval=0.05, maxval=0.15),
             "gaps": u(k_gap, (b, c), minval=0.02, maxval=0.07),
             "tail": u(k_tail, (b,), minval=0.05, maxval=0.15)}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def jax_noise_draws(key, b: int, n: int, p_noise: float = 0.5) -> dict:
    """synth_device.add_noise's three draws from `key`."""
    k_on, k_snr, k_n = jax.random.split(key, 3)
    draws = {"on": jax.random.bernoulli(k_on, p_noise, (b,)),
             "snr": jax.random.uniform(k_snr, (b,), minval=12.0, maxval=35.0),
             "noise": jax.random.normal(k_n, (b, n))}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def jax_synth_draws(key: tuple, b: int, c: int, n: int, device) -> tuple:
    """The port recipe's `_synth_draws` for a key path, from jax.random as
    the JAX recipe draws them: PRNGKey(base), fold_in(., i), then split
    into render_batch's key and add_noise's."""
    k = jax.random.PRNGKey(key[0])
    if len(key) > 1:
        k = jax.random.fold_in(k, key[1])
    k1, k2 = jax.random.split(k)
    return jax_render_draws(k1, b, c), jax_noise_draws(k2, b, n)


@pytest.fixture(scope="module")
def device_run(tmp_path_factory):
    torch.set_num_threads(2)
    assets = cases.fixture_dir(str(tmp_path_factory.mktemp("assets")))
    kwargs = {**SIZE, **SMALL, "denoiser_dir": "/nonexistent/den"}
    return cases.run_both(str(tmp_path_factory.mktemp("asr")), assets, "bootstrap_asr",
                          kwargs, kwargs, jax_cls=JaxParaformer, fbank_floor=FBANK_FLOOR,
                          patches=((trecipes, "_synth_draws", jax_synth_draws),))


def test_asr_device_path_steps_match_jax(device_run):
    """Every step's loss (CE, quantity and CIF alignment) within 5e-4 of
    JAX's on the same draws, and the parameters after them. Not 1e-4: the
    renderer's audio is 1e-4 of its peak from JAX's in float32
    (test_render_from_draws_matches_jax_render_batch), and the features
    and the loss inherit it (1.7e-4 at step 1 here)."""
    cases.check_logs_and_losses(device_run, SIZE["steps"], cif=True, rtol=5e-4)
    cases.check_saved_params(device_run, "Paraformer")


def test_asr_device_path_metrics_match_jax(device_run):
    cases.check_metrics(device_run, {"eval_cer": 0.0, "eval_exact": 0.0,
                                     "eval_cer_preprocessed": 0.0, "timestamp_mae_ms": 1e-3})


def _ids(b=2, c=6, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 32, (b, c)).astype(np.int32)
    n_chars = np.array([c, c - 3][:b], np.int32)
    return ids, n_chars


def test_render_from_draws_matches_jax_render_batch():
    """JAX's own draws for a key through the port's renderer against
    render_batch on that key: audio within 2e-4 of its peak, and within
    2e-4 of the same draws rendered in float64; boundaries and valid
    counts equal. (Not 1e-4: a harmonic's phase 2 pi f t reaches 7000 rad,
    where float32 keeps 5e-4 rad, and each package's float32 render is
    about 1e-4 from the float64 one.)"""
    ids, n_chars = _ids(2, 7)
    key = jax.random.PRNGKey(11)
    want = jsd.render_batch(key, jnp.asarray(ids), jnp.asarray(n_chars), 12000)
    draws = jax_render_draws(key, *ids.shape)
    got = tsd.render_from_draws(draws, torch.from_numpy(ids), torch.from_numpy(n_chars), 12000)
    assert _rel(got["audio"].numpy(), want["audio"]) <= 2e-4
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        exact = tsd.render_from_draws({k: v.double() if v.is_floating_point() else v
                                       for k, v in draws.items()}, torch.from_numpy(ids),
                                      torch.from_numpy(n_chars), 12000)["audio"]
    finally:
        torch.set_default_dtype(default)
    assert _rel(got["audio"].numpy(), exact.numpy()) <= 2e-4
    for k in ("starts", "ends"):
        assert np.allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6), k
    assert np.array_equal(got["n_valid"].numpy(), np.asarray(want["n_valid"]))


def test_add_noise_matches_jax():
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((4, 3000)) * 0.2).astype(np.float32)
    n_valid = np.array([3000, 2500, 100, 2999], np.int32)
    key = jax.random.PRNGKey(5)
    want = jsd.add_noise(key, jnp.asarray(audio), jnp.asarray(n_valid))
    got = tsd.add_noise_from_draws(jax_noise_draws(key, 4, 3000), torch.from_numpy(audio),
                                   torch.from_numpy(n_valid))
    assert _rel(got.numpy(), want) <= 1e-4


def test_render_batch_draws_from_its_generator():
    """The port's own draws: reproducible from a seed, in their ranges,
    and the audio silent past each row's valid count."""
    ids, n_chars = _ids()
    outs = [tsd.render_batch(torch.Generator().manual_seed(4), torch.from_numpy(ids),
                             torch.from_numpy(n_chars), 16000) for _ in range(2)]
    assert torch.equal(outs[0]["audio"], outs[1]["audio"])
    d = tsd.draw_render(torch.Generator().manual_seed(4), 2, 6)
    assert float(d["f0"].min()) >= 95.0 and float(d["f0"].max()) < 220.0
    assert float(d["u_na"].max()) < 1.0
    audio, nv = outs[0]["audio"], outs[0]["n_valid"]
    for b in range(2):
        assert not audio[b, int(nv[b]):].any()
        assert float(audio[b, : int(nv[b])].abs().max()) > 0.1
