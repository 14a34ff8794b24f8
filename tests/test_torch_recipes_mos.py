"""`train/mos.py`, `bootstrap_mos` and `bootstrap_sigmos` against the JAX
package, on the CPU.

- The frontends (`audio_melspec`, `sigmos_frontend`) within 1e-6, the
  estimators on the shipped `checkpoints/mos-bootstrap` (with its `p808/`
  head) and `checkpoints/sigmos-bootstrap` on a 10 s seeded signal at 16 and
  48 kHz within 1e-4 (the hop counts equal), and `train/metrics.py`'s rows
  with each package's estimators within 1e-3 (rounded to 0.001).
- The optimizer pieces the new recipes use, `cosine_decay_schedule` and the
  integer-label cross-entropy, against optax (values and gradients, 1e-6).
- The recipes, each run once per module (`tests/torch_recipe_cases.py::
  run_both`) from the same initial parameters (both DNSMOSNet heads' JAX
  draws, in order): `bootstrap_mos` 2 steps of 2 from a pool of 4,
  `bootstrap_sigmos` 3 steps of 2 from a pool of 4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_recipe_cases as cases
from targetdiarization_tpu.train import metrics as jmetrics
from targetdiarization_tpu.train import mos as jmos
from targetdiarization_tpu.runtime.params import load_checkpoint as jax_load_checkpoint
from targetdiarization_tpu_torch.runtime.convert import CONVERTERS, INVERSE_CONVERTERS
from targetdiarization_tpu_torch.runtime.params import unflatten
from targetdiarization_tpu_torch.train import losses as tlosses
from targetdiarization_tpu_torch.train import metrics as tmetrics
from targetdiarization_tpu_torch.train import mos as tmos
from targetdiarization_tpu_torch.train import optim as toptim

torch.set_num_threads(2)

MOS_SIZE = dict(steps=2, batch=2, pool=4)
SIGMOS_SIZE = dict(steps=3, batch=2, pool=4)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _signal(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Seeded speech-like audio: a harmonic tone gated at 4 Hz, with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    tone = sum(np.sin(2 * np.pi * f * t) / (k + 1) for k, f in enumerate((180.0, 360.0, 540.0)))
    gate = 0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 4.0 * t))
    return (0.2 * tone * gate + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def estimators():
    path = "checkpoints/mos-bootstrap"
    jp, _ = jax_load_checkpoint(path)
    j808, _ = jax_load_checkpoint(os.path.join(path, "p808"))
    js, _ = jax_load_checkpoint("checkpoints/sigmos-bootstrap")
    return {"jax": (jmos.MOSEstimator(params=jp, params_p808=j808),
                    jmos.SigMOSEstimator(params=js)),
            "port": (tmos.MOSEstimator.from_pretrained(path, device="cpu"),
                     tmos.SigMOSEstimator.from_pretrained("checkpoints/sigmos-bootstrap",
                                                          device="cpu"))}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return cases.fixture_dir(str(tmp_path_factory.mktemp("assets")))


@pytest.fixture(scope="module")
def mos_run(assets, tmp_path_factory):
    return cases.run_both(str(tmp_path_factory.mktemp("mos")), assets, "bootstrap_mos",
                          MOS_SIZE, MOS_SIZE, jax_cls=jmos.DNSMOSNet)


@pytest.fixture(scope="module")
def sigmos_run(assets, tmp_path_factory):
    return cases.run_both(str(tmp_path_factory.mktemp("sigmos")), assets, "bootstrap_sigmos",
                          SIGMOS_SIZE, SIGMOS_SIZE, jax_cls=jmos.SigMOSNet)


@pytest.mark.parametrize("seconds", [2.0, 9.01])
def test_audio_melspec_matches_jax(seconds):
    x = _signal(seconds, 16000, 1)
    got, want = tmos.audio_melspec(x), jmos.audio_melspec(x)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("sr", [16000, 48000])
def test_sigmos_frontend_matches_jax(sr):
    x = _signal(2.5, sr, 2)
    got, want = tmos.sigmos_frontend(x, sr), jmos.sigmos_frontend(x, sr)
    assert got.shape == want.shape == (3, got.shape[1], 481)
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("sr", [16000, 48000])
def test_estimators_match_jax_on_the_shipped_checkpoints(estimators, sr):
    x = _signal(10.0, sr, 3)
    (jm, js), (tm, ts) = estimators["jax"], estimators["port"]
    want, got = jm(x, sampling_rate=sr), tm(x, sampling_rate=sr)
    assert set(got) == set(want) and got["num_hops"] == want["num_hops"] >= 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (k, got[k], want[k])
    want, got = js.run(x, sr=sr), ts.run(x, sr=sr)
    assert list(got) == list(want) == list(tmos.SigMOSEstimator.KEYS)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (k, got[k], want[k])


def test_metrics_rows_with_the_estimators_match_jax(estimators):
    """MetricsTracker's row with the DNSMOS and SigMOS fields, each package
    with its own estimators, on a 3 s estimate (values rounded to 0.001)."""
    rng = np.random.default_rng(4)
    ref = _signal(3.0, 16000, 5)
    est = (ref + 0.05 * rng.standard_normal(len(ref))).astype(np.float32)
    mix = (ref + 0.2 * rng.standard_normal(len(ref))).astype(np.float32)
    (jm, js), (tm, ts) = estimators["jax"], estimators["port"]
    want = jmetrics.MetricsTracker(mos_estimator=jm, sigmos_estimator=js).update("a", est, ref, mix)
    got = tmetrics.MetricsTracker(mos_estimator=tm, sigmos_estimator=ts).update("a", est, ref, mix)
    assert list(got) == list(want)
    fields = tmetrics.MetricsTracker.MOS_FIELDS + tmetrics.MetricsTracker.SIGMOS_FIELDS
    assert set(fields) <= set(got)
    for k in want:
        if k != "key":
            assert abs(got[k] - want[k]) <= 1e-3 + 1e-9, (k, got[k], want[k])


def test_cosine_decay_schedule_matches_optax():
    for args in [(5e-4, 10, 0.05), (1e-3, 7, 0.0), (2.0, 3, 0.5, 2.0)]:
        want, got = optax.cosine_decay_schedule(*args), toptim.cosine_decay_schedule(*args)
        for step in range(0, args[1] + 3):
            w = float(want(jnp.asarray(step, jnp.int32)))
            assert abs(got(step) - w) <= 1e-6 * max(abs(w), 1e-12) + 1e-12, (args, step)
    with pytest.raises(ValueError):
        toptim.cosine_decay_schedule(1e-3, 0)


def test_integer_label_cross_entropy_matches_optax():
    """Values and gradients with respect to the logits within 1e-6."""
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((5, 7)) * 4).astype(np.float32)
    labels = rng.integers(0, 7, 5).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits),
                                                          jnp.asarray(labels))
    want_g = jax.grad(lambda x: jnp.sum(optax.softmax_cross_entropy_with_integer_labels(
        x, jnp.asarray(labels)) * jnp.arange(1.0, 6.0)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tlosses.softmax_cross_entropy_with_integer_labels(x, torch.from_numpy(labels))
    (got * torch.arange(1.0, 6.0)).sum().backward()
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= 1e-6 * max(
        1.0, float(np.abs(want).max()))
    assert np.abs(x.grad.numpy() - np.asarray(want_g)).max() <= 1e-6


def test_mos_steps_match_jax(mos_run):
    """Every step's loss (both heads) within 1e-4 of JAX's, and both saved
    heads' parameters moved as JAX's."""
    cases.check_logs_and_losses(mos_run, MOS_SIZE["steps"])
    assert len(mos_run["inits"]) == 2
    cases.check_saved_params(mos_run, "DNSMOSNet")
    p808 = {who: {"path": os.path.join(mos_run[who]["path"], "p808")}
            for who in ("port", "jax")}
    cases.check_saved_params(p808, "DNSMOSNet", init_tree=mos_run["inits"][1])


def test_mos_metrics_match_jax(mos_run):
    """The held-out Pearson r (rounded to 0.001) within 2e-3."""
    cases.check_metrics(mos_run, {"ovrl_pearson_r": 2e-3})


def test_sigmos_steps_match_jax(sigmos_run):
    cases.check_logs_and_losses(sigmos_run, SIGMOS_SIZE["steps"])
    cases.check_saved_params(sigmos_run, "SigMOSNet")


def test_sigmos_metrics_match_jax(sigmos_run):
    """The Pearson r within 2e-3, and the same directions."""
    cases.check_metrics(sigmos_run, {"ovrl_pearson_r": 2e-3})
    assert sigmos_run["port"]["metrics"]["direction_ok"] == \
        sigmos_run["jax"]["metrics"]["direction_ok"]


def test_recipe_checkpoints_load_in_both_packages(mos_run, sigmos_run):
    """Each package's checkpoints through the other's estimator: the same
    scores within 1e-4."""
    x = _signal(9.5, 16000, 7)
    for who in ("port", "jax"):
        path = mos_run[who]["path"]
        jp, _ = jax_load_checkpoint(path)
        j808, _ = jax_load_checkpoint(os.path.join(path, "p808"))
        want = jmos.MOSEstimator(params=jp, params_p808=j808)(x)
        got = tmos.MOSEstimator.from_pretrained(path, device="cpu")(x)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (who, k)
        path = sigmos_run[who]["path"]
        want = jmos.SigMOSEstimator(params=jax_load_checkpoint(path)[0]).run(x, sr=16000)
        got = tmos.SigMOSEstimator.from_pretrained(path, device="cpu").run(x, sr=16000)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (who, k)


@pytest.mark.parametrize("name,ckpt", [("DNSMOSNet", "mos-bootstrap"),
                                       ("DNSMOSNet", "mos-bootstrap/p808"),
                                       ("SigMOSNet", "sigmos-bootstrap")])
def test_inverse_converter_is_exact_on_the_shipped_checkpoint(name, ckpt):
    with np.load(os.path.join("checkpoints", ckpt, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    back = INVERSE_CONVERTERS[name](CONVERTERS[name](unflatten(flat)))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v), k
