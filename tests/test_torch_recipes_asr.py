"""`bootstrap_asr` on its host data path against the JAX recipe, on the CPU,
and the CIF's `alphas_raw` that its losses read.

The recipe runs at a 32-wide Paraformer (one encoder and one decoder
block), 2 steps of 2 x 1 s, 1 eval utterance, no denoiser (its
checkpoint path is absent in both runs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_recipe_cases as cases
from targetdiarization_tpu.models.asr import Paraformer as JaxParaformer

SMALL = dict(dim=32, enc_layers=1, dec_layers=1, ffn=64)
# seed 1: no step where the JAX run's jitted CIF drops a target token
# (torch_recipe_cases.check_logs_and_losses); at seed 0 step 1 does
SIZE = dict(steps=2, batch=2, seconds=1.0, eval_utts=1, seed=1)
FBANK_FLOOR = 2.3  # log 10: above the float32 FFT noise of the empty top bands


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return cases.fixture_dir(str(tmp_path_factory.mktemp("assets")))


@pytest.fixture(scope="module")
def host_run(assets, tmp_path_factory):
    torch.set_num_threads(2)
    kwargs = {**SIZE, **SMALL, "denoiser_dir": "/nonexistent/den"}
    return cases.run_both(str(tmp_path_factory.mktemp("asr")), assets, "bootstrap_asr",
                          kwargs, kwargs, jax_cls=JaxParaformer, fbank_floor=FBANK_FLOOR)


def test_asr_host_path_steps_match_jax(host_run):
    cases.check_logs_and_losses(host_run, SIZE["steps"], cif=True)
    cases.check_saved_params(host_run, "Paraformer")


def test_asr_host_path_metrics_and_files_match_jax(host_run):
    """CER and exact rate from the same greedy decodes; the vocabulary and
    the corpus CMVN written beside the parameters."""
    cases.check_metrics(host_run, {"eval_cer": 0.0, "eval_exact": 0.0,
                                   "eval_cer_preprocessed": 0.0, "timestamp_mae_ms": 1e-3})
    import os

    for name in ("vocab.txt", "cmvn.npz", "model.json"):
        assert os.path.exists(os.path.join(host_run["port"]["path"], name)), name
    with open(os.path.join(host_run["port"]["path"], "vocab.txt"), encoding="utf-8") as f:
        got = f.read()
    with open(os.path.join(host_run["jax"]["path"], "vocab.txt"), encoding="utf-8") as f:
        assert got == f.read()
    with np.load(os.path.join(host_run["port"]["path"], "cmvn.npz")) as a, \
            np.load(os.path.join(host_run["jax"]["path"], "cmvn.npz")) as b:
        for k in ("mean", "istd"):
            assert _rel(a[k], b[k]) <= 1e-4, k


@pytest.mark.parametrize("target", [False, True])
def test_alphas_raw_match_jax(host_run, target):
    """The CIF's alphas before target_len scaling, beside the scaled ones,
    on the trained JAX checkpoint; the inference outputs keep their values."""
    from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
    from targetdiarization_tpu_torch.runtime.registry import from_pretrained

    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 20, 560)).astype(np.float32)
    mask = np.ones((2, 20), np.float32)
    mask[1, 14:] = 0
    model, params = jax_from_pretrained(host_run["jax"]["path"])
    tl = np.array([3.0, 2.0], np.float32) if target else None
    want = jax.jit(lambda p, f, m, t: model.apply(p, f, m, target_len=t))(
        params, jnp.asarray(feats), jnp.asarray(mask), None if tl is None else jnp.asarray(tl))
    with torch.no_grad():
        got = from_pretrained(host_run["jax"]["path"])(
            torch.from_numpy(feats), torch.from_numpy(mask),
            None if tl is None else torch.from_numpy(tl))
    for key in ("alphas_raw", "alphas", "logits"):
        assert _rel(got[key].numpy(), want[key]) <= 1e-4, key
    assert np.array_equal(got["n_tokens"].numpy(), np.asarray(want["n_tokens"]))
    if target:
        assert float(got["alphas"].sum()) == pytest.approx(5.0, rel=1e-5)
        assert not np.allclose(got["alphas_raw"].numpy(), got["alphas"].numpy())
    else:
        assert torch.equal(got["alphas_raw"], got["alphas"])
