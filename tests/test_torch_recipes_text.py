"""`bootstrap_punc`, `bootstrap_emotion` and `bootstrap_whisper` against the
JAX recipes, on the CPU.

Each JAX recipe runs once per module (`tests/torch_recipe_cases.py::
run_both`), then the port's from the same initial parameters:
- punctuation: CTTransformerPunc as shipped (128 wide, 2 layers), 3 steps
  of 4 sentences;
- emotion: EmotionNet, 3 steps of 4 x 1 s, 6 held-out clips;
- whisper at 32 wide, one encoder and one decoder layer, 2 x 1 s a step, on
  each of its data paths: the finite corpus (3 steps); fresh host batches
  (`device_synth=True, fresh_source="host"`, no corpus phase, the corpus
  stored clean with noise drawn a batch) and fresh device batches
  (`fresh_source="device"`), both continuing from the corpus run's JAX
  checkpoint (`init_from`). The device path's port run is handed the JAX
  recipe's synthesized audio for the same keys (`_jax_synth`):
  the renderer alone is held against JAX's in
  tests/test_torch_recipes_asr_device.py (1e-4 of its peak in float32), an
  error that moves Adam's first steps of the leaves with small gradients
  by more than the parameter check's 10 %.
The audio recipes floor both packages' fbank at log 2.3 (the synthesized
voices' empty top bands are FFT rounding noise, tests/test_torch_recipes_
asr.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_recipe_cases as cases
from targetdiarization_tpu.models.emotion import EmotionNet as JaxEmotionNet
from targetdiarization_tpu.models.punctuation import CTTransformerPunc as JaxPunc
from targetdiarization_tpu.models.whisper_style import WhisperStyleASR as JaxWhisper
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu_torch.runtime.convert import CONVERTERS, INVERSE_CONVERTERS
from targetdiarization_tpu_torch.runtime.params import load_checkpoint, unflatten
from targetdiarization_tpu_torch.runtime.registry import from_pretrained
from targetdiarization_tpu_torch.train import recipes as trecipes
from targetdiarization_tpu.train import synth_device as jsd
from targetdiarization_tpu_torch.train import synth_device as tsd

torch.set_num_threads(2)

FBANK_FLOOR = 2.3
PUNC_SIZE = dict(steps=3, batch=4, eval_utts=4)
EMO_SIZE = dict(steps=3, batch=4, seconds=1.0, eval_utts=6)
WHISPER_SMALL = dict(dim=32, enc_layers=1, dec_layers=1, ffn=64)
WHISPER_SIZE = dict(batch=2, seconds=1.0, eval_utts=1, **WHISPER_SMALL)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _jax_synth():
    """Patches under which the port's device synthesis gives the JAX
    recipe's audio for its key: `_synth_draws` keeps the key, and
    `render_from_draws` runs the JAX recipe's jitted synthesis graph on it
    (render_batch, then add_noise: one program, as the recipe compiles it,
    since XLA's fusion moves the float32 audio by 1e-4 of its peak against
    an eager render); `add_noise_from_draws` passes that audio on."""
    def graph(key, boot_idx, n_chars, n):
        k1, k2 = jax.random.split(key)
        r = jsd.render_batch(k1, boot_idx, n_chars, n)
        return jsd.add_noise(k2, r["audio"], r["n_valid"]), r["n_valid"]

    graph = jax.jit(graph, static_argnums=3)

    def draws(key, b, c, n, device):
        return {"key": jax.random.PRNGKey(key[0])}, {}

    def render(draws, char_ids, n_chars, n):
        audio, n_valid = graph(draws["key"], jnp.asarray(char_ids.numpy()),
                               jnp.asarray(n_chars.numpy()), n)
        return {"audio": torch.from_numpy(np.array(audio)),
                "n_valid": torch.from_numpy(np.array(n_valid))}

    return ((trecipes, "_synth_draws", draws), (tsd, "render_from_draws", render),
            (tsd, "add_noise_from_draws", lambda draws, audio, n_valid: audio))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return cases.fixture_dir(str(tmp_path_factory.mktemp("assets")))


@pytest.fixture(scope="module")
def punc_run(tmp_path_factory):
    return cases.run_both(str(tmp_path_factory.mktemp("punc")), "/nonexistent", "bootstrap_punc",
                          PUNC_SIZE, PUNC_SIZE, jax_cls=JaxPunc)


@pytest.fixture(scope="module")
def emo_run(assets, tmp_path_factory):
    return cases.run_both(str(tmp_path_factory.mktemp("emo")), assets, "bootstrap_emotion",
                          EMO_SIZE, EMO_SIZE, jax_cls=JaxEmotionNet, fbank_floor=FBANK_FLOOR)


@pytest.fixture(scope="module")
def whisper_runs(tmp_path_factory):
    """The corpus run, then the host and device fresh-batch runs from its
    JAX checkpoint."""
    corpus = dict(WHISPER_SIZE, steps=3, n_corpus=4)
    runs = {"corpus": cases.run_both(str(tmp_path_factory.mktemp("whisper")), "/nonexistent",
                                     "bootstrap_whisper", corpus, corpus, jax_cls=JaxWhisper,
                                     fbank_floor=FBANK_FLOOR)}
    fresh = dict(WHISPER_SIZE, steps=2, n_corpus=2, device_synth=True, phase1_steps=0,
                 init_from=runs["corpus"]["jax"]["path"])
    runs["host"] = cases.run_both(
        str(tmp_path_factory.mktemp("whisper_host")), "/nonexistent", "bootstrap_whisper",
        dict(fresh, fresh_source="host", corpus_noise="fresh"),
        dict(fresh, fresh_source="host", corpus_noise="fresh"), fbank_floor=FBANK_FLOOR)
    runs["device"] = cases.run_both(
        str(tmp_path_factory.mktemp("whisper_device")), "/nonexistent", "bootstrap_whisper",
        dict(fresh, fresh_source="device"), dict(fresh, fresh_source="device"),
        fbank_floor=FBANK_FLOOR, patches=_jax_synth())
    return runs


def test_punc_steps_match_jax(punc_run):
    cases.check_logs_and_losses(punc_run, PUNC_SIZE["steps"])
    cases.check_saved_params(punc_run, "CTTransformerPunc")


def test_punc_metrics_match_jax(punc_run):
    """Class accuracy and exact restores through each package's engine: equal."""
    cases.check_metrics(punc_run, {"class_accuracy": 0.0, "exact_restore": 0.0})


def test_emotion_steps_match_jax(emo_run):
    cases.check_logs_and_losses(emo_run, EMO_SIZE["steps"])
    cases.check_saved_params(emo_run, "EmotionNet")


def test_emotion_metrics_match_jax(emo_run):
    """The held-out accuracy and the confusion counts: equal."""
    cases.check_metrics(emo_run, {"eval_accuracy": 0.0})
    assert emo_run["port"]["metrics"]["confusion"] == emo_run["jax"]["metrics"]["confusion"]


@pytest.mark.parametrize("path", ["corpus", "host", "device"])
def test_whisper_steps_match_jax(whisper_runs, path):
    """Every step's loss within 1e-4 of JAX's, and the parameters after
    them; the fresh-batch runs draw every batch fresh."""
    run = whisper_runs[path]
    cases.check_logs_and_losses(run, 3 if path == "corpus" else 2)
    init = None if path == "corpus" else load_checkpoint(whisper_runs["corpus"]["jax"]["path"])[0]
    cases.check_saved_params(run, "WhisperStyleASR", init_tree=init)
    if path != "corpus":
        assert all("p2-fresh=1.00" in line for line in run["port"]["log"][:-1]), run["port"]["log"]


@pytest.mark.parametrize("path", ["corpus", "host", "device"])
def test_whisper_metrics_match_jax(whisper_runs, path):
    cases.check_metrics(whisper_runs[path], {"eval_cer": 0.0, "eval_exact": 0.0,
                                             "eval_cer_preprocessed": 0.0})


def test_checkpoints_load_in_both_registries(punc_run, emo_run, whisper_runs):
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 21000, (2, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([[16], [9]])).astype(np.float32)
    feats = (rng.standard_normal((2, 80, 80)) * 3).astype(np.float32)
    lengths = np.array([80, 53])
    tokens = rng.integers(1, 21000, (2, 5)).astype(np.int32)
    fmask = (np.arange(80)[None, :] < lengths[:, None]).astype(np.float32)
    cases_ = [(punc_run, (ids, mask)), (emo_run, (feats, lengths)),
              (whisper_runs["device"], (feats, fmask, tokens))]
    for run, args in cases_:
        for who in ("port", "jax"):
            model, params = jax_from_pretrained(run[who]["path"])
            want = np.asarray(jax.jit(model.apply)(params, *(jnp.asarray(a) for a in args)))
            with torch.no_grad():
                got = from_pretrained(run[who]["path"])(
                    *(torch.from_numpy(a).long() if a.dtype == np.int32 and a.ndim == 2
                      and a is not lengths else torch.from_numpy(a) for a in args)).numpy()
            assert _rel(got, want) <= cases.FORWARD_RTOL, (who, run[who]["path"])


@pytest.mark.parametrize("name,ckpt", [("CTTransformerPunc", "punc-bootstrap"),
                                       ("EmotionNet", "emo-bootstrap"),
                                       ("WhisperStyleASR", "whisper-bootstrap")])
def test_inverse_converter_is_exact_on_the_shipped_checkpoint(name, ckpt):
    with np.load(os.path.join("checkpoints", ckpt, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    back = INVERSE_CONVERTERS[name](CONVERTERS[name](unflatten(flat)))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v), k
