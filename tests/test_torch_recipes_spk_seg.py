"""`bootstrap_speaker` and `bootstrap_segmentation` against the JAX recipes,
on the CPU.

Each JAX recipe runs once per module (`tests/torch_recipe_cases.py::
run_both`), then the port's from the same initial parameters. The speaker
recipe runs the "eres2net" preset (ERes2NetV2 16 wide, one block a stage),
3 steps of 4 x 1 s, on a 9.6 s `chat_mix` (the pseudo-speakers and the
segmentation pools cut its span 5.077-8.620 s); its class weights are
JAX's draw (`recipes_plain._class_weights` patched), and its BatchNorm
statistics train as leaves in both packages. Its pools are the JAX
recipe's (`recipes_plain._pseudo_speakers` patched): the phase vocoder
adds up each frame's phase advance, so the packages' float32 STFTs (1.2e-7
of their peak apart) give pitch-shifted pools 3e-3 of their peak apart on
5.7 s; `test_pseudo_speaker_pools_match_jax` holds the port's pools given
the JAX package's STFT. The segmentation recipe runs 3 steps of 2 x 2 s
with boundary weighting and slot gains, then again from the JAX run's
checkpoint (`init_from`) at another learning rate. Both packages' fbank
is floored at log 2.3, as in tests/test_torch_recipes_asr.py. Also the
inverse converters of the models these recipes save.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_recipe_cases as cases
from targetdiarization_tpu.models.diarization import SegmentationNet as JaxSegmentationNet
from targetdiarization_tpu.models.speaker import ERes2NetV2 as JaxERes2NetV2
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu.train import recipes as jrecipes
from targetdiarization_tpu_torch.runtime.convert import CONVERTERS, INVERSE_CONVERTERS
from targetdiarization_tpu_torch.runtime.params import load_checkpoint, unflatten
from targetdiarization_tpu_torch.runtime.registry import from_pretrained
from targetdiarization_tpu_torch.train import recipes as trecipes
from targetdiarization_tpu_torch.train import recipes_plain

torch.set_num_threads(2)

SPK_SIZE = dict(steps=3, batch=4, seconds=1.0)
SEG_SIZE = dict(steps=3, batch=2, seconds=2.0)
# both packages' fbank floored here, as in tests/test_torch_recipes_asr.py: the
# synthesized voices' empty top bands are FFT rounding noise
FBANK_FLOOR = 2.3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _jax_class_weights(seed, shape, device):
    return torch.from_numpy(np.array(0.1 * jax.random.normal(jax.random.PRNGKey(seed), shape)))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return cases.fixture_dir(str(tmp_path_factory.mktemp("assets")), chat_seconds=9.6)


@pytest.fixture(scope="module")
def spk_run(assets, tmp_path_factory):
    return cases.run_both(str(tmp_path_factory.mktemp("spk")), assets, "bootstrap_speaker",
                          SPK_SIZE, SPK_SIZE, jax_cls=JaxERes2NetV2, fbank_floor=FBANK_FLOOR,
                          patches=((recipes_plain, "_class_weights", _jax_class_weights),
                                   (recipes_plain, "_pseudo_speakers",
                                    jrecipes._pseudo_speakers)))


@pytest.fixture(scope="module")
def seg_runs(assets, tmp_path_factory):
    first = dict(SEG_SIZE, boundary_weight=1.0, boundary_frames=2, slot_gain=True)
    run = cases.run_both(str(tmp_path_factory.mktemp("seg")), assets, "bootstrap_segmentation",
                         first, first, jax_cls=JaxSegmentationNet, fbank_floor=FBANK_FLOOR)
    tuned = dict(SEG_SIZE, seed=1, init_from=run["jax"]["path"], lr=3e-4)
    fine = cases.run_both(str(tmp_path_factory.mktemp("seg_ft")), assets,
                          "bootstrap_segmentation", tuned, tuned, fbank_floor=FBANK_FLOOR)
    return run, fine


def test_speaker_steps_match_jax(spk_run):
    """Every step's loss within 1e-4 of JAX's, and the saved variables (the
    trained BatchNorm statistics among them) moved as JAX's."""
    cases.check_logs_and_losses(spk_run, SPK_SIZE["steps"])
    cases.check_saved_params(spk_run, "ERes2NetV2")
    want = cases.saved_state(spk_run["jax"]["path"], "ERes2NetV2")
    init = CONVERTERS["ERes2NetV2"](spk_run["init"])
    moved = [k for k in want if k.endswith("running_var") and not torch.equal(want[k], init[k])]
    assert moved, "the JAX recipe trains the BatchNorm statistics"


def test_speaker_metrics_match_jax(spk_run):
    """The cosines (rounded to 0.001) within 1e-3."""
    cases.check_metrics(spk_run, {k: 1e-3 for k in ("same_voice_cos", "cross_voice_cos",
                                                     "short_same_cos", "short_cross_cos")})


def test_speaker_checkpoints_load_in_both_registries(spk_run):
    rng = np.random.default_rng(3)
    feats = (rng.standard_normal((2, 90, 80)) * 3).astype(np.float32)
    lengths = np.array([90, 61])
    for who in ("port", "jax"):
        model, variables = jax_from_pretrained(spk_run[who]["path"])
        want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(feats),
                                               jnp.asarray(lengths)))
        with torch.no_grad():
            got = from_pretrained(spk_run[who]["path"])(torch.from_numpy(feats),
                                                        torch.from_numpy(lengths)).numpy()
        assert _rel(got, want) <= cases.FORWARD_RTOL, who


def test_segmentation_steps_match_jax(seg_runs):
    run, fine = seg_runs
    cases.check_logs_and_losses(run, SEG_SIZE["steps"])
    cases.check_saved_params(run, "SegmentationNet")
    tree, _ = load_checkpoint(run["jax"]["path"])
    cases.check_logs_and_losses(fine, SEG_SIZE["steps"])
    cases.check_saved_params(fine, "SegmentationNet", init_tree=tree)


def test_segmentation_metrics_match_jax(seg_runs):
    for run in seg_runs:
        cases.check_metrics(run, {"silence_max_act": 1e-3, "speech_max_act": 1e-3})


def test_segmentation_checkpoints_load_in_both_registries(seg_runs):
    rng = np.random.default_rng(4)
    feats = (rng.standard_normal((2, 120, 80)) * 3).astype(np.float32)
    lengths = np.array([120, 77])
    for run in seg_runs:
        for who in ("port", "jax"):
            model, params = jax_from_pretrained(run[who]["path"])
            want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(feats),
                                                   jnp.asarray(lengths)))
            with torch.no_grad():
                got = from_pretrained(run[who]["path"])(torch.from_numpy(feats),
                                                        torch.from_numpy(lengths)).numpy()
            assert _rel(got, want) <= cases.FORWARD_RTOL, who


@pytest.mark.parametrize("name,ckpt", [("ERes2NetV2", "spk-bootstrap"),
                                       ("CAMPlusPlus", "campp-bootstrap"),
                                       ("SegmentationNet", "seg-bootstrap")])
def test_inverse_converter_is_exact_on_the_shipped_checkpoint(name, ckpt):
    """flat -> state dict -> flat gives every leaf back, bit for bit
    (`batch_stats` too)."""
    with np.load(os.path.join("checkpoints", ckpt, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    back = INVERSE_CONVERTERS[name](CONVERTERS[name](unflatten(flat)))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v), k


def test_pseudo_speaker_pools_match_jax(assets, monkeypatch):
    """The pitch-shifted pools the speaker recipe trains on: handed the JAX
    package's STFT, the port's `_pseudo_speakers` gives the JAX recipe's
    pools exactly; with its own, within 1e-2 of their peak (the phase
    vocoder's float32 phase sums, tests/test_torch_surface.py)."""
    from targetdiarization_tpu.ops.stft import stft as jax_stft
    from targetdiarization_tpu_torch.processors import audio as port_audio

    monkeypatch.setattr(jrecipes, "ASSETS", assets)
    monkeypatch.setattr(trecipes, "ASSETS", assets)
    want, own = jrecipes._pseudo_speakers(), trecipes._pseudo_speakers()

    def stft_of_jax(t, n_fft, hop):
        s = jax_stft(jnp.asarray(t.numpy()), n_fft, hop)
        return torch.complex(torch.from_numpy(np.array(s.real)), torch.from_numpy(np.array(s.imag)))

    monkeypatch.setattr(port_audio, "stft", stft_of_jax)
    got = trecipes._pseudo_speakers()
    assert sorted(got) == sorted(own) == sorted(want) and len(got) == 10
    for k in want:
        assert len(want[k]) > 0, k
        np.testing.assert_array_equal(got[k], want[k])
        assert _rel(own[k], want[k]) <= 1e-2, k


def test_every_recipe_is_importable_runs_on_the_card_by_default_and_reproducibly():
    """All fourteen recipes come from `train/recipes.py`, take `device="cuda"`
    by default and run with cuDNN's deterministic algorithms."""
    import inspect

    names = sorted(n for n in dir(jrecipes) if n.startswith("bootstrap_"))
    assert len(names) == 14
    for name in names:
        fn = getattr(trecipes, name)
        assert fn.__wrapped__.__name__ == name
        assert inspect.signature(fn).parameters["device"].default == "cuda", name
        jparams = list(inspect.signature(getattr(jrecipes, name)).parameters.items())
        tparams = list(inspect.signature(fn).parameters.items())
        assert [(k, p.default) for k, p in tparams[:-1]] == [(k, p.default) for k, p in jparams]


def test_chip_smoke_trains_the_shipped_plain_configurations():
    """chip_smoke.py's plain recipes phase trains each shipped checkpoint's
    configuration (its model.json), and each run's own arguments match it."""
    import json

    import chip_smoke

    for name, args in chip_smoke.RECIPE_PLAIN_MODELS.items():
        with open(f"checkpoints/{name}-bootstrap/model.json") as f:
            assert json.load(f)["model_args"] == args, name
    from targetdiarization_tpu_torch.models.speaker import MODEL_PRESETS

    labels = set()
    for label, recipe, kwargs, config in chip_smoke.RECIPE_RUNS_PLAIN:
        labels.add(recipe)
        args = chip_smoke.RECIPE_PLAIN_MODELS[config]
        if recipe == "bootstrap_speaker":
            cls, preset = MODEL_PRESETS[kwargs["model_name"]]
            assert {k: list(v) if isinstance(v, tuple) else v
                    for k, v in preset.items()} == args, label
        for key in set(kwargs) & set(args):
            assert kwargs[key] == args[key], (label, key)
    assert len(labels) == 9
