"""The port's flow enhancer against the JAX package's, on the CPU.

Pieces first (flax's "SAME" `ConvTranspose` and `GroupNorm(8)` against the
port's, at odd and even sizes), then `FlowEnhancer` on a small random
config (ch 16, one flax init converted by `runtime/convert.py`) and on
the shipped `checkpoints/enh-bootstrap` (ch 48), then the engine:
`EnhancerEngine.enhance` at `tau=0` (no prior noise, so the packages'
different noise generators drop out), the solver entry `_program` with the
JAX package's noise handed to both at `tau=0.5`, and
`AudioProcessor.enhance_audio` and `run_modules` with and without an
enhancer. Inputs are seeded numpy arrays and synthesized speech; JAX runs
at full float32 matmul precision.

Limits: 1e-4 of max |JAX| for every comparison. The models agree to
float32 rounding (about 1e-6 on these inputs); the GroupNorms mirror
flax's one-pass variance, so the 2 nfe forwards of a solve do not drift
apart.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BOOT_CHARS, synth_utterance
from targetdiarization_tpu.models import enhancement as je
from targetdiarization_tpu.processors.audio import AudioProcessor as JaxAudioProcessor
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu_torch.models import enhancement as te
from targetdiarization_tpu_torch.ops.conv import ConvTranspose2d
from targetdiarization_tpu_torch.processors.audio import AudioProcessor
from targetdiarization_tpu_torch.runtime.convert import flow_enhancer_state_dict
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "enh-bootstrap")
REST = os.path.join(REPO, "checkpoints", "rest-bootstrap")
TOL = 1e-4
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _speech(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    text = "".join(BOOT_CHARS[int(rng.integers(len(BOOT_CHARS)))] for _ in range(12))
    utt = synth_utterance(text, rng)[0]
    out = np.zeros(int(seconds * SR), np.float32)
    out[: min(len(utt), len(out))] = utt[: len(out)]
    return out + (0.01 * rng.standard_normal(len(out))).astype(np.float32)


@pytest.fixture(scope="module")
def shipped():
    model, params = jax_from_pretrained(CKPT)
    return (te.EnhancerEngine(from_pretrained(CKPT), device="cpu"),
            je.EnhancerEngine(params=params, model=model))


# ---------------- pieces ----------------


@pytest.mark.parametrize("hw", [(7, 9), (8, 10), (313, 65)])
@pytest.mark.parametrize("k,stride", [(4, 2), (2, 2), (3, 2)])
def test_conv_transpose_matches_flax(hw, k, stride):
    """flax ConvTranspose with "SAME" (lax pads the dilated input by
    (2, 2) for a 4x4 kernel of stride 2, (1, 1) for kernel = stride and
    (2, 1) for 3x3) against the port's, kernel flipped by the converter."""
    import flax.linen as nn

    rng = np.random.default_rng(hw[0] * 31 + k)
    x = rng.standard_normal((1, *hw, 6)).astype(np.float32)
    mod = nn.ConvTranspose(5, (k, k), strides=(stride, stride))
    params = mod.init(jax.random.PRNGKey(k), x)
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)  # a nonzero bias
    with jax.default_matmul_precision("highest"):
        want = np.asarray(mod.apply(params, x)).transpose(0, 3, 1, 2)
    conv = ConvTranspose2d(6, 5, k, stride=stride)
    kern = np.asarray(params["params"]["kernel"])
    conv.weight.data = torch.from_numpy(np.ascontiguousarray(kern[::-1, ::-1].transpose(2, 3, 0, 1)))
    conv.bias.data = torch.from_numpy(np.array(params["params"]["bias"]))
    with torch.inference_mode():
        got = conv(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == want.shape == (1, 5, hw[0] * stride, hw[1] * stride)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_group_norm_matches_flax(offset):
    """GroupNorm(8) over (C/8, H, W) per group, flax's one-pass variance,
    also where the mean is large against the spread."""
    import flax.linen as nn

    rng = np.random.default_rng(int(offset) + 11)
    x = (rng.standard_normal((2, 17, 33, 48)) + offset).astype(np.float32)
    mod = nn.GroupNorm(num_groups=8)
    params = mod.init(jax.random.PRNGKey(0), x)
    scale = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    want = np.asarray(mod.apply({"params": {"scale": scale, "bias": bias}}, x))
    gn = te.GroupNorm(48)
    gn.weight.data, gn.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
    with torch.inference_mode():
        got = gn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy().transpose(0, 2, 3, 1)
    assert _rel(got, want) <= TOL


@pytest.fixture(scope="module")
def small():
    """(flax module, params perturbed off their init, the port's model) at ch 16."""
    jm = je.FlowEnhancer(ch=16)
    z = np.zeros((1, 8, 257), np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), z, np.zeros(1, np.float32), z)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * np.random.default_rng(a.size).standard_normal(a.shape), params)
    tm = te.FlowEnhancer(ch=16)
    tm.load_state_dict(flow_enhancer_state_dict(params), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("frames", [13, 32, 57])
def test_small_flow_enhancer_matches_jax(small, frames):
    """ch 16 at odd and even frame counts (the skips are cropped after
    each transposed conv)."""
    jm, params, tm = small
    rng = np.random.default_rng(frames)
    x = rng.standard_normal((2, frames, 257)).astype(np.float32)
    cond = np.abs(rng.standard_normal((2, frames, 257))).astype(np.float32)
    t = np.array([0.1, 0.7], np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(params, x, t, cond))
    with torch.inference_mode():
        got = tm(*(torch.from_numpy(a) for a in (x, t, cond))).numpy()
    assert got.shape == want.shape == (2, frames, 257)
    assert _rel(got, want) <= TOL


def test_shipped_flow_enhancer_matches_jax(shipped):
    """The shipped ch-48 model, one forward on the spectrogram of 0.25 s."""
    ours, theirs = shipped
    wav = _speech(0.25, 1)[None]
    with torch.inference_mode():
        cond, _ = te._stft_mag_phase(torch.from_numpy(wav))
    x = np.random.default_rng(2).standard_normal(cond.shape).astype(np.float32)
    t = np.array([0.4], np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(theirs.model.apply(theirs.params, x, t, cond.numpy()))
    with torch.inference_mode():
        got = ours.model(torch.from_numpy(x), torch.from_numpy(t), cond).numpy()
    assert got.shape == want.shape == (1, 32, 257)
    assert _rel(got, want) <= TOL


# ---------------- the engine ----------------


def test_enhance_at_tau_zero_matches_jax(shipped):
    """1 s at nfe 2: with no prior noise the result is the seed's alone."""
    ours, theirs = shipped
    wav = _speech(1.0, 3)
    with jax.default_matmul_precision("highest"):
        want = theirs.enhance(wav, nfe=2, tau=0.0)
    got = ours.enhance(wav, nfe=2, tau=0.0, seed=5)
    assert got.shape == want.shape == wav.shape and got.dtype == np.float32
    assert _rel(got, want) <= TOL
    np.testing.assert_array_equal(ours.enhance(wav, nfe=2, tau=0.0, seed=0), got)


def test_solver_with_jax_noise_matches_jax(shipped):
    """`_program` on one 1 s piece with the JAX package's prior noise, at
    tau 0.5 and lambd 0.9."""
    ours, theirs = shipped
    wav = _speech(1.0, 4)[None]
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1, SR // te.HOP + 1, 257)))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(theirs._program(SR, 2)(theirs.params, jnp.asarray(wav), noise,
                                                  jnp.float32(0.9), jnp.float32(0.5)))
    got = ours._program(wav, noise, 2, 0.9, 0.5)
    assert got.shape == want.shape == (1, SR)
    assert _rel(got, want) <= TOL


def test_enhance_noise_comes_from_the_seed(shipped):
    """At tau 0.5 one seed gives one result and another seed another; each
    piece draws its noise from the seeded generator in turn."""
    ours, _ = shipped
    wav = _speech(0.5, 6)
    a, b = ours.enhance(wav, nfe=1, seed=1), ours.enhance(wav, nfe=1, seed=1)
    np.testing.assert_array_equal(a, b)
    assert np.abs(ours.enhance(wav, nfe=1, seed=2) - a).max() > 1e-4
    gen = torch.Generator().manual_seed(1)
    noise = torch.randn((1, SR // te.HOP + 1, 257), generator=gen)
    np.testing.assert_array_equal(
        a, ours._program(np.pad(wav, (0, SR - len(wav)))[None], noise, 1, 0.9, 0.5)[0, :len(wav)])


def test_enhance_pieces_and_rates_match_jax(shipped, monkeypatch):
    """Audio above the top bucket is cut in pieces (the buckets shrunk to
    0.25 s in both packages, so 0.6 s makes three), and 8 kHz audio is
    resampled to the model's rate and back."""
    ours, theirs = shipped
    monkeypatch.setattr(te.EnhancerEngine, "BUCKETS", (4000,))
    monkeypatch.setattr(je.EnhancerEngine, "BUCKETS", (4000,))
    for sr, wav in ((SR, _speech(0.6, 8)), (8000, _speech(0.6, 9)[::2].copy())):
        with jax.default_matmul_precision("highest"):
            want = theirs.enhance(wav, sr=sr, nfe=1, tau=0.0)
        got = ours.enhance(wav, sr=sr, nfe=1, tau=0.0)
        assert got.shape == want.shape == wav.shape
        assert _rel(got, want) <= TOL
    assert ours.enhance(np.zeros(0, np.float32)).shape == (0,)


# ---------------- AudioProcessor ----------------


@pytest.fixture(scope="module")
def processors():
    return (AudioProcessor(enhancement_model=CKPT, quality=1, device="cpu",
                           compute_dtype="float32"),
            JaxAudioProcessor(enhancement_model=CKPT, quality=1))


def test_enhance_audio_matches_jax(processors):
    """With an enhancer: the knobs pass through (tau 0, nfe 2 here); the
    quality preset picks nfe and tau defaults to PRIOR_STD."""
    ours, theirs = processors
    assert ours.enhancer is not None and theirs.enhancer is not None
    wav = _speech(0.5, 10)
    with jax.default_matmul_precision("highest"):
        want = theirs.enhance_audio(wav, SR, nfe=2, tau=0.0)
    assert _rel(ours.enhance_audio(wav, SR, nfe=2, tau=0.0), want) <= TOL
    np.testing.assert_array_equal(ours.enhance_audio(wav, SR),
                                  ours.enhancer.enhance(wav, nfe=1, tau=te.PRIOR_STD))
    assert te.PRIOR_STD == je.PRIOR_STD


def test_run_modules_enhance_matches_jax(processors):
    ours, theirs = processors
    wav = _speech(0.5, 11)
    chain = [{"enhance_audio": {"sampling_rate": SR, "nfe": 2, "tau": 0.0}}, "normalize"]
    with jax.default_matmul_precision("highest"):
        want = theirs.run_modules(wav, SR, chain)
    assert _rel(ours.run_modules(wav, SR, chain), want) <= TOL
    np.testing.assert_array_equal(ours.run_modules(wav, SR, ["enhance"]), ours.enhance_audio(wav))


def test_enhance_audio_without_enhancer_restores_like_jax():
    ours = AudioProcessor(restoration_model=REST, device="cpu", compute_dtype="float32")
    theirs = JaxAudioProcessor(restoration_model=REST)
    assert ours.enhancer is None and ours.restorer is not None
    wav = _speech(0.5, 12)
    with jax.default_matmul_precision("highest"):
        want = theirs.enhance_audio(wav, SR)
    got = ours.enhance_audio(wav, SR)
    np.testing.assert_array_equal(got, ours.restore_audio(wav, SR))
    assert _rel(got, want) <= TOL


def test_missing_enhancement_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="not found"):
        AudioProcessor(enhancement_model=str(tmp_path / "nothing"), device="cpu")
