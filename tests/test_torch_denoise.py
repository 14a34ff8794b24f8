"""The port's MDX denoiser against the JAX package on the CPU.

One flax parameter tree (a small perturbed random TDFUNet, or the shipped
`checkpoints/den-bootstrap`) goes through `runtime/convert.py` into the
port; the same numpy inputs from a seed go through both. float32 runs
within 1e-4 of the reference's largest magnitude (the JAX side at full
matmul precision); the bf16 engine against the JAX package's bf16 mode
within 2e-2. Then the MDX STFT pair, the spectral gate, the in-graph chain
at 16 kHz, `denoise_vocal`'s host chunking and `AudioProcessor`'s
preprocessing surface.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.models import denoise as jden
from targetdiarization_tpu.processors.audio import AudioProcessor as JaxAudioProcessor
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu_torch.models import denoise as tden
from targetdiarization_tpu_torch.processors.audio import AudioProcessor
from targetdiarization_tpu_torch.runtime.convert import tdfunet_state_dict
from targetdiarization_tpu_torch.runtime.params import load_checkpoint
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

torch.set_num_threads(2)  # beside the other test workers' threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "den-bootstrap")
SMALL = dict(channels=4, depth=2, growth=4)
TOL, BF16_TOL = 1e-4, 2e-2
SR = 16000


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*args, **kw))


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.standard_normal(p.shape), jnp.float32),
        params)


def _small_pair(freq):
    jm = jden.TDFUNet(**SMALL)
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, freq, 8))))
    tm = tden.TDFUNet(**SMALL, freq=freq)
    tm.load_state_dict(tdfunet_state_dict(params), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def shipped():
    jm, jp = jax_from_pretrained(CKPT)
    return jm, jp, from_pretrained(CKPT)


@pytest.fixture(scope="module")
def small_engines():
    """Engines on a small random TDFUNet at the MDX frequency size (the
    chunking tests need the real spectrum, not the shipped widths)."""
    jm, params, tm = _small_pair(tden.DIM_F)
    return (tden.DenoiseEngine(tm, device="cpu", compute_dtype="float32"),
            jden.DenoiseEngine(params=params, model=jm, compute_dtype="float32"))


def _speech(rng, seconds, sr=SR):
    t = np.arange(int(seconds * sr)) / sr
    env = np.clip(np.sin(2 * np.pi * 2.3 * t), 0, None)
    tone = sum(np.sin(2 * np.pi * h * 160 * t + h) * 0.7 ** h for h in range(1, 12))
    return (0.2 * env * tone + 0.03 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.mark.parametrize("freq,frames", [(64, 16), (96, 24)])
def test_tdfunet_small_matches_jax(freq, frames, rng):
    jm, params, tm = _small_pair(freq)
    x = rng.standard_normal((2, 4, freq, frames)).astype(np.float32)
    want = _jax(jax.jit(jm.apply), params, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(_t(x)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


def test_tdfunet_shipped_matches_jax(shipped, rng):
    jm, jp, tm = shipped
    x = rng.standard_normal((1, 4, tden.DIM_F, 8)).astype(np.float32)
    want = _jax(jax.jit(jm.apply), jp, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(_t(x)).numpy()
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("h,w", [(6, 4), (5, 7)])
def test_conv_transpose_orientation(h, w, rng):
    """flax's ConvTranspose (kernel 2, stride 2, transpose_kernel=False) as
    the converter turns it into torch's: flipped, in and out swapped."""
    conv = fnn.ConvTranspose(3, (2, 2), strides=(2, 2))
    params = _perturb(conv.init(jax.random.PRNGKey(1), jnp.zeros((1, h, w, 5))), seed=1)
    x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
    want = _jax(conv.apply, params, jnp.asarray(x))  # (2, 2h, 2w, 3)
    sd = tdfunet_state_dict({"up_0": params["params"]})
    up = torch.nn.ConvTranspose2d(5, 3, 2, stride=2)
    up.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        got = up(_t(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6


def test_bf16_engine_matches_jax_bf16_mode(shipped, rng):
    """The JAX model in bf16 mode computes every layer in bf16; so does the
    port's bf16 engine."""
    jm, jp, _ = shipped
    ours = tden.DenoiseEngine(from_pretrained(CKPT), device="cpu", compute_dtype="bfloat16")
    theirs = jden.DenoiseEngine(params=jp, model=jm, compute_dtype="bfloat16")
    assert {p.dtype for p in ours.model.parameters()} == {torch.bfloat16}
    x = rng.standard_normal((1, 4, tden.DIM_F, 8)).astype(np.float32)
    want = _jax(theirs._apply, theirs._params_c, jnp.asarray(x))
    got = ours.forward_spec(_t(x)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, want) <= BF16_TOL


@pytest.mark.parametrize("hop", [1024, 256])
def test_mdx_stft_pair_matches_jax(hop, rng):
    x = rng.standard_normal((2, 2, tden.mdx_chunk_size(hop))).astype(np.float32)
    want = _jax(jden.mdx_stft, jnp.asarray(x), hop)
    got = tden.mdx_stft(_t(x), hop).numpy()
    assert got.shape == (2, 4, tden.DIM_F, tden.DIM_T) == want.shape
    assert _rel(got, want) <= 1e-5
    back_want = _jax(jden.mdx_istft, jnp.asarray(want), hop)
    back = tden.mdx_istft(_t(want), hop).numpy()
    assert _rel(back, back_want) <= 1e-5


@pytest.mark.parametrize("n", [16000, 1000])
def test_spectral_gate_matches_jax(n, rng):
    x = _speech(rng, n / SR)
    want = _jax(jden.spectral_gate, jnp.asarray(x))
    got = tden.spectral_gate(_t(x)).numpy()
    assert got.shape == want.shape == (n,)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("inst", [True, False])
def test_denoise_chain_16k_matches_jax(inst, shipped, rng):
    jm, jp, tm = shipped
    ours = tden.DenoiseEngine(tm, is_inst_model=inst, device="cpu", compute_dtype="float32")
    theirs = jden.DenoiseEngine(params=jp, model=jm, is_inst_model=inst, compute_dtype="float32")
    x = _speech(rng, 1.0)
    chain = jax.jit(jden.denoise_chain_16k, static_argnums=(0, 3))
    want = _jax(chain, theirs, theirs._params_c, jnp.asarray(x), SR)
    with torch.inference_mode():
        got = tden.denoise_chain_16k(ours, _t(x), SR).numpy()
    assert got.shape == want.shape == (SR,)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("case", ["mono 2 s", "mono 16 s (two chunks)", "stereo 44.1 kHz"])
def test_denoise_vocal_chunking_matches_jax(case, small_engines, rng):
    ours, theirs = small_engines
    if case.startswith("stereo"):
        sr = 44100
        x = np.stack([_speech(rng, 1.5, sr), _speech(rng, 1.5, sr)], axis=1)
    else:
        sr = SR
        x = _speech(rng, 16.0 if "16" in case else 2.0)
    with jax.default_matmul_precision("highest"):
        want = theirs.denoise_vocal(x, sr=sr)
    got = ours.denoise_vocal(x, sr=sr)
    assert got.shape == want.shape == x.shape
    assert _rel(got, want) <= TOL


def test_fast_mode_is_the_spectral_gate(small_engines, rng):
    ours, theirs = small_engines
    x = _speech(rng, 0.5)
    np.testing.assert_array_equal(ours.denoise_vocal(x, fast_mode=True),
                                  tden.spectral_gate(_t(x)).numpy())
    assert _rel(ours.denoise_vocal(x, fast_mode=True),
                theirs.denoise_vocal(x, fast_mode=True)) <= 1e-4


def test_tdfunet_state_dict_loads_shipped_checkpoint():
    tree, meta = load_checkpoint(CKPT)
    model = tden.TDFUNet(**meta["model_args"])
    missing, unexpected = model.load_state_dict(tdfunet_state_dict(tree), strict=False)
    assert not missing and not unexpected
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["enc.1.tdf_down.weight"].numpy(),
                                  tree["params"]["enc_1"]["tdf_down"]["kernel"].T)
    np.testing.assert_array_equal(sd["up.2.weight"].numpy(),
                                  tree["params"]["up_2"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))


# ---------------- AudioProcessor: preprocessing ----------------


@pytest.fixture(scope="module")
def processors():
    return (AudioProcessor(denoise_model=CKPT, device="cpu", compute_dtype="float32"),
            JaxAudioProcessor(denoise_model=CKPT))


@pytest.mark.parametrize("quality,hop", [(1, 256), (2, 1024), (3, 2048), (7, 1024)])
def test_quality_selects_the_mdx_hop(quality, hop):
    ap = AudioProcessor(denoise_model=CKPT, quality=quality, device="cpu")
    assert ap.is_denoise_vocal and ap.denoiser.hop == hop and ap.denoiser.is_inst_model


def test_missing_denoise_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="not found"):
        AudioProcessor(denoise_model=str(tmp_path / "nothing"), device="cpu")


@pytest.mark.parametrize("case", ["speech", "short", "silent"])
def test_loudness_surface_matches_jax(case, processors, rng):
    ours, theirs = processors
    x = {"speech": _speech(rng, 2.0), "short": _speech(rng, 0.3),
         "silent": np.zeros(SR, np.float32)}[case]
    m_ours, m_theirs = ours.meter_loudness(x, SR), theirs.meter_loudness(x, SR)
    assert m_ours == m_theirs if np.isinf(m_theirs) else abs(m_ours - m_theirs) <= 0.05
    got, want = ours.audio_loudness_control(x, SR), theirs.audio_loudness_control(x, SR)
    if case == "speech":
        assert _rel(got, want) <= 0.006  # 0.05 LU
    else:
        np.testing.assert_array_equal(got, want)
    assert _rel(ours.audio_gain(x + 0.01, -6.0), theirs.audio_gain(x + 0.01, -6.0)) <= 1e-6
    assert _rel(ours.audio_normalize(x + 0.01), theirs.audio_normalize(x + 0.01)) <= 1e-6


def test_run_modules_matches_jax(processors, rng):
    ours, theirs = processors
    x = _speech(rng, 1.0)
    chain = ["loudness", {"audio_gain": {"gain_db": -3.0}}, "denoise", "normalize",
             "no_such_stage"]
    with jax.default_matmul_precision("highest"):
        want = theirs.run_modules(x, SR, chain)
    got = ours.run_modules(x, SR, chain)
    assert _rel(got, want) <= 1e-3  # loudness is metered by each package's own host meter


@pytest.mark.parametrize("stage", ["restore", "enhance", {"restore_audio": {}}])
def test_run_modules_refuses_unported_stages(stage, processors):
    """No stage of the chain is refused any more: restoration (Apollo, since
    the infer slice) and enhancement (the flow enhancer, since the surface
    slice) are ported. Without a restorer or an enhancer both pass the
    audio through, as the JAX package's do (enhancement restores when no
    enhancer is loaded); `test_torch_restoration.py` and
    `test_torch_enhancement.py` run them with their models."""
    x = np.linspace(-0.5, 0.5, SR).astype(np.float32)
    assert processors[0].restorer is None and processors[0].enhancer is None
    np.testing.assert_array_equal(processors[0].run_modules(x, SR, [stage]), x)
    np.testing.assert_array_equal(processors[1].run_modules(x, SR, [stage]), x)


def test_denoise_without_denoiser_is_the_spectral_gate(rng):
    ap = AudioProcessor(device="cpu")
    x = _speech(rng, 1.0)
    assert not ap.is_denoise_vocal
    np.testing.assert_array_equal(ap.denoise_vocal(x), tden.spectral_gate(_t(x)).numpy())
