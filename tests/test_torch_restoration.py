"""The port's Apollo restoration against the JAX package's.

Module by module on one flax parameter tree (random init, perturbed so
that no bias is zero and no scale is one) converted by
`runtime/convert.py::apollo_state_dict`, then the whole model on a small
random config and on the shipped `checkpoints/rest-bootstrap` (sr 16000,
win 20 ms, feature 96, 4 layers: 79 bands of 2 bins and a tail of 3), then
`RestorationEngine.restore` on a short rung and on an overlap-added input
above the 6 s window. JAX runs on the CPU at full float32 matmul precision,
the port with `device="cpu"`.

Limits: float32 within 1e-4 (max |diff| over max |JAX|; the modules
agree to float32 rounding). In bf16 mode both engines round their
weights to bf16 and compute in float32 (the JAX program's STFT window
and float32 stream promote every product; `test_jax_bf16_mode_computes_in_float32`
reads its types), so the port is held to the JAX bf16 mode within 1e-4
too, with the input rounded to bf16 as `FusedSeparation` rounds its
streams.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiarization_tpu.models import restoration as jr
from targetdiarization_tpu.ops import chunk as jchunk
from targetdiarization_tpu.runtime.registry import from_pretrained as jax_from_pretrained
from targetdiarization_tpu_torch.models import restoration as tr
from targetdiarization_tpu_torch.ops import chunk as tchunk
from targetdiarization_tpu_torch.runtime.convert import apollo_state_dict
from targetdiarization_tpu_torch.runtime.registry import from_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "rest-bootstrap")
TOL = 1e-4
SMALL = dict(sr=16000, win_ms=20, feature_dim=16, layer=2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs under pytest-xdist with several
    workers a machine, and more threads than cores slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb(params, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.standard_normal(p.shape),
                              jnp.float32), params)


def _init(module, *args, seed=0):
    with jax.default_matmul_precision("highest"):
        return _perturb(jax.jit(module.init)(jax.random.PRNGKey(seed), *args), seed)


def _apply(module, params, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(module.apply)(params, *args))


def _port(module, params):
    module.load_state_dict(apollo_state_dict(params), strict=True)
    return module.eval()


def _run(module, *args):
    with torch.no_grad():
        return module(*(torch.from_numpy(np.asarray(a)) for a in args)).numpy()


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("n, window, hop", [(1000, 400, 200), (1000, 400, None),
                                            (350, 400, 200), (1234, 300, 100)])
@pytest.mark.parametrize("window_fn", ["rect", "tri"])
def test_chunk_and_merge_match_jax(n, window, hop, window_fn):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    got, got_n = tchunk.chunk_signal(torch.from_numpy(x), window, hop)
    want, want_n = jchunk.chunk_signal(jnp.asarray(x), window, hop)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = got.numpy() * 0.5 + 0.1
    np.testing.assert_allclose(
        tchunk.merge_chunks(torch.from_numpy(y), n, hop, window_fn).numpy(),
        np.asarray(jchunk.merge_chunks(jnp.asarray(y), n, hop, window_fn)), rtol=1e-6,
        atol=1e-6)


def test_rms_norm_and_banked(rng):
    x = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
    mod = jr.RMSNorm(16)
    params = _init(mod, jnp.asarray(x))
    _close(_run(_port(tr.RMSNorm(16), params), x), _apply(mod, params, jnp.asarray(x)))
    mod = jr.RMSNormBanked(5, 16)
    params = _init(mod, jnp.asarray(x))
    _close(_run(_port(tr.RMSNormBanked(5, 16), params), x), _apply(mod, params, jnp.asarray(x)))


def test_band_roformer(rng):
    x = rng.standard_normal((2, 80, 9, 16)).astype(np.float32)
    mod = jr.BandRoformer(16)
    params = _init(mod, jnp.asarray(x))
    _close(_run(_port(tr.BandRoformer(16), params), x), _apply(mod, params, jnp.asarray(x)))


def test_band_attention_over_many_rows(rng):
    """80 bands attending for 600 (stream, frame) rows in one call, as at
    the restorer's rungs, against the JAX module's explicit scores."""
    x = rng.standard_normal((2, 80, 300, 16)).astype(np.float32)
    mod = jr.BandRoformer(16)
    params = _init(mod, jnp.asarray(x))
    _close(_run(_port(tr.BandRoformer(16), params), x), _apply(mod, params, jnp.asarray(x)))


def test_conv_act_norm_and_bsnet(rng):
    x = rng.standard_normal((6, 11, 16)).astype(np.float32)
    mod = jr.ConvActNorm(16)
    params = _init(mod, jnp.asarray(x))
    _close(_run(_port(tr.ConvActNorm(16), params), x), _apply(mod, params, jnp.asarray(x)))
    x4 = x.reshape(2, 3, 11, 16)
    mod = jr.BSNet(16)
    params = _init(mod, jnp.asarray(x4))
    _close(_run(_port(tr.BSNet(16), params), x4), _apply(mod, params, jnp.asarray(x4)))


def test_apollo_small_random(rng):
    wav = (0.1 * rng.standard_normal((2, 4000))).astype(np.float32)
    mod = jr.Apollo(**SMALL)
    params = _init(mod, jnp.asarray(wav))
    _close(_run(_port(tr.Apollo(**SMALL), params), wav), _apply(mod, params, jnp.asarray(wav)))


@pytest.fixture(scope="module")
def shipped():
    model, params = jax_from_pretrained(CKPT)
    return from_pretrained(CKPT), model, params


def test_rest_bootstrap_loads_strictly_and_matches_jax(shipped, rng):
    port, model, params = shipped
    assert (port.sr, port.win, port.stride, port.enc_dim, port._bands()) == \
        (16000, 320, 160, 161, (2, 79, 3))
    wav = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
    _close(_run(port, wav), _apply(model, params, jnp.asarray(wav)))


def _eqns(jaxpr) -> list:
    """Every equation of a jaxpr and of the jaxprs nested in it."""
    out = []
    for e in jaxpr.eqns:
        out.append(e)
        for v in e.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_eqns(inner))
    return out


def _bf16_engines():
    ours = tr.RestorationEngine.from_pretrained(CKPT, device="cpu", compute_dtype="bfloat16")
    theirs = jr.RestorationEngine.from_pretrained(CKPT)
    theirs_bf = jr.RestorationEngine(params=theirs.params, model=theirs.model,
                                     compute_dtype="bfloat16")
    return ours, theirs_bf


def test_jax_bf16_mode_computes_in_float32():
    """The JAX bf16 program: bf16 parameters, a bf16 input, float32 out of
    the STFT and every layer after it."""
    _, theirs = _bf16_engines()
    wav = jnp.zeros((1, 3200), jnp.bfloat16)
    eqns = _eqns(jax.make_jaxpr(lambda p, w: theirs.model.apply(p, w))(
        theirs._params_c, wav).jaxpr)
    ffts = [e for e in eqns if e.primitive.name == "fft"]
    assert ffts and {v.aval.dtype for e in ffts for v in e.invars} == \
        {jnp.dtype(jnp.float32), jnp.dtype(jnp.complex64)}
    dots = [e for e in eqns if e.primitive.name == "dot_general"]
    assert dots and all(e.outvars[0].aval.dtype == jnp.float32 for e in dots)
    assert {str(p.dtype) for p in jax.tree_util.tree_leaves(theirs._params_c)} == {"bfloat16"}


def test_bf16_mode_matches_jax_bf16_mode(rng):
    ours, theirs = _bf16_engines()
    assert {p.dtype for p in ours.model.parameters()} == {torch.float32}
    wav = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
    # as FusedSeparation gives it: the streams rounded to bf16
    wav_bf = torch.from_numpy(wav).to(torch.bfloat16)
    got = ours.forward(wav_bf.float()).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(theirs.model.apply(theirs._params_c, jnp.asarray(wav, jnp.bfloat16)),
                          np.float32)
    _close(got, want)
    # the engine's own windows are float32, as the JAX engine's
    _close(ours.restore(wav[0]), theirs.restore(wav[0]))


@pytest.mark.parametrize("seconds", [1.3, 6.6])
def test_restore_matches_jax(seconds):
    """1.3 s runs at the 200-frame rung (32000 samples), 6.6 s in two 6 s
    windows every 3 s, cross-faded."""
    rng = np.random.default_rng(int(seconds * 10))
    audio = (0.1 * rng.standard_normal(int(seconds * 16000))).astype(np.float32)
    ours = tr.RestorationEngine.from_pretrained(CKPT, device="cpu", compute_dtype="float32")
    theirs = jr.RestorationEngine.from_pretrained(CKPT)
    with jax.default_matmul_precision("highest"):
        want = theirs.restore(audio)
    got = ours.restore(audio)
    assert got.shape == audio.shape
    _close(got, want)


def test_audio_processor_restores_like_jax():
    """`AudioProcessor(restoration_model=...)`: `restore_audio` and the
    "restore" stage of `run_modules` against the JAX package's."""
    from targetdiarization_tpu.processors.audio import AudioProcessor as JaxAudioProcessor
    from targetdiarization_tpu_torch.processors.audio import AudioProcessor

    ours = AudioProcessor(restoration_model=CKPT, device="cpu", compute_dtype="float32")
    theirs = JaxAudioProcessor(restoration_model=CKPT)
    assert ours.is_restore_audio and theirs.is_restore_audio
    audio = (0.1 * np.random.default_rng(4).standard_normal(12000)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = theirs.run_modules(audio, 16000, ["restore"])
    _close(ours.run_modules(audio, 16000, ["restore"]), want)
    _close(ours.restore_audio(audio), want)
