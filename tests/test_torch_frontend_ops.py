"""The port's front-end DSP against the JAX package on the CPU.

STFT and iSTFT, overlap-add, the device resample, the K-weighting,
integrated loudness and its masked form in the fused front end, the
biquad, and the gain helpers: the same numpy inputs (from a seed) through
both packages, float32, within 1e-5 of the reference's largest magnitude
(loudness in LU within 1e-5 relative).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter, resample_poly

from targetdiarization_tpu.pipeline import fused as jfused
from targetdiarization_tpu_torch.ops import audio as taudio
from targetdiarization_tpu_torch.ops import loudness as tloud
from targetdiarization_tpu_torch.ops import resample as tres
from targetdiarization_tpu_torch.ops import stft as tstft
from targetdiarization_tpu_torch.pipeline import fused as tfused

torch.set_num_threads(2)  # beside the other test workers' threads

# the JAX package's `ops/__init__.py` exports functions named like their modules
jaudio, jloud, jres, jstft = (importlib.import_module(f"targetdiarization_tpu.ops.{m}")
                              for m in ("audio", "loudness", "resample", "stft"))
TOL = 1e-5
SR = 16000


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    if np.iscomplexobj(want):
        got, want = got.astype(np.complex128), want.astype(np.complex128)
    else:
        got, want = got.astype(np.float64), want.astype(np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*args, **kw))


def _speechlike(rng, n, silent_from=None):
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * 180 * t) * np.clip(np.sin(2 * np.pi * 3 * t), 0, None) \
        + 0.05 * rng.standard_normal(n)
    if silent_from is not None:
        x[silent_from:] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,n", [(1024, 256, 16000), (6144, 1024, 1024 * 255),
                                         (64, 16, 40)])
def test_stft_matches_jax(n_fft, hop, n, rng):
    """n = 40 < n_fft / 2: the reflection pad is longer than the signal."""
    x = rng.standard_normal((2, n)).astype(np.float32)
    want = _jax(jstft.stft, jnp.asarray(x), n_fft, hop)
    got = tstft.stft(_t(x), n_fft, hop).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("center,length", [(True, None), (True, 15000), (False, None)])
def test_istft_matches_jax(center, length, rng):
    x = rng.standard_normal(16000).astype(np.float32)
    spec = np.asarray(jstft.stft(jnp.asarray(x), 1024, 256, center=center))
    spec = spec * (1.0 + 0.5 * rng.random(spec.shape)).astype(np.float32)  # not a true STFT
    want = _jax(jstft.istft, jnp.asarray(spec), 1024, 256, center=center, length=length)
    got = tstft.istft(_t(spec), 1024, 256, center=center, length=length).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("frame,hop", [(6144, 1024), (1000, 300), (7, 7)])
def test_overlap_add_matches_jax(frame, hop, rng):
    frames = rng.standard_normal((2, 9, frame)).astype(np.float32)
    want = _jax(jstft.overlap_add, jnp.asarray(frames), hop)
    np.testing.assert_allclose(tstft.overlap_add(_t(frames), hop).numpy(), want,
                               rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("n,pad", [(5, 3), (5, 12), (1, 4), (100, 50)])
def test_reflect_pad_is_numpys(n, pad, rng):
    x = rng.standard_normal((2, n)).astype(np.float32)
    np.testing.assert_array_equal(tstft.reflect_pad(_t(x), pad).numpy(),
                                  np.pad(x, ((0, 0), (pad, pad)), mode="reflect"))


def test_hann_window_matches_jax():
    np.testing.assert_array_equal(tstft.hann_window(6144).numpy(),
                                  np.asarray(jstft.hann_window(6144)))


@pytest.mark.parametrize("target,source,n", [(44100, 16000, 16000), (16000, 44100, 44100),
                                             (44100, 16000, 1237), (16000, 8000, 999)])
def test_resample_matches_jax_and_scipy(target, source, n, rng):
    x = _speechlike(rng, n)
    want = _jax(jres.resample, jnp.asarray(x), target, source)
    got = tres.resample(_t(x), target, source).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL
    assert _rel(got, resample_poly(x.astype(np.float64), *tres._rates(target, source))) <= TOL
    w_t, q_t = tres._filterbank(*tres._rates(target, source))
    w_j, q_j = jres._filterbank(*jres._rates(target, source))
    np.testing.assert_array_equal(w_t, w_j)
    assert q_t == q_j


def test_resample_stereo_rows_are_resampled_alone(rng):
    x = np.stack([_speechlike(rng, 3000), _speechlike(rng, 3000)])
    got = tres.resample(_t(x), 44100, 16000).numpy()
    for c in range(2):
        np.testing.assert_array_equal(got[c], tres.resample(_t(x[c]), 44100, 16000).numpy())


@pytest.mark.parametrize("n", [8000, 48000])
def test_k_weight_matches_jax(n, rng):
    x = _speechlike(rng, n)
    want = _jax(jloud.k_weight, jnp.asarray(x), 16000)
    assert _rel(tloud.k_weight(_t(x), 16000).numpy(), want) <= TOL
    np.testing.assert_array_equal(tloud._k_freq_response(16000, 65536),
                                  jloud._k_freq_response(16000, 65536))
    np.testing.assert_array_equal(tloud._k_weighting_sos(44100), jloud._k_weighting_sos(44100))


@pytest.mark.parametrize("case", ["speech", "quiet_tail", "short", "stereo", "silent"])
def test_integrated_and_normalized_loudness_match_jax(case, rng):
    x = {"speech": _speechlike(rng, 3 * SR),
         "quiet_tail": _speechlike(rng, 3 * SR) * np.r_[np.ones(SR), 1e-3 * np.ones(2 * SR)],
         "short": _speechlike(rng, SR // 4),
         "stereo": np.stack([_speechlike(rng, 2 * SR), 0.5 * _speechlike(rng, 2 * SR)]),
         "silent": np.zeros(2 * SR)}[case].astype(np.float32)
    want = float(_jax(jloud.integrated_loudness, jnp.asarray(x), 16000))
    got = float(tloud.integrated_loudness_device(_t(x), 16000))
    if np.isinf(want):
        assert got == want
    else:
        assert abs(got - want) <= TOL * abs(want)
    want_n = _jax(jloud.normalize_loudness, jnp.asarray(x), 16000)
    got_n = tloud.normalize_loudness(_t(x), 16000).numpy()
    if case == "silent":
        np.testing.assert_array_equal(got_n, want_n)
    else:
        assert _rel(got_n, want_n) <= TOL


def test_device_loudness_agrees_with_host_meter(rng):
    x = _speechlike(rng, 3 * SR)
    assert abs(float(tloud.integrated_loudness_device(_t(x), SR))
               - tloud.integrated_loudness(x, SR)) <= 0.05


@pytest.mark.parametrize("section", [0, 1])
def test_biquad_scan_matches_lfilter_and_jax(section, rng):
    x = _speechlike(rng, 4000)
    sos = tloud._k_weighting_sos(SR)[section]
    b, a = sos[:3], sos[3:]
    want = lfilter(b, a, x.astype(np.float64))
    got = tloud.biquad_scan(_t(x), b, a).numpy()
    assert got.dtype == np.float32
    assert _rel(got, want) <= 1e-4  # a float32 recurrence of 4000 steps
    # no further from float64 than the JAX package's float32 associative
    # scan, or both at float32 resolution
    jax_got = np.asarray(jloud.biquad_scan(jnp.asarray(x), jnp.asarray(b), jnp.asarray(a)))
    assert _rel(got, want) <= max(_rel(jax_got, want), 1e-6)


@pytest.mark.parametrize("n_valid", [16000, 11000, 3000])
def test_masked_loudness_normalize_matches_jax(n_valid, rng):
    """A 1 s rung with `n_valid` samples of audio; 3000 is under one
    gating block, so the level stays."""
    x = _speechlike(rng, SR, silent_from=n_valid)
    want = _jax(jfused._masked_loudness_normalize, jnp.asarray(x), 16000, n_valid)
    got = tfused._masked_loudness_normalize(_t(x), 16000, n_valid).numpy()
    assert _rel(got, want) <= TOL
    if n_valid < 6400:
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("name,args", [
    ("to_mono", ()), ("rms", ()), ("rms_db", ()), ("peak_normalize", (-3.0,)),
    ("apply_gain_db", (4.5,)), ("soft_clip", ()), ("fade_edges", (100,)),
    ("mix_audio", ("b", 6.0)), ("mix_audio", ("b", None)), ("crossfade_concat", ("b", 64)),
])
def test_audio_helpers_match_jax(name, args, rng):
    a = (0.7 * rng.standard_normal((6, 2000))).astype(np.float32)
    x = a if name == "to_mono" else a[0]
    b = a[1]
    targs = [_t(b) if v == "b" else v for v in args]
    jargs = [jnp.asarray(b) if v == "b" else v for v in args]
    want = np.asarray(getattr(jaudio, name)(jnp.asarray(x), *jargs))
    got = getattr(taudio, name)(_t(x), *targs).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL
